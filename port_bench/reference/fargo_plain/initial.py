"""Initial conditions (reference src/init.cpp): the power-law disk
(init_gas_density :937, init_gas_energy :1257, init_gas_velocities
:1467). The port's other initial conditions are not in this copy
(``scope.py``).

Everything is built host-side in float64 numpy and cast to the run dtype
on the target device.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import Constants
from .grid import Geometry
from .ops import diskmodel as dm
from .params import Physics
from .state import FieldState


def powerlaw_sigma(phys: Physics, geom: Geometry) -> np.ndarray:
    """Sigma = Sigma0 r^-slope with floor and optional profile cutoffs
    (reference src/init.cpp:937-1124)."""
    r = geom.rmed[:, None]
    sigma = phys.sigma0 * r ** (-phys.sigma_slope)
    if phys.profile_cutoff_outer:
        sigma = sigma * dm.cutoff_outer(phys.profile_cutoff_point_outer,
                                        phys.profile_cutoff_width_outer, r)
    if phys.profile_cutoff_inner:
        sigma = sigma * dm.cutoff_inner(phys.profile_cutoff_point_inner,
                                        phys.profile_cutoff_width_inner, r)
    sigma = np.maximum(sigma, phys.sigma_floor * phys.sigma0)
    return np.broadcast_to(sigma, (geom.nrad, geom.naz)).copy()


def powerlaw_energy(phys: Physics, constants: Constants,
                    geom: Geometry, sigma: np.ndarray) -> np.ndarray:
    """reference src/init.cpp:1257-1302 with the temperature floor and the
    profile-cutoff damping of the energy (init.cpp:1364-1443)."""
    r = geom.rmed[:, None]
    energy = dm.initial_energy(phys, constants, r, phys.hydro_center_mass)
    e_floor = phys.minimum_temperature * sigma / phys.mu * constants.R \
        / (phys.adiabatic_index - 1.0)
    energy = np.maximum(np.broadcast_to(energy, sigma.shape), e_floor)
    if phys.profile_cutoff_outer:
        fac = np.asarray(dm.cutoff_outer(phys.profile_cutoff_point_outer,
                                         phys.profile_cutoff_width_outer, r))
        energy = np.maximum(energy * fac, e_floor)
    if phys.profile_cutoff_inner:
        fac = np.asarray(dm.cutoff_inner(phys.profile_cutoff_point_inner,
                                         phys.profile_cutoff_width_inner, r))
        energy = np.maximum(energy * fac, e_floor)
    return energy


def gas_velocities(phys: Physics, constants: Constants, geom: Geometry,
                   quad_moment: float = 0.0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Axisymmetric velocity ICs (reference src/init.cpp:1467-1780,
    single-star primary-frame branch). ``quad_moment`` adds the binary
    quadrupole support to v_az (reference src/Theo.cpp:183-205)."""
    G = constants.G
    M = phys.hydro_center_mass
    rb = geom.rmed
    ri = geom.rinf
    if phys.initialize_pure_keplerian:
        # the reference takes Rmed for the v_rad rows too
        # (src/init.cpp:1611-1632)
        vaz_row = np.sqrt(G * M / rb)
        vr_row = dm.viscous_radial_speed_analytic(phys, constants, rb, M)
        vaz = np.broadcast_to((vaz_row - phys.omega_frame * rb)[:, None],
                              (geom.nrad, geom.naz)).copy()
        vr_full = np.zeros((geom.nrad + 1, geom.naz))
        vr_full[:geom.nrad] = vr_row[:, None]
        vr_full[geom.nrad] = vr_row[geom.nrad - 1]
        return vr_full, vaz
    vaz_row = dm.v_az_smoothed(phys, constants, rb, M, quad_moment) \
        - phys.omega_frame * rb
    vaz = np.broadcast_to(vaz_row[:, None], (geom.nrad, geom.naz)).copy()
    vr_full = np.zeros((geom.nrad + 1, geom.naz))
    if not phys.initialize_vradial_zero:
        # the numerical drift of the initial profile, cutoffs included
        # (src/init.cpp:1766 get_vr_with_numerical_viscous_speed)
        vr_row = dm.vr_numerical_viscous(phys, constants, ri, M,
                                         quad_moment)
        if phys.imposed_disk_drift != 0.0:
            sigma_inf = phys.sigma0 * ri ** (-phys.sigma_slope)
            vr_row = vr_row + phys.imposed_disk_drift * phys.sigma0 \
                / sigma_inf / ri
        vr_full[:geom.nrad] = vr_row[:, None]
        vr_full[geom.nrad] = vr_row[geom.nrad - 1]
    return vr_full, vaz


SPREADING_RING_R0 = 1.0
SPREADING_RING_TAU0 = 0.016










_GRAD2 = np.array([[1, 1], [-1, 1], [1, -1], [-1, -1],
                   [1, 0], [-1, 0], [0, 1], [0, -1]], np.float64)


























def build_initial_state(phys: Physics, constants: Constants, geom: Geometry,
                        *, dtype: torch.dtype, device: torch.device | str
                        ) -> tuple[FieldState, Physics]:
    """The initial fields (reference src/init.cpp:255-341 ``init_physics``)
    of the power-law disk, and the Physics."""
    sigma = powerlaw_sigma(phys, geom)
    energy = powerlaw_energy(phys, constants, geom, sigma) \
        if phys.is_adiabatic else np.zeros_like(sigma)
    vrad, vaz = gas_velocities(phys, constants, geom, 0.0)
    return _to_state(sigma, vrad, vaz, energy, dtype, device), phys


def _to_state(sigma, vrad, vaz, energy, dtype, device) -> FieldState:
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return FieldState(sigma=t(sigma), vrad=t(vrad), vaz=t(vaz),
                      energy=t(energy))
