"""Initial conditions of the power-law disk (reference src/init.cpp:
init_gas_density :937, init_gas_energy :1257, init_gas_velocities :1467).

Everything is built host-side in float64 numpy and cast to the run dtype on
the target device. Only the power-law branch of ``build_initial_state`` is
ported; the other initial-condition options raise.
"""

from __future__ import annotations

import numpy as np
import torch

from . import theo
from .constants import Constants
from .grid import Geometry
from .params import Physics
from .state import FieldState


def powerlaw_sigma(phys: Physics, geom: Geometry) -> np.ndarray:
    """Sigma = Sigma0 r^-slope with floor and optional profile cutoffs
    (reference src/init.cpp:937-1124)."""
    r = geom.rmed[:, None]
    sigma = phys.sigma0 * r ** (-phys.sigma_slope)
    if phys.profile_cutoff_outer:
        sigma = sigma * theo.cutoff_outer(phys.profile_cutoff_point_outer,
                                          phys.profile_cutoff_width_outer, r)
    if phys.profile_cutoff_inner:
        sigma = sigma * theo.cutoff_inner(phys.profile_cutoff_point_inner,
                                          phys.profile_cutoff_width_inner, r)
    sigma = np.maximum(sigma, phys.sigma_floor * phys.sigma0)
    return np.broadcast_to(sigma, (geom.nrad, geom.naz)).copy()


def powerlaw_energy(phys: Physics, constants: Constants,
                    geom: Geometry, sigma: np.ndarray) -> np.ndarray:
    """reference src/init.cpp:1257-1302 with the temperature floor and the
    profile-cutoff damping of the energy (init.cpp:1364-1443)."""
    r = geom.rmed[:, None]
    energy = theo.initial_energy(phys, constants.G, r, phys.hydro_center_mass)
    e_floor = phys.minimum_temperature * sigma / phys.mu * constants.R \
        / (phys.adiabatic_index - 1.0)
    energy = np.maximum(np.broadcast_to(energy, sigma.shape), e_floor)
    if phys.profile_cutoff_outer:
        fac = np.asarray(theo.cutoff_outer(phys.profile_cutoff_point_outer,
                                           phys.profile_cutoff_width_outer,
                                           r))
        energy = np.maximum(energy * fac, e_floor)
    if phys.profile_cutoff_inner:
        fac = np.asarray(theo.cutoff_inner(phys.profile_cutoff_point_inner,
                                           phys.profile_cutoff_width_inner,
                                           r))
        energy = np.maximum(energy * fac, e_floor)
    return energy


# --- analytic disk model of the initial radial drift (reference
# src/Theo.cpp:131-202, src/viscosity/viscous_radial_speed.cpp:39-199) ---

def _sigma_profile(phys: Physics, r):
    sig = phys.sigma0 * r ** (-phys.sigma_slope)
    if phys.profile_cutoff_outer:
        sig = sig * theo.cutoff_outer(phys.profile_cutoff_point_outer,
                                      phys.profile_cutoff_width_outer, r)
    if phys.profile_cutoff_inner:
        sig = sig * theo.cutoff_inner(phys.profile_cutoff_point_inner,
                                      phys.profile_cutoff_width_inner, r)
    return np.maximum(sig, phys.sigma_floor * phys.sigma0)


def _nu_of(phys: Physics, constants: Constants, r, mass, sigma):
    """Initial-profile viscosity with the temperature clamp
    (viscous_radial_speed.cpp:39-89 ``get_nu2``)."""
    vk = np.sqrt(constants.G * mass / r)
    h = phys.aspectratio_ref * r ** phys.flaring_index
    if phys.is_adiabatic:
        gam = phys.adiabatic_index
        cutoff = 1.0
        if phys.profile_cutoff_outer:
            cutoff = cutoff * theo.cutoff_outer(
                phys.profile_cutoff_point_outer,
                phys.profile_cutoff_width_outer, r)
        if phys.profile_cutoff_inner:
            cutoff = cutoff * theo.cutoff_inner(
                phys.profile_cutoff_point_inner,
                phys.profile_cutoff_width_inner, r)
        e = cutoff / (gam - 1.0) * sigma * (h * vk) ** 2
        efac = sigma / phys.mu * constants.R / (gam - 1.0)
        e = np.clip(e, phys.minimum_temperature * efac,
                    min(phys.maximum_temperature,
                        float(np.finfo(np.float64).max)) * efac)
        cs_adb = np.sqrt(gam * (gam - 1.0) * e / sigma)
        cs_iso = np.sqrt((gam - 1.0) * e / sigma)
        big_h = cs_iso * r / vk
    else:
        cs_adb = h * vk
        big_h = h * r
    return phys.viscous_alpha * cs_adb * big_h


def _derive(f, r, rel_h: float = 8.0e-4):
    """5-point finite difference df/dr with h = 8e-4 r
    (viscous_radial_speed.cpp:115-131)."""
    h = rel_h * r
    return (-f(r + 2.0 * h) + 8.0 * f(r + h)
            - 8.0 * f(r - h) + f(r - 2.0 * h)) / (12.0 * h)


def vr_numerical_viscous(phys: Physics, constants: Constants, r, mass):
    """Steady viscous-accretion drift on the initial profile
    (viscous_radial_speed.cpp:173-199):
    v_r = [1/r d/dr(nu Sigma r^3 dw/dr)] / [Sigma d(r^2 w)/dr]."""
    G = constants.G

    def w(rr):
        return theo.initial_locally_isothermal_smoothed_v_az(
            phys, G, rr, mass) / rr

    def nu_s_r3_dwdr(rr):
        sig = _sigma_profile(phys, rr)
        return _nu_of(phys, constants, rr, mass, sig) * sig * rr ** 3 \
            * _derive(w, rr)

    num = _derive(nu_s_r3_dwdr, r) / r
    den = _sigma_profile(phys, r) * _derive(lambda rr: rr ** 2 * w(rr), r)
    return num / den


def gas_velocities(phys: Physics, constants: Constants,
                   geom: Geometry) -> tuple[np.ndarray, np.ndarray]:
    """Axisymmetric velocity ICs (reference src/init.cpp:1467-1780,
    single-star primary-frame branch)."""
    G = constants.G
    M = phys.hydro_center_mass
    rb = geom.rmed
    ri = geom.rinf
    if phys.initialize_pure_keplerian:
        raise NotImplementedError("InitializePureKeplerian is not ported yet")
    vaz_row = theo.initial_locally_isothermal_smoothed_v_az(phys, G, rb, M)
    vaz_row = vaz_row - phys.omega_frame * rb
    vaz = np.broadcast_to(vaz_row[:, None], (geom.nrad, geom.naz)).copy()
    vr_full = np.zeros((geom.nrad + 1, geom.naz))
    if not phys.initialize_vradial_zero:
        vr_row = vr_numerical_viscous(phys, constants, ri, M)
        if phys.imposed_disk_drift != 0.0:
            sigma_inf = phys.sigma0 * ri ** (-phys.sigma_slope)
            vr_row = vr_row + phys.imposed_disk_drift * phys.sigma0 \
                / sigma_inf / ri
        vr_full[:geom.nrad] = vr_row[:, None]
        vr_full[geom.nrad] = vr_row[geom.nrad - 1]
    return vr_full, vaz


def build_initial_state(phys: Physics, constants: Constants, geom: Geometry,
                        *, dtype: torch.dtype,
                        device: torch.device | str) -> FieldState:
    """Power-law disk initial state (reference src/init.cpp:255-341)."""
    unsupported = {
        "ShockTube": phys.shock_tube != 0,
        "the spreading ring": phys.spreading_ring,
        "SigmaCondition other than the profile":
            phys.sigma_condition != "profile",
        "EnergyCondition other than the profile":
            phys.energy_condition != "profile",
        "SigmaRandomize": phys.sigma_randomize,
        "SetSigma0": phys.sigma_adjust,
        "the circumbinary ring": phys.cbd_ring,
        "the secondary disk": phys.secondary_disk,
        "CentrifugalBalance": phys.centrifugal_balance,
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet")
    sigma = powerlaw_sigma(phys, geom)
    energy = powerlaw_energy(phys, constants, geom, sigma)
    vrad, vaz = gas_velocities(phys, constants, geom)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return FieldState(sigma=t(sigma), vrad=t(vrad), vaz=t(vaz),
                      energy=t(energy))
