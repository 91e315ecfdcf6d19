"""Initial conditions (reference src/init.cpp): the power-law disk
(init_gas_density :937, init_gas_energy :1257, init_gas_velocities
:1467), the spreading-ring test (:346-415), the Sod shock tube with the
ideal gas (:425-443), the pure Keplerian start, the disk-mass
renormalisation ``SetSigma0`` (:1150-1188), the 1-d / 2-d profile files of
``SigmaCondition`` / ``EnergyCondition``, the N-body-centred conditions
(``nbody``), the circumbinary ring and the binary quadrupole support of
v_az.

Everything is built host-side in float64 numpy and cast to the run dtype on
the target device. ``SigmaRandomize``, the secondary disk,
``CentrifugalBalance`` and the PVTE shock tube raise.
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


def _spreading_ring_profile(phys: Physics, x):
    """Speith & Kley 2003: Sigma(x) = M / (pi R0^2 tau0) x^-1/4
    I_{1/4}(2x / tau0) exp(-(1 + x^2) / tau0)."""
    from scipy.special import iv as bessel_iv
    tau0 = SPREADING_RING_TAU0
    return phys.sigma_diskmass / (np.pi * SPREADING_RING_R0 ** 2) \
        / (tau0 * x ** 0.25) * bessel_iv(0.25, 2.0 * x / tau0) \
        * np.exp(-(1.0 + x ** 2) / tau0)


def spreading_ring_sigma(phys: Physics, geom: Geometry) -> np.ndarray:
    """The viscously spreading ring (reference src/init.cpp:352-415),
    floored at SigmaFloor times its value in the cell holding R0
    (:361-380)."""
    r0 = SPREADING_RING_R0
    sigma = _spreading_ring_profile(phys, geom.rmed / r0)
    idx = np.nonzero((geom.rsup > r0) & (geom.rinf < r0))[0]
    r_peak = geom.rmed[idx[0]] if idx.size else geom.rmed[0]
    floor = _spreading_ring_profile(phys, r_peak / r0) * phys.sigma_floor
    sigma = np.maximum(sigma, floor)
    return np.broadcast_to(sigma[:, None], (geom.nrad, geom.naz)).copy()


def shock_tube_fields(geom: Geometry) -> tuple[np.ndarray, np.ndarray]:
    """Sod shock tube, ideal gas (reference src/init.cpp:425-443): left
    (Sigma, E) = (1, 2.5), right (0.125, 0.25), the jump half a unit above
    the innermost cell centre. Returns (sigma, energy)."""
    right = (geom.rmed - geom.rmed[0]) > 0.5
    sig = np.where(right, 0.125, 1.0)
    en = np.where(right, 2.0 * 0.125, 2.5)
    shape = (geom.nrad, geom.naz)
    return (np.broadcast_to(sig[:, None], shape).copy(),
            np.broadcast_to(en[:, None], shape).copy())


def renormalize_sigma(phys: Physics, geom: Geometry, sigma: np.ndarray,
                      energy: np.ndarray):
    """SetSigma0: rescale so the active rings hold DiskMass (reference
    src/init.cpp:1150-1188). Returns (sigma, energy, new_sigma0)."""
    surf = geom.surf[:, None]
    total = float(np.sum(sigma[1:-1] * surf[1:-1]))
    factor = phys.sigma_diskmass / total
    sigma = sigma * factor
    if phys.is_adiabatic:
        energy = energy * factor
    return sigma, energy, phys.sigma0 * factor


def read_1d_profile(path: str, radii: np.ndarray) -> np.ndarray:
    """A binary 1-d profile ([radius, value] rows, or the written [radius,
    avg, min, max]) cubic-splined onto ``radii`` (reference
    src/polargrid.cpp:360-470 ``read1D``)."""
    from scipy.interpolate import CubicSpline
    raw = np.fromfile(path, np.float64)
    raw = raw.reshape(-1, 4 if raw.size % 4 == 0 else 2)
    return CubicSpline(raw[:, 0], raw[:, 1])(radii)


def _read_condition(condition: str, path: str, geom: Geometry):
    """The 1d / 2d file of a Sigma/EnergyCondition; None for the profile."""
    if condition == "1d" and path:
        return np.broadcast_to(read_1d_profile(path, geom.rmed)[:, None],
                               (geom.nrad, geom.naz)).copy()
    if condition == "2d" and path:
        return np.fromfile(path, np.float64).reshape(geom.nrad, geom.naz)
    return None


def _com_distance(geom: Geometry, com_x: float, com_y: float,
                  radial: np.ndarray) -> np.ndarray:
    """Distance from the bodies' centre of mass of each (row radius, cell
    centre azimuth) position; ``radial`` holds one radius a row."""
    phi = geom.phi[None, :]
    x = radial[:, None] * np.cos(phi) - com_x
    y = radial[:, None] * np.sin(phi) - com_y
    return np.hypot(x, y)


def nbody_centered_sigma(phys: Physics, geom: Geometry, com_x: float,
                         com_y: float) -> np.ndarray:
    """The Sigma power law at the distance from the centre of mass
    (reference src/init.cpp:962-997): the profile samples the cell's inner
    interface radius Rinf times CenterProfileDensityCorrectionFactor, the
    profile cutoffs (:1063-1147) the cell centre's distance, the floor
    after each."""
    r_inf = _com_distance(geom, com_x, com_y, geom.rinf)
    floor = phys.sigma_floor * phys.sigma0
    sigma = np.maximum(
        phys.sigma0 * r_inf ** (-phys.sigma_slope)
        * phys.center_mass_density_correction_factor, floor)
    r_med = _com_distance(geom, com_x, com_y, geom.rmed)
    if phys.profile_cutoff_outer:
        sigma = np.maximum(sigma * dm.cutoff_outer(
            phys.profile_cutoff_point_outer,
            phys.profile_cutoff_width_outer, r_med), floor)
    if phys.profile_cutoff_inner:
        sigma = np.maximum(sigma * dm.cutoff_inner(
            phys.profile_cutoff_point_inner,
            phys.profile_cutoff_width_inner, r_med), floor)
    return sigma


def nbody_centered_energy(phys: Physics, constants: Constants,
                          geom: Geometry, com_x: float, com_y: float,
                          com_mass: float, sigma: np.ndarray) -> np.ndarray:
    """The energy profile of the bodies' total mass at the cell centre's
    distance from their centre of mass (reference src/init.cpp:1302-1348),
    floored at the temperature floor of ``sigma``, then damped by the
    cutoffs with the floor after each (:1363-1457)."""
    r_med = _com_distance(geom, com_x, com_y, geom.rmed)
    energy = dm.initial_energy(phys, constants, r_med, com_mass)
    e_floor = phys.minimum_temperature * sigma / phys.mu * constants.R \
        / (phys.adiabatic_index - 1.0)
    energy = np.maximum(energy, e_floor)
    if phys.profile_cutoff_outer:
        energy = np.maximum(energy * dm.cutoff_outer(
            phys.profile_cutoff_point_outer,
            phys.profile_cutoff_width_outer, r_med), e_floor)
    if phys.profile_cutoff_inner:
        energy = np.maximum(energy * dm.cutoff_inner(
            phys.profile_cutoff_point_inner,
            phys.profile_cutoff_width_inner, r_med), e_floor)
    return energy


def nbody_centered_velocities(phys: Physics, constants: Constants,
                              geom: Geometry, com: tuple, v_com: tuple,
                              com_mass: float, quad_moment: float,
                              dist_secondary: float):
    """Velocities around the bodies' centre of mass (reference
    src/init.cpp:1467-1608, the N-body-centred branch): each cell takes
    the rotation and drift of the total mass at its distance from the
    centre of mass, as a Cartesian vector in that frame, plus the centre
    of mass's velocity, projected on the grid's polar axes. The
    quadrupole-supported v_az holds only beyond twice the secondary's
    distance (:1514-1520). Returns (vrad, vaz)."""
    G = constants.G

    def model(radial_rows: np.ndarray, phi_row: np.ndarray):
        x = radial_rows[:, None] * np.cos(phi_row)[None, :] - com[0]
        y = radial_rows[:, None] * np.sin(phi_row)[None, :] - com[1]
        r_com = np.hypot(x, y)
        if phys.initialize_pure_keplerian:
            vazi0 = np.sqrt(G * com_mass / r_com)
            vr0 = dm.viscous_radial_speed_analytic(phys, constants, r_com,
                                                   com_mass)
        else:
            vazi0 = dm.v_az_smoothed(phys, constants, r_com, com_mass)
            if quad_moment > 0.0 and phys.vaz_quadrupole_support:
                vazi0 = np.where(r_com > 2.0 * dist_secondary,
                                 dm.v_az_smoothed(phys, constants, r_com,
                                                  com_mass, quad_moment),
                                 vazi0)
            vr0 = dm.vr_numerical_viscous(phys, constants, r_com, com_mass)
        if phys.initialize_vradial_zero:
            vr0 = np.zeros_like(r_com)
        vx = (vr0 * x - vazi0 * y) / r_com + v_com[0]
        vy = (vr0 * y + vazi0 * x) / r_com + v_com[1]
        return vx, vy

    # v_rad at the interface radii (row NR repeats Rinf[NR-1], reference
    # :1492-1496) and the cell centre's azimuth
    phi_c = geom.phi
    ra = np.concatenate([geom.rinf, [geom.rinf[-1]]])
    vx, vy = model(ra, phi_c)
    vrad = vx * np.cos(phi_c)[None, :] + vy * np.sin(phi_c)[None, :]
    # v_az at the cell centre radii and the azimuthal interfaces
    phi_i = phi_c - 0.5 * geom.dphi
    vx, vy = model(geom.rmed, phi_i)
    vaz = (vy * np.cos(phi_i)[None, :] - vx * np.sin(phi_i)[None, :]
           - phys.omega_frame * geom.rmed[:, None])
    return vrad, vaz


def add_gaussian_rings(phys: Physics, constants: Constants, geom: Geometry,
                       sigma: np.ndarray, energy: np.ndarray,
                       com=None, com_mass=None):
    """The circumbinary ring (reference src/init.cpp:889-958 +
    :1208-1256): an asymmetric Gaussian enhancement of Sigma and, with an
    energy equation, of the energy, of independent inner width and outer
    decay width and exponent, centred on ``com`` where given. Returns
    (sigma, energy)."""
    if com is not None:
        x, y = geom.cell_centers_xy()
        r = np.hypot(x - com[0], y - com[1])
        mass = com_mass
    else:
        r = np.broadcast_to(geom.rmed[:, None], sigma.shape)
        mass = phys.hydro_center_mass
    r_ring = phys.cbd_ring_position
    fac = phys.cbd_ring_enhancement_factor
    w_in = phys.cbd_ring_width
    w_out = phys.cbd_decay_width
    p_out = phys.cbd_decay_exponent
    bump = np.where(
        r < r_ring,
        np.exp(-((r_ring - r) ** 2) / (2.0 * w_in ** 2)),
        np.exp(-(np.maximum(r - r_ring, 0.0) ** p_out)
               / (2.0 * w_out ** 2)))
    sigma = sigma + phys.sigma0 * r ** (-phys.sigma_slope) * (fac - 1.0) \
        * bump
    if phys.is_adiabatic:
        energy = energy + dm.initial_energy(phys, constants, r, mass) \
            * (fac - 1.0) * bump
    return sigma, energy


def build_initial_state(phys: Physics, constants: Constants, geom: Geometry,
                        quad_moment: float = 0.0, nbody: dict | None = None,
                        *, dtype: torch.dtype, device: torch.device | str
                        ) -> tuple[FieldState, Physics]:
    """The initial fields (reference src/init.cpp:255-341 ``init_physics``)
    and the Physics, whose sigma0 ``SetSigma0`` renormalises.
    ``quad_moment`` is the binary quadrupole moment of the v_az support;
    ``nbody`` (the bodies' x, y, vx, vy and mass, float64 arrays) centres
    the ``nbody`` conditions and the circumbinary ring on the bodies'
    centre of mass."""
    unsupported = {
        "the PVTE shock tube (ShockTube 2)": phys.shock_tube == 2,
        "SigmaRandomize": phys.sigma_randomize,
        "the secondary disk": phys.secondary_disk,
        "CentrifugalBalance": phys.centrifugal_balance,
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet")
    com, com_mass = None, phys.hydro_center_mass
    if nbody is not None:
        m = np.asarray(nbody["mass"])
        com_mass = float(m.sum())
        com = (float((m * np.asarray(nbody["x"])).sum() / m.sum()),
               float((m * np.asarray(nbody["y"])).sum() / m.sum()))
    nbody_centred = phys.sigma_condition == "nbody" and com is not None
    if phys.shock_tube == 1:
        sigma, energy = shock_tube_fields(geom)
    else:
        if phys.spreading_ring:
            sigma = spreading_ring_sigma(phys, geom)
            energy = np.zeros_like(sigma)
        else:
            sigma = _read_condition(phys.sigma_condition,
                                    phys.sigma_filename, geom)
            if sigma is None:
                sigma = nbody_centered_sigma(phys, geom, *com) \
                    if nbody_centred else powerlaw_sigma(phys, geom)
            if not phys.is_adiabatic:
                energy = np.zeros_like(sigma)
            else:
                energy = _read_condition(phys.energy_condition,
                                         phys.energy_filename, geom)
                if energy is None and phys.energy_condition == "nbody" \
                        and com is not None:
                    energy = nbody_centered_energy(phys, constants, geom,
                                                   *com, com_mass, sigma)
                elif energy is None:
                    energy = powerlaw_energy(phys, constants, geom, sigma)
        if phys.sigma_adjust:
            sigma, energy, sigma0 = renormalize_sigma(phys, geom, sigma,
                                                      energy)
            phys = phys.with_(sigma0=sigma0)
        if phys.cbd_ring:
            sigma, energy = add_gaussian_rings(
                phys, constants, geom, sigma, energy,
                com if phys.sigma_condition == "nbody" else None, com_mass)
    if nbody_centred and phys.shock_tube != 1:
        # the reference's N-body-centred branch returns early, before the
        # centrifugal balance (src/init.cpp:1473-1609)
        m = np.asarray(nbody["mass"])
        v_com = (float((m * np.asarray(nbody["vx"])).sum() / m.sum()),
                 float((m * np.asarray(nbody["vy"])).sum() / m.sum()))
        dist_sec = float(np.hypot(nbody["x"][1] - nbody["x"][0],
                                  nbody["y"][1] - nbody["y"][0])) \
            if m.size > 1 else 0.0
        vrad, vaz = nbody_centered_velocities(phys, constants, geom, com,
                                              v_com, com_mass, quad_moment,
                                              dist_sec)
    else:
        # the standard path, the shock tube's too (src/init.cpp:330-331
        # runs init_gas_velocities unconditionally)
        vrad, vaz = gas_velocities(phys, constants, geom, quad_moment)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return FieldState(sigma=t(sigma), vrad=t(vrad), vaz=t(vaz),
                      energy=t(energy)), phys
