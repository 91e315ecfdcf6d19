"""Initial conditions (reference src/init.cpp): the power-law disk
(init_gas_density :937, init_gas_energy :1257, init_gas_velocities
:1467), the spreading-ring test (:346-415), the Sod shock tube with the
ideal gas (:425-443), the pure Keplerian start, the disk-mass
renormalisation ``SetSigma0`` (:1150-1188) and the 1-d / 2-d profile
files of ``SigmaCondition`` / ``EnergyCondition``.

Everything is built host-side in float64 numpy and cast to the run dtype on
the target device. The N-body-centred conditions, ``SigmaRandomize``, the
circumbinary ring, the secondary disk, ``CentrifugalBalance`` and the PVTE
shock tube raise.
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
        # the reference takes Rmed for the v_rad rows too
        # (src/init.cpp:1611-1632)
        vaz_row = np.sqrt(G * M / rb)
        vr_row = theo.initial_viscous_radial_speed(phys, G, rb, M)
        vaz = np.broadcast_to((vaz_row - phys.omega_frame * rb)[:, None],
                              (geom.nrad, geom.naz)).copy()
        vr_full = np.zeros((geom.nrad + 1, geom.naz))
        vr_full[:geom.nrad] = vr_row[:, None]
        vr_full[geom.nrad] = vr_row[geom.nrad - 1]
        return vr_full, vaz
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


def build_initial_state(phys: Physics, constants: Constants, geom: Geometry,
                        *, dtype: torch.dtype, device: torch.device | str
                        ) -> tuple[FieldState, Physics]:
    """The initial fields (reference src/init.cpp:255-341 ``init_physics``)
    and the Physics, whose sigma0 ``SetSigma0`` renormalises."""
    unsupported = {
        "the PVTE shock tube (ShockTube 2)": phys.shock_tube == 2,
        "SigmaCondition nbody (N-body-centred initial conditions)":
            phys.sigma_condition == "nbody",
        "EnergyCondition nbody (N-body-centred initial conditions)":
            phys.energy_condition == "nbody",
        "SigmaRandomize": phys.sigma_randomize,
        "the circumbinary ring": phys.cbd_ring,
        "the secondary disk": phys.secondary_disk,
        "CentrifugalBalance": phys.centrifugal_balance,
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet")
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
                sigma = powerlaw_sigma(phys, geom)
            if not phys.is_adiabatic:
                energy = np.zeros_like(sigma)
            else:
                energy = _read_condition(phys.energy_condition,
                                         phys.energy_filename, geom)
                if energy is None:
                    energy = powerlaw_energy(phys, constants, geom, sigma)
        if phys.sigma_adjust:
            sigma, energy, sigma0 = renormalize_sigma(phys, geom, sigma,
                                                      energy)
            phys = phys.with_(sigma0=sigma0)
    # the velocities take the standard path, the shock tube's too
    # (src/init.cpp:330-331 runs init_gas_velocities unconditionally)
    vrad, vaz = gas_velocities(phys, constants, geom)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return FieldState(sigma=t(sigma), vrad=t(vrad), vaz=t(vaz),
                      energy=t(energy)), phys
