"""Analytic disk-model profiles (reference src/Theo.cpp and
src/viscosity/viscous_radial_speed.cpp; the JAX package's
``fargocpt_tpu/ops/diskmodel.py``).

Sigma, energy, v_az and v_r as closed-form functions of the radius around
a central mass. They serve the initial conditions (host-side, float64
tensors on the CPU) and the ``centerofmass`` boundary (on the run device,
each ghost cell at its distance from the bodies' centre of mass). Every
function is elementwise math on the radii: numpy arrays on the host for
the initial conditions, which keeps their values those of the JAX
package's host-side construction, or tensors on the run device for the
boundary. A mass may be a float or a 0-d tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..params import Physics
from .eos import finite_in


def _exp(x):
    return torch.exp(x) if torch.is_tensor(x) else np.exp(x)


def _sqrt(x):
    return torch.sqrt(x) if torch.is_tensor(x) else np.sqrt(x)


def _clamp(x, lo, hi=None):
    """x clamped to [lo, hi] (hi optional); the bounds are floats or
    arrays like ``x``."""
    if torch.is_tensor(x):
        return torch.clamp(x, lo, hi)
    return np.maximum(x, lo) if hi is None else np.clip(x, lo, hi)


def cutoff_outer(point, width, x):
    """reference src/util.cpp:69-81."""
    return 1.0 / (1.0 + _exp((x - point) / width))


def cutoff_inner(point, width, x):
    """reference src/util.cpp:90-93."""
    return 1.0 / (1.0 + _exp((point - x) / width))


def binary_quadrupole_moment(bodies_cfg, n_hydroframe: int) -> float:
    """Static quadrupole moment of a central binary (reference
    src/Theo.cpp:58-78 ``init_binary_quadropole_moment``); 0 unless the
    hydro frame is centred on two bodies."""
    if n_hydroframe != 2 or len(bodies_cfg) < 2:
        return 0.0
    a_b = bodies_cfg[1].semi_major_axis
    m1, m2 = bodies_cfg[0].mass, bodies_cfg[1].mass
    q_b = m2 / m1 if m2 < m1 else m1 / m2
    e_b = bodies_cfg[1].eccentricity
    return a_b ** 2 / 4.0 * q_b / (1.0 + q_b) ** 2 * (1.0 + 1.5 * e_b ** 2)


def sigma_profile(phys: Physics, r):
    """Sigma0 r^-slope with the optional cutoffs and the floor (reference
    src/viscosity/viscous_radial_speed.cpp:91-113)."""
    sig = phys.sigma0 * r ** (-phys.sigma_slope)
    if phys.profile_cutoff_outer:
        sig = sig * cutoff_outer(phys.profile_cutoff_point_outer,
                                 phys.profile_cutoff_width_outer, r)
    if phys.profile_cutoff_inner:
        sig = sig * cutoff_inner(phys.profile_cutoff_point_inner,
                                 phys.profile_cutoff_width_inner, r)
    return _clamp(sig, phys.sigma_floor * phys.sigma0)


def initial_energy(phys: Physics, constants, r, mass):
    """E = Sigma cs_iso^2 / (gamma - 1) of the locally isothermal profile
    (reference src/Theo.cpp:86-100)."""
    h0 = phys.aspectratio_ref
    return (1.0 / (phys.adiabatic_index - 1.0) * phys.sigma0 * h0 ** 2
            * r ** (-phys.sigma_slope - 1.0 + 2.0 * phys.flaring_index)
            * constants.G * mass)


def support_azi_pressure(phys: Physics, r):
    """reference src/Theo.cpp:131-139."""
    h = phys.aspectratio_ref * r ** phys.flaring_index
    return (2.0 * phys.flaring_index - 1.0 - phys.sigma_slope) * h ** 2


def support_azi_smoothing_derivative(phys: Physics, r):
    """reference src/Theo.cpp:141-149."""
    f = phys.flaring_index
    h = phys.aspectratio_ref * r ** f
    he2 = (h * phys.thickness_smoothing) ** 2
    return (1.0 + (f + 1.0) * he2) / _sqrt(1.0 + he2) ** 3


def support_azi_quadrupole(quad_moment: float, r):
    """reference src/Theo.cpp:150-158."""
    if quad_moment <= 0.0:
        return 0.0
    return 3.0 * quad_moment / r ** 2


def v_kepler(constants, r, mass):
    return _sqrt(constants.G * mass / r)


def v_az_smoothed(phys: Physics, constants, r, mass, quad_moment=0.0):
    """The pressure-supported, smoothing-corrected azimuthal velocity, with
    the optional binary quadrupole support (reference
    src/Theo.cpp:166-202)."""
    support = support_azi_smoothing_derivative(phys, r) \
        + support_azi_pressure(phys, r) \
        + support_azi_quadrupole(quad_moment, r)
    return _sqrt(constants.G * mass / r * support)


def viscous_radial_speed_analytic(phys: Physics, constants, r, mass):
    """The steady-accretion v_r = -3 nu / r (1 - slope + 2F) (reference
    src/Theo.cpp:220-244 ``initial_viscous_radial_speed``)."""
    if phys.viscous_alpha > 0:
        sqrt_gamma = math.sqrt(phys.adiabatic_index) \
            if phys.is_adiabatic else 1.0
        vk = v_kepler(constants, r, mass)
        h = phys.aspectratio_ref * r ** phys.flaring_index
        nu = phys.viscous_alpha * (sqrt_gamma * h * vk) * (h * r)
        return -3.0 * nu / r * (-phys.sigma_slope
                                + 2.0 * phys.flaring_index + 1.0)
    nu = phys.constant_viscosity
    return -3.0 * nu / r * (-phys.sigma_slope + 0.5)


def _nu_of(phys: Physics, constants, r, mass, sigma):
    """The initial profile's viscosity with the temperature floor and
    ceiling (reference src/viscosity/viscous_radial_speed.cpp:39-89
    ``get_nu2``)."""
    vk = v_kepler(constants, r, mass)
    h = phys.aspectratio_ref * r ** phys.flaring_index
    if phys.is_adiabatic:
        gam = phys.adiabatic_index
        cutoff = 1.0
        if phys.profile_cutoff_outer:
            cutoff = cutoff * cutoff_outer(phys.profile_cutoff_point_outer,
                                           phys.profile_cutoff_width_outer,
                                           r)
        if phys.profile_cutoff_inner:
            cutoff = cutoff * cutoff_inner(phys.profile_cutoff_point_inner,
                                           phys.profile_cutoff_width_inner,
                                           r)
        e = cutoff / (gam - 1.0) * sigma * (h * vk) ** 2
        efac = sigma / phys.mu * constants.R / (gam - 1.0)
        t_max = finite_in(phys.maximum_temperature, e.dtype) \
            if torch.is_tensor(e) \
            else min(phys.maximum_temperature, float(np.finfo(e.dtype).max))
        e = _clamp(e, phys.minimum_temperature * efac, t_max * efac)
        cs_adb = _sqrt(gam * (gam - 1.0) * e / sigma)
        cs_iso = _sqrt((gam - 1.0) * e / sigma)
        big_h = cs_iso * r / vk
    else:
        cs_adb = h * vk
        big_h = h * r
    return phys.viscous_alpha * cs_adb * big_h


def _derive(f, r, rel_h: float = 8.0e-4):
    """The 5-point finite difference df/dr with h = 8e-4 r (reference
    src/viscosity/viscous_radial_speed.cpp:115-131)."""
    h = rel_h * r
    return (-f(r + 2.0 * h) + 8.0 * f(r + h)
            - 8.0 * f(r - h) + f(r - 2.0 * h)) / (12.0 * h)


def vr_numerical_viscous(phys: Physics, constants, r, mass,
                         quad_moment=0.0):
    """v_r of the steady viscous accretion balance on the initial profile,
    v_r = [1/r d/dr(nu Sigma r^3 dw/dr)] / [Sigma d(r^2 w)/dr] (reference
    src/viscosity/viscous_radial_speed.cpp:173-199
    ``get_vr_with_numerical_viscous_speed``)."""
    def w(rr):
        return v_az_smoothed(phys, constants, rr, mass, quad_moment) / rr

    def nu_s_r3_dwdr(rr):
        return _nu_of(phys, constants, rr, mass, sigma_profile(phys, rr)) \
            * sigma_profile(phys, rr) * rr ** 3 * _derive(w, rr)

    num = _derive(nu_s_r3_dwdr, r) / r
    den = sigma_profile(phys, r) * _derive(lambda rr: rr ** 2 * w(rr), r)
    return num / den


def vr_outer_grid_correction(phys: Physics, constants, g, r, mass,
                             quad_moment=0.0):
    """The grid correction of the outer centre-of-mass boundary's drift
    (reference src/viscosity/viscous_radial_speed.cpp:207-253
    ``get_vr_outer_viscous_speed_correction_factor``): the steady-drift
    formula on the radial grid's stencil at the ring holding ``r``
    (Rmed[i] <= r < Rmed[i+1], i clamped to [2, NR-1]), over the smooth
    model's drift at that ring's lower interface. ``g`` is the ``Geom``;
    the ring is found on the device (``torch.searchsorted``)."""
    rmed = g.rmed_ext[:, 0]                       # (NR+1,)
    radii = g.ra[:, 0]                            # (NR+1,), the Rinf rows
    nr = torch.clamp(torch.searchsorted(rmed, r.contiguous(), right=True)
                     - 1, 2, rmed.shape[0] - 2)
    rinf = radii[nr]
    r_p, r_0, r_m, r_m2 = rmed[nr + 1], rmed[nr], rmed[nr - 1], rmed[nr - 2]

    def w(rr):
        return v_az_smoothed(phys, constants, rr, mass, quad_moment) / rr

    w_p, w_0, w_m, w_m2 = w(r_p), w(r_0), w(r_m), w(r_m2)
    dw_dr = (0.5 * (w_p + w_0) - 0.5 * (w_0 + w_m)) \
        / (radii[nr + 1] - radii[nr])
    dw_dr_m = (0.5 * (w_0 + w_m) - 0.5 * (w_m + w_m2)) \
        / (radii[nr] - radii[nr - 1])
    sig = sigma_profile(phys, r_0)
    nu = _nu_of(phys, constants, r_0, mass, sig)
    sig_m = sigma_profile(phys, r_m)
    nu_m = _nu_of(phys, constants, r_m, mass, sig_m)
    num = (nu * sig * r_0 ** 3 * dw_dr
           - nu_m * sig_m * r_m ** 3 * dw_dr_m) / (r_0 - r_m) / rinf
    den = sig_m * (r_0 ** 2 * w_0 - r_m ** 2 * w_m) / (r_0 - r_m)
    vr_grid = num / den
    vr_smooth = vr_numerical_viscous(phys, constants, rinf, mass,
                                     quad_moment)
    return vr_grid / vr_smooth
