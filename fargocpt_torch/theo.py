"""Analytic disk-model profiles used by ICs and boundary conditions.

Re-derivation of reference src/Theo.cpp and
src/viscosity/viscous_radial_speed.cpp (closed-form branch). All functions
are numpy-level (ICs are built host-side once).
"""

from __future__ import annotations

import numpy as np

from .params import Physics


def omega_kepler(r, GM):
    return np.sqrt(GM / r ** 3)


def v_kepler(r, GM):
    """reference src/Theo.cpp:207-211."""
    return np.sqrt(GM / r)


def initial_energy(phys: Physics, G: float, r, M):
    """Locally-isothermal energy profile (reference src/Theo.cpp:86-99):
    E = Sigma (h0 r^F v_K)^2 / (gamma - 1)."""
    h0 = phys.aspectratio_ref
    F = phys.flaring_index
    S = phys.sigma_slope
    return (1.0 / (phys.adiabatic_index - 1.0) * phys.sigma0 * h0 ** 2
            * r ** (-S - 1.0 + 2.0 * F) * G * M)


def support_azi_pressure(phys: Physics, r):
    """reference src/Theo.cpp:131-138."""
    h = phys.aspectratio_ref * r ** phys.flaring_index
    return (2.0 * phys.flaring_index - 1.0 - phys.sigma_slope) * h ** 2


def support_azi_smoothing_derivative(phys: Physics, r):
    """reference src/Theo.cpp:140-148."""
    h = phys.aspectratio_ref * r ** phys.flaring_index
    eps = phys.thickness_smoothing
    he2 = (h * eps) ** 2
    return (1.0 + (phys.flaring_index + 1.0) * he2) / np.sqrt(1.0 + he2) ** 3


def initial_locally_isothermal_smoothed_v_az(phys: Physics, G, r, M):
    """Pressure- and smoothing-supported azimuthal velocity
    (reference src/Theo.cpp:166-180)."""
    support = support_azi_smoothing_derivative(phys, r) \
        + support_azi_pressure(phys, r)
    vk2 = G * M / r
    return np.sqrt(vk2 * support)


def initial_viscous_radial_speed(phys: Physics, G, r, M):
    """Steady-state viscous drift speed (reference src/Theo.cpp:220-244)."""
    if phys.viscous_alpha > 0.0:
        sqrt_gamma = np.sqrt(phys.adiabatic_index) if phys.is_adiabatic else 1.0
        v_k = np.sqrt(G * M / r)
        h = phys.aspectratio_ref * r ** phys.flaring_index
        cs = sqrt_gamma * h * v_k
        H = h * r
        nu = phys.viscous_alpha * cs * H
        return -3.0 * nu / r * (-phys.sigma_slope
                                + 2.0 * phys.flaring_index + 1.0)
    nu = phys.constant_viscosity
    return -3.0 * nu / r * (-phys.sigma_slope + 0.5) * np.ones_like(r)


def cutoff_outer(point, width, r):
    """Smooth exponential outer cutoff (reference src/util.cpp)."""
    return 1.0 / (1.0 + np.exp((r - point) / width))


def cutoff_inner(point, width, r):
    return 1.0 / (1.0 + np.exp(-(r - point) / width))
