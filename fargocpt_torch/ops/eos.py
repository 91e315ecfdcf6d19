"""Equation of state and derived thermodynamic quantities for the ideal-gas,
polytropic and locally isothermal disks (reference
src/SourceEuler.cpp:1054-1505).

AspectRatioMode 0 takes the axisymmetric forms, mode 1 the sums over the
bodies and mode 2 the distance from the bodies' centre of mass (the
``*_nbody`` and ``*_com`` functions; the bodies are float64 tensors, the
results the field type). Under the PVTE equation of state the callers
pass ``pvte_vals``, the (gamma_eff, mu, gamma1) grids of a PVTE refresh
(``ops/pvte.py``); without them gamma and mu are the configured
constants.
"""

from __future__ import annotations

import math

import torch

from ..params import Physics
from .common import Geom


def sound_speed_iso_profile(phys: Physics, constants,
                            rb: torch.Tensor) -> torch.Tensor:
    """Locally-isothermal cs(r) = h0 r^F vK(r)
    (reference src/SourceEuler.cpp:1080-1088). ``rb`` is (NR,1)."""
    vk = torch.sqrt(constants.G * phys.hydro_center_mass / rb)
    h = phys.aspectratio_ref * rb ** phys.flaring_index
    return h * vk


def gamma_eff(phys: Physics):
    """The constant adiabatic index; PVTE runs pass ``pvte_vals``."""
    return phys.adiabatic_index


def mu_eff(phys: Physics):
    """The constant mean molecular weight; PVTE runs pass ``pvte_vals``."""
    return phys.mu


def sound_speed(phys: Physics, constants, g: Geom, sigma, energy,
                cs_iso: torch.Tensor | None, pvte_vals=None):
    """Adiabatic cs = sqrt(gamma1 (gamma_eff - 1) E / Sigma)
    (reference src/SourceEuler.cpp:1063-1072), gamma1 = gamma_eff without
    PVTE; polytropic: sqrt(gamma R T / mu) of the polytropic temperature;
    locally isothermal: the static profile."""
    if phys.is_adiabatic:
        if pvte_vals is not None:
            gam, _, g1 = pvte_vals
        else:
            gam = g1 = gamma_eff(phys)
        return torch.sqrt(g1 * (gam - 1.0) * energy / sigma)
    if phys.is_polytropic:
        temp = temperature(phys, constants, sigma, energy, None)
        return torch.sqrt(gamma_eff(phys) * constants.R / phys.mu * temp)
    return cs_iso.expand_as(sigma)


def pressure(phys: Physics, constants, sigma, energy, cs, pvte_vals=None):
    """reference src/SourceEuler.cpp:1442-1473."""
    if phys.is_adiabatic:
        if pvte_vals is not None:
            return (pvte_vals[0] - 1.0) * energy
        return (gamma_eff(phys) - 1.0) * energy
    if phys.is_polytropic:
        return sigma * cs ** 2 / phys.adiabatic_index
    return sigma * cs ** 2


def temperature(phys: Physics, constants, sigma, energy, press,
                pvte_vals=None):
    """reference src/SourceEuler.cpp:1475-1505."""
    if phys.is_adiabatic:
        if pvte_vals is not None:
            gam, mu, _ = pvte_vals
            return mu / constants.R * (gam - 1.0) * energy / sigma
        return phys.mu / constants.R * (gamma_eff(phys) - 1.0) * energy \
            / sigma
    if phys.is_polytropic:
        # T = mu / R K Sigma^(gamma - 1), the energy unused
        return phys.mu / constants.R * phys.polytropic_constant \
            * sigma ** (gamma_eff(phys) - 1.0)
    return phys.mu / constants.R * press / sigma


def scale_height(phys: Physics, constants, g: Geom, cs, pvte_vals=None):
    """AspectRatioMode 0: H = cs / (sqrt(gamma1) Omega_K) (adiabatic) or
    cs / Omega_K (reference src/SourceEuler.cpp:1218-1251)."""
    omega_k = torch.sqrt(constants.G * phys.hydro_center_mass / g.rb ** 3)
    if phys.is_adiabatic or phys.is_polytropic:
        if pvte_vals is not None:
            return cs / torch.sqrt(pvte_vals[2]) / omega_k
        return cs / math.sqrt(gamma_eff(phys)) / omega_k
    return cs / omega_k


def _min_dist_col(g: Geom):
    """Half the larger cell extent, the closest a body can be to the gas of
    a cell (reference src/SourceEuler.cpp:1113-1119)."""
    return 0.5 * torch.maximum(g.rsup - g.rinf, g.rb * g.dphi)


def _gamma1(phys: Physics, pvte_vals) -> float | torch.Tensor:
    """gamma1 of the ideal gas, 1 for the locally isothermal disk."""
    if phys.is_adiabatic or phys.is_polytropic:
        return pvte_vals[2] if pvte_vals is not None else gamma_eff(phys)
    return 1.0


def _body_distance(g: Geom, bodies, body_radius, k: int, cell_x, cell_y):
    """The cells' distance from body ``k``, at least the cell's half
    extent plus the body's radius."""
    return torch.maximum(
        torch.sqrt((cell_x - bodies.x[k]) ** 2 + (cell_y - bodies.y[k]) ** 2),
        _min_dist_col(g) + body_radius[k])


def center_of_mass(bodies):
    """(x, y, mass) of the bodies' centre of mass, 0-d tensors."""
    m = torch.sum(bodies.mass)
    return (torch.sum(bodies.mass * bodies.x) / m,
            torch.sum(bodies.mass * bodies.y) / m, m)


def sound_speed_iso_nbody(phys: Physics, constants, g: Geom, bodies,
                          n_bodies: int, body_radius, cell_x, cell_y):
    """AspectRatioMode 1: Cs^2 = sum_k h0^2 dist^2F G m_k / dist over all
    bodies (reference src/SourceEuler.cpp:1136-1195
    ``compute_iso_sound_speed_nbody``)."""
    cs2 = torch.zeros_like(cell_x)
    h0 = phys.aspectratio_ref
    for k in range(n_bodies):
        dist = _body_distance(g, bodies, body_radius, k, cell_x, cell_y)
        cs2 = cs2 + h0 * h0 * dist ** (2.0 * phys.flaring_index) \
            * constants.G * bodies.mass[k] / dist
    return torch.sqrt(cs2)


def sound_speed_iso_com(phys: Physics, constants, g: Geom, com_x, com_y,
                        com_mass, cell_x, cell_y):
    """AspectRatioMode 2: Cs from the distance to the bodies' centre of
    mass (reference src/SourceEuler.cpp:1094-1134)."""
    dist = torch.maximum(
        torch.sqrt((cell_x - com_x) ** 2 + (cell_y - com_y) ** 2),
        _min_dist_col(g))
    return phys.aspectratio_ref * dist ** phys.flaring_index \
        * torch.sqrt(constants.G * com_mass / dist)


def scale_height_nbody(phys: Physics, constants, g: Geom, cs, bodies,
                       n_bodies: int, body_radius, cell_x, cell_y,
                       pvte_vals=None):
    """AspectRatioMode 1: 1/H^2 = sum_k G m_k gamma1 / (dist^3 cs^2)
    (Thun et al. 2017 eq. 8; reference src/SourceEuler.cpp:1255-1345
    ``compute_scale_height_nbody``)."""
    g1 = _gamma1(phys, pvte_vals)
    cs2 = cs * cs
    inv_h2 = torch.zeros_like(cs)
    for k in range(n_bodies):
        dist = _body_distance(g, bodies, body_radius, k, cell_x, cell_y)
        inv_h2 = inv_h2 + constants.G * bodies.mass[k] * g1 \
            / (dist ** 3 * cs2)
    return 1.0 / torch.sqrt(inv_h2)


def aspect_ratio_nbody(phys: Physics, constants, g: Geom, cs, bodies,
                       n_bodies: int, body_radius, cell_x, cell_y,
                       pvte_vals=None):
    """The AspectRatioMode-1 ASPECTRATIO grid (reference
    src/SourceEuler.cpp:1316-1341), h = sqrt(1 / sum_k G m_k gamma1 /
    (dist cs^2)): not H/r. The irradiation's H/R factor reads it."""
    g1 = _gamma1(phys, pvte_vals)
    cs2 = cs * cs
    inv_h2 = torch.zeros_like(cs)
    for k in range(n_bodies):
        dist = _body_distance(g, bodies, body_radius, k, cell_x, cell_y)
        inv_h2 = inv_h2 + constants.G * bodies.mass[k] * g1 / (dist * cs2)
    return 1.0 / torch.sqrt(inv_h2)


def aspect_ratio_com(phys: Physics, constants, g: Geom, cs, com_x, com_y,
                     com_mass, cell_x, cell_y, pvte_vals=None):
    """The AspectRatioMode-2 ASPECTRATIO grid (reference
    src/SourceEuler.cpp:1380-1396), h = cs sqrt(dist / (G M gamma1)) at
    the distance from the centre of mass (H / dist, not H / r)."""
    g1 = _gamma1(phys, pvte_vals)
    dist = torch.sqrt((cell_x - com_x) ** 2 + (cell_y - com_y) ** 2)
    return cs * torch.sqrt(dist / (constants.G * com_mass * g1))


def scale_height_com(phys: Physics, constants, g: Geom, cs, com_x, com_y,
                     com_mass, cell_x, cell_y, pvte_vals=None):
    """AspectRatioMode 2: H = dist cs sqrt(dist / (G M gamma1))
    (reference src/SourceEuler.cpp:1346-1399)."""
    return torch.sqrt((cell_x - com_x) ** 2 + (cell_y - com_y) ** 2) \
        * aspect_ratio_com(phys, constants, g, cs, com_x, com_y, com_mass,
                           cell_x, cell_y, pvte_vals)


def adjust_scale_height_for_sg(h, toomre_q):
    """The self-gravitating vertical structure of the Bessel-kernel mode:
    H sqrt(2 / pi) f(Q), f(Q) = pi (sqrt(1 + 8 Q^2 / pi) - 1) / (4 Q)
    (reference src/SourceEuler.cpp:1400-1420)."""
    f = math.pi * (torch.sqrt(1.0 + 8.0 * toomre_q ** 2 / math.pi) - 1.0) \
        / (4.0 * toomre_q)
    return h * f * math.sqrt(2.0 / math.pi)


def finite_in(value: float, dtype: torch.dtype) -> float:
    """Clamp a Python scalar to the largest finite value of ``dtype``
    (MaximumTemperature defaults to a DBL_MAX-scale number)."""
    return min(float(value), float(torch.finfo(dtype).max))


def energy_floor_ceiling(phys: Physics, constants, sigma, energy,
                         pvte_vals=None):
    """Clamp energy to [E(Tmin), E(Tmax)]
    (reference src/SourceEuler.cpp:136-202 ``assure_temperature_range``)."""
    t_max = finite_in(phys.maximum_temperature, energy.dtype)
    if pvte_vals is not None:
        gam, mu, _ = pvte_vals
        factor = sigma / mu * constants.R / (gam - 1.0)
    else:
        factor = sigma / phys.mu * constants.R / (gamma_eff(phys) - 1.0)
    return torch.clamp(energy, phys.minimum_temperature * factor,
                       t_max * factor)


def sigma_floor_value(phys: Physics) -> float:
    return phys.sigma_floor * phys.sigma0


def apply_sigma_floor(phys: Physics, sigma):
    """reference src/SourceEuler.cpp:102-134."""
    return torch.clamp(sigma, min=sigma_floor_value(phys))

