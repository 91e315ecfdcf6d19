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




def _gamma1(phys: Physics, pvte_vals) -> float | torch.Tensor:
    """gamma1 of the ideal gas, 1 for the locally isothermal disk."""
    if phys.is_adiabatic or phys.is_polytropic:
        return pvte_vals[2] if pvte_vals is not None else gamma_eff(phys)
    return 1.0




















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

