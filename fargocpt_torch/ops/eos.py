"""Equation of state and derived thermodynamic quantities for the ideal-gas
and locally isothermal disks (reference src/SourceEuler.cpp:1054-1505).

The AspectRatioMode-0 forms are ported. Under the PVTE equation of state
the callers pass ``pvte_vals``, the (gamma_eff, mu, gamma1) grids of a
PVTE refresh (``ops/pvte.py``); without them gamma and mu are the
configured constants. The N-body aspect-ratio variants of
``fargocpt_tpu.ops.eos`` are not ported yet.
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
    PVTE; locally isothermal: the static profile."""
    if phys.is_adiabatic:
        if pvte_vals is not None:
            gam, _, g1 = pvte_vals
        else:
            gam = g1 = gamma_eff(phys)
        return torch.sqrt(g1 * (gam - 1.0) * energy / sigma)
    if phys.is_polytropic:
        raise NotImplementedError("polytropic EoS is not ported yet")
    return cs_iso.expand_as(sigma)


def pressure(phys: Physics, constants, sigma, energy, cs, pvte_vals=None):
    """reference src/SourceEuler.cpp:1442-1473."""
    if phys.is_adiabatic:
        if pvte_vals is not None:
            return (pvte_vals[0] - 1.0) * energy
        return (gamma_eff(phys) - 1.0) * energy
    if phys.is_polytropic:
        raise NotImplementedError("polytropic EoS is not ported yet")
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
        raise NotImplementedError("polytropic EoS is not ported yet")
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

