"""Equation of state and derived thermodynamic quantities for the ideal-gas
and locally isothermal disks (reference src/SourceEuler.cpp:1054-1505).

Only the constant-gamma, AspectRatioMode-0 forms are ported; the PVTE and
N-body aspect-ratio variants of ``fargocpt_tpu.ops.eos`` come later.
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


def sound_speed(phys: Physics, constants, g: Geom, sigma, energy,
                cs_iso: torch.Tensor | None):
    """Adiabatic cs = sqrt(gamma (gamma - 1) E / Sigma)
    (reference src/SourceEuler.cpp:1063-1072); locally isothermal: the
    static profile."""
    if phys.is_adiabatic:
        gam = phys.adiabatic_index
        return torch.sqrt(gam * (gam - 1.0) * energy / sigma)
    if phys.is_polytropic:
        raise NotImplementedError("polytropic EoS is not ported yet")
    return cs_iso.expand_as(sigma)


def pressure(phys: Physics, constants, sigma, energy, cs):
    """reference src/SourceEuler.cpp:1442-1473."""
    if phys.is_adiabatic:
        return (phys.adiabatic_index - 1.0) * energy
    if phys.is_polytropic:
        raise NotImplementedError("polytropic EoS is not ported yet")
    return sigma * cs ** 2


def scale_height(phys: Physics, constants, g: Geom, cs):
    """AspectRatioMode 0: H = cs / (sqrt(gamma) Omega_K) (adiabatic) or
    cs / Omega_K (reference src/SourceEuler.cpp:1218-1251)."""
    omega_k = torch.sqrt(constants.G * phys.hydro_center_mass / g.rb ** 3)
    if phys.is_adiabatic or phys.is_polytropic:
        return cs / math.sqrt(phys.adiabatic_index) / omega_k
    return cs / omega_k


def finite_in(value: float, dtype: torch.dtype) -> float:
    """Clamp a Python scalar to the largest finite value of ``dtype``
    (MaximumTemperature defaults to a DBL_MAX-scale number)."""
    return min(float(value), float(torch.finfo(dtype).max))


def energy_floor_ceiling(phys: Physics, constants, sigma, energy):
    """Clamp energy to [E(Tmin), E(Tmax)]
    (reference src/SourceEuler.cpp:136-202 ``assure_temperature_range``)."""
    t_max = finite_in(phys.maximum_temperature, energy.dtype)
    factor = sigma / phys.mu * constants.R / (phys.adiabatic_index - 1.0)
    return torch.clamp(energy, phys.minimum_temperature * factor,
                       t_max * factor)


def sigma_floor_value(phys: Physics) -> float:
    return phys.sigma_floor * phys.sigma0


def apply_sigma_floor(phys: Physics, sigma):
    """reference src/SourceEuler.cpp:102-134."""
    return torch.clamp(sigma, min=sigma_floor_value(phys))

