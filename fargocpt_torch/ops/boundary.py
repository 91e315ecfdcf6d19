"""Radial boundary conditions, the subset the flagship reaches: outflow
(zero-gradient scalars, one-way v_rad) with Keplerian v_az ghosts
(reference src/boundary_conditions/boundary_conditions.cpp:65-110,
outflow.cpp:16-35, keplerian_azimuthal.cpp:19-38).

Ghost rows: row 0 / NR-1 of the scalar fields, rows 0,1 / NR-1,NR of
v_rad (row 1 / NR-1 sit on the active boundary). Every function returns
new tensors and leaves its inputs untouched.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..params import Physics
from .common import Geom

SUPPORTED = {
    "sigma": ("zerogradient", "outflow"),
    "energy": ("zerogradient", "outflow"),
    "vrad": ("outflow",),
    "vaz": ("keplerian", "zerogradient"),
}


@dataclass(frozen=True)
class RefValues:
    """Initial-value snapshots (reference SIGMA0/ENERGY0/... grids)."""
    sigma0: torch.Tensor
    energy0: torch.Tensor
    vrad0: torch.Tensor
    vaz0: torch.Tensor


def check_supported(phys: Physics) -> None:
    names = {"sigma": (phys.bc_sigma_inner, phys.bc_sigma_outer),
             "energy": (phys.bc_energy_inner, phys.bc_energy_outer),
             "vrad": (phys.bc_vrad_inner, phys.bc_vrad_outer),
             "vaz": (phys.bc_vaz_inner, phys.bc_vaz_outer)}
    for var, pair in names.items():
        for edge, name in zip(("inner", "outer"), pair):
            if name not in SUPPORTED[var]:
                raise NotImplementedError(
                    f"{edge} {var} boundary {name!r} is not ported yet "
                    "(outflow only)")
    if phys.composite_inner not in ("outflow", "individual") \
            or phys.composite_outer not in ("outflow", "individual"):
        raise NotImplementedError(
            "only outflow boundaries are ported yet, got "
            f"{phys.composite_inner!r} / {phys.composite_outer!r}")


def _with_row(x, row: int, value):
    out = x.clone()
    out[row] = value
    return out


def _scalar(x):
    """Zero-gradient ghost rings (outflow's scalar rule)."""
    nr = x.shape[0]
    return torch.cat([x[1:2], x[1:nr - 1], x[nr - 2:nr - 1]], dim=0)


def _vrad_outflow(vr):
    """Inner ghost faces 0,1 take min(vr[2], 0); outer faces NR-1, NR take
    max(vr[NR-2], 0) (outflow.cpp:16-35)."""
    nv = vr.shape[0]
    lo = torch.clamp(vr[2:3], max=0.0)
    hi = torch.clamp(vr[nv - 3:nv - 2], min=0.0)
    return torch.cat([lo, lo, vr[2:nv - 2], hi, hi], dim=0)


def _vaz_edge(phys: Physics, constants, name: str, vaz, g: Geom,
              omega_frame, row: int, neighbour: int, factor: float):
    if name == "zerogradient":
        return _with_row(vaz, row, vaz[neighbour])
    r = float(g.rb[row, 0])
    vkep = math.sqrt(constants.G * phys.hydro_center_mass / r)
    val = factor * vkep - r * omega_frame.to(vaz.dtype)
    return _with_row(vaz, row, val)


def apply_boundary_conditions(phys: Physics, constants, g: Geom,
                              sigma, vrad, vaz, energy,
                              omega_frame: torch.Tensor):
    """Per-variable, per-edge dispatch of the outflow boundary."""
    nr = g.nrad
    sigma = _scalar(sigma)
    energy = _scalar(energy)
    vrad = _vrad_outflow(vrad)
    vaz = _vaz_edge(phys, constants, phys.bc_vaz_inner, vaz, g, omega_frame,
                    0, 1, phys.keplerian_azimuthal_inner_factor)
    vaz = _vaz_edge(phys, constants, phys.bc_vaz_outer, vaz, g, omega_frame,
                    nr - 1, nr - 2, phys.keplerian_azimuthal_outer_factor)
    return sigma, vrad, vaz, energy
