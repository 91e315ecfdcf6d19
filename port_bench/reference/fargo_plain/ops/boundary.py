"""Radial boundary conditions, the per-variable, per-edge menu
(reference src/boundary_conditions/boundary_conditions.cpp:65-110 with the
dispatch of src/boundary_conditions/config.cpp; the JAX package's
``fargocpt_tpu/ops/boundary.py:37-253``):

* the scalars (sigma, energy): zerogradient, outflow, reflecting,
  reference, diskmodel and none;
* v_rad: zerogradient, outflow, reflecting, reference, keplerian, viscous
  and none;
* v_az: keplerian, zerogradient, reference, zeroshear, balanced and none.

The composite sides (``centerofmass``, ``custom``) and the Roche-lobe
overflow stream are not in this copy (``scope.py``).

Ghost rows: row 0 / NR-1 of the scalar fields, rows 0,1 / NR-1,NR of
v_rad (row 1 / NR-1 sit on the active boundary). Each field is rebuilt by
one ``torch.cat`` of its ghost rows and its interior; every function
returns new tensors and leaves its inputs untouched. The ghost values that
depend on the grid alone are Python floats from the host's radii, so a BC
reads nothing back from the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..params import Physics
from .common import Geom

SCALAR_BCS = ("zerogradient", "outflow", "reflecting", "reference",
              "diskmodel", "none")
VRAD_BCS = ("zerogradient", "outflow", "reflecting", "reference",
            "keplerian", "viscous", "none")
VAZ_BCS = ("keplerian", "zerogradient", "reference", "zeroshear",
           "balanced", "none")
SUPPORTED = {"sigma": SCALAR_BCS, "energy": SCALAR_BCS, "vrad": VRAD_BCS,
             "vaz": VAZ_BCS}


@dataclass(frozen=True)
class RefValues:
    """Initial-value snapshots (reference SIGMA0/ENERGY0/... grids), the
    targets of the reference BCs and of the damping zones."""
    sigma0: torch.Tensor
    energy0: torch.Tensor
    vrad0: torch.Tensor
    vaz0: torch.Tensor


def check_supported(phys: Physics) -> None:
    """Raise NotImplementedError for a boundary name outside the menu,
    naming it: the JAX package's boundaries raise for the same names
    (fargocpt_tpu/ops/boundary.py), so this refuses them up front."""
    names = {"sigma": (phys.bc_sigma_inner, phys.bc_sigma_outer),
             "energy": (phys.bc_energy_inner, phys.bc_energy_outer),
             "vrad": (phys.bc_vrad_inner, phys.bc_vrad_outer),
             "vaz": (phys.bc_vaz_inner, phys.bc_vaz_outer)}
    for var, pair in names.items():
        for edge, name in zip(("inner", "outer"), pair):
            if name not in SUPPORTED[var]:
                raise NotImplementedError(
                    f"{edge} {var} boundary {name!r} is not in the menu")


def _row(x, value):
    """One (1, NAZ) row of ``x``'s type holding ``value``: a float or a
    0-d tensor (then a broadcast view, no launch)."""
    if torch.is_tensor(value):
        return value.to(x.dtype).reshape(1, 1).expand(1, x.shape[1])
    return torch.full((1, x.shape[1]), value, dtype=x.dtype,
                      device=x.device)


def _host(g: Geom, name: str, row: int) -> float:
    return float(g.host[name][row])


# ----- scalar BCs ------------------------------------------------------------

def _diskmodel_value(phys: Physics, var: str, r: float) -> float:
    """Analytic-profile ghost values (reference
    src/boundary_conditions/diskmodel.cpp:18-31 calc_sig/calc_eng, which
    omit the G*M factor of the initial energy)."""
    if var == "sigma":
        return phys.sigma0 * r ** (-phys.sigma_slope)
    return (1.0 / (phys.adiabatic_index - 1.0) * phys.sigma0
            * phys.aspectratio_ref ** 2
            * r ** (-phys.sigma_slope - 1.0 + 2.0 * phys.flaring_index))


def _scalar_ghost(name: str, x, x0, g: Geom, phys: Physics, var: str,
                  outer: bool):
    row = x.shape[0] - 1 if outer else 0
    inside = row - 1 if outer else 1
    if name in ("zerogradient", "outflow", "reflecting"):
        return x[inside:inside + 1]
    if name == "reference":
        return x0[row:row + 1]
    if name == "diskmodel":
        return _row(x, _diskmodel_value(phys, var, _host(g, "rmed", row)))
    if name == "none":
        return x[row:row + 1]
    raise NotImplementedError(f"scalar {'outer' if outer else 'inner'} BC "
                              f"{name!r}")


def _scalar(names, x, x0, g: Geom, phys: Physics, var: str):
    nr = x.shape[0]
    return torch.cat([_scalar_ghost(names[0], x, x0, g, phys, var, False),
                      x[1:nr - 1],
                      _scalar_ghost(names[1], x, x0, g, phys, var, True)],
                     dim=0)


# ----- v_rad BCs -------------------------------------------------------------

def _vrad_ghosts(name: str, vr, vr0, g: Geom, phys: Physics, gm: float,
                 nu, outer: bool):
    """The two ghost faces of one edge, in row order: faces 0, 1 (inner;
    face 1 on the boundary) or NR-1, NR (outer; face NR-1 on it)."""
    nv = vr.shape[0]                   # NR + 1
    irad = nv - 1
    # the edge face, the face beyond it, the interior face they copy
    edge, ghost, src = (irad - 1, irad, irad - 2) if outer else (1, 0, 2)
    if name == "zerogradient":
        rows = (vr[src:src + 1],) * 2
    elif name == "outflow":
        # reference src/boundary_conditions/outflow.cpp:16-35
        v = vr[src:src + 1]
        v = torch.clamp(v, min=0.0) if outer else torch.clamp(v, max=0.0)
        rows = (v, v)
    elif name == "reflecting":
        rows = {ghost: -vr[src:src + 1], edge: torch.zeros_like(vr[:1])}
        rows = (rows[min(edge, ghost)], rows[max(edge, ghost)])
    elif name == "reference":
        lo = irad - 1 if outer else 0
        rows = (vr0[lo:lo + 2],)
    elif name == "keplerian":
        # reference src/boundary_conditions/keplerian_radial.cpp:18-63
        factor = phys.keplerian_radial_outer_factor if outer \
            else phys.keplerian_radial_inner_factor
        lo = irad - 1 if outer else 0
        rows = tuple(_row(vr, factor * math.sqrt(
            gm / _host(g, "rmed_ext", lo + k))) for k in range(2))
    elif name == "viscous":
        # the steady viscous drift at the edge (reference
        # src/boundary_conditions/viscous.cpp:12-48)
        if nu is None:
            raise ValueError("the viscous BC needs the viscosity grid")
        nu_edge = 0.5 * (nu[-1:] + nu[-2:-1]) if outer \
            else 0.5 * (nu[0:1] + nu[1:2])
        lo = irad - 1 if outer else 0
        vos = phys.viscous_outflow_speed
        rows = tuple(-1.5 * vos / _host(g, "ra", lo + k) * nu_edge
                     for k in range(2))
    elif name == "none":
        lo = irad - 1 if outer else 0
        rows = (vr[lo:lo + 2],)
    else:
        raise NotImplementedError(f"vrad {'outer' if outer else 'inner'} "
                                  f"BC {name!r}")
    return list(rows)


def _vrad(vr, vr0, g: Geom, phys: Physics, gm: float, nu):
    nv = vr.shape[0]
    inner = _vrad_ghosts(phys.bc_vrad_inner, vr, vr0, g, phys, gm, nu, False)
    outer = _vrad_ghosts(phys.bc_vrad_outer, vr, vr0, g, phys, gm, nu, True)
    return torch.cat([*inner, vr[2:nv - 2], *outer], dim=0)


# ----- v_az BCs --------------------------------------------------------------

def _balanced_value(phys: Physics, constants, r: float, omega_frame):
    """Pressure-gradient / smoothing-balanced equilibrium v_az at a ghost
    ring (reference src/boundary_conditions/balanced.cpp:23-75, Baruteau
    2008)."""
    vk2 = constants.G * phys.hydro_center_mass / r
    support = 0.0
    if not phys.profile_cutoff_outer:
        h = phys.aspectratio_ref * r ** phys.flaring_index
        support = support + (2.0 * phys.flaring_index - 1.0
                             - phys.sigma_slope) * h ** 2
        he2 = (h * phys.thickness_smoothing) ** 2
        support = support + (1.0 + (phys.flaring_index + 1.0) * he2) \
            / math.sqrt(1.0 + he2) ** 3
    return math.sqrt(vk2 * support) - r * omega_frame


def _vaz_ghost(phys: Physics, constants, name: str, vaz, vaz0, g: Geom,
               omega_frame, outer: bool):
    nr = vaz.shape[0]
    row, inside = (nr - 1, nr - 2) if outer else (0, 1)
    if name == "keplerian":
        # reference src/boundary_conditions/keplerian_azimuthal.cpp:19-38
        factor = phys.keplerian_azimuthal_outer_factor if outer \
            else phys.keplerian_azimuthal_inner_factor
        r = _host(g, "rmed", row)
        vkep = math.sqrt(constants.G * phys.hydro_center_mass / r)
        return _row(vaz, factor * vkep - r * omega_frame.to(vaz.dtype))
    if name == "zerogradient":
        return vaz[inside:inside + 1]
    if name == "reference":
        return vaz0[row:row + 1]
    if name == "zeroshear":
        # d(omega)/dr = 0
        return vaz[inside:inside + 1] * _host(g, "rmed", row) \
            / _host(g, "rmed", inside)
    if name == "balanced":
        return _row(vaz, _balanced_value(phys, constants,
                                         _host(g, "rmed", row),
                                         omega_frame.to(vaz.dtype)))
    if name == "none":
        return vaz[row:row + 1]
    raise NotImplementedError(f"vaz {'outer' if outer else 'inner'} BC "
                              f"{name!r}")


def apply_boundary_conditions(phys: Physics, constants, g: Geom,
                              sigma, vrad, vaz, energy, ref: RefValues,
                              omega_frame: torch.Tensor, nu=None):
    """Per-variable x per-edge dispatch (reference
    src/boundary_conditions/boundary_conditions.cpp:65-110). ``nu`` is the
    viscosity grid the viscous v_rad BC reads."""
    sigma = _scalar((phys.bc_sigma_inner, phys.bc_sigma_outer), sigma,
                    ref.sigma0, g, phys, "sigma")
    energy = _scalar((phys.bc_energy_inner, phys.bc_energy_outer), energy,
                     ref.energy0, g, phys, "energy")
    gm = constants.G * phys.hydro_center_mass
    vrad = _vrad(vrad, ref.vrad0, g, phys, gm, nu)
    nr = vaz.shape[0]
    vaz = torch.cat([
        _vaz_ghost(phys, constants, phys.bc_vaz_inner, vaz, ref.vaz0, g,
                   omega_frame, False),
        vaz[1:nr - 1],
        _vaz_ghost(phys, constants, phys.bc_vaz_outer, vaz, ref.vaz0, g,
                   omega_frame, True)], dim=0)
    return sigma, vrad, vaz, energy






