"""Gravitational potential of the N-body system on the gas and the indirect
terms of the hydro frame (reference src/Pframeforce.cpp:21-95 and
src/frame_of_reference.cpp:114-165).

Body vectors are tiny (N bodies); the loop over bodies is unrolled and the
per-cell work is elementwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..params import Physics
from .common import Geom, ring_col


@dataclass(frozen=True)
class BodiesOnGrid:
    """Per-body state the gas-side gravity ops need; 1-D tensors of
    length N_bodies."""
    x: torch.Tensor
    y: torch.Tensor
    mass: torch.Tensor                    # ramped-up mass
    cubic_smoothing_radius: torch.Tensor


def smoothing_length(phys: Physics, scale_height: torch.Tensor,
                     body_index: int, body_r=None) -> torch.Tensor:
    """epsilon * H per cell (reference src/Force.cpp:124-131), or at the
    planet location in compatibility mode (:133-143)."""
    if phys.compatibility_no_star_smoothing and body_index == 0:
        return torch.zeros_like(scale_height)
    if phys.compatibility_smoothing_planetloc and body_r is not None:
        h_loc = phys.aspectratio_ref * body_r ** (1.0 + phys.flaring_index)
        return (phys.thickness_smoothing * h_loc).expand_as(scale_height)
    return phys.thickness_smoothing * scale_height


def nbody_potential(phys: Physics, constants, g: Geom,
                    bodies: BodiesOnGrid, n_bodies: int,
                    cell_x: torch.Tensor, cell_y: torch.Tensor,
                    scale_height: torch.Tensor,
                    indirect_x, indirect_y) -> torch.Tensor:
    """POTENTIAL grid (reference src/Pframeforce.cpp:21-95):
    Phi = sum_k [-G m_k / sqrt(d^2 + (eps H)^2) * klahr] - I . x_cell.
    Body values are cast to the field dtype first."""
    dt = cell_x.dtype
    bx, by = bodies.x.to(dt), bodies.y.to(dt)
    bm = bodies.mass.to(dt)
    brs = bodies.cubic_smoothing_radius.to(dt)
    pot = torch.zeros_like(cell_x)
    for k in range(n_bodies):
        body_r = torch.sqrt(bx[k] ** 2 + by[k] ** 2)
        smooth = smoothing_length(phys, scale_height, k, body_r)
        dx = cell_x - bx[k]
        dy = cell_y - by[k]
        d_sm = torch.sqrt(dx * dx + dy * dy + smooth * smooth)
        r_sm = brs[k]
        # Klahr & Kley 2005 cubic inner smoothing (src/Pframeforce.cpp:61-76)
        q = d_sm / torch.where(r_sm > 0.0, r_sm, torch.ones_like(r_sm))
        klahr = torch.where((r_sm > 0.0) & (d_sm < r_sm),
                            q ** 4 - 2.0 * q ** 3 + 2.0 * q,
                            torch.ones_like(q))
        pot = pot - constants.G * bm[k] / d_sm * klahr
    pot = pot - indirect_x.to(dt) * cell_x - indirect_y.to(dt) * cell_y
    return pot


def disk_on_body_accel(phys: Physics, constants, g: Geom,
                       bodies: BodiesOnGrid, n_bodies: int,
                       cell_x: torch.Tensor, cell_y: torch.Tensor,
                       scale_height: torch.Tensor, sigma: torch.Tensor,
                       row_w=None, comm=None):
    """Acceleration of each body by the gas of the active rings 1..NR-2
    (reference src/Force.cpp:23-122 ``ComputeDiskOnPlanetAccel``), with
    the Klahr & Kley cubic smoothing. Body values are cast to the field
    dtype first. ``row_w`` (NR, 1) weights the rows, those rings when
    None; sharded, the window's owned active rows, and ``comm`` sums the
    ranks' parts (the MPI_Allreduce; fargocpt_tpu/ops/gravity.py:57-103).
    Returns (ax, ay) of length N_bodies."""
    dt = cell_x.dtype
    bx, by = bodies.x.to(dt), bodies.y.to(dt)
    brs = bodies.cubic_smoothing_radius.to(dt)
    row_w = ring_col(g, 1) if row_w is None else row_w
    sig = sigma
    if phys.correct_disk_selfgravity:
        # only the non-axisymmetric disk pulls (reference src/Force.cpp:64-66)
        sig = sigma - torch.mean(sigma, dim=-1, keepdim=True)
    cellmass = g.surf * sig
    axs, ays = [], []
    for k in range(n_bodies):
        body_r = torch.sqrt(bx[k] ** 2 + by[k] ** 2)
        smooth = smoothing_length(phys, scale_height, k, body_r)
        dx = cell_x - bx[k]
        dy = cell_y - by[k]
        d_sm2 = dx * dx + dy * dy + smooth * smooth
        d_sm = torch.sqrt(d_sm2)
        r_sm = brs[k]
        q = d_sm / torch.where(r_sm > 0.0, r_sm, torch.ones_like(r_sm))
        klahr = torch.where((r_sm > 0.0) & (d_sm < r_sm),
                            -(3.0 * q ** 4 - 4.0 * q ** 3),
                            torch.ones_like(q))
        w = constants.G * cellmass * d_sm2 ** -1.5 * klahr
        axs.append(torch.sum(w * dx * row_w))
        ays.append(torch.sum(w * dy * row_w))
    if comm is not None:
        axy = comm.sum(torch.stack([torch.stack(axs), torch.stack(ays)]))
        axs, ays = list(axy[0]), list(axy[1])
    if phys.planet_orbit_disk_test:
        # body 0 orbits in a fixed potential (reference
        # src/Pframeforce.cpp:218-221)
        axs[0], ays[0] = torch.zeros_like(axs[0]), torch.zeros_like(ays[0])
    return torch.stack(axs), torch.stack(ays)


def indirect_term_disk(bodies: BodiesOnGrid, n_center: int, disk_ax,
                       disk_ay):
    """-(sum m_k a_k) / (sum m_k) over the hydro-frame-centre bodies
    (reference src/frame_of_reference.cpp:69-93)."""
    m = bodies.mass[:n_center]
    mc = torch.sum(m)
    return (-torch.sum(m * disk_ax[:n_center].to(m.dtype)) / mc,
            -torch.sum(m * disk_ay[:n_center].to(m.dtype)) / mc)


def indirect_term_nbody_predictor(constants, nb, n_center: int,
                                  n_bodies: int, dt):
    """Predictor-mode N-body indirect term (reference
    src/frame_of_reference.cpp:135-165, INDIRECT_TERM_REBOUND): the bodies
    integrated forward by dt with the plain IAS15 (``nbody/ias15.py``),
    and the frame-centre acceleration read from the COM velocity change.
    Exactly zero when every body defines the frame centre, or dt is 0."""
    if n_center >= n_bodies or n_bodies == 1:
        z = torch.zeros((), dtype=nb.x.dtype, device=nb.x.device)
        return z, z
    from ..nbody.system import integrate
    pred = integrate(nb, constants.G, dt)
    m = nb.mass[:n_center]
    mc = torch.sum(m)
    dvx = torch.sum(m * (pred.vx[:n_center] - nb.vx[:n_center])) / mc
    dvy = torch.sum(m * (pred.vy[:n_center] - nb.vy[:n_center])) / mc
    dt = torch.as_tensor(dt, dtype=nb.x.dtype, device=nb.x.device)
    safe_dt = torch.where(dt != 0.0, dt, torch.ones_like(dt))
    zero = torch.zeros_like(dvx)
    return (torch.where(dt != 0.0, -dvx / safe_dt, zero),
            torch.where(dt != 0.0, -dvy / safe_dt, zero))
