"""Shared building blocks of the hydro ops.

The ops work on global (NR, NAZ) tensors. Azimuthal neighbours are
periodic (``torch.roll``); radial neighbours are row slices. ``Geom`` holds
the radial geometry as (NR, 1) / (NR+1, 1) column buffers of the run dtype,
so they broadcast against the fields and move with ``.to(device)``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..grid import Geometry


def azim_prev(x: torch.Tensor) -> torch.Tensor:
    """x[i, j-1] with periodic wrap."""
    return torch.roll(x, 1, dims=-1)


def azim_next(x: torch.Tensor) -> torch.Tensor:
    """x[i, j+1] with periodic wrap."""
    return torch.roll(x, -1, dims=-1)


def accurate_cos(angle: torch.Tensor) -> torch.Tensor:
    """cos via the half-angle identity 1 - 2 sin^2(x/2), as the JAX
    package computes every trajectory-coupled cosine."""
    s = torch.sin(0.5 * angle)
    return 1.0 - 2.0 * s * s


def van_leer_lim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Harmonic-mean (van Leer) slope limiter
    (reference src/TransportEuler.cpp:306-312)."""
    prod = a * b
    pos = prod > 0.0
    safe = torch.where(pos, a + b, torch.ones_like(a))
    return torch.where(pos, 2.0 * prod / safe, torch.zeros_like(a))


def minmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(a * b > 0.0,
                       torch.where(a.abs() < b.abs(), a, b),
                       torch.zeros_like(a))


def mc_lim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Monotonized-central limiter (reference src/TransportEuler.cpp:321-323)."""
    return minmod(0.5 * (a + b), 2.0 * minmod(a, b))


def flux_limiter(a: torch.Tensor, b: torch.Tensor, kind: int) -> torch.Tensor:
    if kind == 1:
        return mc_lim(a, b)
    return van_leer_lim(a, b)


_GEOM_COLUMNS = (
    ("rb", "rmed"),
    ("inv_rb", "inv_rmed"),
    ("ra", "ra"),
    ("inv_ra", "inv_rinf"),
    ("rinf", "rinf"),
    ("rsup", "rsup"),
    ("rmed_ext", "rmed_ext"),
    ("inv_diff_rmed", "inv_diff_rmed"),
    ("inv_diff_rsup", "inv_diff_rsup"),
    ("inv_diff_rsup_rb", "inv_diff_rsup_rb"),
    ("two_diff_ra_sq", "two_diff_ra_sq"),
    ("four_third_inv_rb_invdphi_sq", "four_third_inv_rb_invdphi_sq"),
    ("surf", "surf"),
    ("inv_surf", "inv_surf"),
)


class Geom(nn.Module):
    """Device geometry: the column buffers (NR,1) / (NR+1,1) of the run
    dtype, plus the static azimuthal spacing and grid size."""

    def __init__(self, geometry: Geometry, dtype: torch.dtype,
                 device: torch.device | str | None = None):
        super().__init__()
        for name, src in _GEOM_COLUMNS:
            col = np.asarray(getattr(geometry, src), np.float64)[:, None]
            self.register_buffer(
                name, torch.tensor(col, dtype=dtype, device=device))
        # the radial cell width Rsup - Rinf, differenced in float64: a
        # difference of float32 radii loses four digits (it is ~2e-3 r at
        # 1000 rings)
        dxrad = np.asarray(geometry.rsup, np.float64) \
            - np.asarray(geometry.rinf, np.float64)
        self.register_buffer("dxrad", torch.tensor(
            dxrad[:, None], dtype=dtype, device=device))
        # the radii on the host, float64, for values that depend on the
        # grid alone (the boundaries' ghost values)
        self.host = {name: np.asarray(getattr(geometry, name), np.float64)
                     for name in ("rmed", "ra", "rmed_ext")}
        self.dphi = float(geometry.dphi)
        self.invdphi = float(geometry.invdphi)
        self.nrad = geometry.nrad
        self.naz = geometry.naz


def ring_col(g: Geom, lo: int) -> torch.Tensor:
    """(NR, 1) 1.0 on the rings ``lo``..NR-2 and 0.0 elsewhere, in the
    grid's dtype: the row weight of a sum over the active rings."""
    row = torch.arange(g.nrad, device=g.surf.device)[:, None]
    return ((row >= lo) & (row <= g.nrad - 2)).to(g.surf.dtype)


def set_rows(x: torch.Tensor, new: torch.Tensor, lo: int,
             hi: int) -> torch.Tensor:
    """x with rows [lo, hi) replaced by the matching rows of ``new`` (both
    full-size); returns a new tensor and leaves ``x`` untouched."""
    return torch.cat([x[:lo], new[lo:hi], x[hi:]], dim=0)
