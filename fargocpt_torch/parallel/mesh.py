"""The radial slabs of a process group (the JAX package's
``fargocpt_tpu/parallel/shard_step.py:118-139``): rank k owns the
``L = NR / n`` rings ``[k L, (k + 1) L)`` and computes on a window of
``Lx = L + 2 halo`` rings, skewed at the domain edges so that the first
window starts at ring 0 and the last ends at ring NR - 1.

The JAX package's ``parallel/mesh.py`` builds a device mesh for XLA's
GSPMD partitioner, which has no counterpart here; what survives of it is
this arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Slabs:
    """The decomposition of ``nrad`` rings over ``n`` ranks."""
    nrad: int
    n: int
    halo: int
    L: int            # rings a rank owns
    Lx: int           # rings of a rank's window
    S: int            # rings sent to each neighbour per exchange
    windows: tuple    # first global ring of each rank's window


def slab_bounds(nrad: int, n: int, halo: int = 10) -> Slabs:
    """The slabs of ``n`` ranks, or ValueError where the JAX package
    refuses them: NR not a multiple of n, slabs narrower than 2 halo + 1
    rings, or a window larger than the grid (one rank: the JAX package's
    ``Geometry.window`` refuses that window)."""
    H = int(halo)
    if n < 1 or nrad % n != 0:
        raise ValueError(f"Nrad={nrad} not divisible by {n} ranks; pad the "
                         "grid or change the rank count")
    L = nrad // n
    Lx = L + 2 * H
    if 2 * H + 1 > L:
        raise ValueError(f"halo={H} needs slabs of at least {2 * H + 1} "
                         f"rings, have {L}; fewer ranks or a smaller halo "
                         "required")
    windows = tuple(min(max(k * L - H, 0), nrad - Lx) for k in range(n))
    for w in windows:
        if w < 0 or w + Lx > nrad:
            raise ValueError(f"window [{w}, {w + Lx}) outside grid of "
                             f"{nrad} rings")
    return Slabs(nrad=nrad, n=n, halo=H, L=L, Lx=Lx, S=2 * H + 1,
                 windows=windows)
