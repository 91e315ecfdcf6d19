"""What the blocks of the azimuthal ring-tile kernel
(fargocpt_torch/csrc/transport.cuh, theta_ring_kernel: the ops
theta_sweep and fargo_theta) and of the CFL kernel
(fargocpt_torch/csrc/cfl.cu) rely on, on the CPU in float64 with the plain
PyTorch ops, bit for bit.

- The azimuthal sweeps: a block takes ``length`` output cells
  j0..j0+length-1 of a ring and loads the source cells c0-2S..c0+length-1+2S
  (c0 = j0 - s_i, s_i = 0 without the roll, S the sweeps), wrapped round
  the ring. One sweep (theta_sweep; fargo_theta without fast transport)
  and two (fargo_theta, the second with the ring's uniform velocity)
  computed on that window alone equal the whole ring's result on the tile,
  rolled, for shifts of either sign and beyond one turn, both limiters,
  K = 1, 5 and 6, tiles that do not divide NAZ and rings shorter than the
  halo (NAZ = 7); a window one cell narrower on either side does not.
- The CFL: a block takes one ring. The dt of ``condition_cfl`` equals the
  maximum of the per-ring maxima of the squared inverse dt over rings
  1..NR-2, each from its own ring's cells and mean alone, combined with the
  shear limit of the ring pairs (i, i+1), i = 0..NR-3, down to the smallest
  grid, NR = 3; ring NR-1's vaz enters nothing, ring 0's does.

The kernels themselves are held to the plain versions on the GPU by
tests/test_torch_gpu.py and chip_smoke.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import cfl as cfl_ops
from fargocpt_torch.ops import kernels
from fargocpt_torch.ops import transport as tr
from fargocpt_torch.ops import viscosity as visc
from fargocpt_torch.ops.common import Geom
from fargocpt_torch.params import Physics
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR = 12
DT = 0.01


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _geom(nr, naz):
    return Geom(Geometry.build(nr, naz, 0.4, 2.5, "Log"), torch.float64,
                "cpu")


def _batch(seed, k_quant, naz):
    """A batch (density last), a sweep velocity per cell, the uniform
    velocities and shifts of either sign, some beyond one turn."""
    rng = np.random.default_rng(seed)
    qs = T(rng.random((k_quant, NR, naz)) + 0.5)
    v = T((rng.random((NR, naz)) - 0.5) * 0.05)
    vconst = T((rng.random((NR, 1)) - 0.5) * 0.02)
    nshift = torch.tensor(rng.integers(-2 * naz - 3, 2 * naz + 3, NR),
                          dtype=torch.int32)
    nshift[0], nshift[1], nshift[2] = 0, -1, naz + 2
    return qs, v, vconst, nshift


# op -> (sweeps, rolled)
OPS = {"theta_sweep": (1, False), "fargo_theta_one": (1, True),
       "fargo_theta_two": (2, True)}


def _whole(op, phys, g, qs, v, vconst, nshift):
    """The op on the whole grid, as its plain version computes it."""
    if op == "theta_sweep":
        return tr.theta_sweep(phys, g, qs, v, T(DT))
    return tr.fargo_theta(phys, g, qs, v, vconst, nshift, T(DT),
                          op == "fargo_theta_two")


def _window(op, phys, g, qs, v, vconst, nshift, j0, length, below=None,
            above=None):
    """Output cells j0..j0+length-1 of every ring from the window of source
    cells alone: ``below`` cells under the first output's source and
    ``above`` over the last one's (the kernel's 2 a sweep each way). The
    window is swept as a ring of its own: its wrap spoils two cells a sweep
    at either end."""
    sweeps, rolled = OPS[op]
    naz = qs.shape[-1]
    below = 2 * sweeps if below is None else below
    above = 2 * sweeps if above is None else above
    n = below + length + above
    shift = nshift.long() if rolled else torch.zeros(NR, dtype=torch.long)
    start = torch.remainder(j0 - shift - below, naz)
    idx = torch.remainder(start[:, None] + torch.arange(n)[None, :], naz)
    q = torch.gather(qs, -1, idx.expand(qs.shape[0], NR, n))
    q = tr.theta_sweep(phys, g, q, torch.gather(v, -1, idx), T(DT))
    if sweeps == 2:
        q = tr.theta_sweep(phys, g, q, vconst.expand(NR, n).contiguous(),
                           T(DT))
    return q[..., below:below + length]


@pytest.mark.parametrize("k_quant", [1, 5, 6])
@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("length", [16, 24])
@pytest.mark.parametrize("naz", [64, 50, 7])
@pytest.mark.parametrize("op", list(OPS))
def test_theta_window_equals_whole_ring(op, naz, length, limiter, k_quant):
    """Every tile of the ring, the ragged last one included; NAZ = 7 is
    shorter than the halo, so the window goes round the ring more than
    once."""
    phys = Physics(flux_limiter_type=limiter)
    g = _geom(NR, naz)
    args = _batch(5, k_quant, naz)
    whole = _whole(op, phys, g, *args)
    for j0 in range(0, naz, length):
        n_out = min(length, naz - j0)
        tile = _window(op, phys, g, *args, j0, n_out)
        assert torch.equal(tile, whole[..., j0:j0 + n_out]), j0


@pytest.mark.parametrize("side", ["below", "above"])
@pytest.mark.parametrize("op", list(OPS))
def test_theta_window_one_cell_narrower_differs(op, side):
    """The halo is no wider than it must be: one cell less on either side
    changes a value on the tile."""
    phys = Physics()
    g = _geom(NR, 64)
    args = _batch(5, 6, 64)
    whole = _whole(op, phys, g, *args)
    narrow = 2 * OPS[op][0] - 1
    tile = _window(op, phys, g, *args, 16, 16, **{side: narrow})
    assert not torch.equal(tile, whole[..., 16:32])


# --- the CFL ring blocks --------------------------------------------------

CFL_PHYS = {
    "adiabatic_sn": dict(eos="adiabatic", artificial_viscosity="sn",
                         viscous_alpha=1e-3),
    "isothermal_tw": dict(eos="isothermal", artificial_viscosity="tw",
                          viscous_alpha=1e-3),
    "adiabatic_constant_nu": dict(eos="adiabatic", artificial_viscosity="tw",
                                  viscous_alpha=0.0, constant_viscosity=1e-5),
}


def _cfl_setup(kind, nr, naz, fast=True, seed=3):
    phys = Physics(adiabatic_index=1.4, aspectratio_ref=0.05,
                   fast_transport=fast,
                   **CFL_PHYS[kind])
    ctx = kernels.KernelContext(phys, Constants.from_units(Units()),
                                Geometry.build(nr, naz, 0.4, 2.5, "Log"),
                                torch.float64, "cpu")
    rng = np.random.default_rng(seed)
    f = {"sigma": T(rng.random((nr, naz)) + 0.5),
         "vrad": T((rng.random((nr + 1, naz)) - 0.5) * 0.05),
         "vaz": T((rng.random((nr, naz)) - 0.5) * 0.1 + 1.0),
         "energy": T(rng.random((nr, naz)) * 1e-3 + 1e-3),
         "qplus": T(rng.random((nr, naz)) * 1e-6),
         "qminus": T(rng.random((nr, naz)) * 1e-6)}
    return ctx, f


def _cfl(ctx, f):
    return kernels.cfl_plain(ctx, f["sigma"], f["vrad"], f["vaz"],
                             f["energy"], f["qplus"], f["qminus"])


def _ring_block_max(ctx, f, i):
    """Ring i's maximum of the squared inverse dt from its own cells, its
    own mean and the face above it alone (a grid of one ring)."""
    g = ctx.g
    cs, _, h = kernels.derived(ctx, f["sigma"], f["energy"])
    nu = visc.kinematic_viscosity(ctx.phys, g, cs, h)
    ring = SimpleNamespace(
        nrad=1, dphi=g.dphi, invdphi=g.invdphi, dxrad=g.dxrad[i:i + 1],
        rb=g.rb[i:i + 1], inv_rb=g.inv_rb[i:i + 1],
        inv_diff_rsup=g.inv_diff_rsup[i:i + 1])
    one = {k: v[i:i + 1] for k, v in f.items() if k != "vrad"}
    vmean = torch.mean(one["vaz"], dim=-1, keepdim=True)
    inv_sq = cfl_ops.inverse_dt_squared(
        ctx.phys, ring, one["sigma"], f["vrad"][i:i + 2], one["vaz"],
        one["energy"], cs[i:i + 1], nu[i:i + 1], one["qplus"],
        one["qminus"], vmean)
    return torch.amax(inv_sq)


def _from_ring_blocks(ctx, f):
    """dt as the kernel assembles it: the maximum of the ring blocks'
    maxima over rings 1..NR-2, and the shear limit of the pairs (i, i+1),
    i = 0..NR-3, from the rings' means."""
    nr = ctx.g.nrad
    m = torch.amax(torch.stack([_ring_block_max(ctx, f, i)
                                for i in range(1, nr - 1)]))
    vmean = torch.mean(f["vaz"], dim=-1, keepdim=True)
    shear = cfl_ops.shear_limit(ctx.phys, ctx.g, vmean)
    return torch.minimum(shear, ctx.phys.cfl / torch.sqrt(m))


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("nr,naz", [(3, 7), (3, 1), (12, 50)])
@pytest.mark.parametrize("kind", list(CFL_PHYS))
def test_cfl_dt_from_ring_blocks(kind, nr, naz, fast):
    """NR = 3: one active ring and one ring pair."""
    ctx, f = _cfl_setup(kind, nr, naz, fast)
    dt = _cfl(ctx, f)
    assert dt.shape == () and bool(torch.isfinite(dt))
    assert torch.equal(_from_ring_blocks(ctx, f), dt)


@pytest.mark.parametrize("nr", [3, 12])
def test_cfl_ring_blocks_see_a_planted_nan(nr):
    """A NaN in a ring of the active range reaches dt through its block's
    maximum, as it does through the plain minimum."""
    ctx, f = _cfl_setup("adiabatic_sn", nr, 50)
    f["sigma"][nr - 2, 5] = float("nan")
    assert bool(torch.isnan(_cfl(ctx, f)))
    assert bool(torch.isnan(_from_ring_blocks(ctx, f)))


@pytest.mark.parametrize("nr", [3, 12])
def test_cfl_ring_nr_minus_1_vaz_enters_nothing(nr):
    """Ring NR-1 has no block of its own (the kernel launches NR-1); its
    vaz changes nothing, while ring 0's, through the shear limit, does."""
    ctx, f = _cfl_setup("adiabatic_sn", nr, 50, seed=8)
    dt = _cfl(ctx, f)
    # steep enough that the shear of the pair (0, 1) sets dt
    f0 = {k: v.clone() for k, v in f.items()}
    f0["vaz"][0] += 3.0
    moved = _cfl(ctx, f0)
    assert not torch.equal(moved, dt)
    assert torch.equal(_from_ring_blocks(ctx, f0), moved)
    last = {k: v.clone() for k, v in f.items()}
    last["vaz"][nr - 1] += 3.0
    assert torch.equal(_cfl(ctx, last), dt)
