"""What the radial column march (fargocpt_torch/csrc/transport.cuh,
radial_march_kernel: the ops radial_momenta_sweep and radial_sweep) relies
on, on the CPU in float64 with the plain PyTorch ops, bit for bit.

- The strips: a thread marches up rows i0..i1-1 of its column, reading rows
  i0-2..i1+1 (clamped at the grid's edges) and faces i0..i1. Each op
  computed on those rows alone, with their faces, equals the whole grid's
  result on rows i0..i1-1: radial_sweep at K = 1, 2, 5, 6 and
  radial_momenta_sweep for both EoS, strips of 1, 2, 16 and 17 rows, the
  first and the last included, NR = 3, 4, 17 and 33, both limiters, vrad
  of both signs. With one halo row on either side it does not.
- The march: emulated with PyTorch ops a row at a time (over all columns
  at once), it equals the plain version bit for bit: each row's quotients
  once, each face once with the limited slope of its upwind row only (zero
  outside rows 1..NR-2), the flux carried to the row below, and 0 * base at
  faces 0 and NR, the signed zero of the plain version's flux.

The kernels themselves are held to the plain versions on the GPU by
tests/test_torch_gpu.py and chip_smoke.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import transport as tr
from fargocpt_torch.ops.common import Geom, flux_limiter
from fargocpt_torch.params import Physics

torch.set_num_threads(2)

NAZ = 20
DT, OMEGA = 0.01, 0.3

# radial_sweep at K = 1 and 2 (the kernel takes these one plane at a time)
# and 5 and 6 (all at once); radial_momenta_sweep isothermal (K = 5) and
# adiabatic (K = 6)
CASES = [("radial_sweep", 1), ("radial_sweep", 2), ("radial_sweep", 5),
         ("radial_sweep", 6), ("radial_momenta_sweep", 5),
         ("radial_momenta_sweep", 6)]


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _phys(k_quant, limiter):
    return Physics(eos="isothermal" if k_quant == 5 else "adiabatic",
                   adiabatic_index=1.4, aspectratio_ref=0.05,
                   flux_limiter_type=limiter)


def _geom(nr):
    return Geom(Geometry.build(nr, NAZ, 0.4, 2.5, "Log"), torch.float64,
                "cpu")


def _inputs(nr, k_quant, seed=3):
    """Seeded fields (vrad of both signs) and a batch of K planes."""
    rng = np.random.default_rng((seed, nr, k_quant))
    f = {"sigma": T(rng.random((nr, NAZ)) + 0.5),
         "vrad": T((rng.random((nr + 1, NAZ)) - 0.5) * 0.05),
         "vaz": T((rng.random((nr, NAZ)) - 0.5) * 0.1 + 1.0),
         "energy": T((rng.random((nr, NAZ)) + 0.2) * 1e-3),
         "qs": T(rng.random((k_quant, nr, NAZ)) + 0.5)}
    assert bool((f["vrad"] > 0).any()) and bool((f["vrad"] < 0).any())
    return f


def _rows(g, a, b):
    """The geometry of rows a..b-1 (faces a..b) as a grid of its own."""
    return SimpleNamespace(nrad=b - a, rb=g.rb[a:b], inv_surf=g.inv_surf[a:b],
                           inv_diff_rmed=g.inv_diff_rmed[a:b],
                           rmed_ext=g.rmed_ext[a:b + 1])


def _op(op, phys, g, f, base, a, b):
    """The plain op on rows a..b-1 and faces a..b alone (the whole grid for
    a = 0, b = NR)."""
    gs = _rows(g, a, b)
    if op == "radial_sweep":
        return tr.radial_sweep(phys, gs, f["qs"][:, a:b], f["sigma"][a:b],
                               f["vrad"][a:b + 1], base[a:b + 1], T(DT))
    return tr.radial_momenta_sweep(phys, gs, f["sigma"][a:b],
                                   f["vrad"][a:b + 1], f["vaz"][a:b],
                                   f["energy"][a:b], base[a:b + 1], T(DT),
                                   T(OMEGA))


def _strip(op, phys, g, f, base, i0, i1, below=2, above=2):
    """Rows i0..i1-1 of the op from rows i0-below..i1+above-1 alone, cut at
    the grid's edges (where the kernel's clamped rows enter no value that
    is used)."""
    a, b = max(i0 - below, 0), min(i1 + above, g.nrad)
    return _op(op, phys, g, f, base, a, b)[:, i0 - a:i1 - a]


@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("nr", [3, 4, 17, 33])
@pytest.mark.parametrize("rows", [1, 2, 16, 17])
@pytest.mark.parametrize("op,k_quant", CASES)
def test_strip_equals_whole_grid(op, k_quant, rows, nr, limiter):
    """Every strip, the first, the last and a ragged last one."""
    phys = _phys(k_quant, limiter)
    g = _geom(nr)
    f = _inputs(nr, k_quant)
    base = tr.sigma_flux(phys, g, f["sigma"], f["vrad"], T(DT))
    whole = _op(op, phys, g, f, base, 0, nr)
    assert whole.shape == (k_quant, nr, NAZ)
    for i0 in range(0, nr, rows):
        i1 = min(i0 + rows, nr)
        got = _strip(op, phys, g, f, base, i0, i1)
        assert torch.equal(got, whole[:, i0:i1]), i0


@pytest.mark.parametrize("side", ["below", "above"])
@pytest.mark.parametrize("op,k_quant", CASES)
def test_strip_with_one_halo_row_differs(op, k_quant, side):
    """The halo is no wider than it must be: one row less on either side
    changes a value of the strip."""
    phys = _phys(k_quant, 0)
    g = _geom(33)
    f = _inputs(33, k_quant)
    base = tr.sigma_flux(phys, g, f["sigma"], f["vrad"], T(DT))
    whole = _op(op, phys, g, f, base, 0, 33)
    assert torch.equal(_strip(op, phys, g, f, base, 8, 24), whole[:, 8:24])
    got = _strip(op, phys, g, f, base, 8, 24, **{side: 1})
    assert not torch.equal(got, whole[:, 8:24])


def _march(phys, g, load, vrad, base, rows):
    """radial_march_kernel emulated over all columns at once: the strips
    of ``rows`` rows, each marching rows i0-2..i1+1 (clamped) with
    ``load(r)`` giving row r's K quantities and their divisor. Returns the
    swept batch and the flux through every face, as its strips made it."""
    nr, dt, kind = g.nrad, T(DT), phys.flux_limiter_type
    rme = g.rmed_ext[:, 0]
    invdrm = torch.cat([g.inv_diff_rmed[:, 0], torch.zeros(1,
                                                           dtype=rme.dtype)])
    k_quant = load(0)[0].shape[0]
    out = torch.full((k_quant, nr, NAZ), float("nan"), dtype=torch.float64)
    flux = torch.full((k_quant, nr + 1, NAZ), float("nan"),
                      dtype=torch.float64)
    for i0 in range(0, nr, rows):
        i1 = min(i0 + rows, nr)
        # q: the quantities of rows r-2..r; w: the quotients of rows
        # r-3..r, the window of face f = r - 1; f_low: the flux of face f-1
        q = [None] * 3
        w = [None] * 4
        f_low = None
        for r in range(i0 - 2, i1 + 2):
            fresh, sig = load(min(max(r, 0), nr - 1))
            q = q[1:] + [fresh]
            w = w[1:] + [fresh / sig]
            f = r - 1
            if f < i0:
                continue
            bf = base[f]
            if 1 <= f <= nr - 1:
                vr = vrad[f]
                up = vr > 0.0
                # the upwind row b and its slope, zero outside 1..NR-2
                b = torch.where(up, f - 1, f)
                sloped = (b >= 1) & (b <= nr - 2)
                a_, m, p = (torch.where(up, w[0], w[1]),
                            torch.where(up, w[1], w[2]),
                            torch.where(up, w[2], w[3]))
                dq = flux_limiter((p - m) * invdrm[b + 1],
                                  (m - a_) * invdrm[b], kind)
                dq = torch.where(sloped, dq, torch.zeros_like(dq))
                reach = torch.where(up, (rme[f] - rme[f - 1]) - vr * dt,
                                    (rme[f + 1] - rme[f]) + vr * dt) * 0.5
                t = reach * dq
                fl = torch.where(up, m + t, m - t) * bf
            else:
                fl = torch.zeros_like(fresh) * bf
            seen = flux[:, f]
            assert bool(seen.isnan().all()) or torch.equal(seen, fl)
            flux[:, f] = fl
            if f > i0:
                out[:, f - 1] = q[0] + (f_low - fl) * g.inv_surf[f - 1]
            f_low = fl
    return out, flux


@pytest.mark.parametrize("rows", [5, 16])
@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("nr", [3, 4, 17, 33])
@pytest.mark.parametrize("op,k_quant", CASES)
def test_march_equals_plain(op, k_quant, nr, limiter, rows):
    """Bit for bit, with the flux's signed zeros: radial_sweep with a base
    of both signs on every face (any base is taken), radial_momenta_sweep
    with the sigma flux its route gives it (±0 at faces 0 and NR)."""
    phys = _phys(k_quant, limiter)
    g = _geom(nr)
    f = _inputs(nr, k_quant)
    if op == "radial_sweep":
        base = T((np.random.default_rng(nr).random((nr + 1, NAZ)) - 0.5)
                 * 1e-3)
        qs = f["qs"]
        ref = tr.radial_sweep(phys, g, qs, f["sigma"], f["vrad"], base,
                              T(DT))

        def load(r):
            return qs[:, r], f["sigma"][r]
    else:
        base = tr.sigma_flux(phys, g, f["sigma"], f["vrad"], T(DT))
        qs = tr.momenta_batch(phys, g, f["sigma"], f["vrad"], f["vaz"],
                              f["energy"], T(OMEGA))
        ref = tr.radial_momenta_sweep(phys, g, f["sigma"], f["vrad"],
                                      f["vaz"], f["energy"], base, T(DT),
                                      T(OMEGA))

        def load(r):
            # MarchFields: the momenta of row r as the kernel builds them
            sig, rb = f["sigma"][r], g.rb[r]
            corot = rb * T(OMEGA)
            vaz = f["vaz"][r]
            built = [sig * f["vrad"][r + 1], sig * f["vrad"][r],
                     sig * (torch.roll(vaz, -1) + corot) * rb,
                     sig * (vaz + corot) * rb]
            if phys.is_adiabatic:
                built.append(f["energy"][r])
            return torch.stack(built + [sig]), sig
    sigma = f["sigma"]
    ref_flux = tr.star_radial(phys, g, qs / sigma, f["vrad"], T(DT)) * base
    got, flux = _march(phys, g, load, f["vrad"], base, rows)
    assert torch.equal(got, ref)
    assert torch.equal(flux, ref_flux)
    assert torch.equal(torch.signbit(flux), torch.signbit(ref_flux))
    for face in (0, nr):
        assert bool((flux[:, face] == 0).all())
        assert torch.equal(torch.signbit(flux[:, face]),
                           torch.signbit(base[face]).expand(k_quant, NAZ))
