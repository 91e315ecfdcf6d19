"""What the tiles of the whole-transport CUDA kernel
(fargocpt_torch/csrc/transport.cu) rely on, on the CPU in float64 with the
plain PyTorch ops, bit for bit.

- The ring stage: a block takes ``length`` output cells j0..j0+length-1 of
  a ring and loads the source cells c0-5..c0+length+3 (c0 = j0 - s_i; with
  one sweep c0-3..c0+length+1), wrapped round the ring. The azimuthal part
  of the plain transport (the sweeps, the roll, sigma / energy / vaz and
  the rolled rp and rm planes) computed on that window alone equals the
  whole ring's on the tile, for shifts of either sign and beyond one turn,
  for tiles that do not divide NAZ and for rings shorter than the halo; a
  window one cell narrower on either side does not.
- The radial stage: a thread marches up a strip of rows with two halo rows
  on either side (clamped at the grid's edges). The radial half of the
  plain transport on rows i0-2..i1+1 alone equals the whole grid's on rows
  i0..i1-1 and faces i0..i1-1 (and face NR in the last strip), first and
  last strips included; with one halo row it does not.
- The last launch: v_rad from the rolled planes of all tiles.

The kernel itself is held to the plain transport on the GPU by
tests/test_torch_gpu.py and chip_smoke.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import transport as tr
from fargocpt_torch.ops.common import Geom
from fargocpt_torch.params import Physics

torch.set_num_threads(2)

NR = 12
DT, OMEGA = 0.01, 0.3


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _phys(adiabatic=True, limiter=0, fast=True):
    return Physics(eos="adiabatic" if adiabatic else "isothermal",
                   adiabatic_index=1.4, aspectratio_ref=0.05,
                   flux_limiter_type=limiter, fast_transport=fast)


def _geom(nr, naz):
    return Geom(Geometry.build(nr, naz, 0.4, 2.5, "Log"), torch.float64,
                "cpu")


def _ring_inputs(seed, k_quant, naz):
    """A swept batch, the sweep velocities and shifts of either sign, some
    beyond one turn of the ring."""
    rng = np.random.default_rng(seed)
    qs = T(rng.random((k_quant, NR, naz)) + 0.5)
    vres = T((rng.random((NR, naz)) - 0.5) * 0.05)
    vconst = T((rng.random((NR, 1)) - 0.5) * 0.02)
    nshift = torch.tensor(rng.integers(-2 * naz - 3, 2 * naz + 3, NR),
                          dtype=torch.int32)
    nshift[0], nshift[1], nshift[2] = 0, -1, naz + 2
    return qs, vres, vconst, nshift


def _whole_ring(phys, g, qs, vres, vconst, nshift):
    """(sigma, energy or None, vaz, rp, rm) of the whole grid, as the plain
    transport computes them after the radial sweep."""
    out = tr.fargo_theta(phys, g, qs, vres, vconst, nshift, T(DT),
                         phys.fast_transport)
    vrad_old = torch.zeros((NR + 1, qs.shape[-1]), dtype=torch.float64)
    _, vaz = tr.velocities_from_momenta(g, out[-1], out[0], out[1], out[2],
                                        out[3], vrad_old, T(OMEGA))
    return out[-1], (out[4] if phys.is_adiabatic else None), vaz, out[0], out[1]


def _ring_window(phys, g, qs, vres, vconst, nshift, j0, length, below=None,
                 above=None):
    """The same five planes on the tile j0..j0+length-1, from the window of
    source cells alone: ``below`` cells under the first output's source and
    ``above`` over the last one's (the kernel's 2 sweeps + 1 and 2 sweeps)."""
    naz = qs.shape[-1]
    sweeps = 2 if phys.fast_transport else 1
    below = 2 * sweeps + 1 if below is None else below
    above = 2 * sweeps if above is None else above
    n = below + length + above
    start = torch.remainder(j0 - nshift.long() - below, naz)
    idx = torch.remainder(start[:, None] + torch.arange(n)[None, :], naz)
    q = torch.gather(qs, -1, idx.expand(qs.shape[0], NR, n))
    v = torch.gather(vres, -1, idx)
    # the window as a ring of its own: its wrap spoils two cells a sweep at
    # either end
    q = tr.theta_sweep(phys, g, q, v, T(DT))
    if phys.fast_transport:
        q = tr.theta_sweep(phys, g, q, vconst.expand(NR, n).contiguous(),
                           T(DT))
    m = below + torch.arange(length)
    sig = q[-1]
    vaz = (q[2][:, m - 1] + q[3][:, m]) / (sig[:, m - 1] + sig[:, m]) \
        * g.inv_rb - g.rb * T(OMEGA)
    return sig[:, m], (q[4][:, m] if phys.is_adiabatic else None), vaz, \
        q[0][:, m], q[1][:, m]


@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("length", [16, 24])
@pytest.mark.parametrize("naz", [64, 50, 7])
def test_ring_window_equals_whole_ring(naz, length, fast, limiter):
    """Every tile of the ring, the ragged last one included; NAZ = 7 is
    shorter than the halo, so the window goes round the ring twice."""
    adiabatic = naz != 50
    phys = _phys(adiabatic, limiter, fast)
    g = _geom(NR, naz)
    args = _ring_inputs(5, 6 if adiabatic else 5, naz)
    whole = _whole_ring(phys, g, *args)
    planes = [torch.empty(NR, naz, dtype=torch.float64) for _ in range(5)]
    for j0 in range(0, naz, length):
        n_out = min(length, naz - j0)
        tile = _ring_window(phys, g, *args, j0, n_out)
        for name, got, ref, plane in zip(("sigma", "energy", "vaz", "rp",
                                          "rm"), tile, whole, planes):
            if ref is None:
                assert got is None
                continue
            assert torch.equal(got, ref[:, j0:j0 + n_out]), (name, j0)
            plane[:, j0:j0 + n_out] = got
    # the last launch: v_rad of rows 1..NR-1 from the rolled planes
    sigma, _, _, rp, rm = planes
    vrad_old = T(np.random.default_rng(9).random((NR + 1, naz)))
    ref, _ = tr.velocities_from_momenta(g, whole[0], whole[3], whole[4],
                                        whole[3], whole[4], vrad_old,
                                        T(OMEGA))
    got = torch.cat([torch.zeros(1, naz, dtype=torch.float64),
                     (rp[:-1] + rm[1:]) / (sigma[:-1] + sigma[1:]),
                     vrad_old[NR:]])
    assert torch.equal(got, ref)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("side", ["below", "above"])
def test_ring_window_one_cell_narrower_differs(side, fast):
    """The halo is no wider than it must be: one cell less on either side
    changes a value on the tile."""
    phys = _phys(fast=fast)
    g = _geom(NR, 64)
    args = _ring_inputs(5, 6, 64)
    whole = _whole_ring(phys, g, *args)
    sweeps = 2 if fast else 1
    narrow = {"below": 2 * sweeps, "above": 2 * sweeps - 1}[side]
    tile = _ring_window(phys, g, *args, 16, 16, **{side: narrow})
    assert not all(torch.equal(got, ref[:, 16:32])
                   for got, ref in zip(tile, whole))


def _radial_inputs(seed, nr, naz):
    rng = np.random.default_rng(seed)
    return (T(rng.random((nr, naz)) + 0.5),
            T((rng.random((nr + 1, naz)) - 0.5) * 0.05),
            T((rng.random((nr, naz)) - 0.5) * 0.1 + 1.0),
            T((rng.random((nr, naz)) + 0.2) * 1e-3))


def _radial_half(phys, g, sigma, vrad, vaz, energy):
    """The swept batch (K, rows, NAZ) and the mass flux (rows + 1, NAZ) of
    the plain transport's radial half on the rows of ``g``."""
    ds = tr.star_radial(phys, g, sigma, vrad, T(DT))
    qs = tr.momenta_batch(phys, g, sigma, vrad, vaz, energy, T(OMEGA))
    qs, flux = tr.van_leer_radial_batch(phys, g, qs, sigma, ds, vrad, T(DT))
    return qs, flux[-1]


def _rows(g, a, b):
    """The geometry of rows a..b-1 as a grid of its own."""
    return SimpleNamespace(nrad=b - a, dphi=g.dphi, rb=g.rb[a:b],
                           inv_surf=g.inv_surf[a:b], ra=g.ra[a:b + 1],
                           inv_diff_rmed=g.inv_diff_rmed[a:b],
                           rmed_ext=g.rmed_ext[a:b + 1])


def _strip(phys, g, sigma, vrad, vaz, energy, i0, i1, halo=2):
    """Rows i0..i1-1 of the batch and faces i0..i1 of the mass flux from
    rows i0-halo..i1+halo-1 alone (cut at the grid's edges, where the
    kernel's clamped rows enter no value that is used)."""
    nr = g.nrad
    a, b = max(i0 - halo, 0), min(i1 + halo, nr)
    qs, flux = _radial_half(phys, _rows(g, a, b), sigma[a:b], vrad[a:b + 1],
                            vaz[a:b], energy[a:b])
    return qs[:, i0 - a:i1 - a], flux[i0 - a:i1 - a + 1]


@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("adiabatic", [True, False])
@pytest.mark.parametrize("rows", [8, 16])
@pytest.mark.parametrize("nr", [32, 37])
def test_radial_strip_equals_whole_grid(nr, rows, adiabatic, limiter):
    """Every strip, the first, the last and a ragged last one (NR = 37)."""
    naz = 20
    phys = _phys(adiabatic, limiter)
    g = _geom(nr, naz)
    fields = _radial_inputs(3, nr, naz)
    qs, flux = _radial_half(phys, g, *fields)
    for i0 in range(0, nr, rows):
        i1 = min(i0 + rows, nr)
        got_qs, got_flux = _strip(phys, g, *fields, i0, i1)
        assert torch.equal(got_qs, qs[:, i0:i1]), i0
        # a strip writes its lower faces; the last one face NR (zero) too
        n_faces = i1 - i0 + (1 if i1 == nr else 0)
        assert torch.equal(got_flux[:n_faces], flux[i0:i0 + n_faces]), i0
    assert bool((flux[nr] == 0).all())


def test_radial_strip_with_one_halo_row_differs():
    phys = _phys()
    g = _geom(32, 20)
    fields = _radial_inputs(3, 32, 20)
    qs, _ = _radial_half(phys, g, *fields)
    got, _ = _strip(phys, g, *fields, 8, 16, halo=1)
    assert not torch.equal(got, qs[:, 8:16])
