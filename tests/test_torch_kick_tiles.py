"""What the tiles of the viscous-kick and sources CUDA kernels
(fargocpt_torch/csrc/viscous_kick.cu, sources.cu) rely on, on the CPU in
float64 with the plain PyTorch versions, bit for bit.

- The viscous kick: a block owns a tile of output cells (rows i0..i1-1,
  columns j0..j1-1) and loads sigma, vrad, vaz and energy with a halo of 2
  cells each way (rows stop at the grid's ends, columns wrap; vrad's rows
  are faces, so its last loaded row is face i1+1). The plain version fed
  only that window (every value outside it replaced by another) gives the
  whole grid's outputs on the tile, for every tile: the first and last row
  tiles with their ghost rings, the tiles on either side of the column
  seam, ragged last tiles and a ring shorter than the halo. With one halo
  cell less on any side it does not (with SN or TW artificial viscosity;
  without, the chain is one stencil shorter). The in-kick sound speed,
  the optional sixth output, is one of the tile's too.
- The sources: a block evaluates (sigma, pressure, potential) on its tile,
  one row below and one column before, and reads vaz one row below and one
  column after; a smoothing plane ``h_smooth`` where it is given on the
  same cells as sigma. The plain version fed only that gives the whole
  grid's kicks on the tile; without the halo it does not.

The kernels themselves are held to the plain versions on the GPU by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import kernels as K
from fargocpt_torch.ops.gravity import BodiesOnGrid
from fargocpt_torch.params import Physics
from fargocpt_torch.units import Units

torch.set_num_threads(2)

VK_OUT = ("vrad", "vaz", "energy", "qplus", "qminus")


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _ctx(nr, naz, **kw):
    base = dict(eos="adiabatic", adiabatic_index=1.4, viscous_alpha=1e-3,
                aspectratio_ref=0.05, flaring_index=0.25,
                artificial_viscosity="sn", heating_viscous=True,
                cooling_beta_enabled=True, cooling_beta=10.0,
                minimum_temperature=1e-6, sigma0=1.0, sigma_floor=1e-6,
                thickness_smoothing=0.6, imposed_disk_drift=1e-4)
    base.update(kw)
    return K.KernelContext(Physics(**base), Constants.from_units(Units()),
                           Geometry.build(nr, naz, 0.4, 2.5, "Log"),
                           torch.float64, "cpu")


def _fields(seed, nr, naz):
    """sigma (one patch under the near-floor density), vrad, vaz, energy:
    converging and diverging flow in both directions, so every branch of
    the artificial viscosity is taken somewhere."""
    rng = np.random.default_rng(seed)
    sigma = rng.random((nr, naz)) + 0.5
    sigma[nr // 3, 1:3] = 5e-6
    return {"sigma": T(sigma),
            "vrad": T((rng.random((nr + 1, naz)) - 0.5) * 0.05),
            "vaz": T((rng.random((nr, naz)) - 0.5) * 0.1 + 1.0),
            "energy": T(rng.random((nr, naz)) * 1e-3 + 1e-3)}


def _outside_replaced(f, other, keep):
    """``f`` with every value outside the kept window replaced by
    ``other``'s. ``keep[name]`` = (row0, row1, col0, col1), half-open, the
    columns taken round the ring."""
    out = {}
    for name, t in f.items():
        r0, r1, c0, c1 = keep[name]
        rows, naz = t.shape
        mask = torch.zeros(t.shape, dtype=torch.bool)
        cols = torch.remainder(torch.arange(c0, c1), naz)
        mask[max(r0, 0):min(r1, rows), cols] = True
        out[name] = torch.where(mask, t, other[name])
    return out


def _tiles(nr, naz, th, tw):
    """Output tiles (i0, i1, j0, j1) that cover rows 0..NR (vrad has NR+1)
    and every column."""
    return [(i0, min(i0 + th, nr + 1), j0, min(j0 + tw, naz))
            for i0 in range(0, nr + 1, th) for j0 in range(0, naz, tw)]


def _on_tile(t, tile):
    i0, i1, j0, j1 = tile
    return t[i0:min(i1, t.shape[0]), j0:j1]


def _vk_window(tile, below=2, above=2, before=2, after=2):
    """What the viscous-kick block of ``tile`` loads: every field's rows
    i0-below..i1+above-1 and columns j0-before..j1+after-1."""
    i0, i1, j0, j1 = tile
    box = (i0 - below, i1 + above, j0 - before, j1 + after)
    return {name: box for name in ("sigma", "vrad", "vaz", "energy")}


def _vk(ctx, f, compress=True, want_cs=False):
    return K.viscous_kick_plain(ctx, f["sigma"], f["vrad"], f["vaz"],
                                f["energy"], T(0.003), T(0.7), compress,
                                want_cs)


@pytest.mark.parametrize("nr,naz,th,tw", [(20, 24, 8, 8), (13, 10, 4, 6),
                                          (9, 3, 4, 4)])
@pytest.mark.parametrize("eos_name", ["adiabatic", "isothermal"])
@pytest.mark.parametrize("artvisc", ["sn", "tw", "none"])
def test_viscous_kick_window_equals_whole_grid(artvisc, eos_name, nr, naz,
                                               th, tw):
    """Every tile: both ghost rings, the column seam, ragged last tiles
    (13x10 in tiles of 4x6) and a ring of 3 cells, shorter than the halo."""
    ctx = _ctx(nr, naz, eos=eos_name, artificial_viscosity=artvisc)
    f, other = _fields(1, nr, naz), _fields(2, nr, naz)
    whole = _vk(ctx, f)
    for tile in _tiles(nr, naz, th, tw):
        got = _vk(ctx, _outside_replaced(f, other, _vk_window(tile)))
        for name, a, b in zip(VK_OUT, got, whole):
            assert torch.equal(_on_tile(a, tile), _on_tile(b, tile)), \
                (name, tile)


@pytest.mark.parametrize("nr,naz,th,tw", [(20, 24, 8, 8), (13, 10, 4, 6),
                                          (9, 3, 4, 4)])
@pytest.mark.parametrize("artvisc", ["sn", "tw", "none"])
def test_viscous_kick_window_with_the_in_kick_sound_speed(artvisc, nr, naz,
                                                          th, tw):
    """With ``want_cs`` the sixth output, the in-kick sound speed, is a
    value of the tile too, and the other five are unchanged."""
    ctx = _ctx(nr, naz, artificial_viscosity=artvisc)
    f, other = _fields(1, nr, naz), _fields(2, nr, naz)
    whole = _vk(ctx, f, want_cs=True)
    assert len(whole) == 6
    for a, b in zip(whole[:5], _vk(ctx, f)):
        assert torch.equal(a, b)
    for tile in _tiles(nr, naz, th, tw):
        got = _vk(ctx, _outside_replaced(f, other, _vk_window(tile)),
                  want_cs=True)
        for name, a, b in zip(VK_OUT + ("cs",), got, whole):
            assert torch.equal(_on_tile(a, tile), _on_tile(b, tile)), \
                (name, tile)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("dissipation", [True, False])
def test_viscous_kick_window_other_branches(dissipation, compress):
    """Constant viscosity, no dissipation, no compression heating, no
    viscous heating and no cooling: the same window serves."""
    ctx = _ctx(20, 24, artificial_viscosity_dissipation=dissipation,
               viscous_alpha=0.0, constant_viscosity=1e-5,
               heating_viscous=dissipation,
               cooling_beta_enabled=not dissipation)
    f, other = _fields(3, 20, 24), _fields(4, 20, 24)
    whole = _vk(ctx, f, compress)
    for tile in _tiles(20, 24, 8, 8):
        got = _vk(ctx, _outside_replaced(f, other, _vk_window(tile)),
                  compress)
        for name, a, b in zip(VK_OUT, got, whole):
            assert torch.equal(_on_tile(a, tile), _on_tile(b, tile)), \
                (name, tile)


@pytest.mark.parametrize("side", ["below", "above", "before", "after"])
@pytest.mark.parametrize("artvisc", ["sn", "tw"])
def test_viscous_kick_window_one_cell_narrower_differs(artvisc, side):
    """The halo is no wider than it must be: with one cell less on any side
    a value on an interior tile changes."""
    ctx = _ctx(20, 24, artificial_viscosity=artvisc)
    f, other = _fields(1, 20, 24), _fields(2, 20, 24)
    whole = _vk(ctx, f)
    tile = (8, 16, 8, 16)
    got = _vk(ctx, _outside_replaced(f, other, _vk_window(tile, **{side: 1})))
    assert not all(torch.equal(_on_tile(a, tile), _on_tile(b, tile))
                   for a, b in zip(got, whole))


def test_viscous_kick_without_artificial_viscosity_needs_less():
    """Without the artificial pressures the chain is one stencil shorter
    below and before the tile. Above and after it the second cell stays:
    the neighbours' nu comes from their energy after the compression
    heating, which reads vrad a row up and vaz a column on. Without the
    compression heating one cell serves all round."""
    ctx = _ctx(20, 24, artificial_viscosity="none")
    f, other = _fields(1, 20, 24), _fields(2, 20, 24)
    tile = (8, 16, 8, 16)
    for halo, compress, same in (((1, 2, 1, 2), True, True),
                                 ((1, 1, 1, 1), True, False),
                                 ((1, 1, 1, 1), False, True),
                                 ((0, 1, 0, 1), False, False)):
        whole = _vk(ctx, f, compress)
        got = _vk(ctx, _outside_replaced(f, other, _vk_window(tile, *halo)),
                  compress)
        assert all(torch.equal(_on_tile(a, tile), _on_tile(b, tile))
                   for a, b in zip(got, whole)) is same, (halo, compress)


def _bodies():
    """A star and two planets inside the grid, each with a cubic smoothing
    radius that reaches some cells."""
    return BodiesOnGrid(x=T([0.0, 1.0, -0.4]), y=T([0.0, 0.3, 1.1]),
                        mass=T([1.0, 1e-3, 3e-4]),
                        cubic_smoothing_radius=T([0.0, 0.3, 0.2]))


def _src(ctx, f):
    return K.sources_plain(ctx, f["sigma"], f["vrad"], f["vaz"], f["energy"],
                           _bodies(), (T(1e-3), T(-2e-3)), T(0.4), T(0.003),
                           f.get("h_smooth"))


def _src_window(tile, halo=1):
    """What the sources block of ``tile`` reads: sigma, energy and the
    smoothing plane on the tile, a row below and a column before; vaz a row
    below and a column after; vrad on the tile alone."""
    i0, i1, j0, j1 = tile
    return {"sigma": (i0 - halo, i1, j0 - halo, j1),
            "energy": (i0 - halo, i1, j0 - halo, j1),
            "h_smooth": (i0 - halo, i1, j0 - halo, j1),
            "vaz": (i0 - halo, i1, j0, j1 + halo),
            "vrad": (i0, i1, j0, j1)}


@pytest.mark.parametrize("nr,naz,th,tw", [(20, 24, 8, 8), (13, 10, 4, 6),
                                          (9, 1, 4, 4)])
@pytest.mark.parametrize("planetloc", [False, True])
@pytest.mark.parametrize("eos_name", ["adiabatic", "isothermal"])
def test_sources_window_equals_whole_grid(eos_name, planetloc, nr, naz, th,
                                          tw):
    """Every tile, three bodies, both smoothing modes; a ring of one cell is
    its own neighbour."""
    ctx = _ctx(nr, naz, eos=eos_name,
               compatibility_smoothing_planetloc=planetloc,
               compatibility_no_star_smoothing=planetloc)
    f, other = _fields(5, nr, naz), _fields(6, nr, naz)
    whole = _src(ctx, f)
    cell_x, cell_y = ctx.cell_xy()
    d = torch.sqrt((cell_x - 1.0) ** 2 + (cell_y - 0.3) ** 2)
    if (nr, naz) == (20, 24):
        assert bool((d < 0.3).any()), "no cell inside a cubic radius"
    for tile in _tiles(nr, naz, th, tw):
        got = _src(ctx, _outside_replaced(f, other, _src_window(tile)))
        for name, a, b in zip(("vrad", "vaz"), got, whole):
            assert torch.equal(_on_tile(a, tile), _on_tile(b, tile)), \
                (name, tile)


@pytest.mark.parametrize("nr,naz,th,tw", [(20, 24, 8, 8), (13, 10, 4, 6),
                                          (9, 1, 4, 4)])
def test_sources_window_with_a_smoothing_plane(nr, naz, th, tw):
    """A smoothing plane ``h_smooth`` (the leapfrog's stale scale height)
    is read on the cells of sigma; it changes the kicks."""
    ctx = _ctx(nr, naz)
    rng = np.random.default_rng(7)
    f, other = _fields(5, nr, naz), _fields(6, nr, naz)
    f["h_smooth"] = T(rng.random((nr, naz)) * 0.05 + 0.02)
    other["h_smooth"] = T(rng.random((nr, naz)) * 0.05 + 0.02)
    whole = _src(ctx, f)
    plain = _src(ctx, {k: v for k, v in f.items() if k != "h_smooth"})
    assert not all(torch.equal(a, b) for a, b in zip(whole, plain))
    for tile in _tiles(nr, naz, th, tw):
        got = _src(ctx, _outside_replaced(f, other, _src_window(tile)))
        for name, a, b in zip(("vrad", "vaz"), got, whole):
            assert torch.equal(_on_tile(a, tile), _on_tile(b, tile)), \
                (name, tile)


def test_sources_window_without_halo_differs():
    ctx = _ctx(20, 24)
    f, other = _fields(5, 20, 24), _fields(6, 20, 24)
    whole = _src(ctx, f)
    tile = (8, 16, 8, 16)
    got = _src(ctx, _outside_replaced(f, other, _src_window(tile, halo=0)))
    for a, b in zip(got, whole):        # both kicks reach into the halo
        assert not torch.equal(_on_tile(a, tile), _on_tile(b, tile))
