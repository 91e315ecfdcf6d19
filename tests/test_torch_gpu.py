"""The CUDA kernels of fargocpt_torch against their plain PyTorch versions
on the same GPU tensors, at a ragged 130x200 float64 grid, with the
tolerances of tests/test_torch_kernels.py (rtol 1e-12 cfl, 1e-11 sources
and transport, 1e-10 viscous kick), rtol 1e-11 for the split route's two
kernels and rtol 1e-12 for artvisc_sn (also in float32: 1e-5 of each
output's largest magnitude) and for the staged route's radial_sweep and
theta_sweep (advect_shift bit for bit); the transport routes and the roll
also at shapes that cross the edges of the whole-transport kernel's tiles
and of the roll's 16-byte vectors, in both dtypes; the viscous kick and the
sources at shapes that cross every edge of their tiles, in both
dtypes and every branch, on a side stream, and with the device launches of
a call counted (the kernel and nothing else); cfl, theta_sweep and
fargo_theta at shapes that cross every edge of their ring blocks and tiles
(NR = 3, rings of 1 and 7 cells, NAZ below and above a tile and around the
size up to which cfl keeps a ring in shared memory, K = 1, 2, 5, 6 and 9),
in both dtypes, cfl with planted NaN and zero-energy cells, each launching
its one kernel and nothing else; radial_momenta_sweep (both EoS) and
radial_sweep (K = 1, 2, 5, 6) at shapes that cross every edge of the
radial column march's strips and blocks (RADIAL_SHAPES), both limiters,
both dtypes; the sources with a smoothing plane
and with 513 bodies, the viscous kick with its in-kick sound speed,
ias15 with 17 and 40 bodies (a device workspace) bit for bit;
bodies_on_grid against its plain ATen chain bit for bit (2 to 513 bodies,
every ramp, cubic and time form) and PDS 70's Euler planet step through
it bit for bit; a
split-route and a staged-route Simulation step through their kernels,
a leapfrog planet_torque step (sources and viscous_kick twice, ias15
four times), a planet_accretion step (the leapfrog in the corotating
frame with a Kley-accreting planet and the monitor grids: sources once,
viscous_kick twice, ias15 four times) and a setups/star_planet.yml step
(Euler, corotating), setups/CloseBinaries/OY_Car.yml (cfl, sources,
artvisc_sn, the transport, ias15 twice) and setups/V1504Cyg.yml (the
transport, ias15 four times) steps, and the Roche-lobe stream, each
against the CPU, a PDS70 gas step through artvisc_sn
and the whole transport, and the whole PDS70 setup with its dust swarm on
the device against the same run on the CPU; the output written from card
tensors against the CPU writer's bytes, and a restart on the card bit for
bit; the long tail: the quickstart with Bessel-kernel self-gravity
(artvisc_sn and the transport once, ias15 twice), examples/full_physics.yml
with its diffusing swarm on one shared draw (cfl, sources, artvisc_sn, the
transport), the polytropic flagship in both dtypes, Disk: no (ias15 only;
the FLD-only disk no kernel), the PVTE shock tube on lookup tables built on
the card, RandomSigma, CentrifugalBalance and the secondary's disk, each
against the CPU, and the NaN trap on the card; the radial decomposition
(``fargocpt_torch.parallel``): two gloo ranks sharing the card, their
host-staged collectives against the CPU ranks' and a sharded flagship
step against the single-process one, and NCCL refused on one card.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one. This file imports no JAX, so it runs on a GPU host that has none:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from fargocpt_torch import telemetry
from fargocpt_torch.config import Config
from fargocpt_torch.constants import Constants
from fargocpt_torch.flagship import FLAGSHIP, pds70, pds70_gas
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import gravity, kernels, transport
from fargocpt_torch.params import Physics
from fargocpt_torch.profile_ops import RADIAL_SHAPES, radial_calls, \
    radial_inputs
from fargocpt_torch.sim import Simulation, reachable_tensors
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR, NAZ = 130, 200


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda")


def _ctx(kw, device, nr=NR, naz=NAZ, dtype=torch.float64):
    geom = Geometry.build(nr, naz, 0.4, 2.5, "Log")
    return kernels.KernelContext(Physics(**kw), Constants.from_units(Units()),
                                 geom, dtype, device)


def _fields(seed, device, nr=NR, naz=NAZ, dtype=torch.float64,
            floor_cells=False):
    rng = np.random.default_rng(seed)
    sigma = rng.random((nr, naz)) + 0.5
    if floor_cells:
        sigma[nr // 3, 3:7] = 5e-6
    f = dict(sigma=sigma,
             energy=rng.random((nr, naz)) * 1e-3 + 1e-3,
             vaz=(rng.random((nr, naz)) - 0.5) * 0.1 + 1.0,
             vrad=(rng.random((nr + 1, naz)) - 0.5) * 0.05,
             qplus=rng.random((nr, naz)) * 1e-6,
             qminus=rng.random((nr, naz)) * 1e-6)
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in f.items()}


def _one(v, device):
    return torch.tensor(v, dtype=torch.float64, device=device)


def _close(got, ref, rtol, atols):
    for g, r, atol in zip(got, ref, atols):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("adiabatic,sn", [(True, True), (False, False)])
def test_cfl_kernel_matches_plain(cuda, adiabatic, sn):
    ctx = _ctx(dict(eos="adiabatic" if adiabatic else "isothermal",
                    adiabatic_index=1.4, viscous_alpha=1e-3,
                    aspectratio_ref=0.05,
                    artificial_viscosity="sn" if sn else "tw"), cuda)
    f = _fields(2, cuda)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], f["qplus"],
            f["qminus"])
    before = telemetry.value("launch.cfl")
    got = kernels.cfl(ctx, *args)
    assert telemetry.value("launch.cfl") == before + 1
    np.testing.assert_allclose(float(got),
                               float(kernels.cfl_plain(ctx, *args)),
                               rtol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("adiabatic", [True, False])
def test_sources_kernel_matches_plain(cuda, adiabatic):
    ctx = _ctx(dict(eos="adiabatic" if adiabatic else "isothermal",
                    adiabatic_index=1.4, thickness_smoothing=0.6,
                    aspectratio_ref=0.05, imposed_disk_drift=1e-4), cuda)
    f = _fields(5, cuda)
    bodies = gravity.BodiesOnGrid(
        x=_one([0.0, 1.0], cuda), y=_one([0.0, 0.3], cuda),
        mass=_one([1.0, 1e-3], cuda),
        cubic_smoothing_radius=_one([0.0, 0.05], cuda))
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], bodies,
            (_one(1e-5, cuda), _one(-2e-5, cuda)), _one(0.4, cuda),
            _one(0.003, cuda))
    _close(kernels.sources(ctx, *args), kernels.sources_plain(ctx, *args),
           1e-11, (1e-13, 1e-13))


@pytest.mark.gpu
@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("artvisc_on", ["sn", "tw", "none"])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_viscous_kick_kernel_matches_plain(cuda, compress, artvisc_on,
                                           adiabatic):
    ctx = _ctx(dict(eos="adiabatic" if adiabatic else "isothermal",
                    adiabatic_index=1.4, viscous_alpha=1e-3,
                    aspectratio_ref=0.05, flaring_index=0.25,
                    artificial_viscosity=artvisc_on,
                    artificial_viscosity_dissipation=True,
                    heating_viscous=True, cooling_beta_enabled=True,
                    cooling_beta=10.0, minimum_temperature=1e-6, sigma0=1.0,
                    sigma_floor=1e-6), cuda)
    f = _fields(11, cuda, floor_cells=True)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], _one(0.003, cuda),
            0.0)
    _close(kernels.viscous_kick(ctx, *args, compress=compress),
           kernels.viscous_kick_plain(ctx, *args, compress=compress),
           1e-10, (1e-13, 1e-13, 1e-16, 1e-18, 1e-18))


# Shapes that cross every edge of the viscous kick's and the sources' tiles
# (16 rows x 64 columns of outputs both; the row tiles cover NR + 1 rows
# of vrad): NR and NAZ one under, on and one over a tile, several tiles
# with a ragged last one, NR = 4 (only ghost rings and one face), rings of
# 1 and 3 cells (shorter than the viscous kick's halo of 2 each way).
KICK_SHAPES = [(4, 1), (4, 3), (15, 63), (16, 64), (17, 65), (31, 64),
               (32, 65), (33, 130), (130, 200)]

VK_PHYS = dict(adiabatic_index=1.4, viscous_alpha=1e-3, aspectratio_ref=0.05,
               flaring_index=0.25, artificial_viscosity_dissipation=True,
               heating_viscous=True, cooling_beta_enabled=True,
               cooling_beta=10.0, minimum_temperature=1e-6, sigma0=1.0,
               sigma_floor=1e-6)


# Shapes that cross every edge of cfl's ring blocks (one block of 256
# threads a ring, rings 0..NR-2; the ring's vaz in shared memory up to
# 40 KB, 10240 cells in float32 and 5120 in float64): NR = 3 (one active
# ring, one ring pair), rings of 1 and 7 cells, NAZ under and over the
# block's 256 threads and on and over the shared-memory limit of each dtype.
CFL_SHAPES = [(3, 1), (3, 7), (20, 7), (37, 1030), (6, 255), (6, 257),
              (4, 5120), (4, 5121), (3, 10240), (3, 10241)]


def _cfl_fields(nr, naz, dtype, device, plant):
    f = _fields(29, device, nr, naz, dtype)
    i = nr - 2                      # the last active ring
    if plant == "nan":
        f["sigma"][i, naz // 2] = float("nan")
    elif plant == "zero_energy":
        # an infinite inverse dt from the heating term: dt = 0
        f["energy"][i, naz - 1] = 0.0
    return f


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("plant", ["none", "nan", "zero_energy"])
@pytest.mark.parametrize("nr,naz", CFL_SHAPES)
@pytest.mark.parametrize("fast", [True, False])
def test_cfl_kernel_across_tile_edges(cuda, fast, nr, naz, plant, dtype):
    """float64 at rtol 1e-12; float32 at 1e-5; a NaN carried through, a
    zero-energy cell giving dt = 0 in both."""
    ctx = _ctx(dict(eos="adiabatic", adiabatic_index=1.4, viscous_alpha=1e-3,
                    aspectratio_ref=0.05, artificial_viscosity="sn",
                    fast_transport=fast), cuda, nr, naz, dtype)
    f = _cfl_fields(nr, naz, dtype, cuda, plant)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], f["qplus"],
            f["qminus"])
    before = telemetry.value("launch.cfl")
    got = kernels.cfl(ctx, *args)
    assert telemetry.value("launch.cfl") == before + 1
    ref = kernels.cfl_plain(ctx, *args)
    assert got.shape == ref.shape == () and got.dtype == dtype
    if plant == "nan":
        assert bool(torch.isnan(got))
    elif plant == "zero_energy":
        assert float(got) == 0.0
    np.testing.assert_allclose(float(got), float(ref),
                               rtol=1e-12 if dtype == torch.float64
                               else 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cfl_counter_resets_between_calls_and_streams(cuda, dtype):
    """The kernel's last block sets its counter back to 0: calls in a row
    on different grids' fields give what fresh contexts give, on the
    default stream and on another one (which keeps a counter of its own)."""
    kw = dict(eos="adiabatic", adiabatic_index=1.4, viscous_alpha=1e-3,
              aspectratio_ref=0.05, artificial_viscosity="sn")
    kept = _ctx(kw, cuda, 37, 1030, dtype)

    def call(ctx, seed):
        f = _fields(seed, cuda, 37, 1030, dtype)
        return kernels.cfl(ctx, f["sigma"], f["vrad"], f["vaz"],
                           f["energy"], f["qplus"], f["qminus"])

    firsts = [call(kept, seed) for seed in (3, 5, 7)]
    for seed, got in zip((3, 5, 7), firsts):
        assert torch.equal(got, call(_ctx(kw, cuda, 37, 1030, dtype), seed))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = call(kept, 5)
    side.synchronize()
    assert torch.equal(again, firsts[1])
    counters = [t for key, t in kept._scratch.items() if key[0] == "cfl"]
    assert len(counters) == 2
    assert all(int(t) == 0 for t in counters)


# Shapes that cross every edge of the azimuthal ring tiles of theta_sweep
# and fargo_theta (a block holds 512 cells in float32, 256 in float64: 508
# and 252 output cells with one sweep, 504 and 248 with two, and a halo of
# 2 cells a sweep each way): NR = 3, rings of 1 and 7 cells (shorter than
# the halo), NAZ under and over a tile of either dtype and sweep count, a
# ring of several tiles with a ragged last one.
THETA_SHAPES = [(3, 1), (3, 7), (20, 7), (37, 1030), (4, 247), (4, 253),
                (4, 503), (4, 509)]
THETA_OPS = ("theta_sweep", "fargo_theta_one", "fargo_theta_two")


def _theta_inputs(nr, naz, k_quant, dtype, device, seed=37):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    qs = t(rng.random((k_quant, nr, naz)) + 0.5)
    v = t((rng.random((nr, naz)) - 0.5) * 0.05)
    vconst = t((rng.random((nr, 1)) - 0.5) * 0.02)
    nshift = rng.integers(-2 * naz - 3, 2 * naz + 3, nr)
    nshift[:3] = [0, -1, naz + 2][:nr]
    return qs, v, vconst, torch.tensor(nshift, dtype=torch.int32,
                                       device=device)


def _theta_call(op, ctx, qs, v, vconst, nshift, dt, plain=False):
    if op == "theta_sweep":
        fn = kernels.theta_sweep_plain if plain else kernels.theta_sweep
        return fn(ctx, qs, v, dt)
    fn = kernels.fargo_theta_plain if plain else kernels.fargo_theta
    return fn(ctx, qs, v, vconst, nshift, dt, op == "fargo_theta_two")


def _close_batch(got, ref, dtype):
    """float64 at rtol 1e-11; float32 at 1e-5 of each plane's largest
    magnitude."""
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    if dtype == torch.float64:
        _close([got], [ref], 1e-11, [1e-13 * float(ref.abs().max())])
    else:
        for k in range(ref.shape[0]):
            _close([got[k]], [ref[k]], 0.0,
                   [1e-5 * float(ref[k].abs().max())])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("k_quant", [1, 2, 5, 6])
@pytest.mark.parametrize("nr,naz", THETA_SHAPES)
@pytest.mark.parametrize("op", THETA_OPS)
def test_theta_ops_across_tile_edges(cuda, op, nr, naz, k_quant, limiter,
                                     dtype):
    """One sweep without the roll (theta_sweep), one and two sweeps with
    it (fargo_theta), shifts of either sign and beyond one turn."""
    ctx = _ctx(dict(flux_limiter_type=limiter), cuda, nr, naz, dtype)
    args = _theta_inputs(nr, naz, k_quant, dtype, cuda)
    dt = torch.tensor(0.01, dtype=dtype, device=cuda)
    name = op[:11]
    before = telemetry.value("launch." + name)
    got = _theta_call(op, ctx, *args, dt)
    assert telemetry.value("launch." + name) == before + 1
    _close_batch(got, _theta_call(op, ctx, *args, dt, plain=True), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op", THETA_OPS)
def test_theta_ops_take_a_batch_beyond_48_kb_of_shared_memory(cuda, op,
                                                              dtype):
    """K = 9: a tile of 512 (256) cells needs more shared memory than a
    block gets unasked; the kernel asks for it."""
    ctx = _ctx({}, cuda, 6, 1030, dtype)
    args = _theta_inputs(6, 1030, 9, dtype, cuda)
    dt = torch.tensor(0.01, dtype=dtype, device=cuda)
    _close_batch(_theta_call(op, ctx, *args, dt),
                 _theta_call(op, ctx, *args, dt, plain=True), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op", THETA_OPS)
def test_theta_ops_allocate_only_their_output(cuda, op, dtype):
    """No scratch batch: a call's peak allocation is its output."""
    ctx = _ctx({}, cuda, 37, 1030, dtype)
    args = _theta_inputs(37, 1030, 6, dtype, cuda)
    dt = torch.tensor(0.01, dtype=dtype, device=cuda)
    _theta_call(op, ctx, *args, dt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = _theta_call(op, ctx, *args, dt)
    torch.cuda.synchronize()
    out_bytes = -(-out.numel() * out.element_size() // 512) * 512
    assert torch.cuda.max_memory_allocated() - before == out_bytes


def _close_by_dtype(got, ref, dtype, rtol, atols, scales):
    """float64 at ``rtol`` / ``atols``; float32 at 1e-5 of each output's
    scale."""
    if dtype == torch.float64:
        _close(got, ref, rtol, atols)
    else:
        _close(got, ref, 0.0, [1e-5 * sc for sc in scales])


def _vk_scales(f, ref):
    """The velocities' scale is max|vaz|, or the output's own where the
    kick on a near-floor cell (sigma 5e-6) makes it hundreds of that; the
    other outputs' is their own."""
    v = float(f["vaz"].abs().max())
    return [max(v, float(r.abs().max())) for r in ref[:2]] \
        + [max(float(r.abs().max()), 1e-30) for r in ref[2:]]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nr,naz", KICK_SHAPES)
@pytest.mark.parametrize("artvisc_on", ["sn", "tw"])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_viscous_kick_kernel_across_tile_edges(cuda, adiabatic, artvisc_on,
                                               nr, naz, dtype):
    ctx = _ctx(dict(VK_PHYS, eos="adiabatic" if adiabatic else "isothermal",
                    artificial_viscosity=artvisc_on), cuda, nr, naz, dtype)
    f = _fields(11, cuda, nr, naz, dtype, floor_cells=naz >= 7)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"],
            torch.tensor(0.003, dtype=dtype, device=cuda), 0.0)
    before = telemetry.value("launch.viscous_kick")
    got = kernels.viscous_kick(ctx, *args)
    assert telemetry.value("launch.viscous_kick") == before + 1
    ref = kernels.viscous_kick_plain(ctx, *args)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
    _close_by_dtype(got, ref, dtype, 1e-10,
                    (1e-13, 1e-13, 1e-16, 1e-18, 1e-18), _vk_scales(f, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("branch", [
    dict(artificial_viscosity_dissipation=False),
    dict(heating_viscous=False),
    dict(cooling_beta_enabled=False),
    dict(viscous_alpha=0.0, constant_viscosity=1e-5),
    dict(artificial_viscosity="none"),
    dict(artificial_viscosity="tw", artificial_viscosity_dissipation=False),
    dict(cooling_beta_ramp_up=5.0),
])
@pytest.mark.parametrize("compress", [True, False])
def test_viscous_kick_kernel_branches(cuda, compress, branch, dtype):
    """Every switch of the op off once, on a grid of several tiles; with
    the cooling ramp 1/beta is a tensor of the time, read on the device."""
    ctx = _ctx(dict(VK_PHYS, eos="adiabatic", artificial_viscosity="sn")
               | branch, cuda, 33, 130, dtype)
    f = _fields(11, cuda, 33, 130, dtype, floor_cells=True)
    time = torch.tensor(1.5, dtype=dtype, device=cuda)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"],
            torch.tensor(0.003, dtype=dtype, device=cuda), time)
    got = kernels.viscous_kick(ctx, *args, compress=compress)
    ref = kernels.viscous_kick_plain(ctx, *args, compress=compress)
    _close_by_dtype(got, ref, dtype, 1e-10,
                    (1e-13, 1e-13, 1e-16, 1e-18, 1e-18), _vk_scales(f, ref))
    if "cooling_beta_ramp_up" in branch:
        # the same ramp at a float time: 1/beta as a static parameter
        again = kernels.viscous_kick(ctx, *args[:5], 1.5, compress=compress)
        _close_by_dtype(again, ref, dtype, 1e-10,
                        (1e-13, 1e-13, 1e-16, 1e-18, 1e-18),
                        _vk_scales(f, ref))


def _planets(n_bodies, device):
    """A star and one or two planets inside the grid, each planet with a
    cubic smoothing radius that reaches some cells."""
    return gravity.BodiesOnGrid(
        x=_one([0.0, 1.0, -0.4][:n_bodies], device),
        y=_one([0.0, 0.3, 1.1][:n_bodies], device),
        mass=_one([1.0, 1e-3, 3e-4][:n_bodies], device),
        cubic_smoothing_radius=_one([0.0, 0.3, 0.2][:n_bodies], device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nr,naz", KICK_SHAPES)
@pytest.mark.parametrize("n_bodies,planetloc", [(2, False), (3, False),
                                                (3, True)])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_sources_kernel_across_tile_edges(cuda, adiabatic, n_bodies,
                                          planetloc, nr, naz, dtype):
    """Two and three bodies with cubic smoothing radii inside the grid,
    eps*H per cell or the scalar eps*h at the planet (no smoothing for the
    star)."""
    ctx = _ctx(dict(eos="adiabatic" if adiabatic else "isothermal",
                    adiabatic_index=1.4, thickness_smoothing=0.6,
                    aspectratio_ref=0.05, flaring_index=0.25,
                    imposed_disk_drift=1e-4,
                    compatibility_smoothing_planetloc=planetloc,
                    compatibility_no_star_smoothing=planetloc), cuda, nr, naz,
               dtype)
    f = _fields(5, cuda, nr, naz, dtype)
    bodies = _planets(n_bodies, cuda)
    if (nr, naz) == (130, 200):
        cell_x, cell_y = ctx.cell_xy()
        d = torch.sqrt((cell_x - 1.0) ** 2 + (cell_y - 0.3) ** 2)
        assert bool((d < 0.3).any())
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], bodies,
            (_one(1e-3, cuda), _one(-2e-3, cuda)), _one(0.4, cuda),
            torch.tensor(0.003, dtype=dtype, device=cuda))
    before = telemetry.value("launch.sources")
    got = kernels.sources(ctx, *args)
    assert telemetry.value("launch.sources") == before + 1
    ref = kernels.sources_plain(ctx, *args)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
    v = float(f["vaz"].abs().max())
    _close_by_dtype(got, ref, dtype, 1e-11, (1e-13, 1e-13), [v, v])


def _step_like_args(ctx, f, dtype, device):
    """The two ops' arguments as the step hands them over: dt, the time and
    the frame rate 0-d tensors of the field type, the indirect terms and
    the bodies in float64."""
    dt = torch.tensor(0.003, dtype=dtype, device=device)
    fields = (f["sigma"], f["vrad"], f["vaz"], f["energy"])
    zero = _one(0.0, device)
    return {"viscous_kick": (ctx, *fields, dt,
                             torch.tensor(0.5, dtype=dtype, device=device)),
            "sources": (ctx, *fields, _planets(2, device), (zero, zero),
                        torch.tensor(0.4, dtype=dtype, device=device), dt)}


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["viscous_kick", "sources"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kick_ops_on_a_side_stream(cuda, dtype, op):
    """A call on a stream other than the default one gives bit for bit
    what the default stream gives."""
    ctx = _ctx(dict(VK_PHYS, eos="adiabatic", artificial_viscosity="sn",
                    thickness_smoothing=0.6), cuda, 33, 130, dtype)
    f = _fields(23, cuda, 33, 130, dtype)
    args = _step_like_args(ctx, f, dtype, cuda)[op]
    fn = getattr(kernels, op)
    ref = fn(*args)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = fn(*args)
    side.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _device_activity(fn, args, calls=5):
    """What ``calls`` calls of ``fn`` asked of the device (every launch,
    copy and fill the host requested) and the names of the device kernels
    that ran (the profiler now and then drops one of these)."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    asked = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU
             and ("LaunchKernel" in e.name or "Memcpy" in e.name
                  or "Memset" in e.name)]
    # the device-side annotations of the port's spans (``fc:``, on while
    # the profiler records) are not work the call asked of the device
    ran = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("fc:")]
    return asked, ran


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["viscous_kick", "sources"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kick_ops_launch_their_kernel_and_nothing_else(cuda, dtype, op):
    """With the arguments the step gives them the wrappers pack nothing:
    the only device activity of a call is the op's one kernel (the output
    allocations launch nothing)."""
    ctx = _ctx(dict(VK_PHYS, eos="adiabatic", artificial_viscosity="sn",
                    thickness_smoothing=0.6), cuda, 33, 130, dtype)
    f = _fields(23, cuda, 33, 130, dtype)
    args = _step_like_args(ctx, f, dtype, cuda)[op]
    calls = 5
    asked, ran = _device_activity(getattr(kernels, op), args, calls)
    assert len(asked) == calls and all("LaunchKernel" in n for n in asked), \
        asked
    fragment = {"viscous_kick": "vk_tile_kernel",
                "sources": "sources_kernel"}[op]
    assert 1 <= len(ran) <= calls and all(fragment in n for n in ran), ran


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["cfl", *THETA_OPS])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cfl_and_theta_ops_launch_one_kernel_and_nothing_else(cuda, dtype,
                                                              op):
    """With the arguments the step gives them (dt a 0-d tensor of the
    field type) cfl, theta_sweep and fargo_theta with either two_pass make
    one launch a call, of their own kernel, and no copy or fill."""
    ctx = _ctx(dict(eos="adiabatic", adiabatic_index=1.4,
                    viscous_alpha=1e-3, aspectratio_ref=0.05,
                    artificial_viscosity="sn"), cuda, 33, 130, dtype)
    dt = torch.tensor(0.003, dtype=dtype, device=cuda)
    if op == "cfl":
        f = _fields(23, cuda, 33, 130, dtype)
        fn, args = kernels.cfl, (ctx, f["sigma"], f["vrad"], f["vaz"],
                                 f["energy"], f["qplus"], f["qminus"])
    else:
        qs, v, vconst, nshift = _theta_inputs(33, 130, 6, dtype, cuda)
        fn = lambda: _theta_call(op, ctx, qs, v, vconst, nshift, dt)  # noqa
        args = ()
    calls = 5
    asked, ran = _device_activity(fn, args, calls)
    assert len(asked) == calls and all("LaunchKernel" in n for n in asked), \
        asked
    fragment = "cfl_ring_kernel" if op == "cfl" else "theta_ring_kernel"
    assert 1 <= len(ran) <= calls and all(fragment in n for n in ran), ran


# Shapes that cross every edge of the whole-transport kernel's tiles (the
# radial stage marches up strips of 16 rows in blocks of 128 columns; a ring
# block takes 512 cells in float32, 256 in float64, plus a halo of 9): NR on
# and off a multiple of 16, a ring shorter than a tile, one shorter than
# the halo, rings that leave a last tile of 3 and of 6 cells.
TRANSPORT_SHAPES = [(130, 200), (37, 7), (48, 1030), (20, 515)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("nr,naz", TRANSPORT_SHAPES)
@pytest.mark.parametrize("route", ["whole", "split", "staged"])
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_transport_kernel_matches_plain(cuda, adiabatic, fast, route, nr, naz,
                                        limiter, dtype):
    """Each route (the whole-transport kernel takes any NR) against the
    plain whole transport: K = 6 and 5, one and two azimuthal sweeps, both
    limiters, shifts of either sign and beyond one turn. float64 at rtol
    1e-11; float32 at 1e-5 of each output's scale (the velocities' is
    max|vaz|)."""
    ctx = _ctx(dict(eos="adiabatic" if adiabatic else "isothermal",
                    adiabatic_index=1.4, aspectratio_ref=0.05,
                    fast_transport=fast, flux_limiter_type=limiter), cuda,
               nr, naz, dtype)
    f = _fields(13, cuda, nr, naz, dtype)
    dt = torch.tensor(0.01, dtype=dtype, device=cuda)
    omega = _one(0.3, cuda)
    vmean, _, vconst = transport.fargo_shift(ctx.g, f["vaz"], dt)
    nshift = torch.tensor(
        np.random.default_rng(47).integers(-2 * naz, 2 * naz, nr),
        dtype=torch.int32, device=cuda)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], omega, dt,
            (vmean, nshift, vconst))
    before = telemetry.values("launch.", kernels.OPS)
    got = kernels.transport(ctx, *args, route=route)
    ops = {"whole": {"transport": 1},
           "split": {"radial_momenta_sweep": 1, "fargo_theta": 1},
           "staged": {"radial_sweep": 1, "theta_sweep": 2 if fast else 1,
                      "advect_shift": 1}}[route]
    assert {op: telemetry.value("launch." + op) - before[op]
            for op in kernels.OPS} == \
        {op: ops.get(op, 0) for op in kernels.OPS}
    ref = kernels.transport_plain(ctx, *args, route="whole")
    if dtype == torch.float64:
        _close(got, ref, 1e-11, (1e-14, 1e-13, 1e-13, 1e-14, 1e-15))
    else:
        v = float(f["vaz"].abs().max())
        scales = [float(ref[0].abs().max()), v, v, float(ref[3].abs().max()),
                  float(ref[4].abs().max())]
        _close(got, ref, 0.0, [1e-5 * sc for sc in scales])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_transport_scratch_leaks_nothing_between_calls(cuda, dtype):
    """The context keeps the whole-transport kernel's scratch: two calls in
    a row on different inputs give bit for bit what two fresh contexts
    give, and the second call reuses the first one's scratch."""
    kw = dict(eos="adiabatic", adiabatic_index=1.4, aspectratio_ref=0.05)
    dt, omega = torch.tensor(0.01, dtype=dtype, device=cuda), _one(0.3, cuda)

    def call(ctx, seed):
        f = _fields(seed, cuda, 48, 1030, dtype)
        return kernels.transport(ctx, f["sigma"], f["vrad"], f["vaz"],
                                 f["energy"], omega, dt, route="whole")

    kept = _ctx(kw, cuda, 48, 1030, dtype)
    first, second = call(kept, 53), call(kept, 59)
    assert len(kept._scratch) == 1
    for seed, got in ((53, first), (59, second)):
        ref = call(_ctx(kw, cuda, 48, 1030, dtype), seed)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    # on another stream the scratch is another pair
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        third = call(kept, 59)
    side.synchronize()
    assert len(kept._scratch) == 2
    for a, b in zip(third, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_radial_momenta_sweep_kernel_matches_plain(cuda, adiabatic, limiter):
    ctx = _ctx(dict(eos="adiabatic" if adiabatic else "isothermal",
                    adiabatic_index=1.4, aspectratio_ref=0.05,
                    flux_limiter_type=limiter), cuda)
    f = _fields(17, cuda)
    dt, omega = _one(0.01, cuda), _one(0.3, cuda)
    base = transport.sigma_flux(ctx.phys, ctx.g, f["sigma"], f["vrad"], dt)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], base, dt, omega)
    before = telemetry.value("launch.radial_momenta_sweep")
    got = kernels.radial_momenta_sweep(ctx, *args)
    assert telemetry.value("launch.radial_momenta_sweep") == before + 1
    ref = kernels.radial_momenta_sweep_plain(ctx, *args)
    assert got.shape == ref.shape == (6 if adiabatic else 5, NR, NAZ)
    _close([got], [ref], 1e-11, [1e-13 * float(ref.abs().max())])


@pytest.mark.gpu
@pytest.mark.parametrize("two_pass", [True, False])
@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("k_quant", [5, 6])
def test_fargo_theta_kernel_matches_plain(cuda, k_quant, limiter, two_pass):
    ctx = _ctx(dict(flux_limiter_type=limiter), cuda)
    rng = np.random.default_rng(19)
    qs = _one(rng.random((k_quant, NR, NAZ)) + 0.5, cuda)
    vres = _one((rng.random((NR, NAZ)) - 0.5) * 0.05, cuda)
    vconst = _one((rng.random((NR, 1)) - 0.5) * 0.02, cuda)
    # shifts of either sign, some beyond one turn of the ring
    nshift = torch.tensor(rng.integers(-2 * NAZ, 2 * NAZ, NR),
                          dtype=torch.int32, device=cuda)
    args = (qs, vres, vconst, nshift, _one(0.01, cuda), two_pass)
    before = telemetry.value("launch.fargo_theta")
    got = kernels.fargo_theta(ctx, *args)
    assert telemetry.value("launch.fargo_theta") == before + 1
    ref = kernels.fargo_theta_plain(ctx, *args)
    _close([got], [ref], 1e-11, [1e-13 * float(ref.abs().max())])


@pytest.mark.gpu
def test_split_route_step_launches_the_split_kernels(cuda):
    """A Simulation on the split route (named: every grid takes the whole
    route by itself) steps through radial_momenta_sweep and fargo_theta,
    never the whole transport."""
    cfg = Config.from_dict({
        "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
        "AspectRatio": "0.05", "ViscousAlpha": "0.001",
        "Sigma0": "200 g/cm2", "SigmaSlope": "0.5",
        "ArtificialViscosity": "SN", "Nrad": "40", "Naz": "128",
        "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Log",
        "InnerBoundary": "outflow", "OuterBoundary": "outflow",
        "Transport": "FARGO"})
    assert Simulation(cfg).stepper.ops.route == "whole"
    sim = Simulation(cfg, transport_route="split")
    assert sim.device.type == "cuda"
    assert sim.stepper.ops.route == "split"
    before = telemetry.values("launch.", kernels.OPS)
    sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    delta = {op: telemetry.value("launch." + op) - before[op]
             for op in kernels.OPS}
    assert delta == dict.fromkeys(kernels.OPS, 0) | {
        "cfl": 1, "sources": 1, "viscous_kick": 1,
        "radial_momenta_sweep": 1, "fargo_theta": 1}
    assert bool(torch.isfinite(sim.fields.sigma).all())


def _batch(seed, k_quant, device, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return (t(rng.random((k_quant, NR, NAZ)) + 0.5),
            t((rng.random((NR, NAZ)) - 0.5) * 0.05),
            t((rng.random((NR + 1, NAZ)) - 0.5) * 0.05))


@pytest.mark.gpu
@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("k_quant", [1, 5, 6])
def test_radial_sweep_kernel_matches_plain(cuda, k_quant, limiter):
    """Any K >= 1 and any contents: the divisor is a field of its own, not
    the batch's last entry."""
    ctx = _ctx(dict(flux_limiter_type=limiter), cuda)
    qs, _, vrad = _batch(29, k_quant, cuda)
    sigma = _batch(31, 1, cuda)[0][0]
    dt = _one(0.01, cuda)
    base = transport.sigma_flux(ctx.phys, ctx.g, sigma, vrad, dt)
    before = telemetry.value("launch.radial_sweep")
    got = kernels.radial_sweep(ctx, qs, sigma, vrad, base, dt)
    assert telemetry.value("launch.radial_sweep") == before + 1
    ref = kernels.radial_sweep_plain(ctx, qs, sigma, vrad, base, dt)
    _close([got], [ref], 1e-11, [1e-13 * float(ref.abs().max())])


# radial_sweep at K = 1 and 2 (one plane at a time), 5 and 6 (all at once);
# radial_momenta_sweep isothermal (K = 5) and adiabatic (K = 6)
RADIAL_CASES = [("radial_sweep", 1), ("radial_sweep", 2), ("radial_sweep", 5),
                ("radial_sweep", 6), ("radial_momenta_sweep", 5),
                ("radial_momenta_sweep", 6)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("nr,naz", RADIAL_SHAPES)
@pytest.mark.parametrize("op,k_quant", RADIAL_CASES)
def test_radial_ops_across_strip_edges(cuda, op, k_quant, nr, naz, limiter,
                                       dtype):
    """The column march across the edges of its strips of 16 rows and its
    blocks of 128 columns, vrad of both signs: one launch a call."""
    ctx = _ctx(dict(eos="isothermal" if k_quant == 5 else "adiabatic",
                    adiabatic_index=1.4, aspectratio_ref=0.05,
                    flux_limiter_type=limiter), cuda, nr, naz, dtype)
    kern, plain = radial_calls(
        ctx, radial_inputs(nr, naz, k_quant, dtype, cuda))[op]
    before = telemetry.value("launch." + op)
    got = kern()
    assert telemetry.value("launch." + op) == before + 1
    _close_batch(got, plain(), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("k_quant", [1, 5, 6])
def test_theta_sweep_kernel_matches_plain(cuda, k_quant, limiter):
    ctx = _ctx(dict(flux_limiter_type=limiter), cuda)
    qs, v, _ = _batch(37, k_quant, cuda)
    before = telemetry.value("launch.theta_sweep")
    got = kernels.theta_sweep(ctx, qs, v, _one(0.01, cuda))
    assert telemetry.value("launch.theta_sweep") == before + 1
    ref = kernels.theta_sweep_plain(ctx, qs, v, _one(0.01, cuda))
    _close([got], [ref], 1e-11, [1e-13 * float(ref.abs().max())])


def _shifts(nr, naz, device, seed=43):
    """Shifts of either sign and beyond one turn; the first ten rings take
    0, multiples of 4 and of 2, odd ones, whole turns."""
    nshift = np.random.default_rng(seed).integers(-2 * naz, 2 * naz, nr)
    nshift[:10] = [0, 4, -4, 1, -1, naz, naz + 3, -2 * naz - 2, 2, 3]
    return torch.tensor(nshift, dtype=torch.int32, device=device)


# NAZ on and off a multiple of the 16-byte vector (4 values in float32, 2
# in float64: 1030 and 202 take the vector kernel in float64 only, 7 and
# 515 the scalar kernel in both)
SHIFT_SHAPES = [(130, 200), (37, 7), (20, 515), (16, 1030), (24, 202)]


@pytest.mark.gpu
@pytest.mark.parametrize("nr,naz", SHIFT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k_quant", [1, 5, 6])
def test_advect_shift_kernel_equals_plain(cuda, k_quant, dtype, nr, naz):
    """Bit for bit, with shifts of either sign, on and off a multiple of
    the vector width, and beyond one turn."""
    rng = np.random.default_rng(41)
    qs = torch.tensor(rng.random((k_quant, nr, naz)), dtype=dtype,
                      device=cuda)
    nshift = _shifts(nr, naz, cuda)
    before = telemetry.value("launch.advect_shift")
    got = kernels.advect_shift(qs, nshift)
    assert telemetry.value("launch.advect_shift") == before + 1
    assert torch.equal(got, kernels.advect_shift_plain(qs, nshift))
    with pytest.raises(ValueError, match="nshift"):
        kernels.advect_shift(qs, nshift.long())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_advect_shift_takes_a_batch_off_16_byte_alignment(cuda, dtype):
    """A contiguous batch that starts one value into its storage (and the
    same for the output the allocator hands out aligned): the scalar
    kernel, the same result."""
    k_quant, nr, naz = 6, 130, 200
    rng = np.random.default_rng(61)
    flat = torch.tensor(rng.random(k_quant * nr * naz + 1), dtype=dtype,
                        device=cuda)
    qs = flat[1:].view(k_quant, nr, naz)
    assert qs.is_contiguous() and qs.data_ptr() % 16 != 0
    nshift = _shifts(nr, naz, cuda)
    assert torch.equal(kernels.advect_shift(qs, nshift),
                       kernels.advect_shift_plain(qs, nshift))


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["FARGO", "Standard"])
def test_staged_route_step_launches_the_staged_kernels(cuda, scheme):
    """``transport_route="staged"``: per step one radial_sweep, one
    theta_sweep per azimuthal pass and one advect_shift, never another
    transport kernel."""
    cfg = Config.from_dict(dict(FLAGSHIP, Nrad="64", Naz="128",
                                Transport=scheme))
    sim = Simulation(cfg, transport_route="staged")
    assert sim.stepper.ops.route == "staged"
    before = telemetry.values("launch.", kernels.OPS)
    sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    delta = {op: telemetry.value("launch." + op) - before[op]
             for op in kernels.OPS}
    assert delta == dict.fromkeys(kernels.OPS, 0) | {
        "cfl": 1, "sources": 1, "viscous_kick": 1, "radial_sweep": 1,
        "theta_sweep": 2 if scheme == "FARGO" else 1, "advect_shift": 1}
    assert bool(torch.isfinite(sim.fields.sigma).all())


@pytest.mark.gpu
def test_kernel_refuses_a_dtype_other_than_its_context(cuda):
    ctx = _ctx(dict(eos="adiabatic", artificial_viscosity="sn"), cuda, 16, 32)
    f = _fields(2, cuda, 16, 32, dtype=torch.float32)
    with pytest.raises(TypeError):
        kernels.cfl(ctx, f["sigma"], f["vrad"], f["vaz"], f["energy"],
                    f["qplus"], f["qminus"])


@pytest.mark.gpu
def test_kernel_refuses_non_contiguous_fields(cuda):
    ctx = _ctx(dict(eos="adiabatic", artificial_viscosity="sn"), cuda, 16, 32)
    f = _fields(2, cuda, 16, 64)
    half = {k: v[:, ::2] for k, v in f.items()}
    with pytest.raises(ValueError, match="contiguous"):
        kernels.cfl(ctx, half["sigma"], half["vrad"], half["vaz"],
                    half["energy"], half["qplus"], half["qminus"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dissipation", [True, False])
def test_artvisc_sn_kernel_matches_plain(cuda, dissipation, dtype):
    ctx = kernels.KernelContext(
        Physics(eos="adiabatic", artificial_viscosity="sn",
                artificial_viscosity_dissipation=dissipation),
        Constants.from_units(Units()), Geometry.build(NR, NAZ, 0.4, 2.5,
                                                      "Log"), dtype, cuda)
    f = _fields(23, cuda, dtype=dtype)
    vaz = (f["vaz"] - 1.0) * 3.0
    args = (f["sigma"], f["vrad"] * 6.0, vaz, f["energy"],
            torch.tensor(0.01, dtype=dtype, device=cuda))
    before = telemetry.value("launch.artvisc_sn")
    got = kernels.artvisc_sn(ctx, *args)
    assert telemetry.value("launch.artvisc_sn") == before + 1
    ref = kernels.artvisc_sn_plain(ctx, *args)
    if dtype == torch.float64:
        _close(got, ref, 1e-12, (1e-15, 1e-15, 1e-15))
    else:
        _close(got, ref, 0.0, [1e-5 * float(r.abs().max()) for r in ref])


@pytest.mark.gpu
def test_pds70_gas_step_launches_artvisc_sn_and_transport(cuda):
    """The PDS70 gas setup (variable gamma) takes the unfused substeps: per
    step one artvisc_sn and one whole-transport launch, and none of the
    fused sources, viscous kick or CFL."""
    sim = Simulation(pds70_gas(64, 128), dtype="float32")
    assert sim.device.type == "cuda"
    before = telemetry.values("launch.", kernels.OPS)
    for _ in range(2):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    delta = {op: telemetry.value("launch." + op) - before[op]
             for op in kernels.OPS}
    assert delta == dict.fromkeys(kernels.OPS, 0) | {"transport": 2,
                                                     "artvisc_sn": 2}
    for name in ("sigma", "vrad", "vaz", "energy"):
        assert bool(torch.isfinite(getattr(sim.fields, name)).all())


@pytest.mark.gpu
def test_pds70_swarm_lives_and_moves_on_the_device(cuda):
    """The whole PDS70 setup in float64 at 32x64 with 512 particles: every
    tensor of the run on the card, the swarm included; five steps on the
    card against the same steps on the CPU (the GPU's dt sequence): the
    swarm at rtol 1e-9 (r_dot at 1e-9 of its largest value), ``alive``
    equal and whole."""
    gpu = Simulation(pds70(32, 64, n_particles=512))
    cpu = Simulation(pds70(32, 64, n_particles=512), device="cpu")
    for _ in range(5):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        cpu.step_once(dt.cpu())
    found = dict(reachable_tensors(gpu))
    assert "sim.state.particles.r" in found
    assert "sim.stepper.dust_grid.cell.pos" in found
    assert {t.device.type for t in found.values()} == {"cuda"}
    gp, cp = gpu.state.particles, cpu.state.particles
    assert bool(gp.alive.all()) and torch.equal(gp.alive.cpu(), cp.alive)
    assert bool((gp.stokes > 0).all())
    for name in ("r", "phi", "r_dot", "phi_dot", "stokes"):
        ref = getattr(cp, name).numpy()
        atol = 1e-9 * np.abs(ref).max() if name == "r_dot" else 0.0
        np.testing.assert_allclose(getattr(gp, name).cpu().numpy(), ref,
                                   rtol=1e-9, atol=atol, err_msg=name)


def _flagship_cfg(snapshots):
    return Config.from_dict(dict(FLAGSHIP, Nrad="64", Naz="128",
                                 Nsnapshots=str(snapshots),
                                 MonitorTimestep="0.02",
                                 BitwiseExactRestarting="yes"))


def _flagship_run(device, dtype, outdir, snapshots, restore_from=None):
    from fargocpt_torch import output
    sim = Simulation(_flagship_cfg(snapshots), dtype=dtype, device=device)
    output.OutputWriter(sim, outdir)
    if restore_from is not None:
        output.restore_simulation(sim, outdir, restore_from)
    sim.run()
    return sim


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_output_from_the_card(cuda, dtype, tmp_path):
    """The writer on card tensors (one pinned copy to the host a boundary)
    writes the bytes the CPU writer writes from the same state, and a
    restart on the card is bit for bit the uninterrupted run."""
    from fargocpt_torch import output
    from fargocpt_torch.state import (system_state_from_numpy,
                                      system_state_to_numpy)
    a = _flagship_run(cuda, dtype, tmp_path / "a", 2)
    _flagship_run(cuda, dtype, tmp_path / "b", 1)
    c = _flagship_run(cuda, dtype, tmp_path / "b", 2, restore_from=1)
    sa, sc = system_state_to_numpy(a.state), system_state_to_numpy(c.state)
    for key in sa:
        np.testing.assert_array_equal(sc[key], sa[key], err_msg=key)
    names = ("Sigma.dat", "vrad.dat", "vazi.dat", "energy.dat", "Qplus.dat",
             "Qminus.dat", "misc.bin", "nbody.bin")
    for name in names:
        assert (tmp_path / "a" / "snapshots" / "2" / name).read_bytes() \
            == (tmp_path / "b" / "snapshots" / "2" / name).read_bytes(), name
    # the same state written from the CPU
    cpu = Simulation(_flagship_cfg(2), dtype=dtype, device="cpu")
    cpu.state = system_state_from_numpy(sa, "cpu", cpu.dtype)
    cpu.time, cpu.last_dt = a.time.cpu(), a.last_dt.cpu()
    cpu.n_monitor, cpu.n_hydro_iter = a.n_monitor, a.n_hydro_iter
    output.OutputWriter(cpu, tmp_path / "cpu")
    cpu._handle_outputs()
    for name in names:
        assert (tmp_path / "a" / "snapshots" / "2" / name).read_bytes() \
            == (tmp_path / "cpu" / "snapshots" / "2" / name).read_bytes(), \
            name


# ---------------------------------------------------------------------------
# ias15: a whole IAS15 call of the N-body integrator in one launch
# ---------------------------------------------------------------------------

def _ias15_bodies(case, device):
    """(x, y, vx, vy, m) float64 on ``device`` and a period: two bodies at
    apocentre at e = 0.9, or a star and three planets from a seed."""
    if case == "e0.9":
        e, m2 = 0.9, 1e-3
        m = np.array([1.0, m2])
        M = m.sum()
        r, v = 1 + e, np.sqrt(M * (1 - e) / (1 + e))
        arrs = (np.array([-(m2 / M) * r, r / M]), np.zeros(2), np.zeros(2),
                np.array([-(m2 / M) * v, v / M]), m)
        period = 2 * np.pi / np.sqrt(M)
    else:
        rng = np.random.default_rng(5)
        a = np.array([0.7, 1.3, 2.1])
        phi = rng.random(3) * 2 * np.pi
        vk = np.sqrt(1.0 / a) * (1.0 + 0.1 * rng.random(3))
        arrs = (np.concatenate([[0.0], a * np.cos(phi)]),
                np.concatenate([[0.0], a * np.sin(phi)]),
                np.concatenate([[0.0], -vk * np.sin(phi)]),
                np.concatenate([[0.0], vk * np.cos(phi)]),
                np.array([1.0, 1e-3, 3e-4, 2e-3]))
        period = 2 * np.pi * 0.7 ** 1.5
    return [torch.tensor(x, dtype=torch.float64, device=device)
            for x in arrs], period


@pytest.mark.gpu
@pytest.mark.parametrize("dt_dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["e0.9", "four"])
def test_ias15_kernel_matches_plain(cuda, case, dt_dtype):
    """Calls of a tenth of a period on the card: the kernel against the
    plain version on the same tensors, rtol 1e-13 of each state vector's
    scale (the sums over the bodies run in another order), and the same
    counts of accepted substeps and trial steps."""
    (x, y, vx, vy, m), period = _ias15_bodies(case, cuda)
    k_state = p_state = (x, y, vx, vy)
    for _ in range(4):
        dt = torch.tensor(period / 10, dtype=dt_dtype, device=cuda)
        counts = torch.zeros(2, dtype=torch.int32, device=cuda)
        before = telemetry.value("launch.ias15")
        k_state = kernels.ias15(*k_state, m, 1.0, dt, counts=counts)
        assert telemetry.value("launch.ias15") == before + 1
        plain_counts = []
        p_state = kernels.ias15_plain(*p_state, m, 1.0, dt, plain_counts)
        assert tuple(counts.tolist()) == plain_counts[0]
        for group in ((0, 1), (2, 3)):
            scale = max(float(p_state[i].abs().max()) for i in group)
            for i in group:
                torch.testing.assert_close(k_state[i], p_state[i], rtol=0,
                                           atol=1e-13 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dt_dtype", [torch.float64, torch.float32])
def test_ias15_kernel_is_one_launch_and_no_host_read(cuda, dt_dtype):
    """With a device dt of the run type (as the step gives it) a call asks
    the device for one launch, its kernel's, and no copy or fill: the
    whole adaptive call runs there, with no read back to the host."""
    (x, y, vx, vy, m), period = _ias15_bodies("four", cuda)
    dt = torch.tensor(period / 10, dtype=dt_dtype, device=cuda)
    calls = 5
    asked, ran = _device_activity(kernels.ias15, (x, y, vx, vy, m, 1.0, dt),
                                  calls)
    assert len(asked) == calls and all("LaunchKernel" in n for n in asked), \
        asked
    assert 1 <= len(ran) <= calls and all("ias15_kernel" in n for n in ran), \
        ran


@pytest.mark.gpu
def test_ias15_kernel_refuses_what_it_cannot_take(cuda):
    (x, y, vx, vy, m), _ = _ias15_bodies("four", cuda)
    with pytest.raises(TypeError, match="float64"):
        kernels.ias15(*(t.float() for t in (x, y, vx, vy, m)), 1.0, 0.1)
    lone = [t[:1] for t in (x, y, vx, vy, m)]
    with pytest.raises(ValueError, match="2 or more bodies"):
        kernels.ias15(*lone, 1.0, 0.1)


def many_bodies(n, device):
    """A star and n - 1 small planets on near-circular orbits between r =
    0.6 and 2.4, from a seed: (x, y, vx, vy, m) float64 and the innermost
    period."""
    rng = np.random.default_rng(n)
    a = np.linspace(0.6, 2.4, n - 1)
    phi = rng.random(n - 1) * 2 * np.pi
    vk = np.sqrt(1.0 / a) * (1.0 + 0.02 * rng.random(n - 1))
    arrs = (np.concatenate([[0.0], a * np.cos(phi)]),
            np.concatenate([[0.0], a * np.sin(phi)]),
            np.concatenate([[0.0], -vk * np.sin(phi)]),
            np.concatenate([[0.0], vk * np.cos(phi)]),
            np.concatenate([[1.0], 1e-4 * (1.0 + rng.random(n - 1))]))
    return [torch.tensor(v, dtype=torch.float64, device=device)
            for v in arrs], 2 * np.pi * 0.6 ** 1.5


@pytest.mark.gpu
@pytest.mark.parametrize("n", [17, 40])
def test_ias15_kernel_takes_more_than_16_bodies(cuda, n):
    """Beyond the 16 bodies of the thread's own arrays the kernel works in
    a device workspace: bit for bit with the plain version on the same
    tensors, the same (accepted, trial) counts, one launch a call."""
    (x, y, vx, vy, m), period = many_bodies(n, cuda)
    k_state = p_state = (x, y, vx, vy)
    for _ in range(3):
        dt = torch.tensor(period / 20, dtype=torch.float64, device=cuda)
        counts = torch.zeros(2, dtype=torch.int32, device=cuda)
        before = telemetry.value("launch.ias15")
        k_state = kernels.ias15(*k_state, m, 1.0, dt, counts=counts)
        assert telemetry.value("launch.ias15") == before + 1
        plain_counts = []
        p_state = kernels.ias15_plain(*p_state, m, 1.0, dt, plain_counts)
        assert tuple(counts.tolist()) == plain_counts[0]
        for a, b in zip(k_state, p_state):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# bodies_on_grid: the ramped masses, Roche radii and cubic smoothing radii
# in one launch
# ---------------------------------------------------------------------------

def _grid_bodies(n, device):
    """A star and n - 1 bodies from a seed, one of them of 1e-12 stellar
    masses (from 3 bodies on): an NBodyState of float64 tensors on
    ``device``."""
    from fargocpt_torch.nbody.system import NBodyState
    rng = np.random.default_rng(n)
    a = 0.3 + 2.5 * rng.random(n - 1)
    phi = rng.random(n - 1) * 2 * np.pi
    m = np.concatenate([[0.76], 10.0 ** rng.uniform(-7, -1.5, n - 1)])
    if n >= 3:
        m[2] = 1e-12
    x = np.concatenate([[1e-3], a * np.cos(phi)])
    y = np.concatenate([[-2e-3], a * np.sin(phi)])
    z = np.zeros(n)
    return NBodyState(*(torch.tensor(v, dtype=torch.float64, device=device)
                        for v in (x, y, z, z, m)))


RAMPS = {"in_progress": lambda n: np.linspace(0.0, 3.0, n),
         "finished": lambda n: np.full(n, 0.5),
         "off": lambda n: None}
CUBIC = {"factors": lambda n: np.linspace(0.0, 0.6, n),
         "zero_factors": lambda n: np.zeros(n),
         "off": lambda n: None}


@pytest.mark.gpu
@pytest.mark.parametrize("time_kind", ["float", "float64", "float32"])
@pytest.mark.parametrize("cubic", list(CUBIC))
@pytest.mark.parametrize("ramp", list(RAMPS))
@pytest.mark.parametrize("n", [2, 3, 17, 513])
def test_bodies_on_grid_kernel_equals_the_plain_chain(cuda, n, ramp, cubic,
                                                      time_kind):
    """The kernel against the plain ATen chain (rampup_masses, the Roche
    radius's 12 Newton iterations, the distance to the primary) on the same
    card, bit for bit: the ramped masses, the Roche radii and the cubic
    smoothing radii; time as a float and as a 0-d device tensor of either
    run type; one launch a call."""
    nb = _grid_bodies(n, cuda)
    ramp_time, factor = (None if f(n) is None else _one(f(n), cuda)
                         for f in (RAMPS[ramp], CUBIC[cubic]))
    time = 1.25 if time_kind == "float" else torch.tensor(
        1.25, dtype=getattr(torch, time_kind), device=cuda)
    before = telemetry.value("launch.bodies_on_grid")
    got = kernels.bodies_on_grid(nb, ramp_time, factor, time)
    assert telemetry.value("launch.bodies_on_grid") == before + 1
    want = kernels.bodies_on_grid_plain(nb, ramp_time, factor, time)
    for name, a, b in zip(("mass", "roche", "cubic"), got, want):
        assert a.shape == (n,) and a.dtype == torch.float64, name
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), (name, (a - b).abs().max())
    mass, roche, cubic_r = got
    assert float(roche[0]) == 0.0 and bool((roche[1:] > 0.0).all())
    assert bool((cubic_r != 0.0).any()) == (cubic == "factors")
    assert bool((mass != nb.mass).any()) == (ramp == "in_progress")


@pytest.mark.gpu
def test_roche_radius_on_the_card_reads_the_kernel(cuda):
    """dimensionless_roche_radius of a CUDA state (the accretion's and the
    output's) is the kernel's Roche output: one launch, the plain Newton
    loop's values bit for bit, also with the roles swapped as the output's
    radius limit swaps them."""
    from fargocpt_torch.nbody import system as nbody_sys
    nb = _grid_bodies(3, cuda)
    swapped = nb.replace(x=nb.x[[1, 0]], y=nb.y[[1, 0]], vx=nb.vx[:2],
                         vy=nb.vy[:2], mass=nb.mass[[1, 0]])
    for state in (nb, swapped):
        before = telemetry.value("launch.bodies_on_grid")
        got = nbody_sys.dimensionless_roche_radius(state)
        assert telemetry.value("launch.bodies_on_grid") == before + 1
        assert torch.equal(got, nbody_sys.roche_radius_plain(state))


@pytest.mark.gpu
@pytest.mark.parametrize("time_kind", ["float", "float64", "float32"])
def test_bodies_on_grid_kernel_is_one_launch_and_no_host_read(cuda,
                                                              time_kind):
    """A call asks the device for one launch, its kernel's, and no copy
    or fill, with time a float (a kernel argument) or on the device (read
    by the kernel)."""
    nb = _grid_bodies(3, cuda)
    time = 1.25 if time_kind == "float" else torch.tensor(
        1.25, dtype=getattr(torch, time_kind), device=cuda)
    args = (nb, _one(RAMPS["in_progress"](3), cuda),
            _one(CUBIC["factors"](3), cuda), time)
    calls = 5
    asked, ran = _device_activity(kernels.bodies_on_grid, args, calls)
    assert len(asked) == calls and all("LaunchKernel" in n for n in asked), \
        asked
    assert 1 <= len(ran) <= calls \
        and all("bodies_on_grid_kernel" in n for n in ran), ran


@pytest.mark.gpu
def test_bodies_on_grid_kernel_refuses_what_it_cannot_take(cuda):
    nb = _grid_bodies(3, cuda)
    with pytest.raises(TypeError, match="float64"):
        kernels.bodies_on_grid(nb.replace(mass=nb.mass.float()))
    with pytest.raises(ValueError, match="shape"):
        kernels.bodies_on_grid(nb, _one([1.0, 2.0], cuda))
    with pytest.raises(TypeError, match="time"):
        kernels.bodies_on_grid(nb, None, None,
                               torch.ones(2, dtype=torch.float64,
                                          device=cuda))


def _pds70_planets(device):
    """setups/PDS70.yml with its unit moved to planet b's orbit, at 16x32
    with 64 particles (tests/test_torch_telemetry.py's planet disk)."""
    import warnings
    import yaml
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "setups" / "PDS70.yml"
    cfg = yaml.safe_load(path.read_text())
    cfg.update(l0="22.7 au", Sigma0="3.66915 g/cm2", Nrad=16, Naz=32,
               NumberOfParticles=64)
    for body, axis in zip(cfg["nbody"], ("0.0 au", "22.7 au", "30.2 au")):
        body["semi-major axis"] = axis
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return Simulation(Config.from_dict(cfg), device=device)


@pytest.mark.gpu
def test_euler_planet_step_with_the_kernel_equals_the_plain_chain(
        cuda, monkeypatch):
    """PDS 70 b and c in their disk at 16x32 on the card (the Euler step
    with its swarm): three steps with the kernel equal three steps with
    the plain ATen chain on the same card bit for bit, the fields, the
    bodies and the swarm; the kernel launches twice a step (the step's
    start and the swarm's integration)."""
    sims = {}
    for side in ("kernel", "plain"):
        if side == "plain":
            monkeypatch.setattr(kernels, "bodies_on_grid",
                                kernels.bodies_on_grid_plain)
        sim = _pds70_planets(cuda)
        before = telemetry.value("launch.bodies_on_grid")
        for _ in range(3):
            sim.step_once(sim.calculate_time_step())
        launched = telemetry.value("launch.bodies_on_grid") - before
        assert launched == (6 if side == "kernel" else 0), (side, launched)
        sims[side] = sim
    a, b = sims["kernel"], sims["plain"]
    for name in ("sigma", "vrad", "vaz", "energy"):
        assert torch.equal(getattr(a.fields, name), getattr(b.fields, name)), \
            name
    for name in ("x", "y", "vx", "vy", "mass"):
        assert torch.equal(getattr(a.state.nbody, name),
                           getattr(b.state.nbody, name)), name
    for name in ("r", "phi"):
        assert torch.equal(getattr(a.state.particles, name),
                           getattr(b.state.particles, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_planet_disk_step_launches_and_matches_the_cpu(cuda, dtype):
    """The quickstart physics at 64x128: each step launches cfl, sources,
    viscous_kick, the transport and bodies_on_grid once and ias15 twice
    (the indirect term's predictor and the drift); ten steps agree with the CPU's plain
    versions (rtol 1e-9 in float64, 1e-4 of each field's scale in
    float32) and the bodies too."""
    from fargocpt_torch.flagship import planet_disk
    gpu = Simulation(planet_disk(64, 128), dtype=dtype, device=cuda)
    cpu = Simulation(planet_disk(64, 128), dtype=dtype, device="cpu")
    gpu.step_once(gpu.calculate_time_step())
    cpu.step_once(cpu.calculate_time_step())
    before = telemetry.values("launch.", kernels.OPS)
    for _ in range(9):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        cpu.step_once(dt.cpu())
    delta = {op: telemetry.value("launch." + op) - before[op]
             for op in kernels.OPS}
    assert delta == dict.fromkeys(kernels.OPS, 0) | {
        "cfl": 9, "sources": 9, "viscous_kick": 9, "transport": 9,
        "ias15": 18, "bodies_on_grid": 9}
    tol = 1e-9 if dtype == "float64" else 1e-4
    for name in ("sigma", "vrad", "vaz"):
        a = getattr(gpu.fields, name).cpu()
        b = getattr(cpu.fields, name)
        scale = float(b.abs().max()) if name != "vrad" else \
            float(cpu.fields.vaz.abs().max())
        assert float((a - b).abs().max()) <= tol * scale, name
    for name in ("x", "y", "vx", "vy"):
        torch.testing.assert_close(getattr(gpu.state.nbody, name).cpu(),
                                   getattr(cpu.state.nbody, name),
                                   rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the leapfrog's kernel interfaces: the smoothing plane, the in-kick sound
# speed, any number of bodies
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nr,naz", [(17, 65), (33, 130), (130, 200)])
def test_sources_kernel_with_a_smoothing_plane(cuda, nr, naz, dtype):
    """``h_smooth``: the "cell" smoothing takes eps times the plane's H;
    the kernel against the plain version given the same plane."""
    ctx = _ctx(dict(eos="adiabatic", adiabatic_index=1.4,
                    thickness_smoothing=0.6, aspectratio_ref=0.05,
                    flaring_index=0.25), cuda, nr, naz, dtype)
    f = _fields(5, cuda, nr, naz, dtype)
    rng = np.random.default_rng(9)
    h_smooth = torch.tensor(rng.random((nr, naz)) * 0.05 + 0.03,
                            dtype=dtype, device=cuda)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], _planets(3, cuda),
            (_one(1e-3, cuda), _one(-2e-3, cuda)), _one(0.4, cuda),
            torch.tensor(0.003, dtype=dtype, device=cuda))
    got = kernels.sources(ctx, *args, h_smooth=h_smooth)
    ref = kernels.sources_plain(ctx, *args, h_smooth=h_smooth)
    v = float(f["vaz"].abs().max())
    _close_by_dtype(got, ref, dtype, 1e-11, (1e-13, 1e-13), [v, v])
    without = kernels.sources_plain(ctx, *args)
    assert not torch.equal(ref[1], without[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sources_kernel_takes_more_bodies_than_a_chunk(cuda, dtype):
    """513 bodies: two chunks of the per-body table through shared memory;
    each cell's sum over the bodies stays in index order."""
    ctx = _ctx(dict(eos="adiabatic", adiabatic_index=1.4,
                    thickness_smoothing=0.6, aspectratio_ref=0.05,
                    flaring_index=0.25), cuda, 33, 130, dtype)
    f = _fields(5, cuda, 33, 130, dtype)
    (x, y, _, _, m), _ = many_bodies(513, cuda)
    bodies = gravity.BodiesOnGrid(
        x=x, y=y, mass=m,
        cubic_smoothing_radius=torch.full_like(m, 0.05) * (m < 1.0))
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"], bodies,
            (_one(1e-3, cuda), _one(-2e-3, cuda)), _one(0.4, cuda),
            torch.tensor(0.003, dtype=dtype, device=cuda))
    before = telemetry.value("launch.sources")
    got = kernels.sources(ctx, *args)
    assert telemetry.value("launch.sources") == before + 1
    ref = kernels.sources_plain(ctx, *args)
    v = float(f["vaz"].abs().max())
    _close_by_dtype(got, ref, dtype, 1e-11, (1e-13, 1e-13), [v, v])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nr,naz", [(4, 3), (17, 65), (33, 130), (130, 200)])
@pytest.mark.parametrize("artvisc_on", ["sn", "tw"])
def test_viscous_kick_kernel_with_the_in_kick_sound_speed(cuda, artvisc_on,
                                                          nr, naz, dtype):
    """``want_cs``: one launch writes the five outputs and the sound speed
    of the viscosity stage, each against the plain version."""
    ctx = _ctx(dict(VK_PHYS, eos="adiabatic", artificial_viscosity=artvisc_on),
               cuda, nr, naz, dtype)
    f = _fields(11, cuda, nr, naz, dtype, floor_cells=naz >= 7)
    args = (f["sigma"], f["vrad"], f["vaz"], f["energy"],
            torch.tensor(0.003, dtype=dtype, device=cuda), 0.0)
    before = telemetry.value("launch.viscous_kick")
    got = kernels.viscous_kick(ctx, *args, want_cs=True)
    assert telemetry.value("launch.viscous_kick") == before + 1
    ref = kernels.viscous_kick_plain(ctx, *args, want_cs=True)
    assert len(got) == len(ref) == 6
    scales = _vk_scales(f, ref[:5]) + [float(ref[5].abs().max())]
    _close_by_dtype(got, ref, dtype, 1e-10,
                    (1e-13, 1e-13, 1e-16, 1e-18, 1e-18, 1e-16), scales)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_planet_torque_leapfrog_step_launches_and_matches_the_cpu(cuda,
                                                                  dtype):
    """The leapfrog at 128x256 (flagship.planet_torque): each step launches
    cfl and the transport once, sources and viscous_kick twice (the two
    kicks), ias15 and bodies_on_grid four times (two half drifts, two
    predictors); ten steps
    agree with the CPU's plain versions (rtol 1e-9 in float64, 1e-4 of
    each field's scale in float32), the bodies too."""
    from fargocpt_torch.flagship import planet_torque
    gpu = Simulation(planet_torque(128, 256), dtype=dtype, device=cuda)
    cpu = Simulation(planet_torque(128, 256), dtype=dtype, device="cpu")
    gpu.step_once(gpu.calculate_time_step())
    cpu.step_once(cpu.calculate_time_step())
    before = telemetry.values("launch.", kernels.OPS)
    for _ in range(9):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        cpu.step_once(dt.cpu())
    delta = {op: telemetry.value("launch." + op) - before[op]
             for op in kernels.OPS}
    assert delta == dict.fromkeys(kernels.OPS, 0) | {
        "cfl": 9, "sources": 18, "viscous_kick": 18, "transport": 9,
        "ias15": 36, "bodies_on_grid": 36}
    tol = 1e-9 if dtype == "float64" else 1e-4
    for name in ("sigma", "vrad", "vaz"):
        a = getattr(gpu.fields, name).cpu()
        b = getattr(cpu.fields, name)
        scale = float(b.abs().max()) if name != "vrad" else \
            float(cpu.fields.vaz.abs().max())
        assert float((a - b).abs().max()) <= tol * scale, name
    for name in ("x", "y", "vx", "vy"):
        torch.testing.assert_close(getattr(gpu.state.nbody, name).cpu(),
                                   getattr(cpu.state.nbody, name),
                                   rtol=0, atol=1e-12)


@pytest.mark.gpu
def test_adiabatic_leapfrog_step_matches_the_cpu(cuda):
    """The quickstart disk adiabatic with the leapfrog and a viscous inner
    boundary at 64x128 float64: the in-kick sound speed of the fused kick
    feeds kick 2's smoothing plane and the boundaries; ten steps agree with
    the CPU's plain versions at rtol 1e-9."""
    from fargocpt_torch.flagship import PLANET_DISK
    cfg = dict(PLANET_DISK, Nrad="64", Naz="128", Integrator="LeapFrog",
               EquationOfState="Ideal", InnerBoundary="viscous")
    cfg["nbody"] = [dict(b) for b in PLANET_DISK["nbody"]]
    gpu = Simulation(Config.from_dict(dict(cfg)), device=cuda)
    cpu = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    assert gpu.stepper.in_kick
    for _ in range(10):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        cpu.step_once(dt.cpu())
    for name in ("sigma", "vrad", "vaz", "energy"):
        a = getattr(gpu.fields, name).cpu()
        b = getattr(cpu.fields, name)
        scale = float(b.abs().max()) if name != "vrad" else \
            float(cpu.fields.vaz.abs().max())
        assert float((a - b).abs().max()) <= 1e-9 * scale, name


# each float32 monitor grid of planet_accretion at 128x256 after ten steps,
# rel-L2 against the CPU's: twice the JAX package's own float32 run's
# rel-L2 from its float64 run there, rounded up (2.1818e-2, 1.0646e-2,
# 5.6890e-2 by ``python tests/test_torch_monitor_f32.py 128 256 10``)
F32_GRID_LIMITS = {"massflow": 4.4e-2, "t_adv": 2.2e-2, "t_grav": 0.12}


def _held_to_the_cpu(gpu, cpu, tol, f32_grids=False):
    """Each field within ``tol`` of its scale (v_rad of v_az's), the
    bodies and the frame's rate within ``tol`` of their scales, and each
    monitor grid that is on within ``tol`` of its largest value. A monitor
    grid sums terms that cancel, so in float32 it is rounding to a few per
    cent of itself in the JAX package as in the port: with ``f32_grids``
    each grid of ``F32_GRID_LIMITS`` is held to its limit there instead."""
    for name in ("sigma", "vrad", "vaz"):
        a = getattr(gpu.fields, name).cpu()
        b = getattr(cpu.fields, name)
        scale = float(b.abs().max()) if name != "vrad" else \
            float(cpu.fields.vaz.abs().max())
        assert float((a - b).abs().max()) <= tol * scale, name
    for names in (("x", "y"), ("vx", "vy"), ("mass",)):
        a = torch.stack([getattr(gpu.state.nbody, k).cpu() for k in names])
        b = torch.stack([getattr(cpu.state.nbody, k) for k in names])
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), \
            names
    a, b = float(gpu.state.omega_frame), float(cpu.state.omega_frame)
    assert abs(a - b) <= tol * abs(b)
    from fargocpt_torch.state import MONITOR_GRIDS
    for name in MONITOR_GRIDS:
        b = getattr(cpu.state.monitor_acc, name)
        if b is None:
            continue
        a = getattr(gpu.state.monitor_acc, name).cpu()
        if f32_grids and name in F32_GRID_LIMITS:
            err = float(torch.linalg.norm((a - b).double())
                        / torch.linalg.norm(b.double()))
            assert err <= F32_GRID_LIMITS[name], (name, err)
            continue
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), \
            name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_planet_accretion_step_launches_and_matches_the_cpu(cuda, dtype):
    """The accretion test at 128x256 (flagship.planet_accretion: the
    leapfrog in the corotating frame, a Kley-accreting planet, the MassFlow
    and gas-torque grids): each step launches cfl, sources and the
    transport once, viscous_kick twice, ias15 four times and
    bodies_on_grid seven times (the accretion's Roche radius among them;
    the first
    kick of an accreting step reads the pressure from before the
    accretion: the unfused substep; the second kick the kernel); ten
    steps agree with the CPU's plain versions (rtol 1e-9 in float64, 1e-4
    of each scale in float32), the bodies, the accreted mass, the frame's
    rate and the monitor grids too (in float32 the grids within
    ``F32_GRID_LIMITS``: ``_held_to_the_cpu``)."""
    from fargocpt_torch.flagship import planet_accretion
    gpu = Simulation(planet_accretion(128, 256), dtype=dtype, device=cuda)
    cpu = Simulation(planet_accretion(128, 256), dtype=dtype, device="cpu")
    before = telemetry.values("launch.", kernels.OPS)
    for _ in range(10):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        cpu.step_once(dt.cpu())
    delta = {op: telemetry.value("launch." + op) - before[op]
             for op in kernels.OPS}
    assert delta == dict.fromkeys(kernels.OPS, 0) | {
        "cfl": 10, "sources": 10, "viscous_kick": 20, "transport": 10,
        "ias15": 40, "bodies_on_grid": 70}
    assert float(gpu.state.nbody.mass[1]) > 2e-5
    _held_to_the_cpu(gpu, cpu, 1e-9 if dtype == "float64" else 1e-4,
                     f32_grids=dtype == "float32")


@pytest.mark.gpu
def test_star_planet_step_launches_and_matches_the_cpu(cuda):
    """setups/star_planet.yml at 64x128 float64 (the Euler step in the
    corotating frame): each step launches cfl, sources, viscous_kick,
    the transport and bodies_on_grid once and ias15 twice; ten steps agree with the CPU's
    plain versions at rtol 1e-9, the bodies and the frame's rate too."""
    import yaml
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "setups" \
        / "star_planet.yml"
    cfg = dict(yaml.safe_load(path.read_text()), Nrad=64, Naz=128)
    gpu = Simulation(Config.from_dict(dict(cfg)), device=cuda)
    cpu = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    before = telemetry.values("launch.", kernels.OPS)
    for _ in range(10):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        cpu.step_once(dt.cpu())
    delta = {op: telemetry.value("launch." + op) - before[op]
             for op in kernels.OPS}
    assert delta == dict.fromkeys(kernels.OPS, 0) | {
        "cfl": 10, "sources": 10, "viscous_kick": 10, "transport": 10,
        "ias15": 20, "bodies_on_grid": 10}
    _held_to_the_cpu(gpu, cpu, 1e-9)


def _binary_gcfull(nr, naz, **over):
    """flagship.binary_gcfull's physics on the binary_gcfull golden's
    radii (the e = 0.4 secondary inside the grid)."""
    from fargocpt_torch.flagship import binary_gcfull
    return binary_gcfull(nr, naz, Rmin="0.05", Rmax="12", **over)


@pytest.mark.gpu
@pytest.mark.parametrize("over", [
    {}, {"StabilizeViscosity": "2"}, {"AspectRatioMode": "2"},
    {"HydroFrameCenter": "binary"},
    {"EquationOfState": "Isothermal", "AlphaMode": "0"}],
    ids=["stabilize-1-aspect-1", "stabilize-2", "aspect-2",
         "binary-frame-quadrupole", "isothermal-nbody-sound-speed"])
def test_binary_gcfull_step_launches_and_matches_the_cpu(cuda, over):
    """The circumbinary-disk menu at 128x256 float64 (N-body-centred ICs,
    AspectRatioMode, AlphaMode 2, StabilizeViscosity, the center-of-mass
    boundary, the viscously accreting secondary): each leapfrog step
    launches the transport once, ias15 four times (twice with the hydro
    frame on the binary), bodies_on_grid seven times and no other kernel (the gates keep cfl, sources
    and viscous_kick off); ten steps agree with
    the CPU's plain versions at rtol 1e-9, the bodies and their masses
    too."""
    gpu = Simulation(_binary_gcfull(128, 256, **over), device=cuda)
    cpu = Simulation(_binary_gcfull(128, 256, **over), device="cpu")
    before = telemetry.values("launch.", kernels.OPS)
    for _ in range(10):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        cpu.step_once(dt.cpu())
    delta = {op: telemetry.value("launch." + op) - before[op]
             for op in kernels.OPS}
    # with the frame on both bodies the indirect term is zero, so the
    # predictor's two calls a step drop out
    ias15 = 20 if gpu.n_hydroframe == 2 else 40
    assert delta == dict.fromkeys(kernels.OPS, 0) | {
        "transport": 10, "ias15": ias15, "bodies_on_grid": 70}
    _held_to_the_cpu(gpu, cpu, 1e-9)
    a, b = gpu.fields.energy.cpu(), cpu.fields.energy
    assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


@pytest.mark.gpu
def test_binary_gcfull_float32_rounds_as_the_jax_package(cuda):
    """binary_gcfull at 128x256 float32 on the card: 20 steps against the
    float64 CPU run on the card's dt sequence, each field within twice the
    rel-L2 that the JAX package's own float32 run leaves from its float64
    run (``BINARY_F32_LIMITS``): the centre-of-mass boundary's drift is
    rounding in float32 in both packages."""
    gpu = Simulation(_binary_gcfull(128, 256), dtype="float32", device=cuda)
    cpu = Simulation(_binary_gcfull(128, 256), dtype="float64", device="cpu")
    for _ in range(20):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        cpu.step_once(dt.cpu().double())
    from fargocpt_torch.flagship import BINARY_F32_LIMITS
    for name, limit in BINARY_F32_LIMITS.items():
        a = getattr(gpu.fields, name).cpu().double()
        b = getattr(cpu.fields, name)
        err = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        assert err <= limit, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("eos_name", ["adiabatic", "isothermal"])
def test_center_of_mass_boundary_on_the_card_matches_the_cpu(cuda, dtype,
                                                             eos_name):
    """Both center-of-mass sides with a non-zero quadrupole moment, three
    bodies, on 130x200 random fields: the card's ghost rows against the
    CPU's, each field within 1e-9 of its scale in float64 (the drift's
    nested differences amplify the two sides' ulps of pow) and 1e-3 in
    float32 (there the drift is rounding), the interior untouched."""
    from fargocpt_torch.nbody.system import NBodyState
    from fargocpt_torch.ops import boundary
    from fargocpt_torch.ops.common import Geom
    geom = Geometry.build(NR, NAZ, 0.3, 6.0, "Log")
    phys = Physics(eos=eos_name, adiabatic_index=1.4, viscous_alpha=1e-2,
                   aspectratio_ref=0.04, flaring_index=0.29, sigma0=1e-3,
                   sigma_slope=1.1, sigma_floor=1e-9, mu=2.35,
                   minimum_temperature=1e-4, thickness_smoothing=0.6,
                   profile_cutoff_inner=True, profile_cutoff_point_inner=1.2,
                   profile_cutoff_width_inner=0.12,
                   vaz_quadrupole_support=True,
                   composite_inner="centerofmass",
                   composite_outer="centerofmass")
    constants = Constants.from_units(Units())
    rng = np.random.default_rng(17)
    f = {"sigma": rng.random((NR, NAZ)) * 1e-3 + 5e-4,
         "energy": rng.random((NR, NAZ)) * 1e-5 + 1e-5,
         "vrad": (rng.random((NR + 1, NAZ)) - 0.5) * 0.05,
         "vaz": (rng.random((NR, NAZ)) - 0.5) * 0.1 + 1.0}
    nb = {k: rng.uniform(-0.5, 0.5, 3) for k in ("x", "y", "vx", "vy")}
    nb["mass"] = np.array([0.7, 0.2, 0.1])
    out = {}
    for dev in ("cpu", cuda):
        g = Geom(geom, dtype, dev)
        t = {k: torch.tensor(v, dtype=dtype, device=dev)
             for k, v in f.items()}
        bodies = NBodyState(**{k: torch.tensor(v, dtype=torch.float64,
                                               device=dev)
                               for k, v in nb.items()})
        ref = boundary.RefValues(t["sigma"], t["energy"], t["vrad"],
                                 t["vaz"])
        out[str(dev)] = [x.cpu() for x in boundary.apply_boundary_conditions(
            phys, constants, g, t["sigma"], t["vrad"], t["vaz"], t["energy"],
            ref, torch.tensor(0.05, dtype=dtype, device=dev),
            com_ctx=(bodies, 2, 0.02))]
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    for k, name in enumerate(("sigma", "vrad", "vaz", "energy")):
        a, b = out[str(cuda)][k], out["cpu"][k]
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), \
            name
        lo, hi = (2, NR - 1) if name == "vrad" else (1, NR - 1)
        assert torch.equal(a[lo:hi], b[lo:hi]), name


@pytest.mark.gpu
def test_oy_car_step_launches_and_matches_the_cpu(cuda):
    """setups/CloseBinaries/OY_Car.yml at 64x128 float64, its stream's
    ramp ending in the first step: each Euler step launches cfl, sources,
    artvisc_sn, the transport and bodies_on_grid once and ias15 twice, no
    other kernel
    (surface cooling keeps the viscous kick's gate off); ten steps agree
    with the CPU's plain versions at 1e-9 of each field's scale, the
    bodies and the Roche-lobe tracker's rate too."""
    from fargocpt_torch.flagship import oy_car
    cfg = dict(ROFrampingtime="1e-7", FirstDT="1e-7")
    gpu = Simulation(oy_car(64, 128, **cfg), device=cuda)
    cpu = Simulation(oy_car(64, 128, **cfg), device="cpu")
    before = telemetry.values("launch.", kernels.OPS)
    for _ in range(10):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        cpu.step_once(dt.cpu())
    delta = {op: telemetry.value("launch." + op) - before[op]
             for op in kernels.OPS}
    assert delta == dict.fromkeys(kernels.OPS, 0) | {
        "cfl": 10, "sources": 10, "artvisc_sn": 10, "transport": 10,
        "ias15": 20, "bodies_on_grid": 10}
    _held_to_the_cpu(gpu, cpu, 1e-9)
    a = float(gpu.state.monitor_acc.rof_mdot)
    b = float(cpu.state.monitor_acc.rof_mdot)
    assert b != 0.0 and abs(a - b) <= 1e-9 * abs(b)


@pytest.mark.gpu
def test_v1504cyg_step_launches_and_matches_the_cpu(cuda):
    """setups/V1504Cyg.yml at 32x64 float64 (the leapfrog, PVTE, S-curve
    cooling, AspectRatioMode 1, AlphaMode 1): each step launches the
    transport once, ias15 four times and pvte_refresh once a PVTE refresh
    (five: calculate_time_step's and the leapfrog's four), bodies_on_grid
    five times, no other kernel; five steps agree
    with the CPU's plain versions at 1e-9 of each field's scale. The
    setup's CFL dt (~1e-16 here; ROADMAP C) moves no field, so both step
    on a fixed 1e-4, under the FARGO shear limit, and sigma, vaz and the
    energy are seen to move far above 1e-9; the CFL dts are held to each
    other."""
    from fargocpt_torch.flagship import v1504cyg
    gpu = Simulation(v1504cyg(32, 64), device=cuda)
    cpu = Simulation(v1504cyg(32, 64), device="cpu")
    start = {k: getattr(cpu.fields, k).clone()
             for k in ("sigma", "vaz", "energy")}
    before = telemetry.values("launch.", kernels.OPS)
    for _ in range(5):
        dt_g, dt_c = gpu.calculate_time_step(), cpu.calculate_time_step()
        assert abs(float(dt_g) - float(dt_c)) <= 1e-9 * float(dt_c)
        gpu.step_once(1e-4)
        cpu.step_once(1e-4)
    delta = {op: telemetry.value("launch." + op) - before[op]
             for op in kernels.OPS}
    assert delta == dict.fromkeys(kernels.OPS, 0) | {"transport": 5,
                                                     "ias15": 20,
                                                     "pvte_refresh": 25,
                                                     "bodies_on_grid": 25}
    _held_to_the_cpu(gpu, cpu, 1e-9)
    a, b = gpu.fields.energy.cpu(), cpu.fields.energy
    assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())
    for name, old in start.items():
        new = getattr(cpu.fields, name)
        assert float((new - old).norm() / old.norm()) > 1e-6, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rochelobe_stream_on_the_card_matches_the_cpu(cuda, dtype):
    """The stream on 130x200 random fields, a donor whose window wraps the
    seam, before the ramp's end: the card's ghost rows against the CPU's
    within 1e-13 of each field's scale (the profile is float64 on both;
    the card's exp and sin may differ from the CPU's by an ulp), one
    float32 ulp in float32, the interior untouched."""
    import math
    from types import SimpleNamespace
    from fargocpt_torch.ops import boundary
    from fargocpt_torch.ops.common import Geom
    geom = Geometry.build(NR, NAZ, 0.05, 0.7, "Log")
    phys = Physics(eos="adiabatic", adiabatic_index=1.4, mu=2.35,
                   sigma0=1e-3, sigma_floor=1e-8, rochelobe_overflow=True,
                   rof_planet=1, rof_temperature=0.05, rof_mdot=4.4e-11,
                   rof_rampingtime=3.0)
    rng = np.random.default_rng(23)
    f = {"sigma": rng.random((NR, NAZ)) * 1e-3 + 5e-4,
         "vrad": (rng.random((NR + 1, NAZ)) - 0.5) * 0.05,
         "vaz": (rng.random((NR, NAZ)) - 0.5) * 0.1 + 1.0,
         "energy": rng.random((NR, NAZ)) * 1e-5 + 1e-5}
    theta = 2.0 * math.pi * (1.0 - 0.3 / NAZ)
    nb = {"x": [0.0, math.cos(theta)], "y": [0.0, math.sin(theta)],
          "vx": [0.0, -math.sin(theta)], "vy": [0.0, math.cos(theta)]}
    units = (25065029.577259634, 0.26543563542339194, 43622739096.12)
    out = {}
    for dev in ("cpu", cuda):
        t = [torch.tensor(f[k], dtype=dtype, device=dev)
             for k in ("sigma", "vrad", "vaz", "energy")]
        bodies = SimpleNamespace(**{k: torch.tensor(v, dtype=torch.float64,
                                                    device=dev)
                                    for k, v in nb.items()})
        time = torch.tensor(2.0, dtype=dtype, device=dev)
        out[str(dev)] = [x.cpu() for x in boundary.rochelobe_overflow(
            phys, Constants(R=3.5), Geom(geom, dtype, dev), *t,
            torch.tensor(0.37, dtype=dtype, device=dev), bodies, time,
            *units)]
    tol = 1e-13 if dtype == torch.float64 else 1.2e-7
    for k, name in enumerate(("sigma", "vrad", "vaz", "energy")):
        a, b = out[str(cuda)][k], out["cpu"][k]
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), \
            name
        rows = NR - 1
        assert torch.equal(a[:rows], b[:rows]), name
    row = out["cpu"][0][NR - 1].numpy()
    assert 3 <= int((row != f["sigma"][NR - 1].astype(row.dtype)).sum()) \
        < NAZ // 2


# ---------------------------------------------------------------------------
# the long tail: Bessel self-gravity, the polytropic EoS, Disk: no, the
# PVTE shock tube with the lookup table, the rest of the initial
# conditions, dust diffusion and the NaN trap
# ---------------------------------------------------------------------------

def _step_pair(gpu, cpu, steps, dt=None):
    """``steps`` steps of both on the card's dt (or ``dt``); the kernels
    launched by the card's run."""
    before = telemetry.values("launch.", kernels.OPS)
    for _ in range(steps):
        step = gpu.calculate_time_step() if dt is None else dt
        cpu.calculate_time_step()
        gpu.step_once(step)
        cpu.step_once(step.cpu() if torch.is_tensor(step) else step)
    return {op: telemetry.value("launch." + op) - before[op]
             for op in kernels.OPS}


def _energy_held(gpu, cpu, tol):
    a, b = gpu.fields.energy.cpu(), cpu.fields.energy
    assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.gpu
def test_planet_disk_sg_step_launches_and_matches_the_cpu(cuda):
    """examples/quickstart.yml with SelfGravity: Yes (the Bessel kernel)
    at 32x96 float64: each Euler step launches artvisc_sn, the transport
    and bodies_on_grid once and ias15 twice, no other kernel (the Bessel mode keeps
    cfl, sources and the viscous kick off); ten steps agree with the CPU
    at 1e-9 of each field's scale."""
    from fargocpt_torch.flagship import planet_disk_sg
    gpu = Simulation(planet_disk_sg(32, 96), device=cuda)
    cpu = Simulation(planet_disk_sg(32, 96), device="cpu")
    delta = _step_pair(gpu, cpu, 10)
    assert delta == dict.fromkeys(kernels.OPS, 0) | {
        "artvisc_sn": 10, "transport": 10, "ias15": 20,
        "bodies_on_grid": 10}
    _held_to_the_cpu(gpu, cpu, 1e-9)


@pytest.mark.gpu
def test_full_physics_step_launches_and_matches_the_cpu(cuda, monkeypatch):
    """examples/full_physics.yml at 32x64 float64 with 300 particles: each
    step launches cfl, sources, artvisc_sn and the transport once, no
    other kernel; the diffusion draws one shared normal array a step on
    both devices (their generators differ), so ten steps agree with the
    CPU at 1e-9 of each field's scale, the energy and the swarm's radii
    too."""
    from fargocpt_torch import flagship
    from fargocpt_torch.particles import dust
    draw = np.random.default_rng(3).standard_normal(300)
    monkeypatch.setattr(dust, "standard_normal", lambda state: torch.tensor(
        draw, dtype=state.r.dtype, device=state.r.device))
    cfg = dict(NumberOfParticles="300", FirstDT="1e-3")
    gpu = Simulation(flagship.full_physics(32, 64, **cfg), device=cuda)
    cpu = Simulation(flagship.full_physics(32, 64, **cfg), device="cpu")
    delta = _step_pair(gpu, cpu, 10)
    assert delta == dict.fromkeys(kernels.OPS, 0) | {
        "cfl": 10, "sources": 10, "artvisc_sn": 10, "transport": 10}
    _held_to_the_cpu(gpu, cpu, 1e-9)
    _energy_held(gpu, cpu, 1e-9)
    a, b = gpu.state.particles.r.cpu(), cpu.state.particles.r
    assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-3)])
def test_polytropic_step_launches_and_matches_the_cpu(cuda, dtype, tol):
    """The flagship with the polytropic EoS at 32x64: artvisc_sn and the
    transport once a step, no other kernel; ten steps agree with the
    CPU's run in the same dtype at ``tol`` of each field's scale."""
    cfg = dict(FLAGSHIP, Nrad="32", Naz="64", FirstDT="1e-3",
               EquationOfState="Polytropic")
    gpu = Simulation(Config.from_dict(dict(cfg)), device=cuda, dtype=dtype)
    cpu = Simulation(Config.from_dict(dict(cfg)), device="cpu", dtype=dtype)
    delta = _step_pair(gpu, cpu, 10)
    assert delta == dict.fromkeys(kernels.OPS, 0) | {
        "artvisc_sn": 10, "transport": 10}
    _held_to_the_cpu(gpu, cpu, tol)


@pytest.mark.gpu
def test_disk_no_steps_on_the_card(cuda):
    """setups/single_planet_no_disk.yml: ias15 twice a step, bodies_on_grid
    once and no other kernel, the gas untouched, the bodies as on the CPU to 1e-12; and the
    FLD-only disk (tests/test_fld1d.py's at 64 rings): no kernel, the
    energy as on the CPU to 1e-9."""
    from fargocpt_torch.flagship import single_planet_no_disk
    gpu = Simulation(single_planet_no_disk(), device=cuda)
    cpu = Simulation(single_planet_no_disk(), device="cpu")
    sigma0 = gpu.fields.sigma.clone()
    delta = _step_pair(gpu, cpu, 10)
    assert delta == dict.fromkeys(kernels.OPS, 0) | {"ias15": 20,
                                                     "bodies_on_grid": 10}
    assert torch.equal(gpu.fields.sigma, sigma0)
    _held_to_the_cpu(gpu, cpu, 1e-12)
    from fargocpt_torch.flagship import fld1d
    gpu = Simulation(fld1d(64, 2), device=cuda)
    cpu = Simulation(fld1d(64, 2), device="cpu")
    e0 = cpu.fields.energy.clone()
    delta = _step_pair(gpu, cpu, 10)
    assert delta == dict.fromkeys(kernels.OPS, 0)
    _energy_held(gpu, cpu, 1e-9)
    assert float((cpu.fields.energy - e0).abs().max()) \
        > 1e-4 * float(e0.abs().max())




@pytest.mark.gpu
def test_pvte_shocktube_lookup_on_the_card(cuda):
    """The shocktube_pvte golden's setup with PVTELookupTable at 1000x2
    float64: the tables built on the card hold the CPU's to 1e-12 (gamma1
    1e-9); 50 steps launch the transport once each, no other kernel, and
    agree with the CPU at 1e-9 of each field's scale."""
    from fargocpt_torch.flagship import shocktube_pvte
    from fargocpt_torch.ops import pvte
    gpu = Simulation(shocktube_pvte(lookup=True), device=cuda)
    cpu = Simulation(shocktube_pvte(lookup=True), device="cpu")
    for t, c, rtol in zip(pvte.lookup_tables(0.75, "cuda"),
                          pvte.lookup_tables(0.75, "cpu"),
                          (0, 0, 1e-12, 1e-12, 1e-9)):
        assert float(((t.cpu() - c).abs() / c.abs()).max()) <= rtol
    delta = _step_pair(gpu, cpu, 50)
    assert delta == dict.fromkeys(kernels.OPS, 0) | {"transport": 50}
    _held_to_the_cpu(gpu, cpu, 1e-9)
    _energy_held(gpu, cpu, 1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [
    {"RandomSigma": "Yes", "FeatureSize": "0.05"},
    {"CentrifugalBalance": "Yes"},
    {"SecondaryDisk": "Yes", "SigmaSlope": "1.0",
     "ProfileCutoffPointOuter": "0.8", "ProfileCutoffWidthOuter": "0.1",
     "nbody": [{"name": "star", "semi-major axis": "0.0", "mass": "1.0"},
               {"name": "companion", "semi-major axis": "1.2",
                "mass": "0.3"}]},
])
def test_long_tail_initial_conditions_on_the_card(cuda, extra):
    """RandomSigma, CentrifugalBalance and the secondary's disk on the
    flagship at 32x64 float64: the initial fields on the card equal the
    CPU's bit for bit (both are built in numpy on the host), and five
    steps agree at 1e-9 of each field's scale."""
    cfg = dict(FLAGSHIP, Nrad="32", Naz="64", FirstDT="1e-3", **extra)
    gpu = Simulation(Config.from_dict(dict(cfg)), device=cuda)
    cpu = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    for name in ("sigma", "vrad", "vaz", "energy"):
        assert torch.equal(getattr(gpu.fields, name).cpu(),
                           getattr(cpu.fields, name)), name
    _step_pair(gpu, cpu, 5)
    _held_to_the_cpu(gpu, cpu, 1e-9)


@pytest.mark.gpu
def test_debug_nans_trap_on_the_card(cuda):
    """A NaN planted in v_az stops the card's run after its first step
    with a FloatingPointError naming a field."""
    cfg = dict(FLAGSHIP, Nrad="32", Naz="64", MonitorTimestep="0.01")
    sim = Simulation(Config.from_dict(dict(cfg)), device=cuda)
    sim.stepper.debug_nans = True
    vaz = sim.fields.vaz.clone()
    vaz[3, 5] = float("nan")
    sim.state = sim.state.replace(fields=sim.fields.replace(vaz=vaz))
    with pytest.raises(FloatingPointError, match="after hydro step 1"):
        sim.run()


# --- the radial decomposition on ranks sharing the card ---------------------

@pytest.mark.gpu
def test_staged_collectives_on_the_card_equal_the_cpu(cuda, tmp_path):
    """gloo with CUDA tensors stages each collective through the host:
    the exchange, sum, min, gather and broadcast of 2 ranks on the card
    give the CPU ranks' values and bytes, and come back on the card."""
    import shard_ranks as sr
    from fargocpt_torch.parallel.launch import launch
    got = {}
    for dev in ("cuda", "cpu"):
        got[dev] = launch(sr.rank_comm_ops, 2, backend="gloo", device=dev,
                          init_method=f"file://{tmp_path}/store_{dev}")
    for (g, devs, nbytes), (c, _, cbytes) in zip(got["cuda"], got["cpu"]):
        assert devs == {"cuda"}
        assert nbytes == cbytes
        for name in c:
            np.testing.assert_array_equal(g[name], c[name], err_msg=name)


@pytest.mark.gpu
def test_two_ranks_step_the_flagship_through_the_kernels(cuda, tmp_path):
    """Two ranks sharing the card step the 192x64 flagship in float64: the
    sharded step launches sources, viscous_kick and the transport, and
    matches the single-process step on the card to 1e-13
    of each grid's scale (tests/test_shard_map.py's gate)."""
    import shard_ranks as sr
    from fargocpt_torch.parallel.launch import launch
    res = launch(sr.rank_flagship_step, 2, backend="gloo", device="cuda",
                 init_method=f"file://{tmp_path}/store")
    for diffs, launches in res:
        for op in ("sources", "viscous_kick", "transport"):
            assert launches[op] >= 1, (op, launches)
        for key, d in diffs.items():
            assert d < 1e-13, (key, d)


@pytest.mark.gpu
def test_nccl_on_one_card_is_refused(cuda):
    """NCCL needs a card a rank; more ranks than cards raise by name."""
    from fargocpt_torch.parallel.launch import check_pair
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="nccl needs a card a rank"):
        check_pair("nccl", "cuda", n)
