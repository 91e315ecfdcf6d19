"""The four fused ops of fargocpt_torch.

CPU: each plain PyTorch version (what the op runs on CPU tensors) against
the JAX package's Pallas TPU kernel in interpret mode, with the setups,
parameter grids and tolerances of tests/test_pallas_kernels.py: 64x256
float64, rtol 1e-12 (cfl), 1e-11 (sources, transport), 1e-10 (viscous
kick). Q+/Q- compare on every ring: both versions write the ghost rings
as zero, so the masked ring NR-1 of that file needs no mask here.

The CUDA kernels themselves are held to these plain versions on the GPU by
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import eos as j_eos, pallas_kernels as pk
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.params import Physics as JPhysics
from fargocpt_tpu.units import Units as JUnits

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import gravity, kernels, transport
from fargocpt_torch.params import Physics
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR, NAZ = 64, 256


def _interpret():
    return pltpu.force_tpu_interpret_mode()


def _ctx(kw, nr=NR, naz=NAZ, dtype=torch.float64, device="cpu"):
    geom = Geometry.build(nr, naz, 0.4, 2.5, "Log")
    return kernels.KernelContext(Physics(**kw), Constants.from_units(Units()),
                                 geom, dtype, device)


def _jax(kw):
    geom = JGeometry.build(NR, NAZ, 0.4, 2.5, "Log")
    return (JPhysics(**kw), JConstants.from_units(JUnits()), geom,
            j_prepare_geom(geom, jnp.float64))


def T(a, device="cpu", dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _fields(seed, nr=NR, naz=NAZ, floor_cells=False):
    rng = np.random.default_rng(seed)
    sigma = rng.random((nr, naz)) + 0.5
    if floor_cells:
        sigma[nr // 3, 3:7] = 5e-6
    return dict(sigma=sigma,
                energy=rng.random((nr, naz)) * 1e-3 + 1e-3,
                vaz=(rng.random((nr, naz)) - 0.5) * 0.1 + 1.0,
                vrad=(rng.random((nr + 1, naz)) - 0.5) * 0.05,
                qplus=rng.random((nr, naz)) * 1e-6,
                qminus=rng.random((nr, naz)) * 1e-6)


def _cfl_kw(adiabatic, sn):
    return dict(eos="adiabatic" if adiabatic else "isothermal",
                adiabatic_index=1.4, viscous_alpha=1e-3, aspectratio_ref=0.05,
                artificial_viscosity="sn" if sn else "tw")


@pytest.mark.parametrize("adiabatic,sn", [(True, True), (False, False)])
def test_cfl_plain_matches_pallas(adiabatic, sn):
    kw = _cfl_kw(adiabatic, sn)
    jp, jc, jgeom, jg = _jax(kw)
    f = _fields(2)
    cs_iso = j_eos.sound_speed_iso_profile(jp, jc, jg.rb)
    omega_k = jnp.sqrt(jc.G * jp.hydro_center_mass / jg.rb ** 3)
    hfac = 1.0 / (jnp.sqrt(jp.adiabatic_index) * omega_k) if adiabatic \
        else 1.0 / omega_k
    cols = pk.make_cfl_cols(jg, cs_iso, hfac, jnp.float64)
    vaz = jnp.asarray(f["vaz"])
    vmean = jnp.mean(vaz, axis=-1, keepdims=True)
    with _interpret():
        dt_min = pk.cfl_pallas(
            jnp.asarray(f["sigma"]), jnp.asarray(f["energy"]),
            jnp.asarray(f["vrad"]), vaz, jnp.asarray(f["qplus"]),
            jnp.asarray(f["qminus"]), vmean, cols, adiabatic=adiabatic,
            gamma=1.4, alpha=1e-3, const_nu=0.0,
            c2=jp.artificial_viscosity_factor ** 2, lf=1.0,
            inv_hc_limit=1.0 / jp.heating_cooling_cfl_limit, cfl=jp.cfl,
            sn=sn, fast=True, dphi=jg.dphi, invdphi=jg.invdphi)
    omega_row = vmean * jg.inv_rb
    denom = jnp.abs(omega_row[:-1] - omega_row[1:]) + 1e-100
    ref = jnp.minimum(jnp.min((jp.cfl * jg.dphi / denom)[:NR - 2]), dt_min)

    ctx = _ctx(kw)
    got = kernels.cfl(ctx, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]),
                      T(f["energy"]), T(f["qplus"]), T(f["qminus"]))
    assert kernels.LAUNCHES["cfl"] == 0
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)


def _sources_kw(adiabatic):
    return dict(eos="adiabatic" if adiabatic else "isothermal",
                adiabatic_index=1.4, thickness_smoothing=0.6,
                aspectratio_ref=0.05, imposed_disk_drift=1e-4)


def _two_bodies(device="cpu"):
    f64 = lambda v: torch.tensor(v, dtype=torch.float64,   # noqa: E731
                                 device=device)
    return gravity.BodiesOnGrid(x=f64([0.0, 1.0]), y=f64([0.0, 0.3]),
                                mass=f64([1.0, 1e-3]),
                                cubic_smoothing_radius=f64([0.0, 0.05]))


@pytest.mark.parametrize("adiabatic", [True, False])
def test_sources_plain_matches_pallas(adiabatic):
    kw = _sources_kw(adiabatic)
    jp, jc, jgeom, jg = _jax(kw)
    f = _fields(5)
    dt, omega, it = 0.003, 0.4, (1e-5, -2e-5)
    cs_iso = j_eos.sound_speed_iso_profile(jp, jc, jg.rb)
    cols, cos_row, sin_row, modes = pk.make_sources_prep(
        jp, jc, jgeom, jg, cs_iso, 2, jnp.float64)
    per_body = jnp.stack(
        [jc.G * jnp.asarray([1.0, 1e-3]), jnp.asarray([0.0, 1.0]),
         jnp.asarray([0.0, 0.3]), jnp.asarray([0.0, 0.05]), jnp.zeros(2)],
        axis=1).reshape(-1)
    scal = jnp.concatenate([jnp.asarray([dt, omega, it[0], it[1]]),
                            per_body])
    with _interpret():
        vr_ref, va_ref = pk.sources_fused_pallas(
            jnp.asarray(f["sigma"]), jnp.asarray(f["energy"]),
            jnp.asarray(f["vaz"]), jnp.asarray(f["vrad"]), cols, cos_row,
            sin_row, scal, n_bodies=2, adiabatic=adiabatic,
            gamma=jp.adiabatic_index, eps=jp.thickness_smoothing,
            smooth_modes=modes)

    ctx = _ctx(kw)
    vr, va = kernels.sources(ctx, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]),
                             T(f["energy"]), _two_bodies(),
                             (T(it[0]), T(it[1])), T(omega), T(dt))
    np.testing.assert_allclose(vr.numpy(), np.asarray(vr_ref), rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(va.numpy(), np.asarray(va_ref), rtol=1e-11,
                               atol=1e-13)


@pytest.mark.parametrize("sn", [True, False])
def test_cfl_plain_matches_pallas_isothermal(sn):
    """The locally isothermal CFL (the quickstart's: SN artificial
    viscosity; the spreading ring's: none of it)."""
    test_cfl_plain_matches_pallas(False, sn)


@pytest.mark.parametrize("adiabatic", [True, False])
@pytest.mark.parametrize("ramp", [0.0, 0.5, 1.0])
def test_sources_plain_matches_pallas_with_a_ramped_planet(adiabatic, ramp):
    """A star and a 1e-3 planet at r = 1, inside the grid, with its mass
    ramped to the fraction ``ramp`` (0 at the start of the ramp), and its
    cubic smoothing radius: the per-body scalars the step hands the op."""
    kw = _sources_kw(adiabatic)
    jp, jc, jgeom, jg = _jax(kw)
    f = _fields(9)
    dt, omega, it = 0.002, 0.0, (3e-6, 1e-6)
    mass = [1.0, 1e-3 * ramp]
    pos = ([0.0, 1.0], [0.0, 0.0])
    cubic = [0.0, 0.07]
    cs_iso = j_eos.sound_speed_iso_profile(jp, jc, jg.rb)
    cols, cos_row, sin_row, modes = pk.make_sources_prep(
        jp, jc, jgeom, jg, cs_iso, 2, jnp.float64)
    per_body = jnp.stack(
        [jc.G * jnp.asarray(mass), jnp.asarray(pos[0]), jnp.asarray(pos[1]),
         jnp.asarray(cubic), jnp.zeros(2)], axis=1).reshape(-1)
    scal = jnp.concatenate([jnp.asarray([dt, omega, it[0], it[1]]),
                            per_body])
    with _interpret():
        vr_ref, va_ref = pk.sources_fused_pallas(
            jnp.asarray(f["sigma"]), jnp.asarray(f["energy"]),
            jnp.asarray(f["vaz"]), jnp.asarray(f["vrad"]), cols, cos_row,
            sin_row, scal, n_bodies=2, adiabatic=adiabatic,
            gamma=jp.adiabatic_index, eps=jp.thickness_smoothing,
            smooth_modes=modes)
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    bodies = gravity.BodiesOnGrid(x=f64(pos[0]), y=f64(pos[1]),
                                  mass=f64(mass),
                                  cubic_smoothing_radius=f64(cubic))
    vr, va = kernels.sources(_ctx(kw), T(f["sigma"]), T(f["vrad"]),
                             T(f["vaz"]), T(f["energy"]), bodies,
                             (T(it[0]), T(it[1])), T(omega), T(dt))
    np.testing.assert_allclose(vr.numpy(), np.asarray(vr_ref), rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(va.numpy(), np.asarray(va_ref), rtol=1e-11,
                               atol=1e-13)


def _visc_kw(adiabatic, artvisc_on):
    return dict(eos="adiabatic" if adiabatic else "isothermal",
                adiabatic_index=1.4, viscous_alpha=1e-3,
                aspectratio_ref=0.05, flaring_index=0.25,
                artificial_viscosity=artvisc_on,
                artificial_viscosity_dissipation=True,
                heating_viscous=True, cooling_beta_enabled=True,
                cooling_beta=10.0, minimum_temperature=1e-6, sigma0=1.0,
                sigma_floor=1e-6)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("artvisc_on", ["sn", "tw", "none"])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_viscous_kick_plain_matches_pallas(compress, artvisc_on, adiabatic):
    kw = _visc_kw(adiabatic, artvisc_on)
    jp, jc, jgeom, jg = _jax(kw)
    f = _fields(11, floor_cells=True)
    dt = 0.003
    gam = jp.adiabatic_index
    cols = pk.make_viscous_prep(jp, jc, jg, jnp.float64, 16)
    with _interpret():
        ref = pk.viscous_kick_pallas(
            jnp.asarray(f["sigma"]), jnp.asarray(f["vrad"]),
            jnp.asarray(f["vaz"]), jnp.asarray(f["energy"]), cols,
            jnp.float64(dt), jnp.float64(1.0 / jp.cooling_beta), tile=16,
            adiabatic=adiabatic, gamma=gam, alpha=jp.viscous_alpha,
            const_nu=jp.constant_viscosity,
            c2=jp.artificial_viscosity_factor ** 2,
            artvisc={"none": 0, "sn": 1, "tw": 2}[artvisc_on],
            dissipation=True, compress=compress, heating=True,
            heat_factor=jp.heating_viscous_factor,
            rvf=jp.radial_viscosity_factor, beta_on=True,
            tmin=jp.minimum_temperature,
            tmax=j_eos.finite_in(jp.maximum_temperature, jnp.float64),
            rs=jc.R / (jp.mu * (gam - 1.0)),
            rad_fac=8.0 * jc.sigma_sb / jc.c,
            mu_fac=(jp.mu * (gam - 1.0) / jc.R) ** 4,
            sig_nf=10.0 * jp.sigma0 * jp.sigma_floor, invdphi=jg.invdphi)

    ctx = _ctx(kw)
    got = kernels.viscous_kick(ctx, T(f["sigma"]), T(f["vrad"]),
                               T(f["vaz"]), T(f["energy"]), T(dt), 0.0,
                               compress=compress)
    vr, va, e, qp, qm = [np.asarray(x) for x in ref]
    np.testing.assert_allclose(got[0].numpy(), vr, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got[1].numpy(), va, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got[2].numpy(), e, rtol=1e-10, atol=1e-16)
    np.testing.assert_allclose(got[3].numpy(), qp, rtol=1e-10, atol=1e-18)
    np.testing.assert_allclose(got[4].numpy(), qm, rtol=1e-10, atol=1e-18)


def _transport_kw(adiabatic, fast):
    return dict(eos="adiabatic" if adiabatic else "isothermal",
                adiabatic_index=1.4, aspectratio_ref=0.05,
                fast_transport=fast)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_transport_plain_matches_pallas(adiabatic, fast):
    kw = _transport_kw(adiabatic, fast)
    jp, jc, jgeom, jg = _jax(kw)
    f = _fields(13)
    dt, omega = 0.01, 0.3
    vaz = jnp.asarray(f["vaz"])
    vmean = jnp.mean(vaz, axis=-1, keepdims=True)
    ntilde = vmean * jg.inv_rb * dt * jg.invdphi
    nround = jnp.floor(ntilde + 0.5)
    nshift = nround.astype(jnp.int32)[:, 0]
    vconst = (ntilde - nround) * jg.rb * jg.dphi / dt
    cols = pk.make_transport_prep(jg, jnp.float64, 16)
    with _interpret():
        ref = pk.transport_fused_pallas(
            jnp.asarray(f["sigma"]), jnp.asarray(f["vrad"]), vaz,
            jnp.asarray(f["energy"]), cols, nshift, vmean, vconst,
            jnp.float64(dt), jnp.float64(omega), tile=16,
            adiabatic=adiabatic, limiter=jp.flux_limiter_type, fast=fast,
            dphi=jg.dphi)

    ctx = _ctx(kw)
    shift = (T(vmean), torch.tensor(np.asarray(nshift)), T(vconst))
    got = kernels.transport(ctx, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]),
                            T(f["energy"]), T(omega), T(dt), shift)
    for g, r, atol in zip(got, ref, (1e-14, 1e-13, 1e-13, 1e-14, 1e-15)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-11,
                                   atol=atol)


def test_transport_shift_rounds_half_up():
    """floor(x + 0.5), not round-half-to-even: the reference's rounding."""
    from types import SimpleNamespace
    one = torch.ones((5, 1), dtype=torch.float64)
    g = SimpleNamespace(rb=one, inv_rb=one, dphi=1.0, invdphi=1.0)
    means = torch.tensor([2.5, -2.5, 0.5, -0.5, 1.5], dtype=torch.float64)
    vaz = means[:, None].expand(5, 4).contiguous()
    _, nshift, vconst = transport.fargo_shift(g, vaz,
                                              torch.tensor(1.0).double())
    assert nshift.dtype == torch.int32
    assert nshift.tolist() == [3, -2, 1, 0, 2]
    assert vconst[:, 0].tolist() == [-0.5, -0.5, -0.5, -0.5, -0.5]


def test_column_order_matches_the_cuda_header():
    """ops/kernels.py KERNEL_COLUMNS and csrc/common.cuh enum Col index
    the same table: a reordering on one side only would feed every kernel
    the wrong geometry."""
    import re
    header = (kernels.CSRC / "common.cuh").read_text()
    body = header[header.index("enum Col {"):header.index("N_COLS_USED")]
    names = [n[2:].lower() for n in re.findall(r"\b(C_[A-Z_]+)\b", body)]
    assert tuple(names) == kernels.KERNEL_COLUMNS
    n_cols = int(re.search(r"constexpr int N_COLS = (\d+);", header).group(1))
    assert n_cols == kernels.N_COLS


def test_cuda_launch_refuses_cpu_tensors():
    """The CUDA path never runs on CPU tensors (and never falls back)."""
    x = torch.zeros((8, 16), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        kernels._launch("cfl", x, [x], [], [8, 16])
    assert kernels.LAUNCHES["cfl"] == 0
