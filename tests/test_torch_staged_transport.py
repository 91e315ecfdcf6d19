"""The staged transport route of fargocpt_torch against the JAX package, on
the CPU in float64.

- Each plain stage (``radial_sweep``, ``theta_sweep``, ``advect_shift``)
  against its Pallas TPU kernel in interpret mode, as
  tests/test_pallas_kernels.py runs them, at 64x256 over K = 5 and 6 and
  both limiters: rtol 1e-12, atol 1e-14, the tolerances of that file; the
  roll bit for bit, with shifts in -40..40 and beyond NAZ.
- ``transport_staged`` against the JAX package's ``transport``, which takes
  its stage-by-stage branch on the CPU: rtol 1e-12, with and without fast
  transport, adiabatic and isothermal. The absolute floors are those of
  tests/test_torch_split_transport.py (v_rad and v_az are differences of
  momenta ~1e2 times larger).
- The three routes of the port against each other on one state, and a
  planted fault (the second azimuthal pass given the pre-sweep density)
  that the same check must refuse.
- The flagship Simulation at 40x128 with ``transport_route="staged"``
  against the JAX Simulation for 20 steps, with the tolerances of
  tests/test_torch_slice.py (rtol 1e-10, v_rad atol 1e-9 max|v_rad|).

The CUDA kernels themselves are held to these plain versions on the GPU by
tests/test_torch_gpu.py.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import pallas_kernels as pk, transport as j_transport
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.params import Physics as JPhysics
from fargocpt_tpu.sim import Simulation as JSimulation

from fargocpt_torch import telemetry
from fargocpt_torch.config import Config
from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import kernels, transport
from fargocpt_torch.params import Physics
from fargocpt_torch.sim import Simulation
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR, NAZ = 64, 256
OUTPUTS = ("sigma", "vrad", "vaz", "energy", "mass_flux")


def _phys_kw(adiabatic=True, limiter=0, fast=True):
    return dict(eos="adiabatic" if adiabatic else "isothermal",
                adiabatic_index=1.4, aspectratio_ref=0.05,
                flux_limiter_type=limiter, fast_transport=fast)


def _ctx(kw, nr=NR, naz=NAZ, route=None):
    geom = Geometry.build(nr, naz, 0.4, 2.5, "Log")
    return kernels.KernelContext(Physics(**kw), Constants.from_units(Units()),
                                 geom, torch.float64, "cpu", route)


def _jax_geom(nr=NR, naz=NAZ):
    return j_prepare_geom(JGeometry.build(nr, naz, 0.4, 2.5, "Log"),
                          jnp.float64)


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _fields(seed, nr=NR, naz=NAZ):
    rng = np.random.default_rng(seed)
    return dict(sigma=rng.random((nr, naz)) + 0.5,
                energy=(rng.random((nr, naz)) + 0.2) * 1e-3,
                vaz=(rng.random((nr, naz)) - 0.5) * 0.1 + 1.0,
                vrad=(rng.random((nr + 1, naz)) - 0.5) * 0.05)


def _no_launch():
    assert all(telemetry.value("launch." + op) == 0 for op in kernels.OPS)


@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("k_quant", [5, 6])
def test_radial_sweep_plain_matches_pallas(k_quant, limiter):
    jg = _jax_geom()
    rng = np.random.default_rng(3)
    qs = rng.random((k_quant, NR, NAZ)) + 0.5
    vrad = (rng.random((NR + 1, NAZ)) - 0.5) * 0.05
    dt = 0.01
    sig = jnp.asarray(qs[-1])
    ds = j_transport.star_radial(JPhysics(flux_limiter_type=limiter), jg, sig,
                                 jnp.asarray(vrad), jnp.float64(dt))
    base = dt * jg.dphi * jg.ra * ds * jnp.asarray(vrad)
    rme = jg.rmed_ext
    zc = jnp.zeros((1, 1), rme.dtype)
    cm = jnp.concatenate([zc, rme[1:] - rme[:-1]], axis=0)
    cp = jnp.concatenate([rme[1:] - rme[:-1], zc], axis=0)
    with pltpu.force_tpu_interpret_mode():
        ref = pk.radial_sweep_pallas(jnp.asarray(qs), sig, jnp.asarray(vrad),
                                     base, jnp.float64(dt), jg.inv_diff_rmed,
                                     cm, cp, jg.inv_surf, limiter=limiter)
    ctx = _ctx(_phys_kw(limiter=limiter))
    got = kernels.radial_sweep(ctx, T(qs), T(qs[-1]), T(vrad), T(base), T(dt))
    _no_launch()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-14)
    # the port's sigma flux is the ``base`` the JAX package builds
    mine = transport.sigma_flux(ctx.phys, ctx.g, T(qs[-1]), T(vrad), T(dt))
    np.testing.assert_allclose(mine.numpy(), np.asarray(base), rtol=1e-12,
                               atol=1e-16)


@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("k_quant", [5, 6])
def test_theta_sweep_plain_matches_pallas(k_quant, limiter):
    jg = _jax_geom()
    rng = np.random.default_rng(42)
    qs = rng.random((k_quant, NR, NAZ)) + 0.5
    v = (rng.random((NR, NAZ)) - 0.5) * 0.05
    dt = 0.01
    with pltpu.force_tpu_interpret_mode():
        ref = pk.theta_sweep_pallas(jnp.asarray(qs), jnp.asarray(v), jg.rb,
                                    jg.rsup - jg.rinf, jg.inv_surf,
                                    jnp.float64(dt), dphi=jg.dphi,
                                    limiter=limiter, tile=16)
    ctx = _ctx(_phys_kw(limiter=limiter))
    got = kernels.theta_sweep(ctx, T(qs), T(v), T(dt))
    _no_launch()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("span", [40, 3 * NAZ], ids=["pm40", "beyond_naz"])
@pytest.mark.parametrize("k_quant", [5, 6])
def test_advect_shift_plain_equals_pallas(k_quant, span):
    rng = np.random.default_rng(7)
    qs = rng.random((k_quant, NR, NAZ)) + 0.5
    nshift = rng.integers(-span, span, NR).astype(np.int32)
    assert (nshift < 0).any() and (nshift > 0).any()
    assert span <= NAZ or (np.abs(nshift) > NAZ).any()
    with pltpu.force_tpu_interpret_mode():
        ref = pk.advect_shift_pallas(jnp.asarray(qs), jnp.asarray(nshift),
                                     tile=16)
    got = kernels.advect_shift(T(qs), torch.tensor(nshift))
    _no_launch()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the definition, element by element
    i, j = 5, 17
    assert got[2, i, j] == qs[2, i, (j - int(nshift[i])) % NAZ]


def _assert_outputs(got, ref, rtol, label=""):
    for name, a, b, atol in zip(OUTPUTS, got, ref,
                                (1e-14, 1e-13, 1e-13, 1e-17, 1e-15)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=f"{name} {label}")


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_staged_composition_matches_jax_transport(adiabatic, fast):
    kw = _phys_kw(adiabatic, fast=fast)
    jg = _jax_geom()
    f = _fields(13)
    dt, omega = 0.01, 0.3
    ref = j_transport.transport(
        JPhysics(**kw), jg, *[jnp.asarray(f[k]) for k in
                             ("sigma", "vrad", "vaz", "energy")],
        jnp.float64(omega), jnp.float64(dt))
    ctx = _ctx(kw, route="staged")
    assert ctx.route == "staged"
    got = kernels.transport(ctx, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]),
                            T(f["energy"]), T(omega), T(dt))
    _no_launch()
    _assert_outputs([g.numpy() for g in got], ref, 1e-12)


def _route_args(ctx, f, dt=0.01, omega=0.3):
    return (ctx.phys, ctx.g, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]),
            T(f["energy"]), T(omega), T(dt))


@pytest.mark.parametrize("fast", [True, False])
def test_three_routes_agree_on_one_state(fast):
    """whole, split and staged on one state with one shift: rtol 1e-12."""
    ctx = _ctx(_phys_kw(fast=fast))
    f = _fields(21)
    outs = {r: kernels.transport_plain(
        ctx, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]), T(f["energy"]),
        T(0.3), T(0.01), transport.fargo_shift(ctx.g, T(f["vaz"]), T(0.01)),
        route=r) for r in kernels.ROUTES}
    for r in ("split", "staged"):
        _assert_outputs([o.numpy() for o in outs[r]],
                        [o.numpy() for o in outs["whole"]], 1e-12, r)


def test_second_pass_with_the_presweep_density_is_caught():
    """The planted fault: both azimuthal passes divide by and upwind the
    density of the batch as the radial sweep left it, where the second must
    take it as the first pass left it. On a smooth disk that moves the
    result by less than the float32 budget; the float64 check refuses
    it."""
    ctx = _ctx(_phys_kw())
    f = _fields(21)
    args = _route_args(ctx, f)
    good = transport.transport_staged(*args)
    ref = transport.transport(*args)
    _assert_outputs([o.numpy() for o in good], [o.numpy() for o in ref],
                    1e-12)

    first = {}

    def stale_density_sweep(qs, v, dt):
        sig = first.setdefault("sigma", qs[-1])
        ds = transport.star_theta(ctx.phys, ctx.g, sig, v, dt)
        return transport.van_leer_theta_batch(ctx.phys, ctx.g, qs, sig, ds,
                                              v, dt)

    bad = transport.transport_staged(*args, theta=stale_density_sweep)
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(bad[:4], ref[:4]))
    assert worst > 1e-9, worst
    with pytest.raises(AssertionError):
        _assert_outputs([o.numpy() for o in bad], [o.numpy() for o in ref],
                        1e-12)


def test_stand_ins_are_called_per_stage():
    """``radial``, ``theta`` and ``roll`` stand in for the plain stages:
    one radial sweep, one azimuthal sweep per pass, one roll."""
    for fast, n_theta in ((True, 2), (False, 1)):
        ctx = _ctx(_phys_kw(fast=fast))
        calls = {"radial": 0, "theta": 0, "roll": 0}

        def counted(name, fn):
            def wrapped(*a):
                calls[name] += 1
                return fn(*a)
            return wrapped

        transport.transport_staged(
            *_route_args(ctx, _fields(5)),
            radial=counted("radial", partial(transport.radial_sweep,
                                             ctx.phys, ctx.g)),
            theta=counted("theta", partial(transport.theta_sweep, ctx.phys,
                                           ctx.g)),
            roll=counted("roll", transport.advect_shift))
        assert calls == {"radial": 1, "theta": n_theta, "roll": 1}


def test_route_keyword():
    assert _ctx(_phys_kw()).route == "whole"
    assert _ctx(_phys_kw(), nr=40).route == "whole"
    assert _ctx(_phys_kw(), nr=40, route="staged").route == "staged"
    assert _ctx(_phys_kw(), route="split").route == "split"
    with pytest.raises(ValueError, match="transport_route"):
        _ctx(_phys_kw(), route="fused")


FLAGSHIP_40 = {
    "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
    "AspectRatio": "0.05", "FlaringIndex": "0.25",
    "ViscousAlpha": "0.001",
    "Sigma0": "200 g/cm2", "SigmaSlope": "0.5",
    "HeatingViscous": "Yes", "CoolingBetaLocal": "Yes",
    "CoolingBeta": "10",
    "ArtificialViscosity": "SN",
    "Nrad": "40", "Naz": "128",
    "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Log",
    "InnerBoundary": "outflow", "OuterBoundary": "outflow",
    "Transport": "FARGO",
    "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "1.0",
}


def test_flagship_on_the_staged_route_matches_jax():
    """Twenty flagship steps at 40x128 through the staged route; tolerances
    of tests/test_torch_slice.py (rtol 1e-10, v_rad atol 1e-9 max|v_rad|)."""
    js = JSimulation(JConfig.from_dict(dict(FLAGSHIP_40)))
    ts = Simulation(Config.from_dict(dict(FLAGSHIP_40)), device="cpu",
                    transport_route="staged")
    assert ts.stepper.ops.route == "staged"
    for _ in range(20):
        dj = js.calculate_time_step()
        dt = ts.calculate_time_step()
        np.testing.assert_allclose(float(dt), dj, rtol=1e-12)
        js.step_once(dj)
        ts.step_once(dt)
    np.testing.assert_allclose(float(ts.time), js.time, rtol=1e-12)
    for name in ("sigma", "vrad", "vaz", "energy"):
        ref = np.asarray(getattr(js.state.fields, name))
        atol = 1e-9 * np.abs(ref).max() if name == "vrad" else 0.0
        np.testing.assert_allclose(getattr(ts.fields, name).numpy(), ref,
                                   rtol=1e-10, atol=atol, err_msg=name)
    for name in ("qplus", "qminus"):
        ref = np.asarray(getattr(js.state, name))
        np.testing.assert_allclose(getattr(ts.state, name).numpy(), ref,
                                   rtol=1e-10, atol=1e-10 * np.abs(ref).max(),
                                   err_msg=name)
    np.testing.assert_allclose(
        ts.state.monitor_acc.mass_delta.numpy(),
        np.asarray(js.state.monitor_acc.mass_delta), rtol=1e-10, atol=1e-30)
