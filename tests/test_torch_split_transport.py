"""The split transport route of fargocpt_torch against the JAX package, on
the CPU in float64.

- Each plain version of the split route's ops against its Pallas TPU
  kernel in interpret mode, as tests/test_pallas_kernels.py runs them, on
  a 40x256 grid (NR not a multiple of 16, NAZ a multiple of 128), over
  K = 5 and 6, both limiters and one or two azimuthal sweeps, with shifts
  of either sign: rtol 1e-12, atol 1e-14, the tolerances of that file.
- The route a grid takes by itself: the whole route for every NR, shown
  beside the route the JAX package's gate takes (NR off a multiple of 16
  goes to its split route: a tile of its TPU kernel, not carried over).
- The split composition, and the whole route's plain version at NR = 33
  and NR = 1000, against the JAX package's jnp transport (rtol 1e-11, as
  tests/test_torch_kernels.py holds the whole route).
- The flagship Simulation at 40x128 on the split route (named) and on the
  default route against the JAX Simulation for 10 steps, with the
  tolerances of tests/test_torch_slice.py.

The CUDA kernels themselves are held to these plain versions on the GPU by
tests/test_torch_gpu.py.
"""

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

NR, NAZ = 40, 256


def _phys_kw(adiabatic=True, limiter=0, fast=True):
    return dict(eos="adiabatic" if adiabatic else "isothermal",
                adiabatic_index=1.4, aspectratio_ref=0.05,
                flux_limiter_type=limiter, fast_transport=fast)


def _ctx(kw, nr=NR, naz=NAZ, route=None):
    geom = Geometry.build(nr, naz, 0.4, 2.5, "Log")
    return kernels.KernelContext(Physics(**kw), Constants.from_units(Units()),
                                 geom, torch.float64, "cpu",
                                 transport_route=route)


def _jax_geom(nr=NR, naz=NAZ, dtype=jnp.float64):
    return j_prepare_geom(JGeometry.build(nr, naz, 0.4, 2.5, "Log"), dtype)


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _fields(seed, nr=NR, naz=NAZ):
    rng = np.random.default_rng(seed)
    return dict(sigma=rng.random((nr, naz)) + 0.5,
                energy=rng.random((nr, naz)) + 0.2,
                vaz=(rng.random((nr, naz)) - 0.5) * 0.1 + 1.0,
                vrad=(rng.random((nr + 1, naz)) - 0.5) * 0.05)


@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_radial_momenta_sweep_plain_matches_pallas(adiabatic, limiter):
    k_quant = 6 if adiabatic else 5
    jg = _jax_geom()
    f = _fields(11)
    dt, omega = 0.01, 0.3
    ds = j_transport.star_radial(JPhysics(flux_limiter_type=limiter), jg,
                                 jnp.asarray(f["sigma"]),
                                 jnp.asarray(f["vrad"]), jnp.float64(dt))
    base = dt * jg.dphi * jg.ra * ds * jnp.asarray(f["vrad"])
    rme = jg.rmed_ext
    zc = jnp.zeros((1, 1), rme.dtype)
    cm = jnp.concatenate([zc, rme[1:] - rme[:-1]], axis=0)
    cp = jnp.concatenate([rme[1:] - rme[:-1], zc], axis=0)
    with pltpu.force_tpu_interpret_mode():
        ref = pk.radial_momenta_sweep_pallas(
            jnp.asarray(f["sigma"]), jnp.asarray(f["vrad"]),
            jnp.asarray(f["vaz"]),
            jnp.asarray(f["energy"] if adiabatic else f["sigma"]), base,
            jnp.float64(dt), jnp.float64(omega), jg.rb, jg.inv_diff_rmed, cm,
            cp, jg.inv_surf, k_quant=k_quant, limiter=limiter)

    ctx = _ctx(_phys_kw(adiabatic, limiter))
    got = kernels.radial_momenta_sweep(
        ctx, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]), T(f["energy"]),
        T(base), T(dt), T(omega))
    assert telemetry.value("launch.radial_momenta_sweep") == 0
    assert got.shape == (k_quant, NR, NAZ)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("two_pass", [True, False])
@pytest.mark.parametrize("limiter", [0, 1])
@pytest.mark.parametrize("k_quant", [5, 6])
def test_fargo_theta_plain_matches_pallas(k_quant, limiter, two_pass):
    jg = _jax_geom()
    rng = np.random.default_rng(7)
    qs = rng.random((k_quant, NR, NAZ)) + 0.5
    v = (rng.random((NR, NAZ)) - 0.5) * 0.05
    vconst = (rng.random((NR, 1)) - 0.5) * 0.02
    nshift = rng.integers(-40, 40, NR).astype(np.int32)
    assert (nshift < 0).any() and (nshift > 0).any()
    dt = 0.01
    vres = v if two_pass else v + vconst
    # the tile the JAX package picks for 40 rings (transport.py:256)
    with pltpu.force_tpu_interpret_mode():
        ref = pk.fargo_theta_pallas(
            jnp.asarray(qs), jnp.asarray(vres), jnp.asarray(vconst),
            jnp.asarray(nshift), jg.rb, jg.rsup - jg.rinf, jg.inv_surf,
            jnp.float64(dt), dphi=jg.dphi, limiter=limiter, tile=8,
            two_pass=two_pass)

    ctx = _ctx(_phys_kw(limiter=limiter))
    got = kernels.fargo_theta(ctx, T(qs), T(vres), T(vconst),
                              torch.tensor(nshift), T(dt), two_pass)
    assert telemetry.value("launch.fargo_theta") == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-14)


class _Took(Exception):
    pass


@pytest.mark.parametrize("nr", [40, 64, 130, 1000, 1024])
def test_route_matches_the_jax_gate(monkeypatch, nr):
    """The JAX package's transport, run as on the TPU (float32, NAZ a
    multiple of 128, the kernels stubbed to report which one it reached),
    takes its whole-transport kernel where NR is a multiple of 16, the row
    tile of that kernel, and its split route elsewhere. The port's kernel
    has no such tile: ``transport.route`` names the whole route for every
    NR, and the other routes are there by name."""
    def took(name):
        def stub(*args, **kwargs):
            raise _Took(name)
        return stub
    monkeypatch.setattr(pk, "use_pallas", lambda dtype=None: True)
    monkeypatch.setattr(pk, "transport_fused_pallas", took("whole"))
    monkeypatch.setattr(pk, "radial_momenta_sweep_pallas", took("split"))
    naz = 128
    jg = _jax_geom(nr, naz, jnp.float32)
    f = {k: jnp.asarray(v, jnp.float32) for k, v in _fields(3, nr, naz).items()}
    with pytest.raises(_Took) as took_route:
        j_transport.transport(JPhysics(), jg, f["sigma"], f["vrad"],
                              f["vaz"], f["energy"], jnp.float32(0.0),
                              jnp.float32(0.01))
    assert str(took_route.value) == ("whole" if nr % 16 == 0 else "split")
    assert transport.route(nr) == "whole"
    assert _ctx(_phys_kw(), nr, naz).route == "whole"
    for named in kernels.ROUTES:
        assert _ctx(_phys_kw(), nr, naz, route=named).route == named


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_split_composition_matches_jax_transport(adiabatic, fast):
    kw = _phys_kw(adiabatic, fast=fast)
    jg = _jax_geom()
    f = _fields(13)
    f["energy"] = f["energy"] * 1e-3
    dt, omega = 0.01, 0.3
    ref = j_transport.transport(
        JPhysics(**kw), jg, *[jnp.asarray(f[k]) for k in
                             ("sigma", "vrad", "vaz", "energy")],
        jnp.float64(omega), jnp.float64(dt))
    ctx = _ctx(kw, route="split")
    assert ctx.route == "split"
    got = kernels.transport(ctx, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]),
                            T(f["energy"]), T(omega), T(dt))
    assert all(telemetry.value("launch." + op) == 0 for op in kernels.OPS)
    for name, g, r, atol in zip(
            ("sigma", "vrad", "vaz", "energy", "mass_flux"), got, ref,
            (1e-14, 1e-13, 1e-13, 1e-14, 1e-15)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-11,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("nr,naz", [(33, 40), (1000, 12)])
def test_whole_route_off_a_multiple_of_16_matches_jax_transport(nr, naz,
                                                                fast):
    """The route every grid now takes, at NR off a multiple of 16 (where
    the JAX package's float64 path is its jnp transport): the whole
    route's plain version against ``transport()``, at the tolerances the
    split composition is held to."""
    kw = _phys_kw(fast=fast)
    jg = _jax_geom(nr, naz)
    f = _fields(17, nr, naz)
    f["energy"] = f["energy"] * 1e-3
    dt, omega = 0.01, 0.3
    ref = j_transport.transport(
        JPhysics(**kw), jg, *[jnp.asarray(f[k]) for k in
                             ("sigma", "vrad", "vaz", "energy")],
        jnp.float64(omega), jnp.float64(dt))
    ctx = _ctx(kw, nr, naz)
    assert ctx.route == "whole"
    got = kernels.transport(ctx, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]),
                            T(f["energy"]), T(omega), T(dt))
    assert all(telemetry.value("launch." + op) == 0 for op in kernels.OPS)
    for name, g, r, atol in zip(
            ("sigma", "vrad", "vaz", "energy", "mass_flux"), got, ref,
            (1e-14, 1e-13, 1e-13, 1e-14, 1e-15)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-11,
                                   atol=atol, err_msg=name)


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


def _ten_flagship_steps_match_jax(route):
    js = JSimulation(JConfig.from_dict(dict(FLAGSHIP_40)))
    ts = Simulation(Config.from_dict(dict(FLAGSHIP_40)), device="cpu",
                    transport_route=route)
    assert ts.stepper.ops.route == (route or "whole")
    for _ in range(10):
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


def test_flagship_on_the_split_route_matches_jax():
    """Ten flagship steps at 40x128 through the split route; tolerances of
    tests/test_torch_slice.py (rtol 1e-10, v_rad atol 1e-9 max|v_rad|)."""
    _ten_flagship_steps_match_jax("split")


def test_flagship_at_40_rings_on_the_default_route_matches_jax():
    """The same ten steps on the route the grid takes by itself, the whole
    route, at the same tolerances."""
    _ten_flagship_steps_match_jax(None)
