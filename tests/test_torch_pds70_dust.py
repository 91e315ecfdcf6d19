"""The whole PDS70 setup, Lagrangian dust included: fargocpt_torch's
Simulation of ``flagship.pds70`` against the JAX package's
``__graft_entry__._pds70``, both on the CPU.

float64 at 32x64 with 256 particles, 20 steps: the gas at the tolerances
of tests/test_torch_pds70.py (rtol 1e-10; v_rad atol 1e-9 max|v_rad|), the
particles' r, phi (mod 2 pi), phi_dot and stokes at rtol 1e-9, r_dot
(which starts at 0 and stays ~1e-4 of r phi_dot) at 1e-9 of max|r_dot|,
``alive`` equal.

float32 at 64x128 with 1024 particles, 50 steps: within the 1e-3 rel-L2
budget of tests/test_dtype_budget.py. In float32 the stopping time's
constants underflow in these units (tests/test_torch_dust.py), in both
packages: every particle fails the escape test on its first step and is
frozen where it started, so the float32 comparison of the swarm is one of
equal arrays.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.params import physics_from_config as j_physics_from_config
from fargocpt_tpu.sim import Simulation as JSimulation
from fargocpt_tpu.units import Units as JUnits

from fargocpt_torch.config import Config
from fargocpt_torch.flagship import PDS70, pds70
from fargocpt_torch.params import physics_from_config
from fargocpt_torch.particles.dust import ParticleState
from fargocpt_torch.sim import Simulation, reachable_tensors
from fargocpt_torch.state import (system_state_from_numpy,
                                  system_state_to_numpy)
from fargocpt_torch.units import Units

torch.set_num_threads(2)

FIELDS = ("sigma", "vrad", "vaz", "energy")
# the swarm's tensors (the diffusion's generator, ``rng``, is not one)
PARTICLE_FIELDS = tuple(f.name for f in dataclasses.fields(ParticleState)
                        if f.name != "rng")


def _cfg(nr, naz, n, **kw):
    return dict(PDS70, Nrad=str(nr), Naz=str(naz), NumberOfParticles=str(n),
                **kw)


def _capture_graft_config(n_particles):
    import __graft_entry__
    import fargocpt_tpu.sim as jsim
    captured = {}
    real = jsim.Simulation
    jsim.Simulation = lambda cfg, dtype: captured.setdefault("cfg", cfg)
    try:
        __graft_entry__._pds70(32, 64, "float64", n_particles)
    finally:
        jsim.Simulation = real
    return captured["cfg"]


def test_setup_equals_the_jax_pds70():
    """``pds70`` is ``_pds70`` whole: equal Physics, and equal particle
    keys (number, radius, species, integrator)."""
    jcfg = _capture_graft_config(256)
    tcfg = pds70(32, 64, n_particles=256)
    jp = j_physics_from_config(jcfg, JUnits(), dtype="float64")
    tp = physics_from_config(tcfg, Units(), dtype="float64")
    assert all(getattr(jp, f.name) == getattr(tp, f.name)
               for f in dataclasses.fields(jp))
    assert tp.integrate_particles
    for key in ("NumberOfParticles", "ParticleRadius",
                "ParticleSpeciesNumber", "ParticleIntegrator"):
        assert str(tcfg.get_raw(key)) == str(jcfg.get_raw(key)), key
    assert int(pds70(32, 64).get_raw("NumberOfParticles")) == 16384


@pytest.fixture(scope="module")
def pair64():
    js = JSimulation(JConfig.from_dict(_cfg(32, 64, 256)))
    ts = Simulation(pds70(32, 64, n_particles=256), device="cpu")
    return js, ts


def test_initial_swarm_equals_jax(pair64):
    js, ts = pair64
    jp, tp = js.state.particles, ts.state.particles
    assert tp.n == 256
    for name in PARTICLE_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    # four sizes from 1 cm, a decade apart
    sizes = np.unique(tp.size.numpy())
    np.testing.assert_allclose(sizes / sizes[0], [1.0, 10.0, 100.0, 1000.0],
                               rtol=1e-12)
    jpp, tpp = js.stepper.particle_params, ts.stepper.particle_params
    assert dataclasses.asdict(tpp) == dataclasses.asdict(jpp)
    assert tpp.integrator == "midpoint" and not tpp.cartesian


def _assert_gas(t_state, j_state, rtol=1e-10, vrad_atol=1e-9):
    for name in FIELDS:
        ref = np.asarray(getattr(j_state.fields, name))
        atol = vrad_atol * np.abs(ref).max() if name == "vrad" else 0.0
        np.testing.assert_allclose(getattr(t_state.fields, name).numpy(),
                                   ref, rtol=rtol, atol=atol, err_msg=name)


def _assert_particles(tp, jp, rtol=1e-9):
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive))
    for name in ("r", "phi_dot", "stokes", "r_dot", "size"):
        ref = np.asarray(getattr(jp, name))
        atol = rtol * np.abs(ref).max() if name == "r_dot" else 0.0
        np.testing.assert_allclose(getattr(tp, name).numpy(), ref, rtol=rtol,
                                   atol=atol, err_msg=name)
    d = np.abs(tp.phi.numpy() - np.asarray(jp.phi))
    assert np.minimum(d, 2.0 * np.pi - d).max() <= rtol * 2.0 * np.pi


def test_twenty_steps_match_jax_f64():
    js = JSimulation(JConfig.from_dict(_cfg(32, 64, 256)))
    ts = Simulation(pds70(32, 64, n_particles=256), device="cpu")
    before = ts.stepper.pvte.refreshes
    for _ in range(20):
        dj = js.calculate_time_step()
        dt = ts.calculate_time_step()
        np.testing.assert_allclose(float(dt), dj, rtol=1e-12)
        js.step_once(dj)
        ts.step_once(dt)
    # the dust reads the memoised step-start PVTE grids: three refreshes
    # per calculate_time_step + step_once, as without the dust
    assert ts.stepper.pvte.refreshes - before == 3 * 20
    np.testing.assert_allclose(float(ts.time), js.time, rtol=1e-12)
    _assert_gas(ts.state, js.state)
    tp, jp = ts.state.particles, js.state.particles
    _assert_particles(tp, jp)
    assert bool(tp.alive.all()) and bool((tp.stokes > 0).all())
    # the swarm moved: drag and gravity act on it
    assert float((tp.r - ts_initial_r(ts)).abs().max()) > 1e-6


def ts_initial_r(ts):
    """The initial radii of ``ts``'s swarm, drawn again from its seed."""
    fresh = Simulation(pds70(ts.geometry.nrad, ts.geometry.naz,
                             n_particles=ts.state.particles.n), device="cpu")
    return fresh.state.particles.r


def test_run_path_refreshes_twice_a_step_with_dust():
    """``run()``: the CFL's refresh serves its step and the dust, two
    refreshes a step as in the gas setup, and the run equals JAX's."""
    cfg = _cfg(16, 32, 64, MonitorTimestep="0.02")
    js = JSimulation(JConfig.from_dict(dict(cfg)))
    ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    before = ts.stepper.pvte.refreshes
    js.run()
    ts.run()
    assert ts.n_hydro_iter == js.n_hydro_iter > 3
    # run() first takes two CFL steps of its own
    assert ts.stepper.pvte.refreshes - before == 2 + 2 * ts.n_hydro_iter
    _assert_gas(ts.state, js.state)
    _assert_particles(ts.state.particles, js.state.particles)


def test_fifty_steps_f32_within_budget():
    js = JSimulation(JConfig.from_dict(_cfg(64, 128, 1024)), dtype="float32")
    ts = Simulation(pds70(64, 128, n_particles=1024), dtype="float32",
                    device="cpu")
    assert ts.state.particles.r.dtype == torch.float32
    for _ in range(50):
        dj = js.calculate_time_step()
        js.step_once(dj)
        ts.step_once(torch.tensor(dj, dtype=torch.float32))
    vaz = np.asarray(js.state.fields.vaz, np.float64)
    for name in FIELDS:
        ref = np.asarray(getattr(js.state.fields, name), np.float64)
        got = getattr(ts.state.fields, name).double().numpy()
        scale = np.linalg.norm(vaz if name == "vrad" else ref)
        assert np.linalg.norm(got - ref) / scale < 1e-3, name
    tp, jp = ts.state.particles, js.state.particles
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive))
    for name in ("r", "phi"):
        ref = np.asarray(getattr(jp, name), np.float64)
        got = getattr(tp, name).double().numpy()
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-3, name
    # float32: the whole swarm is dead after the first step, in both
    assert not bool(tp.alive.any()) and not np.asarray(jp.alive).any()


def jax_particle_tree(particles) -> dict[str, np.ndarray]:
    return {f"particles.{name}": np.asarray(getattr(particles, name))
            for name in PARTICLE_FIELDS}


def test_state_converters_round_trip_the_particles(pair64):
    js, ts = pair64
    tree = system_state_to_numpy(ts.state)
    assert {f"particles.{n}" for n in PARTICLE_FIELDS} <= set(tree)
    assert tree["particles.alive"].dtype == bool
    back = system_state_from_numpy(tree, "cpu", torch.float64)
    for name in PARTICLE_FIELDS:
        a, b = getattr(back.particles, name), getattr(ts.state.particles, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # a swarm taken from the JAX state steps on in the port
    tree.update(jax_particle_tree(js.state.particles))
    seeded = system_state_from_numpy(tree, "cpu", torch.float64)
    assert torch.equal(seeded.particles.r, ts.state.particles.r)
    # a dict without particles gives a state without them
    gas_only = {k: v for k, v in tree.items()
                if not k.startswith("particles.")}
    assert system_state_from_numpy(gas_only, "cpu",
                                   torch.float64).particles is None


def test_every_tensor_lives_on_the_run_device(pair64):
    _, ts = pair64
    found = dict(reachable_tensors(ts))
    for path in ("sim.state.particles.r", "sim.state.particles.alive",
                 "sim.stepper.dust_grid.cell.pos",
                 "sim.stepper.dust_grid.face.pos"):
        assert path in found, path
    assert {t.device.type for t in found.values()} == {"cpu"}
    # the ladder constants are Python floats
    assert all(isinstance(x, float)
               for x in ts.stepper.dust_grid.cell.ladder)


@pytest.mark.parametrize("integrator,cartesian", [
    ("explicit", "no"), ("explicit", "yes"), ("midpoint", "yes")])
def test_integrator_settings_match_jax(integrator, cartesian):
    """The adaptive integrator (polar, cartesian) through the step for 3
    steps at 16x32; midpoint with CartesianParticles warns and stays
    polar, as in the JAX package."""
    cfg = _cfg(16, 32, 32, ParticleIntegrator=integrator,
               CartesianParticles=cartesian)
    warn = integrator == "midpoint"
    if warn:
        with pytest.warns(UserWarning, match="CartesianParticles"):
            js = JSimulation(JConfig.from_dict(dict(cfg)))
        with pytest.warns(UserWarning, match="CartesianParticles"):
            ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    else:
        js = JSimulation(JConfig.from_dict(dict(cfg)))
        ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    assert ts.stepper.particle_params.cartesian == (
        cartesian == "yes" and not warn)
    for _ in range(3):
        dj = js.calculate_time_step()
        js.step_once(dj)
        ts.step_once(torch.tensor(dj, dtype=torch.float64))
    _assert_gas(ts.state, js.state)
    _assert_particles(ts.state.particles, js.state.particles)


def test_dust_diffusion_is_refused_by_name(monkeypatch):
    """Dust diffusion, once refused, now ported: the PDS70 setup at 16x32
    with 32 diffusing particles takes three steps as the JAX package does
    on one shared normal draw a step (tests/test_torch_dust_diffusion.py
    says why), the swarm to rtol 1e-9."""
    import jax
    import jax.numpy as jnp
    from fargocpt_torch.particles import dust
    draw = np.random.default_rng(6).standard_normal(32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape,
                        dtype=None: jnp.asarray(draw, dtype))
    monkeypatch.setattr(dust, "standard_normal",
                        lambda state: torch.tensor(draw))
    cfg = _cfg(16, 32, 32, ParticleDustDiffusion="yes")
    js = JSimulation(JConfig.from_dict(dict(cfg)))
    ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    assert ts.stepper.particle_params.diffusion
    for _ in range(3):
        dj = js.calculate_time_step()
        js.step_once(dj)
        ts.step_once(torch.tensor(dj, dtype=torch.float64))
    for name in ("r", "phi_dot"):
        np.testing.assert_allclose(
            getattr(ts.state.particles, name).numpy(),
            np.asarray(getattr(js.state.particles, name)), rtol=1e-9,
            err_msg=name)
    # off, the key is consulted and the run builds
    Simulation(Config.from_dict(_cfg(16, 32, 32,
                                     ParticleDustDiffusion="no")),
               device="cpu")
