"""Dust diffusion on fargocpt_torch against the JAX package, float64 on
the CPU.

The JAX package draws the kicks with ``jax.random``, which PyTorch cannot
replay; the port draws them from the swarm's ``torch.Generator``. So the
deterministic terms are held on a shared draw: the JAX package's
``jax.random.normal`` is monkeypatched to return a seeded numpy array
(no JAX file changes) and the port's ``diffuse_dust`` takes the same array
as its ``normal``. On the draw 0 the kick is the drift term alone (D_g, the
finite-difference drho/dr, the Schmidt number, Omega_K); on a draw it adds
xi sqrt(2 D_d dt) and the 2-d correction; phi_dot follows the new radius.
Each to rtol 1e-12. Then ten steps of ``examples/full_physics.yml`` at
32x64 with 300 particles on one shared draw a step (rtol 1e-10 for the
gas, 1e-9 for the swarm's coordinates).

The stochastic part has a statistical gate like tests/test_dust.py:113:
on a uniform gas, 20000 particles kicked 20 times spread with variance
2 D t (D = alpha cs H / Sc) to 5 %, the sampling error of the variance
being ~1 %, and their mean stays within four standard errors of 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fargocpt_tpu.particles import dust as j_dust

from fargocpt_torch import flagship
from fargocpt_torch.particles import dust
from fargocpt_torch.state import system_state_to_numpy

from longtail_pairs import assert_fields, build_pair, step_pair

torch.set_num_threads(2)

N_SWARM = 300


def _full_physics(nr=32, naz=64):
    return flagship.setup_file(flagship.FULL_PHYSICS, nr, naz,
                               NumberOfParticles=str(N_SWARM),
                               FirstDT="1e-3")


@pytest.fixture(scope="module")
def pair():
    return build_pair(_full_physics())


def _patch_jax_normal(monkeypatch, draw):
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(
                            draw, dtype))


def test_schmidt_number_matches_jax():
    st = np.geomspace(1e-4, 1e2, 50)
    np.testing.assert_allclose(dust.schmidt_number(torch.tensor(st)).numpy(),
                               np.asarray(j_dust.schmidt_number(st)),
                               rtol=1e-15)


@pytest.mark.parametrize("which", ["drift", "draw"])
def test_diffusion_kick_matches_jax(pair, monkeypatch, which):
    js, ts = pair
    rng = np.random.default_rng(21)
    jp = js.state.particles
    stokes = rng.uniform(1e-3, 3.0, N_SWARM)
    jp = jp.replace(stokes=jnp.asarray(stokes))
    f = js.state.fields
    cs, _, h = js.stepper.derived(f.sigma, f.energy)
    rho = f.sigma / (js.phys.density_factor * h)
    draw = np.zeros(N_SWARM) if which == "drift" \
        else rng.standard_normal(N_SWARM)
    dt = 0.01
    _patch_jax_normal(monkeypatch, draw)
    j_out = j_dust.diffuse_dust(js.phys, js.constants, js.geometry,
                                js.stepper.g, jp, rho, cs, h, dt)
    tp = ts.state.particles.replace(
        r=torch.tensor(np.asarray(jp.r)), phi=torch.tensor(np.asarray(jp.phi)),
        phi_dot=torch.tensor(np.asarray(jp.phi_dot)),
        stokes=torch.tensor(stokes))
    t_args = [torch.tensor(np.asarray(a)) for a in (rho, cs, h)]
    t_out = dust.diffuse_dust(ts.phys, ts.constants, ts.stepper.dust_grid,
                              ts.stepper.g, tp, *t_args, dt,
                              normal=torch.tensor(draw))
    dr_j = np.asarray(j_out.r) - np.asarray(jp.r)
    dr_t = (t_out.r - tp.r).numpy()
    np.testing.assert_allclose(dr_t, dr_j, rtol=1e-12,
                               atol=1e-12 * np.abs(dr_j).max())
    assert np.abs(dr_j).max() > 0.0
    np.testing.assert_allclose(t_out.phi_dot.numpy(),
                               np.asarray(j_out.phi_dot), rtol=1e-12)


def test_diffusion_variance_grows_as_2_d_t():
    """20000 particles at r = 1.3 on a uniform gas (no density gradient,
    so no drift), 20 kicks: var(r) = 2 D t, D = alpha cs H / Sc."""
    torch.manual_seed(0)
    _, ts = build_pair(dict(_full_physics(16, 32), NumberOfParticles="16"))
    n, kicks, dt = 20000, 20, 1e-3
    g = ts.stepper.g
    alpha, cs0, h0, st = ts.phys.viscous_alpha, 0.05, 0.05 * 1.3, 0.1
    shape = (ts.geometry.nrad, ts.geometry.naz)
    rho = torch.full(shape, 1e-3, dtype=torch.float64)
    cs = torch.full(shape, cs0, dtype=torch.float64)
    # H / r * r: the gas diffusion coefficient alpha cs H, uniform
    h = torch.full(shape, h0, dtype=torch.float64) * g.rb / 1.3
    gen = torch.Generator().manual_seed(42)
    r0 = torch.full((n,), 1.3, dtype=torch.float64)
    p = dust.ParticleState(
        r=r0.clone(), phi=torch.rand(n, generator=gen, dtype=torch.float64)
        * 6.28, r_dot=torch.zeros(n, dtype=torch.float64),
        phi_dot=torch.ones(n, dtype=torch.float64),
        size=torch.ones(n, dtype=torch.float64),
        stokes=torch.full((n,), st, dtype=torch.float64),
        alive=torch.ones(n, dtype=torch.bool),
        timestep=torch.zeros(n, dtype=torch.float64),
        facold=torch.zeros(n, dtype=torch.float64), rng=gen)
    for _ in range(kicks):
        p = dust.diffuse_dust(ts.phys, ts.constants, ts.stepper.dust_grid,
                              g, p, rho, cs, h, dt)
    d = alpha * cs0 * h0 * g.rb.new_tensor(1.0) \
        / dust.schmidt_number(torch.tensor(st))
    expected = 2.0 * float(d) * kicks * dt
    var = float(torch.var(p.r - r0))
    assert abs(var / expected - 1.0) < 0.05, (var, expected)
    assert abs(float(torch.mean(p.r - r0))) < 4.0 * (var / n) ** 0.5


def test_full_physics_steps_match_jax(monkeypatch):
    draw = np.random.default_rng(8).standard_normal(N_SWARM)
    _patch_jax_normal(monkeypatch, draw)
    monkeypatch.setattr(dust, "standard_normal",
                        lambda state: torch.tensor(draw))
    js, ts = build_pair(_full_physics())
    assert ts.stepper.particle_params.diffusion
    r0 = ts.state.particles.r.clone()
    step_pair(js, ts, 10)
    assert_fields(ts.state, js.state)
    t_p = system_state_to_numpy(ts.state)
    for name in ("r", "phi", "r_dot", "phi_dot", "stokes"):
        ref = np.asarray(getattr(js.state.particles, name))
        np.testing.assert_allclose(t_p[f"particles.{name}"], ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(),
                                   err_msg=name)
    np.testing.assert_array_equal(t_p["particles.alive"],
                                  np.asarray(js.state.particles.alive))
    assert float((ts.state.particles.r - r0).abs().max()) > 1e-6


def test_swarm_generator_is_seeded_and_carried():
    """The diffusion draws come from the swarm's generator, seeded from
    RandomSeed: two runs of the same setup draw the same kicks, and the
    generator survives the steps (the state's ``replace`` carries it)."""
    cfg = _full_physics(16, 32)
    _, a = build_pair(cfg)
    _, b = build_pair(cfg)
    for sim in (a, b):
        for _ in range(3):
            sim.step_once(sim.calculate_time_step())
    assert a.state.particles.rng is not None
    assert torch.equal(a.state.particles.r, b.state.particles.r)
    nxt = dust.standard_normal(a.state.particles)
    assert torch.equal(nxt, dust.standard_normal(b.state.particles))
