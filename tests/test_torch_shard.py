"""The radial domain decomposition of fargocpt_torch
(``fargocpt_torch.parallel``) on gloo ranks on the CPU, float64, at the
192x64 flagship of tests/test_shard_map.py.

Each test spawns one world of ranks (``shard_ranks.spawn``) that runs
every check of its case in one go. A sharded run is held to the port's
single-process run at the JAX package's gates (1e-13 for a step, 1e-11 for
a monitor interval, the same step count and landing time), and its
gathered state to the JAX package's ``ShardedHydroStep`` on as many host
devices at rtol 1e-10. What the ranks must agree on (the dt, the bodies)
is held equal across them. The communicator's byte counter is held to
``comm_model``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.parallel.mesh import make_mesh
from fargocpt_tpu.parallel.shard_step import ShardedHydroStep as JSharded
from fargocpt_tpu.sim import Simulation as JSimulation

import shard_ranks as sr

GRIDS = ("sigma", "vrad", "vaz", "energy", "qplus", "qminus")


def jax_sharded(extra, n, *, steps=None, interval=False, dt=1e-4,
                shard_particles=True, dtype="float64"):
    """The JAX package's explicit path on n host devices: ``steps`` steps
    of ``dt`` or a monitor interval to 0.5; the gathered state."""
    sim = JSimulation(JConfig.from_dict(sr.config(extra)), dtype=dtype)
    ss = JSharded(sim.stepper, make_mesh(n), shard_particles=shard_particles)
    pair = ss.shard_state(sim.state)
    if interval:
        out = ss.advance_to(pair, 0.0, 1e-4, 0.5)
        return ss.gather(out[0]), int(out[3]), float(out[1])
    for i in range(steps):
        pair = ss.step(pair, i * dt, dt)
    return ss.gather(pair), None, None


def j_grid(state, name):
    if name in ("qplus", "qminus"):
        return np.asarray(getattr(state, name))
    return np.asarray(getattr(state.fields, name))


def p_grid(flat, name):
    return flat[name] if name in ("qplus", "qminus") else flat[f"fields.{name}"]


def assert_grids(a, b, tol, what):
    for name in GRIDS:
        d = sr.rel(p_grid(a, name), p_grid(b, name))
        assert d < tol, f"{what}: {name} rel diff {d:.3e}"


def assert_jax(jstate, flat, tol, what, vrad_by_vaz=False):
    """Each grid to ``tol`` of its largest value; v_rad to 1e-9 of it, the
    port's v_rad gate against the JAX package (tests/longtail_pairs.py:
    numpy and XLA round the initial viscous drift apart by ~2e-10, on one
    process as on several). With ``vrad_by_vaz`` (float32) v_rad is
    measured against |v_az| instead, as tests/test_torch_pds70_f32.py
    measures it: the packages' float32 drifts differ by an ulp of v_az."""
    for name in GRIDS:
        a, b = j_grid(jstate, name), p_grid(flat, name)
        if name == "vrad" and vrad_by_vaz:
            d = float(np.max(np.abs(a - b))
                      / np.max(np.abs(p_grid(flat, "vaz"))))
        else:
            d = sr.rel(a, b)
        gate = max(tol, 1e-9) if name == "vrad" else tol
        assert d < gate, f"{what}: {name} against the JAX package {d:.3e}"


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_flagship_matches_single_and_jax(n, tmp_path):
    """The CFL, one step and a monitor interval on n ranks: the port's
    single-process run to 1e-14 / 1e-13 / 1e-11, the same step count and
    landing time on every rank; the halo exchange's bytes are the model's;
    the gathered states are the JAX package's sharded ones to 1e-10."""
    res = sr.spawn(sr.rank_flagship, n, tmp_path, None)
    for r in res:
        c1, c2 = r["cfl"]
        assert np.isclose(c1, c2, rtol=1e-14, atol=0.0), (c1, c2)
        assert r["cfl"] == res[0]["cfl"]
        (n1, t1, dt1, _), (n2, t2, dt2, _) = r["interval"]
        assert n1 == n2 and t1 == t2 == 0.5 and dt1 == pytest.approx(
            dt2, rel=1e-12)
        assert (n2, t2, dt2) == res[0]["interval"][1][:3]
    single, sharded = res[0]["step"]
    assert_grids(single, sharded, 1e-13, "step")
    (n1, _, _, s1), (n2, _, _, s2) = res[0]["interval"]
    assert_grids(s1, s2, 1e-11, "interval")

    # one exchange a step: interior ranks send both ways, edge ranks one
    model = res[0]["model"]
    for k, r in enumerate(res):
        ways = 2 if 0 < k < n - 1 else 1
        assert r["step_bytes"]["exchange"] \
            == model["halo_exchange"] * ways // 2
        assert r["interval_bytes"]["exchange"] \
            == n2 * model["halo_exchange"] * ways // 2
        assert r["step_bytes"]["all_gather"] == 0

    j_step, _, _ = jax_sharded(None, n, steps=1, dt=2e-4)
    assert_jax(j_step, sharded, 1e-10, "step")
    j_int, jn, jt = jax_sharded(None, n, interval=True)
    assert (jn, jt) == (n2, 0.5)
    assert_jax(j_int, s2, 1e-10, "interval")


def test_sharded_planet_feedback_and_damping(tmp_path):
    """Disk feedback with Kley accretion in the corotating frame, the
    damping zones' mass bookkeeping, and the leapfrog with a bucketed
    swarm, on 4 ranks (three steps of 1e-4 each): fields, bodies, the
    frame, the mass deltas and the swarm."""
    res = sr.spawn(sr.rank_cases, 4, tmp_path,
                   ("planet", "damping", "leapfrog"))
    planet, damping, leapfrog = res[0]
    s1, s2 = planet["states"]
    assert_grids(s1, s2, 1e-12, "planet")
    for name in ("x", "y", "vx", "vy", "mass"):
        d = sr.rel(s1[f"nbody.{name}"], s2[f"nbody.{name}"])
        assert d < 1e-13, f"nbody.{name}: {d:.3e}"
        for r in res[1:]:
            np.testing.assert_array_equal(r[0]["states"][1][f"nbody.{name}"],
                                          s2[f"nbody.{name}"])
    assert np.isclose(s1["omega_frame"], s2["omega_frame"], rtol=1e-13)
    j, _, _ = jax_sharded(sr.CASES["planet"], 4, steps=3)
    assert_jax(j, s2, 1e-10, "planet")
    for name in ("x", "y", "vx", "vy", "mass"):
        np.testing.assert_allclose(
            s2[f"nbody.{name}"], np.asarray(getattr(j.nbody, name)),
            rtol=1e-10, atol=1e-10 * np.max(np.abs(s2["nbody.x"])),
            err_msg=name)

    s1, s2 = damping["states"]
    assert_grids(s1, s2, 1e-13, "damping")
    d = sr.rel(s1["monitor_acc.mass_delta"], s2["monitor_acc.mass_delta"])
    assert d < 1e-12, f"mass_delta {d:.3e}"
    j, _, _ = jax_sharded(sr.CASES["damping"], 4, steps=3)
    assert_jax(j, s2, 1e-10, "damping")
    np.testing.assert_allclose(s2["monitor_acc.mass_delta"],
                               np.asarray(j.monitor_acc.mass_delta),
                               rtol=1e-10, atol=1e-10 * np.max(np.abs(
                                   s2["monitor_acc.mass_delta"])))

    s1, s2 = leapfrog["states"]
    assert_grids(s1, s2, 1e-13, "leapfrog")
    for name in ("r", "phi", "r_dot", "phi_dot"):
        d = sr.rel(s1[f"particles.{name}"], s2[f"particles.{name}"])
        assert d < 1e-12, f"leapfrog particles.{name}: {d:.3e}"
    assert sum(r[2]["overflow"] for r in res) == 0


def test_sharded_fld_and_selfgravity(tmp_path):
    """FLD (its halo refreshed each SOR sweep, the norm summed over the
    ranks: the same iteration counts and auto-omega walk) and FFT
    self-gravity (the all-gathered sigma; the alpha-grav monitor) on 2
    ranks; the self-gravity gathers' bytes are the model's."""
    res = sr.spawn(sr.rank_cases, 2, tmp_path, ("fld", "selfgravity"))
    fld, sg = res[0]
    s1, s2 = fld["states"]
    assert_grids(s1, s2, 5e-12, "fld")
    np.testing.assert_allclose(s1["fld_sor"], s2["fld_sor"], rtol=1e-12)
    assert fld["fld_iterations"][0] == fld["fld_iterations"][1]
    j, _, _ = jax_sharded(sr.CASES["fld"], 2, steps=3)
    assert_jax(j, s2, 1e-10, "fld")
    np.testing.assert_allclose(s2["fld_sor"], np.asarray(j.fld_sor),
                               rtol=1e-12)

    s1, s2 = sg["states"]
    assert_grids(s1, s2, 5e-12, "selfgravity")
    d = sr.rel(s1["monitor_acc.alpha_grav_mean"],
               s2["monitor_acc.alpha_grav_mean"])
    assert d < 1e-3, f"alpha_grav_mean {d:.3e}"
    for k in (0, 1, 2):
        assert sr.rel(s1[f"sg_kernel.{k}"], s2[f"sg_kernel.{k}"]) < 1e-12
    j, _, _ = jax_sharded(sr.CASES["selfgravity"], 2, steps=3)
    assert_jax(j, s2, 1e-10, "selfgravity")
    # a gather a kick and one for the alpha-grav monitor, three steps
    for r in res:
        assert r[1]["bytes"]["all_gather"] \
            == 3 * r[1]["model"]["selfgravity_allgather"]


def test_sharded_particles_both_modes(tmp_path, monkeypatch):
    """The replicated swarm (drag and diffusion on all-gathered fields, on
    a shared draw) and the slab buckets (migration, no overflow, every pid
    once) on 4 ranks, against the single-process swarm and the JAX
    package's sharded one; the migration's and the gathers' bytes are
    the model's."""
    res = sr.spawn(sr.rank_cases, 4, tmp_path, ("particles", "buckets"))
    rep, bk = res[0]
    for case, tol in ((rep, 1e-13), (bk, 1e-12)):
        s1, s2 = case["states"]
        assert_grids(s1, s2, 1e-13, "particles")
        for name in ("r", "phi", "r_dot", "phi_dot", "stokes", "timestep"):
            d = sr.rel(s1[f"particles.{name}"], s2[f"particles.{name}"])
            assert d < tol, f"particles.{name}: {d:.3e}"
        np.testing.assert_array_equal(s1["particles.alive"],
                                      s2["particles.alive"])
    assert sum(r[1]["overflow"] for r in res) == 0
    pids = np.concatenate([r[1]["pids"] for r in res])
    np.testing.assert_array_equal(np.sort(pids), np.arange(64))
    model = bk["model"]
    assert "particles_migration" in model
    assert "particles_allgather" not in model
    for k, r in enumerate(res):
        ways = 2 if 0 < k < 3 else 1
        assert r[1]["bytes"]["exchange"] == 3 * ways * (
            model["halo_exchange"] + model["particles_migration"]) // 2
        assert r[0]["bytes"]["all_gather"] \
            == 3 * r[0]["model"]["particles_allgather"]

    fixed = sr.draw(32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(fixed,
                                                                   dtype))
    for case, kw in ((rep, {"shard_particles": False}), (bk, {})):
        name = "particles" if case is rep else "buckets"
        j, _, _ = jax_sharded(sr.CASES[name], 4, steps=3, **kw)
        flat = case["states"][1]
        assert_jax(j, flat, 1e-10, name)
        for f in ("r", "phi", "r_dot", "phi_dot"):
            np.testing.assert_allclose(
                flat[f"particles.{f}"], np.asarray(getattr(j.particles, f)),
                rtol=1e-10, atol=1e-12, err_msg=f"{name} {f}")


def test_sharded_refusals(tmp_path):
    """NR not a multiple of the rank count, and one rank (its window
    would pass the grid's edges), are refused as the JAX package refuses
    them."""
    two = sr.spawn(sr.rank_refusals, 2, tmp_path)
    assert all("not divisible" in r[0] for r in two)
    one = sr.spawn(sr.rank_refusals, 1, tmp_path)
    assert "outside grid" in one[0][0]
    with pytest.raises(ValueError, match="not divisible"):
        JSharded(JSimulation(JConfig.from_dict(sr.config(Nrad=193))).stepper,
                 make_mesh(2))
    with pytest.raises(ValueError, match="outside grid"):
        JSharded(JSimulation(JConfig.from_dict(sr.config())).stepper,
                 make_mesh(1))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["composite", "pvte"])
def test_sharded_slow_cases(name, tmp_path):
    """The composite boundaries (Roche-lobe stream, centre-of-mass outer
    side; float64) and the full-physics PVTE menu (float32), slow in
    tests/test_shard_map.py too: three steps on 2 ranks, sharded against
    single-process at that file's gates, and the gathered state against
    the JAX package's ``ShardedHydroStep`` on 2 host devices: float64 to
    rtol 1e-10, float32 to 2e-5 (the port's float32 PVTE gate against the
    JAX package, tests/test_torch_pvte.py F32_RTOL; v_rad against |v_az|),
    with the Roche-lobe rate, the PVTE warm-start pair and the swarm."""
    dtype = "float32" if name == "pvte" else "float64"
    tol = 5e-6 if name == "pvte" else 1e-12
    jtol = 2e-5 if name == "pvte" else 1e-10
    res = sr.spawn(sr.rank_cases, 2, tmp_path, (name,), dtype)
    s1, s2 = res[0][0]["states"]
    assert_grids(s1, s2, tol, name)
    j, _, _ = jax_sharded(sr.CASES[name], 2, steps=3, dtype=dtype)
    assert_jax(j, s2, jtol, name, vrad_by_vaz=name == "pvte")
    if name == "composite":
        d = sr.rel(s1["monitor_acc.rof_mdot"], s2["monitor_acc.rof_mdot"])
        assert d < 1e-12, d
        d = sr.rel(np.asarray(j.monitor_acc.rof_mdot),
                   s2["monitor_acc.rof_mdot"])
        assert d < jtol, f"rof_mdot against the JAX package {d:.3e}"
    else:
        for k in (0, 1):
            assert sr.rel(s1[f"pvte_guess.{k}"], s2[f"pvte_guess.{k}"]) < tol
            d = sr.rel(np.asarray(j.pvte_guess[k]), s2[f"pvte_guess.{k}"])
            assert d < jtol, f"pvte_guess.{k} against the JAX package {d:.3e}"
        np.testing.assert_array_equal(s2["particles.alive"],
                                      np.asarray(j.particles.alive))
        for f in ("r", "phi", "r_dot", "phi_dot"):
            np.testing.assert_allclose(
                s2[f"particles.{f}"], np.asarray(getattr(j.particles, f)),
                rtol=jtol, atol=0.0, err_msg=f"particles.{f}")
