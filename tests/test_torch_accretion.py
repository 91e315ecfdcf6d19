"""Accretion onto planets and the corotating frame: fargocpt_torch's
Simulation against the JAX package's, both on the CPU in float64, through
``tests/test_torch_planet.py``'s ``run_pair`` (``examples/quickstart.yml``
at 32x64, ten steps, rtol 1e-10; the bodies' masses and velocities, which
the accretion changes, among the compared state), and the frame's rate.

* each accretion variant (``kley``, ``sinkhole``, ``viscous``) on the
  quickstart's Jupiter, under both integrators and both equations of
  state; the viscous variant with ``ViscAccretMassflowTest``'s
  normalization; accretion without disk feedback;
* the viscous variant under the ideal-gas leapfrog with the fused viscous
  kick: the second half's accretion reads the viscosity of kick 2's
  viscosity stage (the kernel's in-kick sound speed), and the same run fed
  the viscosity of the fields after the kick leaves the JAX package's
  trajectory;
* the corotating frame under both integrators, with and without
  accretion, and ``setups/star_planet.yml`` (Euler, corotating) at 32x64;
* ``ops/accretion.orbital_periods`` for two and three bodies against the
  JAX package's.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fargocpt_tpu.nbody import system as jnbody
from fargocpt_tpu.ops import accretion as jaccretion

from fargocpt_torch.config import Config
from fargocpt_torch.constants import Constants
from fargocpt_torch.nbody.system import NBodyState
from fargocpt_torch.ops import accretion
from fargocpt_torch.sim import Simulation

from test_torch_planet import RTOL, assert_states, quickstart, run_pair

torch.set_num_threads(2)


def accreting(kind="kley", **over) -> dict:
    cfg = quickstart(**over)
    cfg["nbody"][1]["accretion efficiency"] = 1.0
    cfg["nbody"][1]["accretion method"] = kind
    return cfg


def run_frame_pair(cfg: dict, steps: int = 10, start=None):
    """``run_pair`` for a corotating run, whose reference body stays on
    the x axis: its y and v_x are roundoff, so each body coordinate is
    held to rtol 1e-10 of the largest position or velocity, and the
    frame's rate and angle to rtol 1e-10. ``start(js, ts)`` may set both
    packages' initial states."""
    from fargocpt_tpu.config import Config as JConfig
    from fargocpt_tpu.sim import Simulation as JSimulation
    js = JSimulation(JConfig.from_dict(dict(cfg)))
    ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    if start is not None:
        start(js, ts)
    for n in range(steps + 1):
        nb_t, nb_j = ts.state.nbody, js.state.nbody
        for names in (("x", "y"), ("vx", "vy")):
            ref = np.stack([np.asarray(getattr(nb_j, k)) for k in names])
            got = torch.stack([getattr(nb_t, k) for k in names]).numpy()
            np.testing.assert_allclose(got, ref, rtol=RTOL,
                                       atol=RTOL * np.abs(ref).max(),
                                       err_msg=f"step {n} {names}")
        for name in ("omega_frame", "frame_angle"):
            np.testing.assert_allclose(
                float(getattr(ts.state, name)),
                float(getattr(js.state, name)), rtol=RTOL,
                err_msg=f"step {n} {name}")
        if n == steps:
            break
        dj = js.calculate_time_step()
        dt = ts.calculate_time_step()
        np.testing.assert_allclose(float(dt), dj, rtol=1e-12)
        js.step_once(dj)
        ts.step_once(dt)
    for name in ("sigma", "vrad", "vaz", "energy"):
        ref = np.asarray(getattr(js.state.fields, name))
        atol = 1e-9 * np.abs(ref).max() if name == "vrad" else 0.0
        np.testing.assert_allclose(getattr(ts.state.fields, name).numpy(),
                                   ref, rtol=RTOL, atol=atol, err_msg=name)
    np.testing.assert_allclose(ts.state.nbody.mass.numpy(),
                               np.asarray(js.state.nbody.mass), rtol=RTOL)
    return ts, js


@pytest.mark.parametrize("kind,integrator,eos", list(itertools.product(
    ("kley", "sinkhole", "viscous"), ("Euler", "LeapFrog"),
    ("Isothermal", "Ideal"))))
def test_accretion_matches_jax(kind, integrator, eos):
    ts, _ = run_pair(accreting(kind, Integrator=integrator,
                               EquationOfState=eos))
    # the planet gained mass; only the kick that reads the pre-accretion
    # pressure leaves the sources op (per call, not per configuration)
    assert float(ts.state.nbody.mass[1]) > 1e-3
    assert ts.stepper.gates["sources"]


@pytest.mark.parametrize("integrator", ["Euler", "LeapFrog"])
def test_viscous_accretion_massflow_test_normalization_matches_jax(
        integrator):
    run_pair(accreting("viscous", Integrator=integrator,
                       ViscAccretMassflowTest="Yes"))


def test_accretion_without_disk_feedback_matches_jax():
    ts, _ = run_pair(accreting("kley", DiskFeedback="No",
                               AccreteWithoutDiskFeedback="Yes"))
    assert float(ts.state.nbody.mass[1]) > 1e-3


def test_viscous_accretion_reads_kick2_in_kick_viscosity():
    """The ideal-gas leapfrog takes the fused viscous kick; its second
    accretion half reads the viscosity of kick 2's viscosity stage, which
    the kernel's in-kick sound speed gives. Fed the viscosity of the fields
    after the kick instead, the run leaves the JAX package's trajectory by
    more than the tolerance."""
    cfg = accreting("viscous", Integrator="LeapFrog", EquationOfState="Ideal")
    ts, js = run_pair(cfg)
    assert ts.stepper.gates["viscous_kick"] and ts.stepper.in_kick
    stale = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    st = stale.stepper
    accrete = st._accrete

    def post_kick(nb, sigma, energy, vrad, vaz, omega_frame, dt, nu_grid,
                  periods=None):
        # the viscosity of the fields as they are at the accretion: the
        # step's start in the first half (as there), after kick 2 in the
        # second
        return accrete(nb, sigma, energy, vrad, vaz, omega_frame, dt,
                       lambda: st._nu_now(sigma, energy), periods)
    st._accrete = post_kick
    for _ in range(10):
        stale.step_once(stale.calculate_time_step())
    with pytest.raises(AssertionError):
        assert_states(stale, js, "post-kick viscosity")


@pytest.mark.parametrize("integrator", ["Euler", "LeapFrog"])
@pytest.mark.parametrize("kind", ["none", "kley"])
def test_corotating_frame_matches_jax(integrator, kind):
    cfg = accreting(kind, Integrator=integrator, Frame="C")
    if kind == "none":
        cfg["nbody"][1].pop("accretion method")
        cfg["nbody"][1]["accretion efficiency"] = 0.0
    ts, _ = run_frame_pair(cfg)
    # the frame follows the planet. The leapfrog measures the rate over
    # each half drift: the planet's orbit, the planet kept on the x axis.
    # The Euler step measures the angle swept by the last step's drift
    # over this step's dt, which the CFL ramp (x 1.1 a step) makes the
    # smaller
    omega = float(ts.state.omega_frame)
    if integrator == "LeapFrog":
        assert abs(omega - 1.0) < 1e-2
        assert abs(float(ts.state.nbody.y[1])) < 1e-12
    else:
        assert 0.85 < omega < 0.95


def test_star_planet_setup_matches_jax():
    """setups/star_planet.yml (the Euler step, a locally isothermal disk,
    the corotating frame) at 32x64."""
    import yaml
    from test_torch_planet import ROOT
    cfg = yaml.safe_load((ROOT / "setups" / "star_planet.yml").read_text())
    cfg.update({"Nrad": 32, "Naz": 64})
    ts, _ = run_frame_pair(cfg)
    assert ts.phys.corotating and ts.phys.hydro_integrator != "leapfrog"


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("n_hydroframe", [1, 2])
def test_orbital_periods_match_jax(n, n_hydroframe):
    rng = np.random.default_rng(n + 10 * n_hydroframe)
    mass = np.concatenate([[1.0], 10.0 ** rng.uniform(-4, -2, n - 1)])
    a = np.concatenate([[0.0], np.sort(rng.uniform(0.5, 3.0, n - 1))])
    phi = rng.uniform(0, 2 * np.pi, n)
    x, y = a * np.cos(phi), a * np.sin(phi)
    v = np.sqrt(1.0 / np.where(a > 0, a, 1.0)) * (1 + rng.normal(0, 0.1, n))
    vx, vy = -v * np.sin(phi) * (a > 0), v * np.cos(phi) * (a > 0)
    constants = Constants()          # G = 1
    ref = np.asarray(jaccretion.orbital_periods(
        constants, jnbody.NBodyState(x=jnp.asarray(x), y=jnp.asarray(y),
                                     vx=jnp.asarray(vx), vy=jnp.asarray(vy),
                                     mass=jnp.asarray(mass)), n_hydroframe))
    got = accretion.orbital_periods(constants, NBodyState(*(
        torch.tensor(q, dtype=torch.float64)
        for q in (x, y, vx, vy, mass))), n_hydroframe)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13)
    assert (got.numpy()[1:] > 0).all()
