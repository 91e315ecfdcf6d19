"""The monitor grids (``state.MonitorAccum``): fargocpt_torch's Simulation
against the JAX package's, both on the CPU in float64, through
``tests/test_torch_planet.py``'s ``run_pair`` (``examples/quickstart.yml``
at 32x64, ten steps, rtol 1e-10), and each grid the steps accumulated held
to rtol 1e-10 as well (the torques and the eccentricity changes sum cells
and stages of either sign, so each grid also takes an absolute tolerance
of 1e-10 of its largest value):

* each grid alone, ``WriteMassFlow``, ``WriteGasTorques``,
  ``WriteAlphaGravMean``, ``WriteAlphaReynoldsMean`` and
  ``WriteEccentricityChange``, under both integrators;
* ``WriteAlphaGravMean`` with symmetric self-gravity, whose accelerations
  it reads;
* the eccentricity changes stage by stage (sources, artificial viscosity,
  viscosity, transport, damping) over one Euler step and over ten; the
  leapfrog books none, as in the JAX package;
* every grid at once with a Kley-accreting planet in the corotating frame
  (the golden ``planet_accretion``'s physics on the quickstart's grid).
"""

import numpy as np
import pytest
import torch

from fargocpt_torch.state import MONITOR_GRIDS

from test_torch_accretion import run_frame_pair
from test_torch_planet import RTOL, quickstart, run_pair

torch.set_num_threads(2)

FLAGS = {"WriteMassFlow": ("massflow",),
         "WriteGasTorques": ("t_adv", "t_visc", "t_grav"),
         "WriteAlphaGravMean": ("alpha_grav_mean",),
         "WriteAlphaReynoldsMean": ("alpha_reynolds_mean",),
         "WriteEccentricityChange": ("decc", "dperi")}


def assert_grids(ts, js, names):
    """Each grid in ``names`` on in both packages and equal; the others
    off in both."""
    for name in MONITOR_GRIDS:
        got = getattr(ts.state.monitor_acc, name)
        ref = getattr(js.state.monitor_acc, name)
        if name not in names:
            assert got is None and ref is None, name
            continue
        ref = np.asarray(ref)
        assert got is not None and got.shape == ref.shape, name
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max(),
                                   err_msg=name)


@pytest.mark.parametrize("integrator", ["Euler", "LeapFrog"])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_monitor_grid_matches_jax(flag, integrator):
    ts, js = run_frame_pair(quickstart(Integrator=integrator,
                                       **{flag: "Yes"}), start=eccentric)
    assert_grids(ts, js, FLAGS[flag])
    for name in FLAGS[flag]:
        grid = getattr(ts.state.monitor_acc, name)
        if name == "alpha_grav_mean" or (
                name in ("decc", "dperi") and integrator == "LeapFrog"):
            # no self-gravity: zero stress; the leapfrog books no stage
            assert not grid.any(), name
        else:
            assert grid.abs().max() > 0, name


@pytest.mark.parametrize("integrator", ["Euler", "LeapFrog"])
def test_alpha_grav_mean_with_self_gravity_matches_jax(integrator):
    ts, js = run_pair(quickstart(Integrator=integrator, SelfGravity="Yes",
                                 SelfGravityMode="symmetric",
                                 WriteAlphaGravMean="Yes",
                                 WriteAlphaReynoldsMean="Yes"))
    assert_grids(ts, js, ("alpha_grav_mean", "alpha_reynolds_mean"))
    assert ts.state.monitor_acc.alpha_grav_mean.abs().max() > 0


def eccentric(js, ts):
    """Both packages' initial v_rad with the same m = 1 wave of 1e-2 of
    the Keplerian speed: the quickstart's disk is axisymmetric, its
    eccentricity roundoff and its pericentre the angle of roundoff."""
    import jax.numpy as jnp
    g = ts.geometry
    wave = 1e-2 * g.cos_phi[None, :] / np.sqrt(g.ra)[:, None]
    vrad = np.asarray(js.state.fields.vrad) + wave
    js.state = js.state.replace(fields=js.state.fields.replace(
        vrad=jnp.asarray(vrad)))
    ts.state = ts.state.replace(fields=ts.state.fields.replace(
        vrad=torch.tensor(vrad)))


@pytest.mark.parametrize("steps", [1, 10])
def test_eccentricity_changes_stage_by_stage_match_jax(steps):
    """The five stages' (e, peri) changes, each held alone; the fused
    viscous kick is gated off, as in the JAX package, so the artificial
    viscosity and the viscosity are stages of their own."""
    ts, js = run_frame_pair(quickstart(WriteEccentricityChange="Yes",
                                       EquationOfState="Ideal"), steps,
                            start=eccentric)
    assert not ts.stepper.gates["viscous_kick"]
    acc_t, acc_j = ts.state.monitor_acc, js.state.monitor_acc
    for name in ("decc", "dperi"):
        got, ref = getattr(acc_t, name).numpy(), np.asarray(getattr(acc_j,
                                                                    name))
        assert got.shape == (5,)
        for stage, label in enumerate(("sources", "artificial viscosity",
                                       "viscosity", "transport",
                                       "damping")):
            np.testing.assert_allclose(
                got[stage], ref[stage], rtol=RTOL,
                atol=RTOL * np.abs(ref).max(), err_msg=f"{name} {label}")
        assert np.count_nonzero(got) >= 4


@pytest.mark.parametrize("integrator", ["Euler", "LeapFrog"])
def test_every_grid_with_accretion_in_the_corotating_frame(integrator):
    cfg = quickstart(Integrator=integrator, Frame="C",
                     **{flag: "Yes" for flag in FLAGS})
    cfg["nbody"][1]["accretion efficiency"] = 1.0
    ts, js = run_frame_pair(cfg, start=eccentric)
    assert_grids(ts, js, MONITOR_GRIDS)
