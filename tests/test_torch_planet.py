"""A planet in the disk: fargocpt_torch's Simulation against the JAX
package's, both on the CPU in float64, ten steps each.

* ``examples/quickstart.yml`` at 32x64: the locally isothermal disk, SN
  artificial viscosity, outflow boundaries, damping zones, a star and a
  Jupiter ramped over ten orbits with disk feedback; and the same with
  every damping target switched on, so the zones move mass.
* the ``cold_disk_planet`` golden's physics on its own grid cut to 1 cell
  per scale height: reflecting boundaries, ``Initial`` damping of every
  quantity, ``CoolingBetaReference`` (the plain viscous substep), TW
  artificial viscosity.
* the 64x128 locally isothermal slice of the flagship (ROADMAP A.4).
* the quickstart disk adiabatic with a viscous inner v_rad boundary or
  viscous inner damping: both read the viscosity grid of the fused
  viscous kick's viscosity stage (its in-kick sound speed), not that of
  the fields after the kick.
* the quickstart with 17 bodies, more than the IAS15 kernel keeps in its
  thread's own arrays.

Compared: the fields, Q+ / Q-, the N-body state and the mass bookkeeping,
rtol 1e-10. v_rad is held to atol 1e-9 max|v_rad| as in
tests/test_torch_slice.py: the initial viscous drift is a 5-point finite
difference of pow() profiles that numpy and XLA round differently."""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.sim import Simulation as JSimulation

from fargocpt_torch import telemetry
from fargocpt_torch.config import Config
from fargocpt_torch.ops import kernels
from fargocpt_torch.sim import Simulation

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-10


def quickstart(**over) -> dict:
    cfg = yaml.safe_load((ROOT / "examples" / "quickstart.yml").read_text())
    cfg.update({"Nrad": 32, "Naz": 64, "FirstDT": 0.01}, **over)
    return cfg


def cold_disk_planet(**over) -> dict:
    cfg = yaml.safe_load((ROOT / "tests" / "goldens" / "cold_disk_planet"
                          / "setup.yml").read_text())
    cfg.update({"cps": 1}, **over)
    return cfg


def assert_states(ts, js, label=""):
    for name in ("sigma", "vrad", "vaz", "energy"):
        ref = np.asarray(getattr(js.state.fields, name))
        atol = 1e-9 * np.abs(ref).max() if name == "vrad" else 0.0
        np.testing.assert_allclose(getattr(ts.state.fields, name).numpy(),
                                   ref, rtol=RTOL, atol=atol,
                                   err_msg=f"{label} {name}")
    for name in ("qplus", "qminus"):
        ref = np.asarray(getattr(js.state, name))
        np.testing.assert_allclose(getattr(ts.state, name).numpy(), ref,
                                   rtol=RTOL, atol=RTOL * np.abs(ref).max(),
                                   err_msg=f"{label} {name}")
    nb_t, nb_j = ts.state.nbody, js.state.nbody
    for name in ("x", "y", "vx", "vy", "mass"):
        ref = np.asarray(getattr(nb_j, name))
        np.testing.assert_allclose(getattr(nb_t, name).numpy(), ref,
                                   rtol=RTOL, atol=RTOL * np.abs(ref).max(),
                                   err_msg=f"{label} nbody.{name}")
    ref = np.asarray(js.state.monitor_acc.mass_delta)
    np.testing.assert_allclose(ts.state.monitor_acc.mass_delta.numpy(), ref,
                               rtol=RTOL, atol=RTOL * np.abs(ref).max()
                               + 1e-300, err_msg=f"{label} mass_delta")


def run_pair(cfg: dict, steps: int = 10):
    js = JSimulation(JConfig.from_dict(dict(cfg)))
    ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    assert_states(ts, js, "initial")
    for n in range(steps):
        dj = js.calculate_time_step()
        dt = ts.calculate_time_step()
        np.testing.assert_allclose(float(dt), dj, rtol=1e-12)
        js.step_once(dj)
        ts.step_once(dt)
    assert_states(ts, js, f"after {steps} steps")
    return ts, js


def test_quickstart_runs_from_its_file_on_the_cpu():
    ts = Simulation(Config.from_file(str(ROOT / "examples"
                                         / "quickstart.yml")), device="cpu")
    assert ts.phys.is_isothermal and ts.stepper.n_bodies == 2
    assert ts.stepper.damping is not None
    before = telemetry.values("launch.", kernels.OPS)
    ts.step_once(ts.calculate_time_step())
    # plain versions on the CPU
    assert telemetry.values("launch.", kernels.OPS) == before
    assert torch.isfinite(ts.fields.sigma).all()


def test_quickstart_without_a_device_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Simulation(Config.from_file(str(ROOT / "examples"
                                        / "quickstart.yml")))


def test_quickstart_matches_jax():
    ts, _ = run_pair(quickstart())
    # the planet's mass is ramped (ten orbits): the gas feels a fraction
    bodies = ts.stepper.bodies_on_grid(ts.state.nbody, ts.time)
    assert 0.0 < float(bodies.mass[1]) < 1e-3 * 1e-3
    assert float(bodies.mass[0]) == 1.0


def test_quickstart_with_every_damping_target_matches_jax():
    targets = {f"Damping{q}{side}": "Initial"
               for q in ("SurfaceDensity", "Energy", "VRadial", "VAzimuthal")
               for side in ("Inner", "Outer")}
    targets["DampingVAzimuthalOuter"] = "Mean"
    targets["DampingSurfaceDensityInner"] = "Mean"
    ts, _ = run_pair(quickstart(**targets))
    assert (ts.state.monitor_acc.mass_delta[4:8] != 0).any()


def test_quickstart_ramp_over_the_run_matches_jax():
    """A ramp of a tenth of an orbit, so the gas feels the planet's mass
    change within the ten steps, the Euler-mode indirect term, and the
    Klahr & Kley cubic smoothing inside half the planet's Roche radius."""
    cfg = quickstart(IndirectTermMode=1)
    cfg["nbody"][1]["ramp-up time"] = 0.02
    cfg["nbody"][1]["cubic smoothing factor"] = 0.5
    ts, _ = run_pair(cfg)
    bodies = ts.stepper.bodies_on_grid(ts.state.nbody, ts.time)
    assert float(bodies.mass[1]) == 1e-3
    assert 0.0 < float(bodies.cubic_smoothing_radius[1]) < 0.05


def test_cold_disk_planet_matches_jax():
    ts, _ = run_pair(cold_disk_planet())
    assert not ts.stepper.gates["viscous_kick"]     # CoolingBetaReference
    assert (ts.state.monitor_acc.mass_delta[4:8] != 0).any()


def test_isothermal_slice_matches_jax():
    """The flagship's disk, locally isothermal, at 64x128 (ROADMAP A.4): the
    energy grid stays zero, nothing clamps it to a temperature floor."""
    from test_torch_slice import FLAGSHIP
    cfg = dict(FLAGSHIP, EquationOfState="Isothermal", FirstDT="0.01")
    ts, _ = run_pair(cfg)
    assert (ts.fields.energy == 0.0).all()
    assert (ts.state.qplus == 0.0).all() and (ts.state.qminus == 0.0).all()


def test_klahr_radius_and_cic_planet_match_jax():
    """The deprecated global KlahrSmoothingRadius reaches each planet whose
    own cubic smoothing factor is unset, and CICPLANET moves a planet to
    the nearest cell-centre radius, as in the JAX package."""
    import warnings
    cfg = quickstart(KlahrSmoothingRadius=0.4, CICPLANET="Yes")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = JSimulation(JConfig.from_dict(dict(cfg)))
        ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    np.testing.assert_array_equal(ts.stepper.body_cubic_factor.numpy(),
                                  np.asarray(js.stepper.body_cubic_factor))
    assert ts.stepper.body_cubic_factor.tolist() == [0.0, 0.4]
    assert [b.semi_major_axis for b in ts.bodies] == \
        [b.semi_major_axis for b in js.bodies]
    assert ts.bodies[1].semi_major_axis in ts.geometry.rmed
    assert_states(ts, js, "initial")


@pytest.mark.parametrize("over", [{"InnerBoundary": "viscous"},
                                  {"DampingVRadialInner": "viscous"}],
                         ids=["viscous-boundary", "viscous-damping"])
def test_adiabatic_viscous_boundary_reads_the_in_kick_viscosity(over):
    ts, _ = run_pair(quickstart(EquationOfState="Ideal", **over))
    assert ts.stepper.gates["viscous_kick"] and ts.stepper.in_kick


def test_seventeen_bodies_match_jax():
    """A star and 16 small planets on orbits inside the grid, five steps
    (IAS15 with its workspace for N > 16 on the GPU)."""
    cfg = quickstart()
    cfg["nbody"] = [dict(cfg["nbody"][0])] + [
        {"name": f"p{k}", "semi-major axis": str(0.6 + 0.08 * k),
         "mass": "1e-6", "trueanomaly": str(0.7 * k)} for k in range(1, 17)]
    ts, _ = run_pair(cfg, steps=5)
    assert ts.stepper.n_bodies == 17
