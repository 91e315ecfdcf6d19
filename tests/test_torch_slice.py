"""The flagship slice end to end: fargocpt_torch's Simulation against the
JAX package's, both on the CPU in float64 at 64x128.

Tolerances. sigma, vaz, energy and the Q grids match to rtol 1e-10. The
initial v_rad is the steady viscous drift, a 5-point finite difference of
pow()-based profiles (ops/diskmodel.py vr_numerical_viscous, in numpy on
the host); numpy's and XLA's pow() differ by one ulp on ~5% of inputs,
which the differences amplify to ~2e-10 of v_rad. So v_rad built
independently is held to rtol 1e-9 at the start and to atol 1e-9 *
max|v_rad| after 10 steps. A port seeded with the
JAX state holds v_rad to atol 1e-10 * max|v_rad|: v_rad crosses zero, and
its kick is the small residual of pressure, gravity and centrifugal terms
~2e4 times larger, so roundoff of those terms shows on it.
"""

import numpy as np
import pytest
import torch

from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.sim import Simulation as JSimulation

from fargocpt_torch.config import Config
from fargocpt_torch.sim import Simulation, reachable_tensors
from fargocpt_torch.state import (state_keys, system_state_from_numpy,
                                  system_state_to_numpy)

torch.set_num_threads(2)

FLAGSHIP = {
    "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
    "AspectRatio": "0.05", "FlaringIndex": "0.25",
    "ViscousAlpha": "0.001",
    "Sigma0": "200 g/cm2", "SigmaSlope": "0.5",
    "HeatingViscous": "Yes", "CoolingBetaLocal": "Yes",
    "CoolingBeta": "10",
    "ArtificialViscosity": "SN",
    "Nrad": "64", "Naz": "128",
    "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Log",
    "InnerBoundary": "outflow", "OuterBoundary": "outflow",
    "Transport": "FARGO",
    "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "1.0",
}
FIELDS = ("sigma", "vrad", "vaz", "energy")


def jax_state_tree(state) -> dict[str, np.ndarray]:
    """The JAX SystemState flattened to the port's dotted-name dict."""
    tree = {}
    for key in state_keys():
        obj = state
        for part in key.split("."):
            obj = getattr(obj, part)
        tree[key] = np.asarray(obj)
    return tree


@pytest.fixture(scope="module")
def pair():
    return (JSimulation(JConfig.from_dict(dict(FLAGSHIP))),
            Simulation(Config.from_dict(dict(FLAGSHIP)), device="cpu"))


def _assert_fields(t_state, j_state, rtol=1e-10, vrad_atol=1e-10):
    for name in FIELDS:
        ref = np.asarray(getattr(j_state.fields, name))
        atol = vrad_atol * np.abs(ref).max() if name == "vrad" else 0.0
        np.testing.assert_allclose(getattr(t_state.fields, name).numpy(),
                                   ref, rtol=rtol, atol=atol, err_msg=name)
    for name in ("qplus", "qminus"):
        ref = np.asarray(getattr(j_state, name))
        np.testing.assert_allclose(getattr(t_state, name).numpy(), ref,
                                   rtol=rtol, atol=1e-10 * np.abs(ref).max(),
                                   err_msg=name)


def test_initial_state_equals_jax(pair):
    js, ts = pair
    j, t = jax_state_tree(js.state), system_state_to_numpy(ts.state)
    assert set(t) == set(j)
    for key in j:
        rtol = 1e-9 if key == "fields.vrad" else 1e-12
        np.testing.assert_allclose(t[key], j[key], rtol=rtol, atol=0.0,
                                   err_msg=key)
    assert ts.fields.sigma.dtype == torch.float64
    assert ts.state.nbody.x.dtype == torch.float64


def test_ten_steps_match_jax():
    js = JSimulation(JConfig.from_dict(dict(FLAGSHIP)))
    ts = Simulation(Config.from_dict(dict(FLAGSHIP)), device="cpu")
    for _ in range(10):
        np.testing.assert_allclose(float(ts.stepper.cfl_dt(ts.state)),
                                   float(js.stepper.cfl_dt(js.state)),
                                   rtol=1e-12)
        dj = js.calculate_time_step()
        dt = ts.calculate_time_step()
        np.testing.assert_allclose(float(dt), dj, rtol=1e-12)
        js.step_once(dj)
        ts.step_once(dt)
    assert ts.n_hydro_iter == js.n_hydro_iter == 10
    np.testing.assert_allclose(float(ts.time), js.time, rtol=1e-12)
    _assert_fields(ts.state, js.state, vrad_atol=1e-9)
    np.testing.assert_allclose(
        ts.state.monitor_acc.mass_delta.numpy(),
        np.asarray(js.state.monitor_acc.mass_delta), rtol=1e-10, atol=1e-30)


def test_cooling_beta_ramp_up_matches_jax():
    """The flagship with the cooling ramp (CoolingBetaRampUp), whose seed of
    Q+ / Q- evaluates the ramp at the float time 0.0: five steps at 32x64
    against the JAX package."""
    cfg = dict(FLAGSHIP, Nrad="32", Naz="64", CoolingBetaRampUp="5.0")
    js = JSimulation(JConfig.from_dict(dict(cfg)))
    ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    assert ts.stepper.phys.cooling_beta_ramp_up == 5.0
    _assert_fields(ts.state, js.state, vrad_atol=1e-9)
    for _ in range(5):
        dj = js.calculate_time_step()
        dt = ts.calculate_time_step()
        np.testing.assert_allclose(float(dt), dj, rtol=1e-12)
        js.step_once(dj)
        ts.step_once(dt)
    np.testing.assert_allclose(float(ts.time), js.time, rtol=1e-12)
    _assert_fields(ts.state, js.state, vrad_atol=1e-9)
    # the ramp is on: after five steps the time is a tiny part of the ramp's
    # length and the cooling has not begun, where the flagship without the
    # ramp cools from its first step
    plain = Simulation(Config.from_dict(dict(cfg, CoolingBetaRampUp="0.0")),
                       device="cpu")
    for _ in range(5):
        plain.step_once(plain.calculate_time_step())
    assert float(ts.time) < 1e-3 * 5.0
    assert (float(ts.state.qminus.abs().max())
            < 1e-6 * float(plain.state.qminus.abs().max()))


def test_seeded_from_jax_state(pair):
    js, _ = pair
    tree = jax_state_tree(js.state)
    ts = Simulation(Config.from_dict(dict(FLAGSHIP)), device="cpu")
    ts.state = system_state_from_numpy(tree, "cpu", torch.float64)
    back = system_state_to_numpy(ts.state)
    for key in tree:
        np.testing.assert_array_equal(back[key], tree[key], err_msg=key)

    j_state = js.state
    t_state = ts.state
    time = 0.0
    for _ in range(10):
        dt = float(js.stepper.cfl_dt(j_state)) * 0.5
        j_state = js.stepper.step(j_state, time, dt)
        t_state = ts.stepper.step(
            t_state, torch.tensor(time, dtype=torch.float64),
            torch.tensor(dt, dtype=torch.float64))
        time += dt
    _assert_fields(t_state, j_state)


def test_run_to_monitor_boundary_matches_jax():
    cfg = dict(FLAGSHIP, FirstDT="0.05", MonitorTimestep="0.5")
    js = JSimulation(JConfig.from_dict(dict(cfg)))
    ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    js.run()
    ts.run()
    assert ts.n_hydro_iter == js.n_hydro_iter > 3
    assert float(ts.time) == pytest.approx(js.time, rel=1e-14)
    assert float(ts.time) == pytest.approx(0.5, rel=1e-14)
    np.testing.assert_allclose(float(ts.last_dt), js.last_dt, rtol=1e-12)
    for key in ("dt_min", "dt_max", "dt_sum"):
        assert ts.monitor_stats[key] == pytest.approx(js.monitor_stats[key],
                                                      rel=1e-12)
    _assert_fields(ts.state, js.state, vrad_atol=1e-9)


def test_every_tensor_lives_on_the_run_device(pair):
    _, ts = pair
    found = dict(reachable_tensors(ts))
    assert "sim.stepper.ops.cols" in found
    assert "sim.stepper.ops.g.rb" in found
    assert "sim.state.fields.sigma" in found
    assert {t.device.type for t in found.values()} == {"cpu"}


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Simulation(Config.from_dict(dict(FLAGSHIP)), device="cuda")


def test_default_device_is_the_card():
    """Without a device argument the Simulation asks for the GPU, so
    without a card it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Simulation(Config.from_dict(dict(FLAGSHIP)))


@pytest.mark.parametrize("extra,feature", [
    ({"EquationOfState": "PVTE", "PVTELookupTable": "Yes"}, "PVTE"),
    ({"SelfGravity": "Yes"}, "self-gravity"),        # the Bessel kernel
    ({"IntegrateParticles": "Yes", "ParticleDustDiffusion": "Yes"},
     "dust diffusion"),
    ({"EquationOfState": "Polytropic"}, "polytropic"),
    ({"Disk": "No"}, "Disk: no"),
])
def test_features_outside_the_slice_raise(extra, feature):
    with pytest.raises(NotImplementedError, match=feature):
        Simulation(Config.from_dict(dict(FLAGSHIP, **extra)),
                   device="cpu")

