"""The cataclysmic variables (ROADMAP A.9, second half): fargocpt_torch's
Simulation against the JAX package's, both on the CPU in float64,
``setups/CloseBinaries/OY_Car.yml`` read as it stands at 32x64 for ten
steps (rtol 1e-10: the fields, Q+ / Q-, the bodies, the frame, the mass
bookkeeping and the Roche-lobe tracker's rate, ``assert_cv_states``):

* at the setup's own ramp (30 donor orbits: the stream sits at the
  density floor, and the tracker follows the inner face's flux);
* with ``ROFrampingtime`` 1e-7: the ramp ends within the first step, so
  the stream carries mass in through the outer face. (The setup's
  heating/cooling CFL limit holds dt near 3.4e-7 at 32x64, so the ramp of
  0.01 orbits the JAX package's own stream test takes would need some 1e5
  steps.)
* with ``ROFVariableTransfer: yes`` and a short averaging time, so the
  tracked rate drives the stream of the Euler step's final boundary call.

Both setup files build on the CPU at their own grids, and OY_Car steps
there.
"""

import numpy as np
import pytest
import torch

from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.sim import Simulation as JSimulation

from fargocpt_torch import telemetry
from fargocpt_torch.config import Config
from fargocpt_torch.flagship import OY_CAR, V1504CYG, setup_file
from fargocpt_torch.ops import kernels
from fargocpt_torch.sim import Simulation
from fargocpt_torch.state import MD_OUTER_IN

torch.set_num_threads(2)

RTOL = 1e-10


def _close(got, ref, label, scale=None):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale
                               + 1e-300, err_msg=label)


def assert_cv_states(ts, js, label=""):
    """The fields, Q+ / Q-, the bodies, the frame's rate, the mass
    bookkeeping and the tracker's rate, rtol 1e-10. v_rad is held to atol
    1e-9 max|v_rad| as in tests/test_torch_planet.py (the initial viscous
    drift); in the corotating frame the donor stays on the x axis, so its
    y and v_x are roundoff and each body coordinate is held to the largest
    position or velocity, as in tests/test_torch_accretion.py."""
    for name in ("sigma", "vrad", "vaz", "energy"):
        ref = np.asarray(getattr(js.state.fields, name))
        np.testing.assert_allclose(
            getattr(ts.state.fields, name).numpy(), ref, rtol=RTOL,
            atol=1e-9 * np.abs(ref).max() if name == "vrad" else 0.0,
            err_msg=f"{label} {name}")
    for name in ("qplus", "qminus"):
        _close(getattr(ts.state, name), getattr(js.state, name),
               f"{label} {name}")
    nb_t, nb_j = ts.state.nbody, js.state.nbody
    for names in (("x", "y"), ("vx", "vy"), ("mass",)):
        ref = np.stack([np.asarray(getattr(nb_j, k)) for k in names])
        got = torch.stack([getattr(nb_t, k) for k in names])
        _close(got, ref, f"{label} nbody {names}")
    _close(ts.state.omega_frame, js.state.omega_frame, f"{label} omega")
    acc_t, acc_j = ts.state.monitor_acc, js.state.monitor_acc
    _close(acc_t.mass_delta, acc_j.mass_delta, f"{label} mass_delta")
    assert (acc_t.rof_mdot is None) == (acc_j.rof_mdot is None)
    if acc_j.rof_mdot is not None:
        _close(acc_t.rof_mdot, acc_j.rof_mdot, f"{label} rof_mdot")


def run_cv_pair(cfg: dict, steps: int, dt: float | None = None):
    """The JAX and the port's Simulation of ``cfg`` on the CPU in float64,
    each step's CFL dt held to rtol 1e-12 of each other, compared at the
    start and the end (``assert_cv_states``). They step on their own CFL
    steps, or on ``dt`` where it is given."""
    js = JSimulation(JConfig.from_dict(dict(cfg)))
    ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    assert_cv_states(ts, js, "initial")
    for _ in range(steps):
        dj = js.calculate_time_step()
        dt_t = ts.calculate_time_step()
        np.testing.assert_allclose(float(dt_t), dj, rtol=1e-12)
        js.step_once(dj if dt is None else dt)
        ts.step_once(dt_t if dt is None else dt)
    assert_cv_states(ts, js, f"after {steps} steps")
    return ts, js


def oy_car(**over) -> dict:
    return setup_file(OY_CAR, 32, 64, **over)


@pytest.mark.parametrize("path,grid", [(OY_CAR, (200, 200)),
                                       (V1504CYG, (450, 1070))])
def test_setup_builds_from_its_file_on_the_cpu(path, grid):
    """Each file as it stands builds at its own grid, its tracker on;
    OY_Car steps there (V1504 Cyg, whose PVTE step takes some 20 s at
    450x1070 on two CPU threads, steps in
    tests/test_torch_cv_v1504.py at 16x32)."""
    ts = Simulation(Config.from_file(str(path)), device="cpu")
    assert (ts.geometry.nrad, ts.geometry.naz) == grid
    assert ts.phys.rochelobe_overflow
    assert ts.state.monitor_acc.rof_mdot is not None
    if path == V1504CYG:
        return
    before = telemetry.values("launch.", kernels.OPS)
    ts.step_once(ts.calculate_time_step())
    # plain versions on the CPU
    assert telemetry.values("launch.", kernels.OPS) == before
    for name in ("sigma", "vrad", "vaz", "energy"):
        assert torch.isfinite(getattr(ts.fields, name)).all(), name


def test_oy_car_matches_jax():
    ts, _ = run_cv_pair(oy_car(), 10)
    st = ts.stepper
    assert ts.phys.is_adiabatic and ts.phys.cooling_surface_enabled
    assert st.gates["sources"] and st.gates["cfl"]
    assert not st.gates["viscous_kick"] and st.gates["artvisc_sn"]
    # the tracker's averaging time: ten orbits of the donor's initial orbit
    assert st.rof_averaging_time() == pytest.approx(20.0 * np.pi)


def test_oy_car_stream_carries_mass_matches_jax():
    ts, js = run_cv_pair(oy_car(ROFrampingtime="1e-7", FirstDT="1e-7"), 10)
    inflow = float(ts.state.monitor_acc.mass_delta[MD_OUTER_IN])
    assert inflow > 0.0
    # the ghost ring holds the stream, far above the floor
    floor = ts.phys.sigma_floor * ts.phys.sigma0
    assert float(ts.fields.sigma[-1].min()) > 1e3 * floor


def test_oy_car_variable_transfer_matches_jax():
    ts, _ = run_cv_pair(oy_car(ROFrampingtime="1e-7", FirstDT="1e-7",
                               ROFVariableTransfer="yes",
                               ROFaveragingtime="1e-6"), 10)
    assert ts.stepper.rof_averaging_time() == pytest.approx(2e-6 * np.pi)
    assert float(ts.state.monitor_acc.rof_mdot) != 0.0
