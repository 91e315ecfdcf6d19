"""The leapfrog integrator (``Integrator: LeapFrog``): fargocpt_torch's
Simulation against the JAX package's, both on the CPU in float64, ten
steps each at rtol 1e-10 (``run_pair`` of tests/test_torch_planet.py; v_rad
to atol 1e-9 max|v_rad| as there).

* ``examples/quickstart.yml`` at 32x64: locally isothermal (the fused
  viscous kick), ideal gas (the fused kick with its in-kick sound speed:
  kick 2 smooths the potential with kick 1's scale height), ideal gas with
  thermal surface cooling (the unfused viscous substep, as the
  ``binary_gceph`` golden runs it), the Euler-mode indirect term and the
  RK4 bodies;
* ``flagship.pds70_gas`` at 32x96: PVTE, FLD (twice a step), FFT
  self-gravity, and the PVTE refreshes a leapfrog step makes, with where
  each warm start came from, equal in both packages;
* ``flagship.pds70`` at 32x96 with 256 particles: the dust in two halves.
"""

import numpy as np
import pytest
import torch

from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.sim import Simulation as JSimulation

from fargocpt_torch import telemetry
from fargocpt_torch.config import Config
from fargocpt_torch.flagship import PDS70, PDS70_GAS
from fargocpt_torch.sim import Simulation

from test_torch_pds70_dust import _assert_particles
from test_torch_pds70_f32 import _GuessSources
from test_torch_planet import quickstart, run_pair

torch.set_num_threads(2)

LF = {"Integrator": "LeapFrog"}


@pytest.mark.parametrize("over", [
    {},
    {"EquationOfState": "Ideal"},
    {"EquationOfState": "Ideal", "SurfaceCooling": "thermal"},
    {"IndirectTermMode": 1},
    {"NbodyIntegrator": "rk4"},
], ids=["isothermal", "adiabatic", "adiabatic-surface-cooling",
        "indirect-term-mode-1", "rk4-bodies"])
def test_quickstart_leapfrog_matches_jax(over):
    ts, _ = run_pair(quickstart(**LF, **over))
    fused = ts.stepper.gates["viscous_kick"]
    assert fused == ("SurfaceCooling" not in over)
    # the in-kick sound speed is asked for only where an adiabatic run
    # reads it
    assert ts.stepper.in_kick == (fused and ts.phys.is_adiabatic)


def test_kick2_smooths_with_the_scale_height_of_kick1():
    """Adiabatic: kick 2's potential smoothing is kick 1's in-kick scale
    height, which differs from the scale height of the fields kick 2 starts
    from (after the transport) and from that of the step's start."""
    ts = Simulation(Config.from_dict(quickstart(**LF,
                                                EquationOfState="Ideal")),
                    device="cpu")
    seen = []
    real = ts.stepper._gas_kick

    def recording(sigma, vrad, vaz, energy, *args, stale_h=None, **kw):
        out = real(sigma, vrad, vaz, energy, *args, stale_h=stale_h, **kw)
        seen.append((stale_h, ts.stepper.derived(sigma, energy)[2], out[7]))
        return out

    ts.stepper._gas_kick = recording
    for _ in range(2):
        ts.step_once(ts.calculate_time_step())
    (h0, h_start, h_kick1), (stale2, h_now2, _) = seen[2:]
    assert torch.equal(h0, h_start)             # kick 1: the step's start
    assert stale2 is h_kick1                    # kick 2: kick 1's in-kick H
    rel = ((h_kick1 - h_now2).abs() / h_now2)[1:-1].max()
    assert float(rel) > 1e-8
    assert float(((h_kick1 - h0).abs() / h0)[1:-1].max()) > 1e-8


def _pds70_gas(**kw):
    return dict(PDS70_GAS, Nrad="32", Naz="96", **LF, **kw)


def test_pds70_gas_leapfrog_matches_jax():
    before = telemetry.value("fld.sor_iterations")
    ts, _ = run_pair(_pds70_gas())
    assert ts.stepper.fld is not None and ts.stepper.selfgravity is not None
    assert telemetry.value("fld.sor_iterations") > before


def test_pvte_refreshes_of_a_leapfrog_step_equal_jax():
    """A leapfrog step refreshes the PVTE grids at the step's start (the
    CFL's and the step's, each warm from the state's guess), after kick
    1's artificial viscosity, after the transport and after kick 2's
    artificial viscosity, each warm from the one before: five for
    calculate_time_step + step_once, in both packages, float32."""
    cfg = dict(PDS70_GAS, Nrad="16", Naz="32", **LF)
    js = JSimulation(JConfig.from_dict(dict(cfg)), dtype="float32")
    ts = Simulation(Config.from_dict(dict(cfg)), dtype="float32",
                    device="cpu")
    jrec, trec = _GuessSources(js.stepper.pvte), _GuessSources(ts.stepper.pvte)
    before = telemetry.value("pvte.refresh")
    js.step_once(js.calculate_time_step())
    ts.step_once(ts.calculate_time_step())
    assert jrec.record == trec.record == ["state", "state", -1, -1, -1]
    assert telemetry.value("pvte.refresh") - before == 5


def test_pds70_dust_leapfrog_matches_jax():
    cfg = dict(PDS70, Nrad="32", Naz="96", NumberOfParticles="256", **LF)
    ts, js = run_pair(cfg)
    tp, jp = ts.state.particles, js.state.particles
    _assert_particles(tp, jp)
    assert bool(tp.alive.all())
    np.testing.assert_allclose(float(ts.state.frame_angle),
                               float(js.state.frame_angle), rtol=1e-12)
