"""Stellar irradiation (``HeatingStar``: a body with a temperature heats
the disk; reference src/SourceEuler.cpp:538-611) on fargocpt_torch against
the JAX package, on the CPU in float64.

* ``setups/PDS70.yml`` (an ideal-gas disk, thermal surface cooling, TW
  artificial viscosity, damping zones, an irradiating star and two
  eccentric planets, 2000 dust particles) cut to 32x96 with 256
  particles: ten steps, Euler and leapfrog, at rtol 1e-10 (``run_pair`` of
  tests/test_torch_planet.py: the fields, Q+ / Q-, the CFL's dt of every
  step, the bodies, the mass bookkeeping) and the swarm;
* the quickstart disk, adiabatic, with an irradiating star whose
  irradiation ramps up over the ten steps;
* the irradiation Q+ of one state, op against op.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp
from fargocpt_tpu.ops import energy as j_energy
from fargocpt_tpu.ops.gravity import BodiesOnGrid as JBodies

from fargocpt_torch.config import Config
from fargocpt_torch.ops import energy
from fargocpt_torch.sim import Simulation

from test_torch_pds70_dust import _assert_particles
from test_torch_planet import quickstart, run_pair

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def pds70_setup(**over) -> dict:
    cfg = yaml.safe_load((ROOT / "setups" / "PDS70.yml").read_text())
    cfg.update({"Nrad": 32, "Naz": 96, "NumberOfParticles": 256}, **over)
    return cfg


@pytest.mark.filterwarnings("ignore:CartesianParticles")
@pytest.mark.parametrize("integrator", ["Euler", "LeapFrog"])
def test_pds70_setup_matches_jax(integrator):
    ts, js = run_pair(pds70_setup(Integrator=integrator))
    assert ts.phys.heating_star and ts.stepper.body_irradiates[0]
    assert not ts.stepper.gates["viscous_kick"]
    _assert_particles(ts.state.particles, js.state.particles)
    assert int(ts.state.particles.alive.sum()) > 200


@pytest.mark.filterwarnings("ignore:CartesianParticles")
def test_pds70_irradiation_heats_the_disk():
    """The star's irradiation adds to Q+ at the start: the same setup with
    a cold star has a smaller Q+ (viscous heating dominates in this
    optically thick disk)."""
    hot = Simulation(Config.from_dict(pds70_setup()), device="cpu")
    cold_cfg = pds70_setup()
    cold_cfg["nbody"][0]["temperature"] = "0 K"
    cold = Simulation(Config.from_dict(cold_cfg), device="cpu")
    assert not cold.phys.heating_star
    q_hot = float(hot.state.qplus[1:-1].sum())
    q_cold = float(cold.state.qplus[1:-1].sum())
    assert q_hot > q_cold * (1.0 + 1e-4) and q_cold > 0.0


def test_irradiation_ramp_up_matches_jax():
    """An irradiating star with an irradiation ramp-up time that the ten
    steps cross, on the adiabatic quickstart disk with surface cooling (the
    unfused substeps; the fused viscous kick does not take HeatingStar)."""
    cfg = quickstart(EquationOfState="Ideal", SurfaceCooling="thermal",
                     l0="1 au", m0="1 solMass", mu=2.35, Sigma0="200 g/cm2")
    cfg["nbody"][0].update({"temperature": "5778 K",
                            "radius": "1 solRadius",
                            "irradiation ramp-up time": 0.05})
    ts, _ = run_pair(cfg)
    assert ts.phys.heating_star
    ramp = float(ts.stepper.body_irradiation_rampup[0])
    assert 0.0 < ramp < float(ts.time)


def test_irradiation_op_equals_jax():
    """energy.irradiation on one set of fields, bodies off centre and with
    a cubic smoothing radius, mid-ramp, against the JAX function."""
    rng = np.random.default_rng(3)
    nr, naz = 12, 20
    r = np.linspace(0.5, 2.0, nr)[:, None]
    phi = np.linspace(0, 2 * np.pi, naz, endpoint=False)[None, :]
    cell_x, cell_y = r * np.cos(phi), r * np.sin(phi)
    aspect = 0.05 + 0.01 * rng.random((nr, naz))
    tau_eff = 1.0 + rng.random((nr, naz))
    bx, by = np.array([0.01, 1.1]), np.array([-0.02, 0.3])
    mass, cubic = np.array([1.0, 1e-3]), np.array([0.0, 0.2])
    radius, temp = np.array([0.05, 0.3]), np.array([20.0, 3.0])
    rampup = np.array([0.0, 2.0])
    irr = [True, True]

    class C:
        sigma_sb = 0.7

    t64 = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    from fargocpt_torch.ops.gravity import BodiesOnGrid
    ctx = energy.IrradiationCtx(
        bodies=BodiesOnGrid(t64(bx), t64(by), t64(mass), t64(cubic)),
        radius=t64(radius), temperature=t64(temp), irradiates=irr,
        rampup=t64(rampup), cell_x=t64(cell_x), cell_y=t64(cell_y))
    got = energy.irradiation(None, C, ctx, t64(aspect), t64(tau_eff), 0.7)
    ref = j_energy.irradiation(
        None, C, None, JBodies(jnp.asarray(bx), jnp.asarray(by),
                               jnp.asarray(mass), jnp.asarray(cubic)),
        2, jnp.asarray(radius), jnp.asarray(temp), irr, jnp.asarray(rampup),
        jnp.asarray(cell_x), jnp.asarray(cell_y), jnp.asarray(aspect),
        jnp.asarray(tau_eff), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)
