"""The monitor grids in float32: how far each lies from the float64 run,
in the port and in the JAX package, on the same dt sequence.

A monitor grid sums terms that cancel (the star's potential differenced
across a ring for the gravitational torque, the flux of a v_rad near 0 for
MassFlow), so in float32 it is rounding to a few per cent of itself. This
holds the port's float32 grids to no more than twice the JAX package's own
float32 deviation: a loss of precision in how the port accumulates them
would show here, float32's own limit does not.

As a script it prints the deviations at another size, on the physics of
``flagship.planet_accretion`` (the leapfrog in the corotating frame, a
Kley-accreting planet, MassFlow and the gas torques)::

    python tests/test_torch_monitor_f32.py NRAD NAZ STEPS
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fargocpt_tpu.config import Config as JConfig  # noqa: E402
from fargocpt_tpu.sim import Simulation as JSimulation  # noqa: E402
from fargocpt_torch.config import Config  # noqa: E402
from fargocpt_torch.flagship import PLANET_ACCRETION  # noqa: E402
from fargocpt_torch.sim import Simulation  # noqa: E402

# the grids this physics fills (its viscous torque is zero: no viscosity)
GRIDS = ("massflow", "t_adv", "t_grav")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def deviations(nrad: int, naz: int, steps: int) -> dict:
    """Each grid's rel-L2 of float32 against float64, in each package,
    after ``steps`` steps on the port's float32 dt sequence; and the
    float64 runs against each other."""
    cfg = dict(PLANET_ACCRETION, Nrad=str(nrad), Naz=str(naz))
    cfg["nbody"] = [dict(b) for b in PLANET_ACCRETION["nbody"]]
    j32 = JSimulation(JConfig.from_dict(dict(cfg)), dtype="float32")
    j64 = JSimulation(JConfig.from_dict(dict(cfg)), dtype="float64")
    t32 = Simulation(Config.from_dict(dict(cfg)), dtype="float32",
                     device="cpu")
    t64 = Simulation(Config.from_dict(dict(cfg)), dtype="float64",
                     device="cpu")
    for _ in range(steps):
        dt = float(t32.calculate_time_step())
        j32.step_once(np.float32(dt))
        j64.step_once(dt)
        t32.step_once(torch.tensor(dt, dtype=torch.float32))
        t64.step_once(dt)
    out = {}
    for name in GRIDS:
        jf, jd = (np.asarray(getattr(s.state.monitor_acc, name))
                  for s in (j32, j64))
        tf, td = (getattr(s.state.monitor_acc, name).double().numpy()
                  for s in (t32, t64))
        out[name] = {"jax": _rel(jf, jd), "port": _rel(tf, td),
                     "f64_parity": _rel(td, jd)}
    return out


@pytest.fixture(scope="module")
def devs():
    return deviations(32, 64, 20)


@pytest.mark.parametrize("name", GRIDS)
def test_float32_grid_rounds_as_the_jax_package(devs, name):
    d = devs[name]
    # float32's own limit: well above float64's, in both packages
    assert d["jax"] > 1e-5 and d["port"] > 1e-5
    assert d["port"] <= 2.0 * d["jax"], d
    assert d["f64_parity"] < 1e-9, d


if __name__ == "__main__":
    nr, nz, n = (int(a) for a in sys.argv[1:4])
    for grid, d in deviations(nr, nz, n).items():
        print(f"{nr}x{nz}, {n} steps, {grid}: float32 against float64 "
              f"JAX {d['jax']:.4e}, port {d['port']:.4e} "
              f"(float64 port against JAX {d['f64_parity']:.3e})")
