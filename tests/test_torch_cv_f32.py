"""The cataclysmic variables in float32: dead in both packages.

``setups/CloseBinaries/OY_Car.yml`` and ``setups/V1504Cyg.yml`` take units
in which the disk's surface density is ~1e-11 and its floor ~1e-19 (OY
Car: l0 = 0.002916 au, m0 = 0.685 solar masses). SubStep3's radiative
correction factor multiplies (mu (gamma - 1) / (R Sigma))^4, which
overflows float32 there, by E^3, which underflows: inf times 0, so the
initial Q+ and Q- (SubStep3 at t = 0, which the CFL reads) are NaN in
the port and in the JAX package alike. The port's time step takes
torch.minimum, which keeps the NaN, as the JAX package's device loop
(``_advance_impl``, jnp.minimum) would; the JAX package's run loop does
not get that far in float32: its while loop refuses the float64 tracker
rate the Euler step makes from a float32 one (a TypeError). Its
``calculate_time_step`` drops the NaN by Python's min, so a run driven by
``step_once`` goes on at 1.1 times the last dt. A repair would be a
feature the JAX package lacks, so both setups run in float64, on the
card too (``chip_smoke.py``), where they are sound.

XLA's CPU backend flushes subnormals to zero and PyTorch keeps them, so
the JAX package has more NaN cells than the port: every NaN cell of the
port is one of the JAX package's.

As a script it prints the NaN cells at another size::

    python tests/test_torch_cv_f32.py NRAD NAZ
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
from fargocpt_torch.flagship import (  # noqa: E402
    OY_CAR, V1504CYG, setup_file)
from fargocpt_torch.sim import Simulation  # noqa: E402

torch.set_num_threads(2)

CV_SETUPS = {"oy_car": OY_CAR, "v1504cyg": V1504CYG}


def nan_cells(name: str, nrad: int, naz: int, dtype: str) -> dict:
    """The cells of the initial Q+ / Q- that are NaN in each package, and
    those where the correction factor's (mu (gamma - 1) / (R Sigma))^4
    overflows the type."""
    cfg = setup_file(CV_SETUPS[name], nrad, naz)
    js = JSimulation(JConfig.from_dict(dict(cfg)), dtype=dtype)
    ts = Simulation(Config.from_dict(dict(cfg)), dtype=dtype, device="cpu")
    out = {}
    for label, sim in (("jax", js), ("port", ts)):
        q = [np.asarray(sim.state.qplus), np.asarray(sim.state.qminus)]
        out[label] = np.isnan(q[0]) | np.isnan(q[1])
    phys = ts.phys
    sigma = ts.fields.sigma.double().numpy()
    base = phys.mu * (phys.adiabatic_index - 1.0) / (ts.constants.R * sigma)
    out["overflow"] = base ** 4 > np.finfo(dtype).max
    out["sim"] = ts
    return out


@pytest.mark.parametrize("name", sorted(CV_SETUPS))
def test_float32_heating_and_cooling_are_nan_in_both_packages(name):
    cells = nan_cells(name, 16, 32, "float32")
    assert cells["port"].any() and cells["jax"].any()
    assert not (cells["port"] & ~cells["jax"]).any()
    # the NaN cells lie where the correction factor's base overflows
    assert not (cells["port"] & ~cells["overflow"]).any()
    # the time step keeps the NaN
    ts = cells["sim"]
    assert torch.isnan(ts.calculate_time_step())


@pytest.mark.parametrize("name", sorted(CV_SETUPS))
def test_float64_heating_and_cooling_are_finite(name):
    cells = nan_cells(name, 16, 32, "float64")
    assert not cells["port"].any() and not cells["jax"].any()
    assert not cells["overflow"].any()


def test_jax_run_loop_refuses_the_float32_tracker():
    cfg = setup_file(CV_SETUPS["oy_car"], 16, 32, Nsnapshots=1, Nmonitor=1,
                     MonitorTimestep=1e-6)
    js = JSimulation(JConfig.from_dict(cfg), dtype="float32")
    with pytest.raises(TypeError, match="rof_mdot"):
        js.stepper.advance_to(js.state, js.time, js.last_dt, 1e-6)


if __name__ == "__main__":
    nr, nz = (int(a) for a in sys.argv[1:3])
    for which in sorted(CV_SETUPS):
        c = nan_cells(which, nr, nz, "float32")
        print(f"{which} {nr}x{nz} float32: initial Q+/Q- NaN in "
              f"{int(c['jax'].sum())} cells (JAX), {int(c['port'].sum())} "
              f"(port); (mu (gamma-1) / (R Sigma))^4 overflows in "
              f"{int(c['overflow'].sum())}")
