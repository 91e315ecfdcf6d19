"""The circumbinary-disk menu in float32: how far the float32 run of
``flagship.binary_gcfull``'s physics lies from the float64 one, in the port
and in the JAX package, on the same dt sequence.

The centre-of-mass boundary's drift nests two five-point differences with
h = 8e-4 r (``ops/diskmodel.py`` ``vr_numerical_viscous``), so in float32
the v_rad it writes into the ghost faces is rounding, in both packages.
This holds each field of the port's float32 run to no more than twice the
JAX package's own float32 deviation: a loss of precision in the port would
show here, float32's own limit does not. ``chip_smoke.py`` holds the card's
float32 trajectory to twice the JAX deviation this script prints at
128x256.

The port keeps the bodies in float64 and forms their centre of mass in
float64; the JAX package in the field type. ``com_rounding`` measures what
that does to the ghost ring alone: the port's boundary from its float64
bodies against the same boundary with the centre of mass formed in
float32 from the bodies rounded to float32.

The four runs take about 80 s on the CPU, two JAX builds of the step
among them, so the tests are in the slow tier (``-m slow``).

As a script it prints the deviations at another size::

    python tests/test_torch_binary_f32.py NRAD NAZ STEPS
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
from fargocpt_torch.flagship import binary_gcfull_setup  # noqa: E402
from fargocpt_torch.nbody.system import NBodyState  # noqa: E402
from fargocpt_torch.ops import boundary  # noqa: E402
from fargocpt_torch.sim import Simulation  # noqa: E402

torch.set_num_threads(2)

pytestmark = pytest.mark.slow

FIELDS = ("sigma", "vrad", "vaz", "energy")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cfg(nrad: int, naz: int) -> dict:
    return binary_gcfull_setup(nrad, naz, Rmin="0.05", Rmax="12")


def deviations(nrad: int, naz: int, steps: int) -> dict:
    """Each field's rel-L2 of float32 against float64, in each package,
    after ``steps`` steps on the port's float32 dt sequence, and the
    float64 runs against each other; ``com_rounding`` as above, at the
    float32 run's end."""
    cfg = _cfg(nrad, naz)
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
    for name in FIELDS:
        jf, jd = (np.asarray(getattr(s.state.fields, name))
                  for s in (j32, j64))
        tf, td = (getattr(s.state.fields, name).double().numpy()
                  for s in (t32, t64))
        out[name] = {"jax": _rel(jf, jd), "port": _rel(tf, td),
                     "f64_parity": _rel(td, jd)}
    out["com_rounding"] = com_rounding(t32)
    return out


def com_rounding(sim) -> float:
    """The largest change, over the largest value, of the outer ghost
    ring's fields when the centre-of-mass boundary forms the centre of mass
    in float32 from the bodies rounded to float32, as the JAX package does,
    in place of float64."""
    st, f, nb = sim.stepper, sim.fields, sim.state.nbody
    nb32 = NBodyState(**{k: getattr(nb, k).float()
                         for k in ("x", "y", "vx", "vy", "mass")})
    args = (sim.phys, sim.constants, st.g, f.sigma, f.vrad, f.vaz, f.energy)
    a = boundary.center_of_mass_boundary(*args, nb, st.n_hydroframe,
                                         st.quad_moment,
                                         sim.state.omega_frame)
    b = boundary.center_of_mass_boundary(*args, nb32, st.n_hydroframe,
                                         st.quad_moment,
                                         sim.state.omega_frame)
    return max(float((x - y).abs().max() / x.abs().max())
               for x, y in zip(a, b))


@pytest.fixture(scope="module")
def devs():
    return deviations(32, 64, 10)


@pytest.mark.parametrize("name", FIELDS)
def test_float32_rounds_as_the_jax_package(devs, name):
    d = devs[name]
    assert d["jax"] > 1e-8 and d["port"] > 1e-8, d
    assert d["port"] <= 2.0 * d["jax"], d
    assert d["f64_parity"] < 1e-9, d


def test_float64_centre_of_mass_moves_the_ghost_ring_by_rounding(devs):
    """A float32 centre of mass moves the ghost ring by float32 rounding,
    no more."""
    assert devs["com_rounding"] < 1e-5, devs["com_rounding"]


if __name__ == "__main__":
    nr, nz, n = (int(a) for a in sys.argv[1:4])
    devs_ = deviations(nr, nz, n)
    for name in FIELDS:
        d = devs_[name]
        print(f"{nr}x{nz}, {n} steps, {name}: float32 against float64 "
              f"JAX {d['jax']:.4e}, port {d['port']:.4e} "
              f"(float64 port against JAX {d['f64_parity']:.3e})")
    print(f"{nr}x{nz}, {n} steps: the outer ghost ring with a float32 "
          f"centre of mass moves by {devs_['com_rounding']:.3e}")
