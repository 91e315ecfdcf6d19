"""The polytropic equation of state on fargocpt_torch against the JAX
package, float64 on the CPU: the sound speed, pressure, temperature and
scale height (``ops/eos.py``) on seeded grids to rtol 1e-12, and ten steps
through ``Simulation`` at 32x64 on one dt sequence to rtol 1e-10 (v_rad to
1e-9 of its largest value, tests/longtail_pairs.py says why).

The polytropic disk takes the unfused substeps: the kernel gates keep cfl,
sources and the viscous kick off (``step.gates``, as the JAX package's)."""

import numpy as np
import pytest
import torch

from fargocpt_tpu.ops import eos as j_eos

from fargocpt_torch.ops import eos
from fargocpt_torch.step import gates

from longtail_pairs import (BASE, assert_fields, build_pair, moved, snapshot,
                            step_pair)

torch.set_num_threads(2)

POLY = dict(BASE, EquationOfState="Polytropic", AdiabaticIndex="1.4")


@pytest.fixture(scope="module")
def pair():
    return build_pair(POLY)


def test_polytropic_eos_ops_match_jax(pair):
    js, ts = pair
    rng = np.random.default_rng(3)
    nr, naz = ts.geometry.nrad, ts.geometry.naz
    sigma = rng.uniform(0.5, 2.0, (nr, naz)) * ts.phys.sigma0
    energy = rng.uniform(0.5, 2.0, (nr, naz))
    jp, tp = js.phys, ts.phys
    assert tp.is_polytropic and tp.polytropic_constant > 0.0
    t_args = (torch.tensor(sigma), torch.tensor(energy))
    j_cs = j_eos.sound_speed(jp, js.constants, js.stepper.g, *map(
        np.asarray, (sigma, energy)), None)
    t_cs = eos.sound_speed(tp, ts.constants, ts.stepper.g, *t_args, None)
    np.testing.assert_allclose(t_cs.numpy(), np.asarray(j_cs), rtol=1e-12)
    np.testing.assert_allclose(
        eos.pressure(tp, ts.constants, *t_args, t_cs).numpy(),
        np.asarray(j_eos.pressure(jp, js.constants, sigma, energy, j_cs)),
        rtol=1e-12)
    np.testing.assert_allclose(
        eos.temperature(tp, ts.constants, *t_args, None).numpy(),
        np.asarray(j_eos.temperature(jp, js.constants, sigma, energy,
                                     None)), rtol=1e-12)
    np.testing.assert_allclose(
        eos.scale_height(tp, ts.constants, ts.stepper.g, t_cs).numpy(),
        np.asarray(j_eos.scale_height(jp, js.constants, js.stepper.g,
                                      j_cs)), rtol=1e-12)


def test_polytropic_takes_the_unfused_substeps(pair):
    _, ts = pair
    g = gates(ts.phys)
    assert not (g["cfl"] or g["sources"] or g["viscous_kick"])
    assert g["artvisc_sn"]


@pytest.mark.parametrize("integrator", ["Euler", "LeapFrog"])
def test_ten_polytropic_steps_match_jax(integrator):
    js, ts = build_pair(dict(POLY, Integrator=integrator))
    assert_fields(ts.state, js.state, q=False)
    before = snapshot(ts)
    step_pair(js, ts, 10)
    assert_fields(ts.state, js.state)
    mv = moved(ts, before)
    assert mv["sigma"] > 1e-4 and mv["vaz"] > 1e-5, mv
