"""Bessel-kernel self-gravity (the default ``SelfGravityMode``) on
fargocpt_torch against the JAX package, float64 on the CPU.

* The kernel: K_r, K_t of the razor-thin Bessel kernel on the doubled grid,
  both built on the host in float64 with scipy's K_0 and K_1, bit for bit
  (rtol 0), the singular cell zeroed.
* The vertical structure: H sqrt(2/pi) f(Q) to rtol 1e-12, and
  ``HydroStep.derived`` of both packages (Q from the disk) to rtol 1e-12.
* Built once: the kernel is not rebuilt in the run (no carried kernel
  state; the JAX package's ``supports_in_run_update`` is false too).
* Ten steps through ``Simulation`` at 32x64, adiabatic and locally
  isothermal, and of the quickstart with ``SelfGravity: Yes`` (a planet
  in a self-gravitating disk, ``flagship.planet_disk_sg``, at 32x96), on
  one dt sequence: rtol 1e-10, v_rad to 1e-9 of its largest value
  (tests/longtail_pairs.py says why).
"""

import numpy as np
import pytest
import torch

from fargocpt_tpu.ops import eos as j_eos, selfgravity as j_sg

from fargocpt_torch import flagship
from fargocpt_torch.ops import eos, selfgravity
from fargocpt_torch.step import gates

from longtail_pairs import (BASE, assert_bodies, assert_fields, build_pair,
                            moved, snapshot, step_pair)

torch.set_num_threads(2)

SG = dict(BASE, SelfGravity="Yes")


@pytest.fixture(scope="module")
def pair():
    return build_pair(SG)


def test_bessel_kernel_matches_jax(pair):
    js, ts = pair
    assert ts.phys.self_gravity_mode == "besselkernel"
    for h in (0.05, 0.1):
        k_r, k_t = selfgravity.kernel_host(ts.phys, ts.geometry, h)
        j_r, j_t = j_sg.kernel_host(js.phys, js.geometry, h)
        np.testing.assert_array_equal(k_r, j_r)
        np.testing.assert_array_equal(k_t, j_t)
        assert k_r[0, 0] == 0.0 and k_t[0, 0] == 0.0
        assert np.isfinite(k_r).all() and np.abs(k_r).max() > 0.0
    np.testing.assert_allclose(
        ts.stepper.selfgravity.k_r_hat.numpy(),
        np.fft.rfft2(selfgravity.kernel_host(ts.phys, ts.geometry,
                                             ts.phys.aspectratio_ref)[0]),
        rtol=1e-14)


def test_scale_height_adjustment_matches_jax(pair):
    js, ts = pair
    rng = np.random.default_rng(5)
    h = rng.uniform(0.01, 0.2, (16, 8))
    q = rng.uniform(0.1, 50.0, (16, 8))
    np.testing.assert_allclose(
        eos.adjust_scale_height_for_sg(torch.tensor(h),
                                       torch.tensor(q)).numpy(),
        np.asarray(j_eos.adjust_scale_height_for_sg(h, q)), rtol=1e-12)
    f = ts.state.fields
    t_out = ts.stepper.derived(f.sigma, f.energy)
    j_out = js.stepper.derived(js.state.fields.sigma, js.state.fields.energy)
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)


def test_bessel_kernel_is_built_once(pair):
    js, ts = pair
    assert not ts.stepper.selfgravity.supports_in_run_update()
    assert ts.state.sg_kernel is None and js.state.sg_kernel is None
    g = gates(ts.phys)
    assert not (g["cfl"] or g["sources"] or g["viscous_kick"])


@pytest.mark.parametrize("eos_name", ["Ideal", "Isothermal"])
def test_ten_bessel_steps_match_jax(eos_name):
    js, ts = build_pair(dict(SG, EquationOfState=eos_name))
    before = snapshot(ts)
    step_pair(js, ts, 10)
    assert_fields(ts.state, js.state)
    mv = moved(ts, before)
    assert mv["sigma"] > 1e-4, mv


def test_planet_in_a_self_gravitating_disk_matches_jax():
    cfg = flagship.planet_disk_sg_setup(32, 96)
    js, ts = build_pair(cfg)
    assert ts.stepper.n_bodies == 2
    before = snapshot(ts)
    step_pair(js, ts, 10)
    assert_fields(ts.state, js.state)
    assert_bodies(ts.state, js.state)
    assert moved(ts, before)["sigma"] > 1e-6
