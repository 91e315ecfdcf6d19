"""fargocpt_torch's FFT self-gravity against fargocpt_tpu's on the same
seeded fields, in float64 on the CPU (complex128 transforms on both
sides): the accelerations, the kick, the kernel refresh on due and
not-due calls, and the initial v_az correction.

Tolerances: accelerations rtol 1e-12 of their largest magnitude (pocketfft
in PyTorch and XLA's FFT sum in different orders); the kick and the v_az
correction rtol 1e-12; refreshed kernel spectra 1e-12 of their largest
magnitude.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import selfgravity as j_sg
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.params import Physics as JPhysics
from fargocpt_tpu.units import Units as JUnits

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import selfgravity as sg
from fargocpt_torch.ops.common import Geom
from fargocpt_torch.params import Physics
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR, NAZ = 32, 64


def _pair(mode="symmetric"):
    kw = dict(eos="adiabatic", self_gravity=True, self_gravity_mode=mode,
              aspectratio_ref=0.05, flaring_index=0.25,
              sg_kernel_update_interval=3)
    jgeom = JGeometry.build(NR, NAZ, 0.4, 2.5, "Log")
    tgeom = Geometry.build(NR, NAZ, 0.4, 2.5, "Log")
    js = j_sg.SelfGravity(JPhysics(**kw), JConstants.from_units(JUnits()),
                          jgeom, jnp.float64)
    ts = sg.SelfGravity(Physics(**kw), Constants.from_units(Units()), tgeom,
                        torch.float64)
    return js, ts, j_prepare_geom(jgeom, jnp.float64), \
        Geom(tgeom, torch.float64)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(23)
    return dict(sigma=(rng.random((NR, NAZ)) + 0.5) * 1e-3,
                h=(rng.random((NR, NAZ)) * 0.01 + 0.05)
                * np.linspace(0.4, 2.5, NR)[:, None],
                vaz=(rng.random((NR, NAZ)) - 0.5) * 0.1 + 1.0,
                vrad=(rng.random((NR + 1, NAZ)) - 0.5) * 0.05)


def T(a):
    return torch.tensor(np.asarray(a))


def _close_scaled(got, ref, rtol=1e-12):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0.0,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["symmetric", "basic"])
def test_kernel_and_accelerations(fields, mode):
    js, ts, _, _ = _pair(mode)
    _close_scaled(ts.k_r_hat, js.k_r_hat)
    _close_scaled(ts.k_t_hat, js.k_t_hat)
    ref = js.accelerations(jnp.asarray(fields["sigma"]))
    got = ts.accelerations(T(fields["sigma"]))
    for a, b in zip(got, ref):
        _close_scaled(a, b)


def test_kick(fields):
    js, ts, jg, tg = _pair()
    f = fields
    g_r, g_t = ts.accelerations(T(f["sigma"]))
    got = ts.kick(tg, T(f["vrad"]), T(f["vaz"]), g_r, g_t, T(0.01))
    ref = js.kick(jg, jnp.asarray(f["vrad"]), jnp.asarray(f["vaz"]),
                  jnp.asarray(g_r.numpy()), jnp.asarray(g_t.numpy()),
                  jnp.float64(0.01))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_kernel_refresh_cadence(fields):
    """Interval 3: call 1 is due and rebuilds (the last aspect ratio starts
    at 0); calls 2 and 3 are not due; call 4 is due but the aspect ratio
    moved less than the threshold; call 7 is due with a moved one."""
    js, ts, jg, tg = _pair()
    sj, st = js.initial_kernel_state(), ts.initial_kernel_state()
    sigma = fields["sigma"]
    for call in range(1, 8):
        h = fields["h"] * (1.2 if call >= 5 else 1.0 + 1e-6 * call)
        sj = js.update_kernel(sj, jnp.asarray(sigma), jnp.asarray(h), jg)
        rebuilds = ts.rebuilds
        st = ts.update_kernel(st, T(sigma), T(h), tg)
        assert st[3] == int(sj[3])
        assert ts.rebuilds - rebuilds == (call in (1, 7))
        _close_scaled(st[0], sj[0])
        _close_scaled(st[1], sj[1])
        np.testing.assert_allclose(float(st[2]), float(sj[2]), rtol=1e-12)
    got = ts.accelerations(T(sigma), st[:2])
    ref = js.accelerations(jnp.asarray(sigma), spectra=sj[:2])
    for a, b in zip(got, ref):
        _close_scaled(a, b)


def test_initial_vaz_correction(fields):
    js, ts, _, _ = _pair()
    geom = JGeometry.build(NR, NAZ, 0.4, 2.5, "Log")
    ref = js.init_azimuthal_velocity_correction(js.phys, geom,
                                                fields["sigma"],
                                                fields["vaz"])
    got = ts.init_azimuthal_velocity_correction(ts.phys, T(fields["sigma"]),
                                                fields["vaz"])
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert not np.array_equal(got, fields["vaz"])


def test_bessel_kernel_is_refused():
    """The Bessel kernel, once refused, now ported: K_r and K_t equal the
    JAX package's bit for bit (both built on the host with scipy), the
    singular cell zeroed; tests/test_torch_sg_bessel.py steps it."""
    k_r, k_t = sg.kernel_host(Physics(self_gravity=True,
                                      self_gravity_mode="besselkernel"),
                              Geometry.build(NR, NAZ, 0.4, 2.5, "Log"), 0.05)
    j_r, j_t = j_sg.kernel_host(JPhysics(self_gravity=True,
                                         self_gravity_mode="besselkernel"),
                                JGeometry.build(NR, NAZ, 0.4, 2.5, "Log"),
                                0.05)
    np.testing.assert_array_equal(k_r, j_r)
    np.testing.assert_array_equal(k_t, j_t)
    assert k_r[0, 0] == 0.0 and np.abs(k_r).max() > 0.0
