"""The damping zones of fargocpt_torch (``ops/damping.py``) against the JAX
package's ``DampingZones``: each target (initial, mean, zero, none, and the
viscous drift of the inner v_rad) on each quantity, both zones, seeded
float64 fields, rtol 1e-14; and the four mass deltas the step books,
against the JAX step's formula on the JAX zones' masks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import boundary as j_boundary
from fargocpt_tpu.ops.damping import DampingZones as JDampingZones
from fargocpt_tpu.params import Physics as JPhysics

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import boundary
from fargocpt_torch.ops.common import Geom
from fargocpt_torch.ops.damping import DampingZones
from fargocpt_torch.params import Physics

NR, NAZ = 40, 16
RTOL = 1e-14
QUANTITIES = {"sigma": "surface_density", "energy": "energy",
              "vaz": "vazimuthal", "vrad": "vradial"}
MODES = ("initial", "mean", "zero", "none")


def _phys(**kw):
    base = dict(eos="adiabatic", adiabatic_index=1.4, damping=True,
                damping_inner_limit=1.3, damping_outer_limit=0.8,
                damping_time_factor=0.1, viscous_outflow_speed=1.2)
    base.update(kw)
    return JPhysics(**base), Physics(**base)


@pytest.fixture(scope="module")
def setup():
    args = (NR, NAZ, 0.4, 2.5, "Log")
    rng = np.random.default_rng(11)
    f = dict(sigma=rng.random((NR, NAZ)) + 0.5,
             energy=rng.random((NR, NAZ)) * 1e-3 + 1e-3,
             vaz=(rng.random((NR, NAZ)) - 0.5) * 0.1 + 1.0,
             vrad=(rng.random((NR + 1, NAZ)) - 0.5) * 0.05)
    ref = {k: v * (1.0 + 0.2 * rng.random(v.shape)) for k, v in f.items()}
    nu = rng.random((NR, NAZ)) * 1e-5 + 1e-6
    return JGeometry.build(*args), Geometry.build(*args), f, ref, nu


def _run(setup, dt, **kw):
    jgeo, tgeo, f, ref, nu = setup
    jp, tp = _phys(**kw)
    jz = JDampingZones(jp, JConstants(), jgeo, jnp.float64)
    tz = DampingZones(tp, Constants(), tgeo, torch.float64)
    T = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    order = ("sigma", "vrad", "vaz", "energy")
    got = tz.apply(tp, *(T(f[k]) for k in order),
                   boundary.RefValues(*(T(ref[k]) for k in
                                        ("sigma", "energy", "vrad", "vaz"))),
                   T(dt), nu=T(nu))
    want = jz.apply(jp, *(jnp.asarray(f[k]) for k in order),
                    j_boundary.RefValues(*(jnp.asarray(ref[k]) for k in
                                           ("sigma", "energy", "vrad",
                                            "vaz"))),
                    jnp.float64(dt), nu=jnp.asarray(nu))
    for name, a, b in zip(order, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=0.0, err_msg=name)
    return jz, tz, tgeo, f["sigma"], got[0].numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("quantity", list(QUANTITIES))
@pytest.mark.parametrize("zone", ["inner", "outer", "both"])
def test_damping_matches_jax(setup, quantity, mode, zone):
    key = QUANTITIES[quantity]
    kw = {}
    for side in (("inner", "outer") if zone == "both" else (zone,)):
        kw[f"damping_{key}_{side}"] = mode
    _run(setup, 0.05, **kw)


@pytest.mark.parametrize("outer", ["none", "initial", "mean"])
def test_viscous_vrad_target_matches_jax(setup, outer):
    _run(setup, 0.05, damping_vradial_inner="viscous",
         damping_vradial_outer=outer)


def test_viscous_outer_vrad_raises(setup):
    with pytest.raises(NotImplementedError, match="outer"):
        _run(setup, 0.05, damping_vradial_outer="viscous")


@pytest.mark.parametrize("limits", [(1.3, 0.8), (1.0, 0.8), (1.3, 1.0)])
def test_mass_deltas_match_the_jax_bookkeeping(setup, limits):
    """The (4,) mass created and removed in each zone
    (fargocpt_tpu/step.py:541-552 on the JAX zones' masks)."""
    jz, tz, tgeo, s0, s1 = _run(
        setup, 0.5, damping_inner_limit=limits[0],
        damping_outer_limit=limits[1],
        damping_surface_density_inner="mean",
        damping_surface_density_outer="initial")
    dm = (s1 - s0) * tgeo.surf[:, None]
    din = np.where(np.asarray(jz.in_b), dm, 0.0)
    dout = np.where(np.asarray(jz.out_b), dm, 0.0)
    want = [np.maximum(din, 0.0).sum(), np.maximum(-din, 0.0).sum(),
            np.maximum(dout, 0.0).sum(), np.maximum(-dout, 0.0).sum()]
    g = Geom(tgeo, torch.float64)
    got = tz.mass_deltas(g, torch.tensor(s0), torch.tensor(s1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-300)
    assert (got[:2] != 0).any() == (limits[0] > 1.0)
    assert (got[2:] != 0).any() == (limits[1] < 1.0)
