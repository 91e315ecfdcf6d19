"""The Roche-lobe overflow stream (ROADMAP A.9, second half) of
fargocpt_torch against the JAX package, both in float64 on the CPU:
``ops/boundary.rochelobe_overflow`` on seeded fields, rtol 1e-12.

* both equations of state (the adiabatic stream sets the ghost ring's
  energy, the isothermal one leaves it);
* before the ramp's end (sin^6 of the time over ROFrampingtime donor
  orbits) and after it;
* a donor in the middle of the ring and one whose window wraps across the
  azimuthal seam (its nearest cell is 0, the window takes cells NAZ-3 ..
  3);
* ``ROFtemperature`` 0: a stream of zero width, a delta at the nearest
  cell;
* the time as a float and as a 0-d tensor, the rate as ``ROFvalue`` and as
  a tracked 0-d tensor;
* through ``apply_boundary_conditions``, after the named boundaries.

The donor's omega, its period and its nearest cell are float64 tensors
on the device in the port, so the stream reads nothing back to the host.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import boundary as j_boundary
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.params import Physics as JPhysics

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import boundary
from fargocpt_torch.ops.common import Geom
from fargocpt_torch.params import Physics

torch.set_num_threads(2)

NR, NAZ = 16, 64
RTOL = 1e-12
# OY Car's units: the temperature unit, hours per time unit, the length
# unit in cm (l0 = 0.002916 au, m0 = 0.685 solar masses)
UNITS = (25065029.577259634, 0.26543563542339194, 43622739096.12)
OMEGA_FRAME = 0.37


def _phys(**kw):
    base = dict(eos="adiabatic", adiabatic_index=1.4, mu=2.35,
                sigma0=1e-3, sigma_floor=1e-8, rochelobe_overflow=True,
                rof_planet=1, rof_temperature=0.05, rof_mdot=4.4e-14,
                rof_rampingtime=3.0)
    base.update(kw)
    return JPhysics(**base), Physics(**base)


@pytest.fixture(scope="module")
def geo():
    jgeo = JGeometry.build(NR, NAZ, 0.05, 0.7, "Log")
    tgeo = Geometry.build(NR, NAZ, 0.05, 0.7, "Log")
    return j_prepare_geom(jgeo, jnp.float64), Geom(tgeo, torch.float64)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(29)
    return dict(sigma=rng.random((NR, NAZ)) * 1e-3 + 5e-4,
                vrad=(rng.random((NR + 1, NAZ)) - 0.5) * 0.05,
                vaz=(rng.random((NR, NAZ)) - 0.5) * 0.1 + 1.0,
                energy=rng.random((NR, NAZ)) * 1e-5 + 1e-5)


def _bodies(theta: float, r: float = 1.0):
    """A unit primary at the origin and a 0.1 donor at radius ``r`` and
    azimuth ``theta`` on a near-circular orbit."""
    v = 0.97 * math.sqrt(1.1 / r)
    return dict(x=np.array([0.0, r * math.cos(theta)]),
                y=np.array([0.0, r * math.sin(theta)]),
                vx=np.array([0.0, -v * math.sin(theta)]),
                vy=np.array([0.0, v * math.cos(theta)]),
                mass=np.array([1.0, 0.1]))


DPHI = 2.0 * math.pi / NAZ
DONORS = {"middle": 2.0 * math.pi * 10.0 / NAZ + 0.4 * DPHI,
          # angle 1 - 0.3 / NAZ: the nearest cell is NAZ, taken mod NAZ
          "seam": 2.0 * math.pi - 0.3 * DPHI}


def _period(b) -> float:
    x, y, vx, vy = b["x"][1], b["y"][1], b["vx"][1], b["vy"][1]
    return 2.0 * math.pi / ((x * vy - y * vx) / (x * x + y * y)
                            + OMEGA_FRAME)


def _run(tp, jp, geo, f, b, time, mdot=None, time_tensor=False):
    jg, tg = geo
    jnb = SimpleNamespace(**{k: jnp.asarray(v) for k, v in b.items()})
    tnb = SimpleNamespace(**{k: torch.tensor(v, dtype=torch.float64)
                             for k, v in b.items()})
    jf = [jnp.asarray(f[k]) for k in ("sigma", "vrad", "vaz", "energy")]
    tf = [torch.tensor(f[k]) for k in ("sigma", "vrad", "vaz", "energy")]
    t_time = torch.tensor(time, dtype=torch.float64) if time_tensor \
        else time
    t_mdot = torch.tensor(mdot, dtype=torch.float64) \
        if mdot is not None else None
    ref = j_boundary.rochelobe_overflow(
        jp, JConstants(R=3.5), jg, *jf, jnp.float64(OMEGA_FRAME), jnb,
        time, *UNITS, None if mdot is None else jnp.float64(mdot))
    got = boundary.rochelobe_overflow(
        tp, Constants(R=3.5), tg, *tf,
        torch.tensor(OMEGA_FRAME, dtype=torch.float64), tnb, t_time,
        *UNITS, t_mdot)
    return got, ref


def _close(got, ref):
    for name, a, b in zip(("sigma", "vrad", "vaz", "energy"), got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                   atol=RTOL * np.abs(b).max(),
                                   err_msg=name)


def _window(got, f) -> np.ndarray:
    """The cells of the outer ghost ring the stream wrote."""
    return got[0].numpy()[NR - 1] != f["sigma"][NR - 1]


@pytest.mark.parametrize("donor", sorted(DONORS))
@pytest.mark.parametrize("ramp", [0.3, 2.0])
@pytest.mark.parametrize("eos_name", ["adiabatic", "isothermal"])
def test_stream_matches_jax(geo, fields, eos_name, ramp, donor):
    jp, tp = _phys(eos=eos_name)
    b = _bodies(DONORS[donor])
    time = ramp * tp.rof_rampingtime * _period(b)
    got, ref = _run(tp, jp, geo, fields, b, time)
    _close(got, ref)
    # the stream wrote a window of a few cells on the ghost ring, the
    # rows inside stay
    win = _window(got, fields)
    assert 3 <= win.sum() < NAZ // 2
    if donor == "seam":
        assert win[0] and win[-1] and win[1] and win[-2]
    for k, name in enumerate(("sigma", "vrad", "vaz", "energy")):
        rows = NR - 1
        np.testing.assert_array_equal(got[k].numpy()[:rows],
                                      fields[name][:rows])
    # v_rad on both faces of the ghost ring, v_az one cell further
    assert (got[1].numpy()[NR] != fields["vrad"][NR]).sum() == win.sum()
    assert (got[2].numpy()[NR - 1] != fields["vaz"][NR - 1]).sum() \
        == win.sum() + 1
    energy_set = (got[3].numpy()[NR - 1] != fields["energy"][NR - 1]).sum()
    assert energy_set == (win.sum() if eos_name == "adiabatic" else 0)


def test_stream_ramps_in_as_sin6(geo, fields):
    """Before the ramp's end the stream's density is sin^6 of its full
    density (a rate that keeps it above the floor); after it, the full
    density."""
    jp, tp = _phys(rof_mdot=4.4e-11)
    b = _bodies(DONORS["middle"])
    t_ramp = tp.rof_rampingtime * _period(b)
    full, _ = _run(tp, jp, geo, fields, b, 1.5 * t_ramp)
    part, _ = _run(tp, jp, geo, fields, b, 0.5 * t_ramp)
    win = _window(full, fields)
    assert (part[0].numpy()[NR - 1][win] > tp.sigma_floor * tp.sigma0).all()
    s = math.sin(0.5 * math.pi / 2.0) ** 6
    np.testing.assert_allclose(part[0].numpy()[NR - 1][win],
                               s * full[0].numpy()[NR - 1][win], rtol=1e-13)


def test_zero_temperature_puts_a_delta_at_the_nearest_cell(geo, fields):
    jp, tp = _phys(rof_temperature=0.0)
    b = _bodies(DONORS["seam"])
    got, ref = _run(tp, jp, geo, fields, b, 2.0 * tp.rof_rampingtime
                    * _period(b))
    _close(got, ref)
    win = _window(got, fields)
    assert win[0] and win.sum() == 1


@pytest.mark.parametrize("ramp", [0.3, 2.0])
def test_time_and_rate_as_tensors(geo, fields, ramp):
    """The time as a 0-d tensor and a tracked rate give the floats'
    stream, bit for bit."""
    jp, tp = _phys()
    b = _bodies(DONORS["middle"])
    time = ramp * tp.rof_rampingtime * _period(b)
    as_float, ref = _run(tp, jp, geo, fields, b, time, mdot=7.3e-14)
    as_tensor, _ = _run(tp, jp, geo, fields, b, time, mdot=7.3e-14,
                        time_tensor=True)
    _close(as_float, ref)
    for a, c in zip(as_float, as_tensor):
        np.testing.assert_array_equal(a.numpy(), c.numpy())


def test_apply_boundary_conditions_runs_the_stream(geo, fields):
    """The stream follows the named boundaries (outflow here), as the JAX
    package orders them."""
    jg, tg = geo
    kw = dict(bc_sigma_outer="outflow", bc_energy_outer="outflow",
              bc_vrad_outer="outflow", bc_vaz_outer="zerogradient")
    jp, tp = _phys(**kw)
    b = _bodies(DONORS["seam"])
    time = 0.7 * tp.rof_rampingtime * _period(b)
    f = fields
    jref = j_boundary.RefValues(*(jnp.asarray(f[k]) for k in
                                  ("sigma", "energy", "vrad", "vaz")))
    tref = boundary.RefValues(*(torch.tensor(f[k]) for k in
                                ("sigma", "energy", "vrad", "vaz")))
    jnb = SimpleNamespace(**{k: jnp.asarray(v) for k, v in b.items()})
    tnb = SimpleNamespace(**{k: torch.tensor(v, dtype=torch.float64)
                             for k, v in b.items()})
    ref = j_boundary.apply_boundary_conditions(
        jp, JConstants(R=3.5), jg,
        *(jnp.asarray(f[k]) for k in ("sigma", "vrad", "vaz", "energy")),
        jref, jnp.float64(OMEGA_FRAME),
        rof_ctx=(jnb, time, *UNITS, tp.rof_mdot))
    got = boundary.apply_boundary_conditions(
        tp, Constants(R=3.5), tg,
        *(torch.tensor(f[k]) for k in ("sigma", "vrad", "vaz", "energy")),
        tref, torch.tensor(OMEGA_FRAME, dtype=torch.float64),
        rof_ctx=(tnb, time, *UNITS, tp.rof_mdot))
    _close(got, ref)
    without = boundary.apply_boundary_conditions(
        tp.with_(rochelobe_overflow=False), Constants(R=3.5), tg,
        *(torch.tensor(f[k]) for k in ("sigma", "vrad", "vaz", "energy")),
        tref, torch.tensor(OMEGA_FRAME, dtype=torch.float64),
        rof_ctx=(tnb, time, *UNITS, tp.rof_mdot))
    assert not torch.equal(got[0], without[0])
    np.testing.assert_array_equal(got[0].numpy()[:NR - 1],
                                  without[0].numpy()[:NR - 1])
