"""The N-body system of fargocpt_torch with more than one body: the plain
IAS15 (``nbody/ias15.py``), RK4 and RK5 against the JAX package's
``integrate``, the mass ramp-up, the Roche radius, the distance to the
primary and both many-body indirect terms, float64 on the CPU; then the
physics checks of tests/test_ias15.py and tests/test_nbody.py run on the
port.

Tolerance: rtol 1e-13 of each state vector's scale (positions by the
largest distance, velocities by the largest speed): both packages run the
same operations in the same order, and the remaining differences are the
order of XLA's and PyTorch's sums over the bodies, which a pericentre
passage amplifies to ~1e-13."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.nbody import system as j_sys
from fargocpt_tpu.nbody.ias15 import integrate_ias15 as j_ias15
from fargocpt_tpu.ops import gravity as j_gravity

from fargocpt_torch.config import Config
from fargocpt_torch.constants import Constants
from fargocpt_torch.nbody import system as t_sys
from fargocpt_torch.nbody.ias15 import integrate_ias15
from fargocpt_torch.ops import gravity, kernels
from fargocpt_torch.sim import Simulation

torch.set_num_threads(1)
RTOL = 1e-13


def _T(a):
    return torch.tensor(np.asarray(a, np.float64), dtype=torch.float64)


def _two_body(e, a=1.0, m2=1e-3):
    """Two bodies at apocentre in the COM frame (tests/test_ias15.py)."""
    m = np.array([1.0, m2])
    M = m.sum()
    r_apo = a * (1 + e)
    v_apo = np.sqrt(M * (1 - e) / (a * (1 + e)))
    x = np.array([-(m2 / M) * r_apo, (1.0 / M) * r_apo])
    vy = np.array([-(m2 / M) * v_apo, (1.0 / M) * v_apo])
    return (x, np.zeros(2), np.zeros(2), vy, m,
            2 * np.pi * np.sqrt(a ** 3 / M))


def _four_body():
    """A star and three planets on mildly eccentric, inclined-phase
    orbits, from a seed."""
    rng = np.random.default_rng(5)
    a = np.array([0.7, 1.3, 2.1])
    phi = rng.random(3) * 2 * np.pi
    m = np.array([1.0, 1e-3, 3e-4, 2e-3])
    x = np.concatenate([[0.0], a * np.cos(phi)])
    y = np.concatenate([[0.0], a * np.sin(phi)])
    v = np.sqrt(1.0 / a) * (1.0 + 0.1 * rng.random(3))
    vx = np.concatenate([[0.0], -v * np.sin(phi)])
    vy = np.concatenate([[0.0], v * np.cos(phi)])
    return x, y, vx, vy, m, 2 * np.pi * 0.7 ** 1.5


def _close(t_state, j_state, label=""):
    for group in ((0, 1), (2, 3)):
        scale = max(np.abs(np.asarray(j_state[k])).max() for k in group)
        for k in group:
            np.testing.assert_allclose(
                t_state[k].numpy(), np.asarray(j_state[k]), rtol=0.0,
                atol=RTOL * scale, err_msg=f"{label} component {k}")


@pytest.mark.parametrize("case,calls", [("e0.9", 3), ("e0.5", 6),
                                        ("four", 4)])
def test_plain_ias15_matches_jax(case, calls):
    """Calls of a tenth of a period: the e = 0.5 case passes its
    pericentre; the e = 0.9 one adapts its substeps toward it."""
    if case == "four":
        x, y, vx, vy, m, period = _four_body()
    else:
        x, y, vx, vy, m, period = _two_body(float(case[1:]))
    t = [_T(a) for a in (x, y, vx, vy)]
    j = [jnp.asarray(a) for a in (x, y, vx, vy)]
    step = jax.jit(lambda x, y, vx, vy: j_ias15(x, y, vx, vy,
                                                jnp.asarray(m), 1.0,
                                                period / 10))
    counts = []
    for n in range(calls):
        t = list(integrate_ias15(*t, _T(m), 1.0, period / 10, counts=counts))
        j = list(step(*j))
        _close(t, j, f"call {n}")
    assert all(acc >= 1 and trials >= acc for acc, trials in counts)


@pytest.mark.parametrize("method", ["ias15", "rk4", "rk5"])
def test_integrate_matches_jax(method):
    x, y, vx, vy, m, period = _two_body(0.3)
    tn = t_sys.NBodyState(*(_T(a) for a in (x, y, vx, vy, m)))
    jn = j_sys.NBodyState(*(jnp.asarray(a) for a in (x, y, vx, vy, m)))
    for _ in range(3):
        tn = t_sys.integrate(tn, 1.0, period / 20, method=method)
        jn = j_sys.integrate(jn, 1.0, period / 20, method=method)
    _close([tn.x, tn.y, tn.vx, tn.vy],
           [jn.x, jn.y, jn.vx, jn.vy], method)


def test_integrate_dispatches_to_the_ias15_op():
    """On the CPU ``integrate`` takes the op's plain version and counts no
    kernel launch; a tensor dt and a float dt give the same bodies."""
    x, y, vx, vy, m, period = _two_body(0.5)
    st = t_sys.NBodyState(*(_T(a) for a in (x, y, vx, vy, m)))
    before = kernels.LAUNCHES["ias15"]
    out = t_sys.integrate(st, 1.0, torch.tensor(period / 7,
                                                dtype=torch.float64))
    direct = integrate_ias15(*(_T(a) for a in (x, y, vx, vy)), _T(m), 1.0,
                             period / 7)
    torch.testing.assert_close(out.x, direct[0], rtol=0, atol=0)
    torch.testing.assert_close(out.vy, direct[3], rtol=0, atol=0)
    assert kernels.LAUNCHES["ias15"] == before
    counts = torch.zeros(2, dtype=torch.int32)
    kernels.ias15(st.x, st.y, st.vx, st.vy, st.mass, 1.0, period / 7,
                  counts=counts)
    assert counts[0] >= 1 and counts[1] >= counts[0]


def test_lone_star_does_not_move():
    st = t_sys.NBodyState(*(_T([v]) for v in (0.1, 0.2, 0.3, 0.4, 1.0)))
    assert t_sys.integrate(st, 1.0, 0.5) is st


@pytest.mark.parametrize("time", [0.0, 3.7, 31.4, 80.0])
def test_rampup_masses_match_jax(time):
    m = np.array([1.0, 1e-3, 2e-4])
    ramp = np.array([0.0, 10.0, 0.5])
    period = np.array([0.0, 2 * np.pi, 2 * np.pi * 1.5 ** 1.5])
    z = np.zeros(3)
    tn = t_sys.NBodyState(*(_T(a) for a in (z, z, z, z, m)))
    jn = j_sys.NBodyState(*(jnp.asarray(a) for a in (z, z, z, z, m)))
    got = t_sys.rampup_masses(tn, _T(ramp * period), time)
    want = j_sys.rampup_masses(jn, jnp.asarray(ramp), jnp.asarray(period),
                               time)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
    # a tensor time gives the same masses
    got_t = t_sys.rampup_masses(tn, _T(ramp * period),
                                torch.tensor(time, dtype=torch.float64))
    torch.testing.assert_close(got_t, got, rtol=0, atol=0)


def test_roche_radius_and_distance_match_jax():
    x, y, vx, vy, m, _ = _four_body()
    tn = t_sys.NBodyState(*(_T(a) for a in (x, y, vx, vy, m)))
    jn = j_sys.NBodyState(*(jnp.asarray(a) for a in (x, y, vx, vy, m)))
    np.testing.assert_allclose(t_sys.dist_to_primary(tn).numpy(),
                               np.asarray(j_sys.dist_to_primary(jn)),
                               rtol=1e-15)
    got = t_sys.dimensionless_roche_radius(tn).numpy()
    np.testing.assert_allclose(got, np.asarray(
        j_sys.dimensionless_roche_radius(jn)), rtol=1e-14)
    assert got[0] == 0.0
    # the L1 point of a 1e-3 companion: (q/3)^(1/3) to first order
    assert got[1] == pytest.approx((1e-3 / 3) ** (1 / 3), rel=0.05)


def test_mutual_accelerations_match_jax():
    x, y, vx, vy, m, _ = _four_body()
    got = t_sys.mutual_accelerations(_T(x), _T(y), _T(m), 1.3)
    want = j_sys.mutual_accelerations(jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(m), 1.3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)


@pytest.mark.parametrize("n_center", [1, 2])
@pytest.mark.parametrize("dt", [0.0, 0.013])
def test_indirect_terms_match_jax(n_center, dt):
    x, y, vx, vy, m, _ = _four_body()
    tn = t_sys.NBodyState(*(_T(a) for a in (x, y, vx, vy, m)))
    jn = j_sys.NBodyState(*(jnp.asarray(a) for a in (x, y, vx, vy, m)))
    zeros = torch.zeros(4, dtype=torch.float64)
    tb = gravity.BodiesOnGrid(x=tn.x, y=tn.y, mass=tn.mass,
                              cubic_smoothing_radius=zeros)
    jb = j_gravity.BodiesOnGrid(x=jn.x, y=jn.y, mass=jn.mass,
                                cubic_smoothing_radius=jnp.zeros(4))
    got = gravity.indirect_term_nbody(Constants(), tb, n_center, 4)
    want = j_gravity.indirect_term_nbody(JConstants(), jb, n_center, 4)
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-14)
    got = gravity.indirect_term_nbody_predictor(
        Constants(), tn, n_center, 4, torch.tensor(dt, dtype=torch.float64))
    want = j_gravity.indirect_term_nbody_predictor(
        JConstants(), jn, n_center, 4, jnp.float64(dt))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-11,
                               atol=1e-17)
    if dt == 0.0:
        assert [float(v) for v in got] == [0.0, 0.0]


# ---------------------------------------------------------------------------
# the physics checks of tests/test_ias15.py and tests/test_nbody.py on the
# port (shorter horizons: the plain version is a host loop on the CPU)
# ---------------------------------------------------------------------------

def _energy(x, y, vx, vy, m):
    ke = 0.5 * (m * (vx ** 2 + vy ** 2)).sum()
    dx, dy = x[1] - x[0], y[1] - y[0]
    return float(ke - m[0] * m[1] / torch.sqrt(dx * dx + dy * dy))


def test_eccentric_orbit_energy_and_return():
    """e = 0.9, two periods in calls of a tenth of a period: energy drift
    < 1e-11, the apocentre returns to < 1e-8."""
    x, y, vx, vy, m, period = _two_body(0.9)
    st = [_T(a) for a in (x, y, vx, vy)]
    mt = _T(m)
    e0 = _energy(*st, mt)
    for _ in range(20):
        st = integrate_ias15(*st, mt, 1.0, period / 10)
    assert abs((_energy(*st, mt) - e0) / e0) < 1e-11
    r_apo = (1.0 / m.sum()) * 1.9
    assert np.hypot(float(st[0][1]) - r_apo, float(st[1][1])) < 1e-8


def test_exact_finish_time_and_circular_precision():
    x, y, vx, vy, m, period = _two_body(0.0)
    x1, y1, _, _ = integrate_ias15(*(_T(a) for a in (x, y, vx, vy)), _T(m),
                                   1.0, 0.37 * period)
    r1 = 1.0 / m.sum()
    phi = 2 * np.pi * 0.37
    assert abs(float(x1[1]) - r1 * np.cos(phi)) < 1e-11
    assert abs(float(y1[1]) - r1 * np.sin(phi)) < 1e-11


def test_system_integrate_dispatch():
    x, y, vx, vy, m, period = _two_body(0.5)
    st = t_sys.NBodyState(*(_T(a) for a in (x, y, vx, vy, m)))
    out = t_sys.integrate(st, 1.0, period / 7)
    xd = integrate_ias15(*(_T(a) for a in (x, y, vx, vy)), _T(m), 1.0,
                         period / 7)[0]
    np.testing.assert_array_equal(out.x.numpy(), xd.numpy())
    out_rk4 = t_sys.integrate(st, 1.0, period / 7, method="rk4")
    np.testing.assert_allclose(out.x.numpy(), out_rk4.x.numpy(), rtol=0,
                               atol=5e-8)


def _kepler_config(ecc="0.0", extra=None):
    """A star and a planet over a faint disk the planet does not feel."""
    cfg = {
        "EquationOfState": "Isothermal", "AspectRatio": "0.05",
        "Sigma0": "1e-12", "DiskFeedback": "No",
        "Nrad": "16", "Naz": "8", "Rmin": "0.4", "Rmax": "2.5",
        "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "1.0",
        "FirstDT": "1e-3",
        "nbody": [
            {"name": "Star", "semi-major axis": "0.0", "mass": "1.0"},
            {"name": "Planet", "semi-major axis": "1.0", "mass": "1e-3",
             "eccentricity": ecc},
        ],
    }
    cfg.update(extra or {})
    return Config.from_dict(cfg)


def test_jacobi_initialization():
    sim = Simulation(_kepler_config(), device="cpu")
    nb = sim.state.nbody
    assert abs(float(nb.x[0])) < 1e-15 and abs(float(nb.y[0])) < 1e-15
    assert np.isclose(np.hypot(float(nb.x[1]), float(nb.y[1])), 1.0)
    el = sim.orbital_elements(1)
    assert np.isclose(el["a"], 1.0, atol=1e-12)
    assert el["e"] < 1e-12


@pytest.mark.parametrize("ecc", ["0.0", "0.3"])
def test_kepler_orbit_conservation(ecc):
    """Two orbits of the N-body drift alone in calls of 1/50 of a period
    (tests/test_nbody.py marches 20 orbits through the Simulation)."""
    sim = Simulation(_kepler_config(ecc), device="cpu")
    el0 = sim.orbital_elements(1)
    nb = sim.state.nbody
    for _ in range(100):
        nb = t_sys.integrate(nb, 1.0, 2 * np.pi / 50)
        nb = t_sys.move_to_hydro_frame_center(nb, 1)
    sim.state = sim.state.replace(nbody=nb)
    el1 = sim.orbital_elements(1)
    assert np.isclose(el1["a"], el0["a"], rtol=1e-9), (el0, el1)
    assert abs(el1["e"] - el0["e"]) < 1e-9


def test_indirect_term_modes_agree():
    nb = t_sys.NBodyState(*(_T(a) for a in ([0.0, 1.0], [0.0, 0.0],
                                            [0.0, 0.0], [0.0, 1.0],
                                            [1.0, 1e-3])))
    bodies = gravity.BodiesOnGrid(x=nb.x, y=nb.y, mass=nb.mass,
                                  cubic_smoothing_radius=torch.zeros(
                                      2, dtype=torch.float64))
    ex, ey = gravity.indirect_term_nbody(Constants(), bodies, 1, 2)
    px, py = gravity.indirect_term_nbody_predictor(
        Constants(), nb, 1, 2, torch.tensor(1e-4, dtype=torch.float64))
    assert np.isclose(float(ex), -1e-3, rtol=1e-10)
    np.testing.assert_allclose(float(px), float(ex), rtol=1e-3)
    np.testing.assert_allclose(float(py), float(ey), atol=1e-6)


@pytest.mark.parametrize("method", ["rk4", "rk5"])
def test_fixed_step_integrators_match_ias15(method):
    """rk4 and the corrected Cash-Karp rk5 agree with IAS15 over a full
    e = 0.3 orbit."""
    e = 0.3
    r0 = 1.0 - e
    v0 = np.sqrt((1.0 + 1e-3) * (1.0 + e) / r0)
    nb = t_sys.NBodyState(*(_T(a) for a in ([0.0, r0], [0.0, 0.0],
                                            [0.0, 0.0], [-1e-3 * v0, v0],
                                            [1.0, 1e-3])))
    ref = nb
    dt = 2 * np.pi / 100.0
    for _ in range(100):
        nb = t_sys.integrate(nb, 1.0, dt, n_substeps=32, method=method)
        ref = t_sys.integrate(ref, 1.0, dt, method="ias15")
    np.testing.assert_allclose(nb.x.numpy(), ref.x.numpy(), atol=5e-6)
    np.testing.assert_allclose(nb.y.numpy(), ref.y.numpy(), atol=5e-6)


def test_nbody_integrator_config_threading():
    sim = Simulation(_kepler_config(extra={"NbodyIntegrator": "rk5"}),
                     device="cpu")
    assert sim.stepper.phys.nbody_integrator == "rk5"
    el0 = sim.orbital_elements(1)
    for _ in range(50):
        sim.step_once(1e-2)
    el1 = sim.orbital_elements(1)
    assert np.isclose(el1["a"], el0["a"], rtol=1e-7)
    with pytest.raises(ValueError, match="NbodyIntegrator"):
        t_sys.integrate(sim.state.nbody, 1.0, 1e-3, method="rk9")
