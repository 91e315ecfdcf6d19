"""The dust functions of fargocpt_torch (particles/dust.py) against the JAX
package's, on the CPU in float64: the same swarm and gas grids, made from
a seed with numpy, through both.

Tolerance rtol 1e-10 unless a test states its own. Two understood
differences sit far below it: the port takes ``torch.cos`` where the JAX
package takes the half-angle form 1 - 2 sin^2(x/2) (its workaround for a
TPU's emulated float64 cosine), which moves the gravity derivatives by
<= 3e-16 of their size here; and the analytic radial cell lookup may land
one cell off on a cell edge, with the weight clamped to 0 or 1, so
interpolated values are compared, never indices.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.ops.gravity import BodiesOnGrid as JBodies
from fargocpt_tpu.params import Physics as JPhysics
from fargocpt_tpu.particles import dust as jdust
from fargocpt_tpu.units import Units as JUnits

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops.gravity import BodiesOnGrid
from fargocpt_torch.params import Physics
from fargocpt_torch.particles import dust
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR, NAZ, N = 48, 64, 512
RTOL = 1e-10
FIELDS = ("r", "phi", "r_dot", "phi_dot", "stokes", "timestep", "facold")


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _geometries(nr=NR, naz=NAZ, rmin=0.4, rmax=2.5, spacing="Log"):
    return (JGeometry.build(nr, naz, rmin, rmax, spacing),
            Geometry.build(nr, naz, rmin, rmax, spacing))


def _gas(seed, nr=NR, naz=NAZ):
    """Gas grids in code units of 1 cm, 1 g, 1 s, at which the drag law's
    Knudsen and Reynolds numbers of these swarms are of order one."""
    rng = np.random.default_rng(seed)
    return dict(rho=(rng.random((nr, naz)) + 0.5) * 1e-5,
                temperature=(rng.random((nr, naz)) + 0.5) * 100.0,
                vrad=(rng.random((nr + 1, naz)) - 0.5) * 0.02,
                vaz=(rng.random((nr, naz)) - 0.5) * 0.05 + 1.0)


def _swarm(seed, n=N, rlo=0.45, rhi=2.4, alive=None):
    rng = np.random.default_rng(seed)
    r = rng.uniform(rlo, rhi, n)
    return dict(r=r, phi=rng.uniform(0.0, 2.0 * np.pi, n),
                r_dot=(rng.random(n) - 0.5) * 0.02,
                phi_dot=r ** -1.5 * (1.0 + 0.02 * (rng.random(n) - 0.5)),
                size=10.0 ** rng.uniform(-2.0, 1.0, n),
                stokes=np.zeros(n),
                alive=np.ones(n, bool) if alive is None else alive,
                timestep=np.zeros(n), facold=np.full(n, 1e-4))


def _states(sw):
    js = jdust.ParticleState(
        **{k: jnp.asarray(v) for k, v in sw.items()},
        rng_key=jax.random.PRNGKey(0))
    ts = dust.ParticleState(**{
        k: torch.tensor(v) if k == "alive" else T(v) for k, v in sw.items()})
    return js, ts


def _bodies():
    x, y, m = [0.0, 1.1], [0.0, 0.4], [1.0, 2e-3]
    jb = JBodies(x=jnp.asarray(x), y=jnp.asarray(y), mass=jnp.asarray(m),
                 cubic_smoothing_radius=jnp.zeros(2))
    tb = BodiesOnGrid(x=T(x), y=T(y), mass=T(m),
                      cubic_smoothing_radius=torch.zeros(2,
                                                         dtype=torch.float64))
    return jb, tb


def _assert_state(t_state, j_state, rtol=RTOL, fields=FIELDS):
    np.testing.assert_array_equal(t_state.alive.numpy(),
                                  np.asarray(j_state.alive))
    for name in fields:
        ref = np.asarray(getattr(j_state, name))
        got = getattr(t_state, name).numpy()
        if name == "phi":
            d = np.abs(got - ref)
            d = np.minimum(d, 2.0 * np.pi - d)
            assert d.max() <= rtol * 2.0 * np.pi, (name, d.max())
            continue
        # r_dot crosses zero: held to rtol of its largest value
        atol = rtol * np.abs(ref).max() if name == "r_dot" else 0.0
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(n=1000, rmin=0.4, rmax=2.5, slope=0.5, ecc=0.0, seed=1337),
    dict(n=257, rmin=0.6, rmax=2.0, slope=1.0, ecc=0.1, seed=7),
], ids=["pds70", "slope1_ecc"])
def test_init_particles_equal_jax(kw):
    sizes = 1e-3 * 10.0 ** (np.arange(kw["n"]) % 4)
    args = (kw["n"], kw["rmin"], kw["rmax"], kw["slope"], sizes, 1.0)
    js = jdust.init_particles(*args, eccentricity=kw["ecc"], seed=kw["seed"])
    ts = dust.init_particles(*args, eccentricity=kw["ecc"], seed=kw["seed"],
                             device="cpu")
    for name in FIELDS + ("size",):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert ts.alive.dtype == torch.bool and bool(ts.alive.all())
    assert ts.n == kw["n"] and ts.r.dtype == torch.float64


@pytest.mark.parametrize("spacing", ["Log", "Arithmetic"])
@pytest.mark.parametrize("az_offset", [0.0, -0.5])
def test_interpolate_many_matches_jax(spacing, az_offset):
    """Log grid: the analytic ladder; arithmetic: searchsorted. Queries
    beyond both ends of the grid are included (clamped weights)."""
    jgeo, geo = _geometries(spacing=spacing)
    rng = np.random.default_rng(2)
    fields = [rng.random((NR, NAZ)) for _ in range(3)]
    r = np.concatenate([rng.uniform(0.3, 2.7, N), geo.rmed[5:9]])
    phi = np.concatenate([rng.uniform(-1.0, 7.5, N), np.zeros(4)])
    ref = jdust.interpolate_many([jnp.asarray(f) for f in fields], jgeo.rmed,
                                 jnp.asarray(r), jnp.asarray(phi), NAZ,
                                 az_offset=az_offset)
    axis = dust.RadialAxis(geo.rmed, torch.float64)
    assert (axis.ladder is not None) == (spacing == "Log")
    got = dust.interpolate_many([T(f) for f in fields], axis, T(r), T(phi),
                                NAZ, az_offset=az_offset)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-14)
    one = dust.interpolate(T(fields[0]), axis, T(r), T(phi), NAZ,
                           az_offset=az_offset)
    assert torch.equal(one, got[0])


def test_analytic_ladder_matches_searchsorted():
    """tests/test_dust.py's check of the JAX package, mirrored: on a log
    grid the analytic lookup reproduces the searchsorted-based values
    (atol 1e-9; an index may flip on a cell edge), exact edge hits and
    out-of-range queries included."""
    rng = np.random.default_rng(5)
    nr, naz = 96, 64
    g = (2.5 / 0.4) ** (1.0 / (nr - 2))
    radii = 0.4 * g ** (np.arange(nr + 1) - 1.0)
    rmed = 0.5 * (radii[:-1] + radii[1:])
    assert dust._geometric_ladder(rmed) is not None
    assert dust._geometric_ladder(np.linspace(0.4, 2.5, nr)) is None
    np.testing.assert_allclose(dust._geometric_ladder(rmed),
                               jdust._geometric_ladder(rmed), rtol=1e-15)

    field = T(rng.random((nr, naz)))
    r = rng.uniform(radii[1], radii[-2], 4096)
    r = np.concatenate([r, rmed[3:10], [0.0, radii[0] * 0.5, radii[-1] * 2]])
    phi = rng.uniform(0, 2 * np.pi, r.size)
    analytic = dust.RadialAxis(rmed, torch.float64)
    searched = dust.RadialAxis(rmed, torch.float64)
    searched.ladder = None
    out_a = dust.interpolate(field, analytic, T(r), T(phi), naz)
    out_s = dust.interpolate(field, searched, T(r), T(phi), naz)
    np.testing.assert_allclose(out_a.numpy(), out_s.numpy(), rtol=0,
                               atol=1e-9)


def test_sample_gas_matches_jax():
    jgeo, geo = _geometries()
    gas, sw = _gas(3), _swarm(4)
    jg = j_prepare_geom(jgeo, jnp.float64)
    ref = jdust.sample_gas(jgeo, jg, *[jnp.asarray(gas[k]) for k in
                                      ("rho", "temperature", "vrad", "vaz")],
                           jnp.float64(0.2), jnp.asarray(sw["r"]),
                           jnp.asarray(sw["phi"]))
    grid = dust.DustGrid(geo, torch.float64)
    got = dust.sample_gas(grid, *[T(gas[k]) for k in
                                  ("rho", "temperature", "vrad", "vaz")],
                          T(0.2), T(sw["r"]), T(sw["phi"]))
    for name in ("rho", "temperature", "vg_phi"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=RTOL,
                                   err_msg=name)
    # vg_r crosses zero: held to rtol of the largest face velocity
    np.testing.assert_allclose(got.vg_r.numpy(), np.asarray(ref.vg_r),
                               rtol=RTOL, atol=RTOL * 0.01)


def test_calc_tstop_matches_jax_in_all_four_reynolds_branches():
    """vrel spans the Stokes branches Re <= 1e-3, <= 500, <= 1500 and
    above (at rho = nu_mol / 2 and size 1, Re = vrel), and falls to the
    1e-15 c_s clamp."""
    units, junits = Units(), JUnits()
    phys, jphys = Physics(), JPhysics()
    temperature = np.full(6, 100.0)
    m0 = phys.mu * 1.66053906660e-24
    vth = np.sqrt(8.0 * 1.380649e-16 * temperature / (np.pi * m0))
    nu_mol = (1.0 / 3.0) * m0 * vth / (np.pi * 1.5e-8 ** 2)
    rho = nu_mol / 2.0
    vrel = np.array([0.0, 1e-4, 1.0, 400.0, 1000.0, 5000.0])
    size = np.ones(6)
    reynolds = 2.0 * size * rho * np.maximum(vrel, 1e-15) / nu_mol
    assert [int(np.searchsorted([1e-3, 500.0, 1500.0], x)) for x in reynolds] \
        == [0, 0, 1, 1, 2, 3]
    ref = jdust.calc_tstop(jphys, JConstants(), junits, jnp.asarray(size),
                           jnp.asarray(rho), jnp.asarray(vrel),
                           jnp.asarray(temperature), 2.65)
    got = dust.calc_tstop(phys, Constants.from_units(units), units, T(size),
                          T(rho), T(vrel), T(temperature), 2.65)
    assert np.all(np.asarray(ref) > 0) and np.all(np.diff(np.asarray(ref))
                                                  <= 0)
    # pow(x, 0.687) and pow(x, -0.313) round differently in the two
    # libraries: 1e-12 observed at most, held at 1e-10
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


def test_gravity_derivatives_match_jax():
    """torch.cos against the JAX package's half-angle cosine: the two
    derivatives differ by <= 3e-16 of their largest value here; held at
    1e-13 of it."""
    jb, tb = _bodies()
    sw = _swarm(6)
    ref = jdust.gravity_derivatives(JConstants(), jb, 2, jnp.asarray(sw["r"]),
                                    jnp.asarray(sw["phi"]))
    got = dust.gravity_derivatives(Constants.from_units(Units()), tb, 2,
                                   T(sw["r"]), T(sw["phi"]))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-13 * np.abs(b).max())


def _integrate_both(name, pp_kw, sw, sg=False, dt=0.02, steps=1,
                    n_bodies=2):
    jgeo, geo = _geometries()
    jg = j_prepare_geom(jgeo, jnp.float64)
    gas = _gas(8)
    jb, tb = _bodies()
    js, ts = _states(sw)
    grid = dust.DustGrid(geo, torch.float64)
    rng = np.random.default_rng(9)
    sg_np = ((rng.random((NR, NAZ)) - 0.5) * 0.1,
             (rng.random((NR, NAZ)) - 0.5) * 0.1) if sg else None
    jpp = jdust.ParticleParams(**pp_kw)
    tpp = dust.ParticleParams(**pp_kw)
    jgas = [jnp.asarray(gas[k]) for k in ("rho", "temperature", "vrad",
                                          "vaz")]
    tgas = [T(gas[k]) for k in ("rho", "temperature", "vrad", "vaz")]
    for _ in range(steps):
        js = getattr(jdust, name)(
            JPhysics(), jpp, JConstants(), JUnits(), jgeo, jg, js, *jgas, jb,
            n_bodies, jnp.float64(0.1), jnp.float64(dt),
            sg_accel=tuple(jnp.asarray(a) for a in sg_np) if sg else None)
        ts = getattr(dust, name)(
            Physics(), tpp, Constants.from_units(Units()), Units(), grid, ts,
            *tgas, tb, n_bodies, T(0.1), T(dt),
            sg_accel=tuple(T(a) for a in sg_np) if sg else None)
    return js, ts


@pytest.mark.parametrize("disk_gravity", [False, True])
@pytest.mark.parametrize("gas_drag", [True, False])
def test_integrate_expmid_matches_jax(gas_drag, disk_gravity):
    """Two steps of the exponential midpoint; a tenth of the swarm starts
    dead and must stay as it was, and the particles that leave
    [0.5, 2.3] die in both packages."""
    alive = np.arange(N) % 10 != 0
    sw = _swarm(11, alive=alive)
    js, ts = _integrate_both(
        "integrate_expmid",
        dict(density=2.65, gas_drag=gas_drag, disk_gravity=disk_gravity,
             min_escape_radius=0.5, max_escape_radius=2.3),
        sw, sg=disk_gravity, steps=2)
    _assert_state(ts, js)
    died = alive & ~ts.alive.numpy()
    assert 5 < died.sum() < N // 4 and ts.alive.numpy().sum() > N // 2
    # the dead keep every value they had
    for name in ("r", "phi", "r_dot", "phi_dot", "stokes"):
        np.testing.assert_array_equal(getattr(ts, name).numpy()[~alive],
                                      sw[name][~alive])
    assert np.all(ts.stokes.numpy()[ts.alive.numpy()] > 0)


@pytest.mark.parametrize("cartesian", [False, True])
@pytest.mark.parametrize("gas_drag", [True, False])
def test_integrate_rk45_matches_jax(gas_drag, cartesian):
    """Two steps of the explicit kick + adaptive RK45, the second resuming
    from the first's per-particle step size and error history. The
    controller's accept/reject decisions are discrete, so one flipped
    decision would show as a difference of the order of the controller's
    tolerance (1e-12), not of rounding: the orbit is held at rtol 1e-9.
    The persisted step size and error history come from the error
    estimate, a sum that cancels to ~1e-12 of its terms, so rounding
    (torch.cos against the half-angle cosine, pow) shows at up to ~1e-3
    on the step size (observed; held at rtol 1e-2) and up to 4e-2 on the
    error history, max(err, 1e-4) with err ~1e-3 an estimate of ~1e-15
    beside values of order one (held at rtol 0.2; it enters the next step
    size to the power 0.04)."""
    alive = np.arange(N) % 10 != 0
    sw = _swarm(12, alive=alive)
    # stiff drag on the smallest grains would blow up the explicit kick
    sw["size"] = np.maximum(sw["size"], 1.0)
    # no close encounter with the unsmoothed planet at (1.1, 0.4): it
    # would take thousands of sub-steps
    near = np.hypot(sw["r"] * np.cos(sw["phi"]) - 1.1,
                    sw["r"] * np.sin(sw["phi"]) - 0.4) < 0.25
    sw["phi"] = np.where(near, sw["phi"] + np.pi, sw["phi"])
    js, ts = _integrate_both(
        "integrate_rk45",
        dict(density=2.65, gas_drag=gas_drag, integrator="explicit",
             cartesian=cartesian, min_escape_radius=0.5,
             max_escape_radius=2.3), sw, steps=2, dt=0.05)
    _assert_state(ts, js, rtol=1e-9,
                  fields=("r", "phi", "r_dot", "phi_dot", "stokes"))
    _assert_state(ts, js, rtol=1e-2, fields=("timestep",))
    _assert_state(ts, js, rtol=0.2, fields=("facold",))
    assert np.all(ts.timestep.numpy()[ts.alive.numpy()] > 0)
    np.testing.assert_array_equal(ts.timestep.numpy()[~alive], 0.0)


def test_rk45_kepler_orbit_conservation():
    """tests/test_dust.py's check of the JAX package, mirrored: the
    drag-free adaptive RK45 conserves the energy and angular momentum of
    two eccentric orbits over one period to 1e-9 and brings the first back
    to its apocenter."""
    phys = Physics(hydro_center_mass=1.0)
    constants = Constants.from_units(Units())
    grid = dust.DustGrid(Geometry.build(32, 16, 0.2, 5.0, "Log"),
                         torch.float64)
    bodies = BodiesOnGrid(x=T([0.0]), y=T([0.0]), mass=T([1.0]),
                          cubic_smoothing_radius=T([0.0]))
    pp = dust.ParticleParams(gas_drag=False, integrator="explicit",
                             min_escape_radius=0.01, max_escape_radius=100.0)
    a, e = np.array([1.0, 1.5]), np.array([0.5, 0.3])
    r0 = a * (1 + e)
    vphi = np.sqrt(constants.G / a) * np.sqrt((1 - e) / (1 + e))
    state = dust.ParticleState(
        r=T(r0), phi=T(np.zeros(2)), r_dot=T(np.zeros(2)),
        phi_dot=T(vphi / r0), size=T(np.full(2, 1e-5)),
        stokes=T(np.zeros(2)), alive=torch.ones(2, dtype=torch.bool),
        timestep=T(np.zeros(2)), facold=T(np.full(2, 1e-4)))

    def invariants(s):
        ang = s.r ** 2 * s.phi_dot
        en = 0.5 * (s.r_dot ** 2 + (s.r * s.phi_dot) ** 2) - constants.G / s.r
        return en.numpy(), ang.numpy()

    e0, l0 = invariants(state)
    ones, zeros_vr = T(np.ones((32, 16))), T(np.zeros((33, 16)))
    n_steps = 20
    for _ in range(n_steps):
        state = dust.integrate_rk45(
            phys, pp, constants, Units(), grid, state, ones, ones, zeros_vr,
            ones, bodies, 1, T(0.0), T(2 * np.pi / n_steps))
    e1, l1 = invariants(state)
    np.testing.assert_allclose(e1, e0, rtol=1e-9)
    np.testing.assert_allclose(l1, l0, rtol=1e-9)
    dphi = (float(state.phi[0]) + np.pi) % (2 * np.pi) - np.pi
    assert abs(dphi) < 1e-4
    assert np.isclose(float(state.r[0]), 1.5, rtol=1e-5)


def test_rk45_gives_up_on_a_particle_that_never_finishes():
    """A NaN error estimate is never accepted and makes the sub-step NaN;
    the host loop raises and does not wait for ever."""
    sw = _swarm(13, n=4)
    sw["r_dot"][1] = np.nan
    _, ts = _states(sw)
    _, geo = _geometries()
    _, tb = _bodies()
    gas = _gas(8)
    with pytest.raises(RuntimeError, match="1 particles can never finish"):
        dust.integrate_rk45(
            Physics(), dust.ParticleParams(gas_drag=False,
                                           integrator="explicit"),
            Constants.from_units(Units()), Units(),
            dust.DustGrid(geo, torch.float64), ts,
            *[T(gas[k]) for k in ("rho", "temperature", "vrad", "vaz")], tb,
            2, T(0.0), T(0.05))


def test_float32_stopping_time_underflows_as_in_jax():
    """In float32 with the PDS70 units (solar mass, au), pi m0 ~ 6e-57
    rounds to 0, the thermal speed is infinite and the stopping time NaN,
    in both packages: every particle then fails the escape test on its
    first step. The port matches this and does not repair it."""
    units, junits = Units.from_config_strings("1 au", "1 solMass"), \
        JUnits.from_config_strings("1 au", "1 solMass")
    args = dict(size=np.full(4, 1e-13), rho=np.full(4, 1e-3),
                vrel=np.full(4, 1e-3), temperature=np.full(4, 1e-4))
    assert math.pi * Physics().mu * (1.66053906660e-24 / units.mass) < 1e-45
    ref = jdust.calc_tstop(
        JPhysics(), JConstants.from_units(junits), junits,
        *[jnp.asarray(args[k], jnp.float32) for k in
          ("size", "rho", "vrel", "temperature")], 1e6)
    got = dust.calc_tstop(
        Physics(), Constants.from_units(units), units,
        *[torch.tensor(args[k], dtype=torch.float32) for k in
          ("size", "rho", "vrel", "temperature")], 1e6)
    assert np.isnan(np.asarray(ref)).all() and bool(torch.isnan(got).all())
    got64 = dust.calc_tstop(
        Physics(), Constants.from_units(units), units,
        *[T(args[k]) for k in ("size", "rho", "vrel", "temperature")], 1e6)
    assert bool(torch.isfinite(got64).all()) and bool((got64 > 0).all())
