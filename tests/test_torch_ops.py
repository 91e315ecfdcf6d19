"""The ported plain ops of fargocpt_torch against their fargocpt_tpu jnp
counterparts on the same seeded inputs, in float64 on the CPU. Unless a
test says otherwise the tolerance is rtol 1e-12: both sides run the same
formulas in the same order; the residue is libm rounding."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import artvisc as j_artvisc, boundary as j_boundary, \
    cfl as j_cfl, eos as j_eos, gravity as j_gravity, sources as j_sources, \
    transport as j_transport, viscosity as j_visc
from fargocpt_tpu.ops import energy as j_energy
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.params import Physics as JPhysics
from fargocpt_tpu.units import Units as JUnits

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import artvisc, boundary, cfl, eos, gravity, \
    sources, transport, viscosity as visc
from fargocpt_torch.ops import energy as energy_ops
from fargocpt_torch.ops.common import Geom
from fargocpt_torch.params import Physics
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR, NAZ = 32, 64
RTOL = 1e-12


def _phys(**kw):
    base = dict(eos="adiabatic", adiabatic_index=1.4, viscous_alpha=1e-3,
                aspectratio_ref=0.05, flaring_index=0.25,
                artificial_viscosity="sn", heating_viscous=True,
                cooling_beta_enabled=True, cooling_beta=10.0,
                minimum_temperature=1e-6, sigma0=1.0, sigma_floor=1e-6,
                bc_sigma_inner="zerogradient", bc_sigma_outer="zerogradient",
                bc_energy_inner="zerogradient",
                bc_energy_outer="zerogradient", bc_vrad_inner="outflow",
                bc_vrad_outer="outflow", composite_inner="outflow",
                composite_outer="outflow")
    base.update(kw)
    return JPhysics(**base), Physics(**base)


@pytest.fixture(scope="module")
def grids():
    jg = j_prepare_geom(JGeometry.build(NR, NAZ, 0.4, 2.5, "Log"),
                        jnp.float64)
    tg = Geom(Geometry.build(NR, NAZ, 0.4, 2.5, "Log"), torch.float64)
    return jg, tg


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(21)
    sigma = rng.random((NR, NAZ)) + 0.5
    sigma[NR // 2, 3:7] = 5e-6                 # near-floor cells
    return dict(
        sigma=sigma,
        energy=rng.random((NR, NAZ)) * 1e-3 + 1e-3,
        vaz=(rng.random((NR, NAZ)) - 0.5) * 0.1 + 1.0,
        vrad=(rng.random((NR + 1, NAZ)) - 0.5) * 0.05,
        qplus=rng.random((NR, NAZ)) * 1e-6,
        qminus=rng.random((NR, NAZ)) * 1e-6,
    )


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, ref, rtol=RTOL, atol=0.0):
    got = [got] if torch.is_tensor(got) else list(got)
    ref = [ref] if not isinstance(ref, (tuple, list)) else list(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol)


def _constants():
    return JConstants.from_units(JUnits()), Constants.from_units(Units())


def test_eos_ops(grids, fields):
    jg, tg = grids
    jp, tp = _phys()
    jc, tc = _constants()
    s, e = fields["sigma"], fields["energy"]
    _close(eos.sound_speed_iso_profile(tp, tc, tg.rb),
           j_eos.sound_speed_iso_profile(jp, jc, jg.rb))
    cs_iso = eos.sound_speed_iso_profile(tp, tc, tg.rb)
    cs = eos.sound_speed(tp, tc, tg, T(s), T(e), cs_iso)
    _close(cs, j_eos.sound_speed(jp, jc, jg, J(s), J(e), None))
    _close(eos.pressure(tp, tc, T(s), T(e), cs),
           j_eos.pressure(jp, jc, J(s), J(e), None))
    _close(eos.scale_height(tp, tc, tg, cs),
           j_eos.scale_height(jp, jc, jg, J(cs.numpy())))
    _close(eos.energy_floor_ceiling(tp, tc, T(s), T(e * 1e-6)),
           j_eos.energy_floor_ceiling(jp, jc, J(s), J(e * 1e-6)))
    _close(eos.apply_sigma_floor(tp, T(s)), j_eos.apply_sigma_floor(jp, J(s)))
    assert eos.finite_in(1e300, torch.float32) == \
        j_eos.finite_in(1e300, np.float32)


def test_isothermal_eos(grids, fields):
    jg, tg = grids
    jp, tp = _phys(eos="isothermal")
    jc, tc = _constants()
    s = fields["sigma"]
    cs_iso_t = eos.sound_speed_iso_profile(tp, tc, tg.rb)
    cs_iso_j = j_eos.sound_speed_iso_profile(jp, jc, jg.rb)
    cs = eos.sound_speed(tp, tc, tg, T(s), None, cs_iso_t)
    _close(cs, j_eos.sound_speed(jp, jc, jg, J(s), None, cs_iso_j))
    _close(eos.pressure(tp, tc, T(s), None, cs),
           j_eos.pressure(jp, jc, J(s), None, J(cs.numpy())))


def _bodies(rsm_planet):
    x, y = [0.0, 1.0], [0.0, 0.3]
    m, r = [1.0, 1e-3], [0.0, rsm_planet]
    jb = j_gravity.BodiesOnGrid(x=J(x), y=J(y), mass=J(m),
                                cubic_smoothing_radius=J(r))
    tb = gravity.BodiesOnGrid(x=T(x), y=T(y), mass=T(m),
                              cubic_smoothing_radius=T(r))
    return jb, tb


@pytest.mark.parametrize("rsm", [0.0, 0.05])
def test_nbody_potential(grids, fields, rsm):
    jg, tg = grids
    jp, tp = _phys(thickness_smoothing=0.6)
    jc, tc = _constants()
    geom = Geometry.build(NR, NAZ, 0.4, 2.5, "Log")
    cx, cy = geom.cell_centers_xy()
    h = fields["energy"] * 0.05
    jb, tb = _bodies(rsm)
    got = gravity.nbody_potential(tp, tc, tg, tb, 2, T(cx), T(cy), T(h),
                                  T(1e-5), T(-2e-5))
    ref = j_gravity.nbody_potential(jp, jc, jg, jb, 2, J(cx), J(cy), J(h),
                                    1e-5, -2e-5)
    _close(got, ref)


def test_indirect_terms_of_a_lone_star():
    jc, tc = _constants()
    from fargocpt_tpu.nbody.system import NBodyState as JNB
    from fargocpt_torch.nbody.system import NBodyState as TNB
    z = [0.0]
    jnb = JNB(x=J(z), y=J(z), vx=J(z), vy=J(z), mass=J([1.0]))
    tnb = TNB(x=T(z), y=T(z), vx=T(z), vy=T(z), mass=T([1.0]))
    got = gravity.indirect_term_nbody_predictor(tc, tnb, 1, 1, T(1e-3))
    ref = j_gravity.indirect_term_nbody_predictor(jc, jnb, 1, 1, 1e-3)
    _close(got, ref)


def test_sources(grids, fields):
    jg, tg = grids
    jp, tp = _phys(imposed_disk_drift=1e-4)
    f = fields
    pot = f["energy"] * 3.0 - 1.0
    press = f["energy"] * 0.4
    args_t = (T(f["sigma"]), T(press), T(pot), T(f["vrad"]), T(f["vaz"]),
              T(f["energy"]), T(0.4), T(0.003))
    args_j = (J(f["sigma"]), J(press), J(pot), J(f["vrad"]), J(f["vaz"]),
              J(f["energy"]), 0.4, jnp.float64(0.003))
    _close(sources.update_with_sourceterms(tp, tg, *args_t),
           j_sources.update_with_sourceterms(jp, jg, *args_j))
    _close(sources.divergence_v(tg, T(f["vrad"]), T(f["vaz"])),
           j_sources.divergence_v(jg, J(f["vrad"]), J(f["vaz"])), atol=1e-15)


@pytest.mark.parametrize("kind", ["sn", "tw"])
@pytest.mark.parametrize("dissipation", [True, False])
def test_artificial_viscosity(grids, fields, kind, dissipation):
    jg, tg = grids
    jp, tp = _phys(artificial_viscosity=kind,
                   artificial_viscosity_dissipation=dissipation)
    f = fields
    vaz = (f["vaz"] - 1.0) * 3.0
    vrad = f["vrad"] * 6.0
    got = artvisc.update_with_artificial_viscosity(
        tp, tg, T(f["sigma"]), T(vrad), T(vaz), T(f["energy"]), T(0.01))
    ref = j_artvisc.update_with_artificial_viscosity(
        jp, jg, J(f["sigma"]), J(vrad), J(vaz), J(f["energy"]),
        jnp.float64(0.01))
    _close(got, ref, atol=1e-15)


def test_viscosity(grids, fields):
    jg, tg = grids
    jp, tp = _phys()
    f = fields
    nu = f["energy"] * 1e-3
    _close(visc.kinematic_viscosity(tp, tg, T(f["energy"]), T(f["sigma"])),
           j_visc.kinematic_viscosity(jp, jg, J(f["energy"]),
                                      J(f["sigma"])))
    stress_t = visc.viscous_stress_tensor(tp, tg, T(f["sigma"]),
                                          T(f["vrad"]), T(f["vaz"]), T(nu))
    stress_j = j_visc.viscous_stress_tensor(jp, jg, J(f["sigma"]),
                                            J(f["vrad"]), J(f["vaz"]), J(nu))
    _close(stress_t, stress_j, atol=1e-18)
    got = visc.update_velocities_with_viscosity(
        tp, tg, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]), *stress_t[:3],
        T(0.003))
    ref = j_visc.update_velocities_with_viscosity(
        jp, jg, J(f["sigma"]), J(f["vrad"]), J(f["vaz"]), *stress_j[:3],
        jnp.float64(0.003))
    _close(got, ref, atol=1e-15)


@pytest.mark.parametrize("ramp", [0.0, 5.0])
def test_substep3(grids, fields, ramp):
    jg, tg = grids
    jp, tp = _phys(cooling_beta_ramp_up=ramp)
    jc, tc = _constants()
    f = fields
    nu = f["energy"] * 1e-3
    h = f["energy"] * 0.05
    stress_t = visc.viscous_stress_tensor(tp, tg, T(f["sigma"]),
                                          T(f["vrad"]), T(f["vaz"]), T(nu))
    got = energy_ops.substep3(tp, tc, tg, T(f["sigma"]), T(f["energy"]),
                              T(nu), *stress_t, T(h), T(1.5), T(0.003))
    sig_j = J(f["sigma"])
    ref = j_energy.substep3(
        jp, jc, jg, sig_j, J(f["energy"]), J(f["vrad"]), J(f["vaz"]), J(nu),
        *[J(s.numpy()) for s in stress_t], J(h), sig_j, J(f["energy"]),
        jnp.zeros_like(sig_j), jnp.float64(1.5), jnp.float64(0.003))
    _close(got, ref, atol=1e-20)


@pytest.mark.parametrize("time", [0.0, 1.5])
def test_substep3_takes_the_time_as_a_float(grids, fields, time):
    """The cooling ramp at a Python-float time, as the initial Q+/Q- are
    seeded (time 0.0): the same numbers as with a tensor, and as JAX's."""
    jg, tg = grids
    jp, tp = _phys(cooling_beta_ramp_up=5.0)
    jc, tc = _constants()
    f = fields
    nu = f["energy"] * 1e-3
    h = f["energy"] * 0.05
    stress_t = visc.viscous_stress_tensor(tp, tg, T(f["sigma"]),
                                          T(f["vrad"]), T(f["vaz"]), T(nu))
    args = (tp, tc, tg, T(f["sigma"]), T(f["energy"]), T(nu), *stress_t,
            T(h))
    got = energy_ops.substep3(*args, time, T(0.003))
    for a, b in zip(got, energy_ops.substep3(*args, T(time), T(0.003))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert isinstance(energy_ops.beta_inverse(tp, time), float)
    sig_j = J(f["sigma"])
    ref = j_energy.substep3(
        jp, jc, jg, sig_j, J(f["energy"]), J(f["vrad"]), J(f["vaz"]), J(nu),
        *[J(s.numpy()) for s in stress_t], J(h), sig_j, J(f["energy"]),
        jnp.zeros_like(sig_j), jnp.float64(time), jnp.float64(0.003))
    _close(got, ref, atol=1e-20)
    if time == 0.0:         # the ramp starts from no cooling at all
        assert energy_ops.beta_inverse(tp, time) == 0.0


def test_outflow_boundaries(grids, fields):
    jg, tg = grids
    jp, tp = _phys(omega_frame=0.2)
    jc, tc = _constants()
    f = fields
    ref0 = j_boundary.RefValues(sigma0=J(f["sigma"]), energy0=J(f["energy"]),
                                vrad0=J(f["vrad"]), vaz0=J(f["vaz"]))
    vrad = f["vrad"].copy()
    vrad[2] = -np.abs(vrad[2])                  # inner: inflow kept
    vrad[NR - 2] = -np.abs(vrad[NR - 2])        # outer: inflow zeroed
    ref_t = boundary.RefValues(sigma0=T(f["sigma"]), energy0=T(f["energy"]),
                               vrad0=T(f["vrad"]), vaz0=T(f["vaz"]))
    got = boundary.apply_boundary_conditions(
        tp, tc, tg, T(f["sigma"]), T(vrad), T(f["vaz"]), T(f["energy"]),
        ref_t, T(0.2))
    ref = j_boundary.apply_boundary_conditions(
        jp, jc, jg, J(f["sigma"]), J(vrad), J(f["vaz"]), J(f["energy"]),
        ref0, jnp.float64(0.2))
    _close(got, ref)


def test_boundary_rejects_unported_names():
    _, tp = _phys(bc_vrad_outer="balanced")
    with pytest.raises(NotImplementedError, match="balanced"):
        boundary.check_supported(tp)


@pytest.mark.parametrize("limiter", [0, 1])
def test_transport_pieces(grids, fields, limiter):
    jg, tg = grids
    jp, tp = _phys(flux_limiter_type=limiter)
    f = fields
    rng = np.random.default_rng(3)
    qs = rng.random((6, NR, NAZ)) + 0.5
    v = (rng.random((NR, NAZ)) - 0.5) * 0.05
    dt_t, dt_j = T(0.01), jnp.float64(0.01)
    sig = qs[-1]
    ds_t = transport.star_radial(tp, tg, T(sig), T(f["vrad"]), dt_t)
    ds_j = j_transport.star_radial(jp, jg, J(sig), J(f["vrad"]), dt_j)
    _close(ds_t, ds_j)
    _close(transport.van_leer_radial_batch(tp, tg, T(qs), T(sig), ds_t,
                                           T(f["vrad"]), dt_t),
           j_transport.van_leer_radial_batch(jp, jg, J(qs), J(sig), ds_j,
                                             J(f["vrad"]), dt_j), atol=1e-16)
    th_t = transport.star_theta(tp, tg, T(sig), T(v), dt_t)
    th_j = j_transport.star_theta(jp, jg, J(sig), J(v), dt_j)
    _close(th_t, th_j)
    _close(transport.van_leer_theta_batch(tp, tg, T(qs), T(sig), th_t, T(v),
                                          dt_t),
           j_transport.van_leer_theta_batch(jp, jg, J(qs), J(sig), th_j,
                                            J(v), dt_j))
    nshift = rng.integers(-40, 40, NR).astype(np.int32)
    _close(transport.advect_shift(T(qs), torch.tensor(nshift)),
           j_transport.advect_shift(J(qs), jnp.asarray(nshift)), rtol=0.0)
    mom_t = transport.compute_momenta(tg, T(f["sigma"]), T(f["vrad"]),
                                      T(f["vaz"]), T(0.3))
    mom_j = j_transport.compute_momenta(jg, J(f["sigma"]), J(f["vrad"]),
                                        J(f["vaz"]), 0.3)
    _close(mom_t, mom_j)
    _close(transport.velocities_from_momenta(tg, T(f["sigma"]), *mom_t,
                                             T(f["vrad"]), T(0.3)),
           j_transport.velocities_from_momenta(jg, J(f["sigma"]), *mom_j,
                                               J(f["vrad"]), 0.3), atol=1e-16)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_transport(grids, fields, fast, adiabatic):
    """The composed FARGO transport; rtol 1e-11 as in the JAX package's
    own kernel parity test (a few more divisions than the pieces)."""
    jg, tg = grids
    jp, tp = _phys(eos="adiabatic" if adiabatic else "isothermal",
                   fast_transport=fast)
    f = fields
    got = transport.transport(tp, tg, T(f["sigma"]), T(f["vrad"]),
                              T(f["vaz"]), T(f["energy"]), T(0.3), T(0.01))
    ref = j_transport.transport(jp, jg, J(f["sigma"]), J(f["vrad"]),
                                J(f["vaz"]), J(f["energy"]), jnp.float64(0.3),
                                jnp.float64(0.01))
    _close(got, ref, rtol=1e-11, atol=1e-15)


@pytest.mark.parametrize("kind", ["sn", "tw"])
def test_condition_cfl(grids, fields, kind):
    jg, tg = grids
    jp, tp = _phys(artificial_viscosity=kind)
    f = fields
    cs = np.sqrt(0.56 * f["energy"] / f["sigma"])
    nu = cs * 1e-3
    got = cfl.condition_cfl(tp, tg, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]),
                            T(f["energy"]), T(cs), T(nu), T(f["qplus"]),
                            T(f["qminus"]))
    ref = j_cfl.condition_cfl(jp, jg, J(f["sigma"]), J(f["vrad"]),
                              J(f["vaz"]), J(f["energy"]), J(cs), J(nu),
                              J(f["qplus"]), J(f["qminus"]))
    _close(got, ref)
