"""The circumbinary-disk menu (ROADMAP A.9, first half) of fargocpt_torch
against the JAX package, both in float64 on the CPU:

* the disk-model profiles (``ops/diskmodel.py``), the N-body and
  centre-of-mass sound speed, scale height and ASPECTRATIO grids (2 and 3
  bodies), the per-cell alpha of AlphaMode 1 / 2 / 3, the
  StabilizeViscosity correction factors and the stabilised velocity
  update, the CFL under StabilizeViscosity 2, the ``centerofmass``
  boundary on both sides with a non-zero quadrupole moment, and the
  N-body-centred initial conditions with the circumbinary ring and both
  profile cutoffs, on seeded inputs. The tolerance is rtol 1e-12 where
  both sides run the same formulas (the residue is libm rounding), 1e-10
  where the nested five-point differences of the drift model (h = 8e-4 r)
  amplify it;
* ``setups/gamma_cephei_full.yml`` at 32x64 on the golden's radii (the e = 0.4
  secondary inside the grid, its viscous accretion, the kick-scoped
  staleness of H and nu), ten steps, rtol 1e-10 on the fields, Q+/Q- and
  the bodies, under StabilizeViscosity 1 and 2, AspectRatioMode 1 and 2,
  with the hydro frame on the binary (a non-zero quadrupole moment), and
  locally isothermal (the N-body sound speed; the JAX package's AlphaMode
  reads a temperature, which a locally isothermal disk does not have).
  Each step's dt is held to 1e-10: its heating/cooling term takes the
  difference Q+ - Q-, which leaves a few 1e-13 of the fields' 1e-15;
* ``setups/gamma_cephei_full.yml`` as it stands, at 24x48, for a few
  steps.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fargocpt_tpu import initial as j_initial
from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import boundary as j_boundary, cfl as j_cfl, \
    diskmodel as j_dm, eos as j_eos, viscosity as j_visc
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.params import Physics as JPhysics
from fargocpt_tpu.sim import Simulation as JSimulation
from fargocpt_tpu.units import Units as JUnits

from fargocpt_torch import initial
from fargocpt_torch.config import Config
from fargocpt_torch.constants import Constants
from fargocpt_torch.flagship import binary_gcfull, binary_gcfull_setup
from fargocpt_torch.grid import Geometry
from fargocpt_torch.nbody.system import BodyConfig
from fargocpt_torch.ops import boundary, cfl, diskmodel as dm, eos, \
    viscosity as visc
from fargocpt_torch.ops.common import Geom
from fargocpt_torch.params import Physics
from fargocpt_torch.sim import Simulation
from fargocpt_torch.units import Units

from test_torch_planet import assert_states

torch.set_num_threads(2)

NR, NAZ = 32, 64
RMIN, RMAX = 0.3, 6.0
RTOL = 1e-12
RTOL_FD = 1e-10


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, ref, rtol=RTOL, label=""):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max(), err_msg=label)


def _phys(**kw):
    base = dict(eos="adiabatic", adiabatic_index=1.4, viscous_alpha=1e-2,
                aspectratio_ref=0.04, flaring_index=0.29, sigma0=1e-3,
                sigma_slope=1.1, sigma_floor=1e-9, thickness_smoothing=0.6,
                minimum_temperature=1e-4, mu=2.35, alpha_cold=1e-3,
                alpha_hot=1e-2, density_factor=2.5066,
                profile_cutoff_inner=True, profile_cutoff_point_inner=1.2,
                profile_cutoff_width_inner=0.12,
                profile_cutoff_outer=True, profile_cutoff_point_outer=4.5,
                profile_cutoff_width_outer=0.4)
    base.update(kw)
    return JPhysics(**base), Physics(**base)


def _bodies(n: int, seed: int = 5):
    """``n`` bodies near the grid's centre, a float64 dict of x, y, vx, vy
    and mass."""
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(-0.6, 0.6, n), "y": rng.uniform(-0.6, 0.6, n),
            "vx": rng.uniform(-0.3, 0.3, n), "vy": rng.uniform(-0.3, 0.3, n),
            "mass": np.concatenate([[0.8], rng.uniform(0.05, 0.3, n - 1)])}


def _ns(b, conv):
    return SimpleNamespace(**{k: conv(v) for k, v in b.items()})


@pytest.fixture(scope="module")
def geo():
    jgeo = JGeometry.build(NR, NAZ, RMIN, RMAX, "Log")
    tgeo = Geometry.build(NR, NAZ, RMIN, RMAX, "Log")
    return (jgeo, j_prepare_geom(jgeo, jnp.float64), tgeo,
            Geom(tgeo, torch.float64))


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(13)
    return dict(
        sigma=rng.random((NR, NAZ)) * 1e-3 + 5e-4,
        energy=rng.random((NR, NAZ)) * 1e-5 + 1e-5,
        vaz=(rng.random((NR, NAZ)) - 0.5) * 0.1 + 1.0,
        vrad=(rng.random((NR + 1, NAZ)) - 0.5) * 0.05,
        cs=rng.random((NR, NAZ)) * 0.03 + 0.02,
        h=rng.random((NR, NAZ)) * 0.05 + 0.05,
        nu=rng.random((NR, NAZ)) * 1e-5 + 1e-6,
        temp=10.0 ** rng.uniform(-1.7, -0.5, (NR, NAZ)),
        qplus=rng.random((NR, NAZ)) * 1e-9,
        qminus=rng.random((NR, NAZ)) * 1e-9)


# --- ops/diskmodel.py --------------------------------------------------------

def test_binary_quadrupole_moment():
    bodies = [BodyConfig(name="a", mass=0.78),
              BodyConfig(name="b", mass=0.22, semi_major_axis=1.0,
                         eccentricity=0.4)]
    q = dm.binary_quadrupole_moment(bodies, 2)
    assert q == j_dm.binary_quadrupole_moment(bodies, 2) > 0.0
    assert dm.binary_quadrupole_moment(bodies, 1) == 0.0


@pytest.mark.parametrize("name", ["sigma_profile", "support_azi_pressure",
                                  "support_azi_smoothing_derivative",
                                  "cutoffs", "initial_energy", "v_kepler",
                                  "v_az_smoothed", "v_az_quadrupole",
                                  "viscous_radial_speed_analytic",
                                  "nu_of"])
@pytest.mark.parametrize("eos_name", ["adiabatic", "isothermal"])
def test_diskmodel_profiles_match_jax(name, eos_name):
    jp, tp = _phys(eos=eos_name)
    r = np.geomspace(0.2, 8.0, 257)
    jc, tc = JConstants(), Constants()
    mass, quad = 0.93, 0.031
    calls = {
        "sigma_profile": lambda m, p, c, x: m.sigma_profile(p, x),
        "support_azi_pressure":
            lambda m, p, c, x: m.support_azi_pressure(p, x),
        "support_azi_smoothing_derivative":
            lambda m, p, c, x: m.support_azi_smoothing_derivative(p, x),
        "cutoffs": lambda m, p, c, x: m.cutoff_outer(2.0, 0.3, x)
        * m.cutoff_inner(0.7, 0.1, x),
        "initial_energy": lambda m, p, c, x: m.initial_energy(p, c, x, mass),
        "v_kepler": lambda m, p, c, x: m.v_kepler(c, x, mass),
        "v_az_smoothed": lambda m, p, c, x: m.v_az_smoothed(p, c, x, mass),
        "v_az_quadrupole":
            lambda m, p, c, x: m.v_az_smoothed(p, c, x, mass, quad),
        "viscous_radial_speed_analytic":
            lambda m, p, c, x: m.viscous_radial_speed_analytic(p, c, x,
                                                               mass),
        "nu_of": lambda m, p, c, x: m._nu_of(p, c, x, mass,
                                             m.sigma_profile(p, x)),
    }
    ref = calls[name](j_dm, jp, jc, J(r))
    _close(calls[name](dm, tp, tc, T(r)), ref, label=name)
    # the host path (numpy, the initial conditions) gives the same numbers
    _close(calls[name](dm, tp, tc, r), ref, label=f"{name} numpy")


@pytest.mark.parametrize("name", ["cutoff_outer", "cutoff_inner",
                                  "initial_energy", "support_azi_pressure",
                                  "support_azi_smoothing_derivative",
                                  "v_az_smoothed",
                                  "viscous_radial_speed_analytic",
                                  "constant_viscosity_radial_speed"])
@pytest.mark.parametrize("eos_name", ["adiabatic", "isothermal"])
def test_diskmodel_gives_the_numbers_of_jax_theo(name, eos_name):
    """The port's one disk model serves the host-side ICs and the
    self-gravity's v_az too: on numpy radii it gives the JAX package's
    ``theo.py`` profiles (its ICs' copy) bit for bit."""
    from fargocpt_tpu import theo as j_theo
    kw = {"viscous_alpha": 0.0, "constant_viscosity": 1e-5} \
        if name == "constant_viscosity_radial_speed" else {}
    jp, tp = _phys(eos=eos_name, **kw)
    r = np.geomspace(0.2, 8.0, 257)
    c, G, mass = Constants(), JConstants().G, 0.93
    pairs = {
        "cutoff_outer": (dm.cutoff_outer(2.0, 0.3, r),
                         j_theo.cutoff_outer(2.0, 0.3, r)),
        "cutoff_inner": (dm.cutoff_inner(0.7, 0.1, r),
                         j_theo.cutoff_inner(0.7, 0.1, r)),
        "initial_energy": (dm.initial_energy(tp, c, r, mass),
                           j_theo.initial_energy(jp, G, r, mass)),
        "support_azi_pressure": (dm.support_azi_pressure(tp, r),
                                 j_theo.support_azi_pressure(jp, r)),
        "support_azi_smoothing_derivative": (
            dm.support_azi_smoothing_derivative(tp, r),
            j_theo.support_azi_smoothing_derivative(jp, r)),
        "v_az_smoothed": (
            dm.v_az_smoothed(tp, c, r, mass),
            j_theo.initial_locally_isothermal_smoothed_v_az(jp, G, r,
                                                            mass)),
    }
    for key in ("viscous_radial_speed_analytic",
                "constant_viscosity_radial_speed"):
        pairs[key] = (dm.viscous_radial_speed_analytic(tp, c, r, mass),
                      j_theo.initial_viscous_radial_speed(jp, G, r, mass))
    got, ref = pairs[name]
    assert isinstance(got, np.ndarray) and got.shape == r.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("quad", [0.0, 0.031])
@pytest.mark.parametrize("eos_name", ["adiabatic", "isothermal"])
def test_vr_numerical_viscous_matches_jax(quad, eos_name):
    jp, tp = _phys(eos=eos_name)
    r = np.geomspace(0.2, 8.0, 257)
    ref = j_dm.vr_numerical_viscous(jp, JConstants(), J(r), 0.93, quad)
    _close(dm.vr_numerical_viscous(tp, Constants(), T(r), 0.93, quad), ref,
           RTOL_FD)
    _close(dm.vr_numerical_viscous(tp, Constants(), r, 0.93, quad), ref,
           RTOL_FD)


@pytest.mark.parametrize("quad", [0.0, 0.031])
def test_vr_outer_grid_correction_matches_jax(geo, quad):
    _, jg, _, tg = geo
    jp, tp = _phys()
    # radii across the grid, its edges and beyond them (the ring index
    # clamps)
    r = np.concatenate([np.geomspace(0.25, 7.0, 97), [RMIN, RMAX]])
    ref = j_dm.vr_outer_grid_correction(jp, JConstants(), jg, J(r), 0.93,
                                        quad)
    got = dm.vr_outer_grid_correction(tp, Constants(), tg, T(r), 0.93, quad)
    # a ratio of two drift models, each differenced twice: the libm
    # residue (PyTorch's pow and sqrt against XLA's, ~1 ulp) reaches
    # 6.0e-10 of the factor on these radii, where the drift itself agrees
    # to 1e-10 of its largest value
    _close(got, ref, 10 * RTOL_FD)


# --- ops/eos.py: AspectRatioMode 1 / 2 ---------------------------------------

@pytest.mark.parametrize("n_bodies", [2, 3])
@pytest.mark.parametrize("eos_name", ["adiabatic", "isothermal"])
def test_nbody_and_com_grids_match_jax(geo, fields, n_bodies, eos_name):
    jgeo, jg, tgeo, tg = geo
    jp, tp = _phys(eos=eos_name)
    jc, tc = JConstants(), Constants()
    b = _bodies(n_bodies)
    jb, tb = _ns(b, J), _ns(b, T)
    radius = np.linspace(0.01, 0.03, n_bodies)
    cx, cy = jgeo.cell_centers_xy()
    jcx, jcy, tcx, tcy = J(cx), J(cy), T(cx), T(cy)
    cs = fields["cs"]
    _close(eos.sound_speed_iso_nbody(tp, tc, tg, tb, n_bodies, T(radius),
                                     tcx, tcy),
           j_eos.sound_speed_iso_nbody(jp, jc, jg, jb, n_bodies, J(radius),
                                       jcx, jcy), label="cs nbody")
    for name in ("scale_height_nbody", "aspect_ratio_nbody"):
        _close(getattr(eos, name)(tp, tc, tg, T(cs), tb, n_bodies,
                                  T(radius), tcx, tcy),
               getattr(j_eos, name)(jp, jc, jg, J(cs), jb, n_bodies,
                                    J(radius), jcx, jcy), label=name)
    com_x, com_y, com_m = eos.center_of_mass(tb)
    m = b["mass"].sum()
    jcom = ((b["mass"] * b["x"]).sum() / m, (b["mass"] * b["y"]).sum() / m,
            m)
    _close(torch.stack([com_x, com_y, com_m]), np.asarray(jcom),
           label="com")
    _close(eos.sound_speed_iso_com(tp, tc, tg, com_x, com_y, com_m, tcx,
                                   tcy),
           j_eos.sound_speed_iso_com(jp, jc, jg, *map(J, jcom), jcx, jcy),
           label="cs com")
    for name in ("scale_height_com", "aspect_ratio_com"):
        _close(getattr(eos, name)(tp, tc, tg, T(cs), com_x, com_y, com_m,
                                  tcx, tcy),
               getattr(j_eos, name)(jp, jc, jg, J(cs), *map(J, jcom), jcx,
                                    jcy), label=name)


# --- ops/viscosity.py --------------------------------------------------------

@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_alpha_grid_and_viscosity_match_jax(geo, fields, mode):
    jgeo, jg, tgeo, tg = geo
    jp, tp = _phys(alpha_mode=mode)
    b = _bodies(3)
    cx, cy = jgeo.cell_centers_xy()
    f = fields
    kw_j = dict(temperature=J(f["temp"]), units=JUnits(), sigma=J(f["sigma"]),
                bodies=_ns(b, J), n_bodies=3, cell_x=J(cx), cell_y=J(cy))
    kw_t = dict(temperature=T(f["temp"]), units=Units(), sigma=T(f["sigma"]),
                bodies=_ns(b, T), n_bodies=3, cell_x=T(cx), cell_y=T(cy))
    ref = j_visc.kinematic_viscosity(jp, jg, J(f["cs"]), J(f["h"]), **kw_j)
    got = visc.kinematic_viscosity(tp, tg, T(f["cs"]), T(f["h"]), **kw_t)
    _close(got, ref, label=f"nu, AlphaMode {mode}")
    if mode != 0:
        alpha = visc.alpha_grid(tp, tg, kw_t["units"], kw_t["temperature"],
                                kw_t["sigma"], T(f["h"]), kw_t["bodies"], 3,
                                kw_t["cell_x"], kw_t["cell_y"])
        # each mode spans its range on these inputs
        assert float(alpha.max() - alpha.min()) > 1e-4
    # without what the mode reads, the constant alpha, as in JAX
    _close(visc.kinematic_viscosity(tp, tg, T(f["cs"]), T(f["h"])),
           j_visc.kinematic_viscosity(jp, jg, J(f["cs"]), J(f["h"])))


def test_viscosity_correction_factors_match_jax(geo, fields):
    _, jg, _, tg = geo
    jp, tp = _phys(radial_viscosity_factor=0.8)
    f = fields
    ref = j_visc.viscosity_correction_factors(jp, jg, J(f["sigma"]),
                                              J(f["nu"]))
    got = visc.viscosity_correction_factors(tp, tg, T(f["sigma"]),
                                            T(f["nu"]))
    for g_, r_, name in zip(got, ref, ("c_phi", "c_r")):
        _close(g_, r_, label=name)
        assert float(g_[1:].max()) < 0.0 and not g_[0].any()


@pytest.mark.parametrize("stabilize", [0, 1])
def test_viscous_update_matches_jax(geo, fields, stabilize):
    _, jg, _, tg = geo
    jp, tp = _phys(stabilize_viscosity=stabilize)
    f = fields
    j_tau = j_visc.viscous_stress_tensor(jp, jg, J(f["sigma"]), J(f["vrad"]),
                                         J(f["vaz"]), J(f["nu"]))
    t_tau = visc.viscous_stress_tensor(tp, tg, T(f["sigma"]), T(f["vrad"]),
                                       T(f["vaz"]), T(f["nu"]))
    # a step long enough that the correction factors matter
    dt = 40.0
    ref = j_visc.update_velocities_with_viscosity(
        jp, jg, J(f["sigma"]), J(f["vrad"]), J(f["vaz"]), *j_tau[:3],
        jnp.float64(dt), nu=J(f["nu"]))
    got = visc.update_velocities_with_viscosity(
        tp, tg, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]), *t_tau[:3],
        torch.tensor(dt, dtype=torch.float64), nu=T(f["nu"]))
    _close(got[0], ref[0], label="vrad")
    _close(got[1], ref[1], label="vaz")
    if stabilize:
        plain = visc.update_velocities_with_viscosity(
            tp, tg, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]), *t_tau[:3],
            torch.tensor(dt, dtype=torch.float64))
        assert not torch.equal(plain[1], got[1])


@pytest.mark.parametrize("stabilize", [0, 2])
def test_cfl_matches_jax(geo, fields, stabilize):
    _, jg, _, tg = geo
    jp, tp = _phys(stabilize_viscosity=stabilize)
    f = fields
    nu = f["nu"] * 1e3            # the viscous limit binds
    args = [f[k] for k in ("sigma", "vrad", "vaz", "energy", "cs")] \
        + [nu, f["qplus"], f["qminus"]]
    ref = float(j_cfl.condition_cfl(jp, jg, *map(J, args)))
    got = float(cfl.condition_cfl(tp, tg, *map(T, args)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    if stabilize:
        jp0, _ = _phys()
        assert ref < float(j_cfl.condition_cfl(jp0, jg, *map(J, args)))


# --- the centerofmass boundary -----------------------------------------------

@pytest.mark.parametrize("eos_name", ["adiabatic", "isothermal"])
@pytest.mark.parametrize("sides", ["outer", "inner", "both"])
def test_center_of_mass_boundary_matches_jax(geo, fields, sides, eos_name):
    _, jg, _, tg = geo
    comp = {"outer": ("zerogradient", "centerofmass"),
            "inner": ("centerofmass", "zerogradient"),
            "both": ("centerofmass", "centerofmass")}[sides]
    names = dict(composite_inner=comp[0], composite_outer=comp[1],
                 **{f"bc_{v}_{s}": "none"
                    for v in ("sigma", "energy", "vrad", "vaz")
                    for s in ("inner", "outer")})
    jp, tp = _phys(eos=eos_name, vaz_quadrupole_support=True,
                   profile_cutoff_outer=False, **names)
    jc, tc = JConstants(), Constants()
    b = _bodies(3, seed=9)
    n_hydroframe = 2
    bodies = [BodyConfig(name="a", mass=0.8),
              BodyConfig(name="b", mass=0.2, semi_major_axis=0.5,
                         eccentricity=0.3)]
    quad = dm.binary_quadrupole_moment(bodies, n_hydroframe)
    assert quad > 0.0
    f = fields
    omega = 0.05
    ref_j = j_boundary.RefValues(*(J(f[k]) for k in ("sigma", "energy",
                                                      "vrad", "vaz")))
    ref_t = boundary.RefValues(*(T(f[k]) for k in ("sigma", "energy",
                                                    "vrad", "vaz")))
    ref = j_boundary.apply_boundary_conditions(
        jp, jc, jg, J(f["sigma"]), J(f["vrad"]), J(f["vaz"]), J(f["energy"]),
        ref_j, jnp.float64(omega), com_ctx=(_ns(b, J), n_hydroframe, quad))
    got = boundary.apply_boundary_conditions(
        tp, tc, tg, T(f["sigma"]), T(f["vrad"]), T(f["vaz"]),
        T(f["energy"]), ref_t, torch.tensor(omega, dtype=torch.float64),
        com_ctx=(_ns(b, T), n_hydroframe, quad))
    for k, name in enumerate(("sigma", "vrad", "vaz", "energy")):
        # v_rad takes the drift model's nested differences
        _close(got[k], ref[k], RTOL_FD if name == "vrad" else RTOL,
               label=name)
    # the ghost rows of the side(s) changed, and nothing else
    rows = {"outer": [NR - 1], "inner": [0], "both": [0, NR - 1]}[sides]
    changed = np.nonzero((got[2].numpy() != f["vaz"]).any(axis=1))[0]
    assert list(changed) == rows


# --- the N-body-centred initial conditions -----------------------------------

@pytest.mark.parametrize("over", [
    {}, {"eos": "isothermal"}, {"initialize_vradial_zero": True},
    {"initialize_pure_keplerian": True}, {"cbd_ring": False}],
    ids=["adiabatic", "isothermal", "vradial-zero", "pure-keplerian",
         "no-ring"])
def test_nbody_centred_initial_conditions_match_jax(geo, over):
    jgeo, _, tgeo, _ = geo
    kw = dict(sigma_condition="nbody", energy_condition="nbody",
              cbd_ring=True, cbd_ring_position=3.0, cbd_ring_width=0.4,
              cbd_ring_enhancement_factor=1.4, vaz_quadrupole_support=True,
              center_mass_density_correction_factor=0.99,
              hydro_center_mass=1.0, minimum_temperature=1e-7)
    kw.update(over)
    jp, tp = _phys(**kw)
    b = _bodies(2, seed=3)
    b["mass"] = np.array([0.78, 0.22])
    quad = 0.04
    js, _ = j_initial.build_initial_state(jp, JConstants(), jgeo, quad,
                                          nbody=b)
    ts, _ = initial.build_initial_state(tp, Constants(), tgeo, quad,
                                        nbody=b, dtype=torch.float64,
                                        device="cpu")
    for name in ("sigma", "energy", "vaz", "vrad"):
        _close(getattr(ts, name), getattr(js, name),
               RTOL_FD if name == "vrad" else RTOL, label=name)
    # the ring and the centre of mass make the fields non-axisymmetric
    assert float(ts.sigma.std(dim=1).max()) > 0.0


# --- the step ----------------------------------------------------------------

def _gcfull(**over) -> dict:
    """``setups/gamma_cephei_full.yml`` at 32x64 on the golden's radii."""
    return binary_gcfull_setup(32, 64, Rmin="0.05", Rmax="12", **over)


@pytest.mark.parametrize("over", [
    {}, {"StabilizeViscosity": "2"}, {"AspectRatioMode": "2"},
    {"HydroFrameCenter": "binary"},
    {"EquationOfState": "Isothermal", "AlphaMode": "0"}],
    ids=["stabilize-1-aspect-1", "stabilize-2", "aspect-2",
         "binary-frame-quadrupole", "isothermal-nbody-sound-speed"])
def test_binary_gcfull_steps_match_jax(over):
    cfg = _gcfull(**over)
    js = JSimulation(JConfig.from_dict(dict(cfg)))
    ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    st = ts.stepper
    assert not any(st.gates[k] for k in ("sources", "viscous_kick", "cfl"))
    assert (st.quad_moment > 0.0) == ("HydroFrameCenter" in over)
    assert_states(ts, js, "initial")
    for _ in range(10):
        dj = js.calculate_time_step()
        dt = ts.calculate_time_step()
        np.testing.assert_allclose(float(dt), dj, rtol=RTOL_FD)
        js.step_once(dj)
        ts.step_once(dt)
    assert_states(ts, js, "after 10 steps")
    # the secondary has moved on its orbit, inside the grid
    r2 = float(torch.hypot(ts.state.nbody.x[1], ts.state.nbody.y[1]))
    assert ts.geometry.rmin < r2 < ts.geometry.rmax


def test_gamma_cephei_full_setup_runs_on_the_cpu():
    sim = Simulation(binary_gcfull(24, 48), device="cpu")
    p = sim.phys
    # the setup's writers: its MassFlow monitor grid runs in every step
    assert p.write_massflow and sim.state.monitor_acc is not None
    assert (p.aspectratio_mode, p.alpha_mode, p.stabilize_viscosity) \
        == (1, 2, 1)
    assert p.composite_outer == "centerofmass" and p.cbd_ring
    # the reference's quirk: the inner energy BC falls back to the outer
    # side's name (none, under centerofmass), not the viscous side's
    # zerogradient (params.py, reference config.cpp:147)
    assert (p.bc_sigma_inner, p.bc_energy_inner) == ("zerogradient", "none")
    assert sim.stepper.n_bodies == 2 and p.heating_star
    for _ in range(3):
        sim.step_once(sim.calculate_time_step())
    for name in ("sigma", "vrad", "vaz", "energy"):
        assert torch.isfinite(getattr(sim.fields, name)).all(), name
    assert float(sim.fields.sigma.min()) > 0.0
