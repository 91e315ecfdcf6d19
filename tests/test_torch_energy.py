"""fargocpt_torch's opacity laws, the PVTE forms of the equation of state
and SubStep3 with surface cooling and PVTE grids, against fargocpt_tpu's
on the same seeded inputs, in float64 on the CPU.

Tolerance rtol 1e-12 unless a test says otherwise: both sides run the same
formulas in the same order; the residue is libm rounding of exp, log and
pow, which the opacity fits' 8th powers scale by ~10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import energy as j_energy, eos as j_eos, \
    opacity as j_opacity, viscosity as j_visc
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.params import Physics as JPhysics
from fargocpt_tpu.units import Units as JUnits

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import energy as energy_ops, eos, opacity, \
    viscosity as visc
from fargocpt_torch.ops.common import Geom
from fargocpt_torch.params import Physics
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR, NAZ = 32, 64
RTOL = 1e-12
# a PDS70-like unit system: 1 au, 1 solar mass
UNITS = {"l0": "1 au", "m0": "1 solMass"}


def _units():
    args = (UNITS["l0"], UNITS["m0"], None, None)
    return JUnits.from_config_strings(*args), Units.from_config_strings(*args)


def _phys(**kw):
    base = dict(eos="adiabatic", variable_gamma=True, adiabatic_index=1.4,
                viscous_alpha=2e-3,
                aspectratio_ref=0.05, flaring_index=0.25,
                artificial_viscosity="sn", heating_viscous=True,
                cooling_surface_enabled=True, minimum_temperature=1e-4,
                sigma0=1e-4, sigma_floor=1e-6)
    base.update(kw)
    return JPhysics(**base), Physics(**base)


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, ref, rtol=RTOL, atol=0.0):
    got = list(got) if isinstance(got, (tuple, list)) else [got]
    ref = list(ref) if isinstance(ref, (tuple, list)) else [ref]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(torch.as_tensor(g).numpy(), np.asarray(r),
                                   rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def grids():
    return (j_prepare_geom(JGeometry.build(NR, NAZ, 0.4, 2.5, "Log"),
                           jnp.float64),
            Geom(Geometry.build(NR, NAZ, 0.4, 2.5, "Log"), torch.float64))


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(31)
    sigma = (rng.random((NR, NAZ)) + 0.5) * 1e-4
    sigma[NR // 2, 3:7] = 5e-10                 # near-floor cells
    return dict(
        sigma=sigma,
        energy=sigma * (rng.random((NR, NAZ)) * 2e-3 + 1e-4),
        vaz=(rng.random((NR, NAZ)) - 0.5) * 0.1 + 1.0,
        vrad=(rng.random((NR + 1, NAZ)) - 0.5) * 0.05,
        h=rng.random((NR, NAZ)) * 0.05 + 0.02,
        pv=(rng.random((NR, NAZ)) * 0.3 + 1.2,
            rng.random((NR, NAZ)) * 1.5 + 0.8,
            rng.random((NR, NAZ)) * 0.3 + 1.15),
    )


@pytest.mark.parametrize("mode", ["lin", "bell", "const", "simple"])
def test_opacity_laws(mode):
    """kappa over rho 1e-16..1e-2 g/cm^3 and T 5..1e6 K, every branch of
    the fits (the code-unit inputs of a 1 au / 1 Msun system)."""
    ju, tu = _units()
    jp, tp = _phys(opacity_mode=mode, kappa_const=2.0)
    rng = np.random.default_rng(7)
    rho = 10.0 ** rng.uniform(-16, -2, 4000) / tu.density
    temp = 10.0 ** rng.uniform(0.7, 6, 4000) / tu.temperature
    _close(opacity.opacity(tp, tu, T(rho), T(temp)),
           j_opacity.opacity(jp, ju, jnp.asarray(rho), jnp.asarray(temp)),
           rtol=1e-11)


def test_eos_with_pvte_grids(grids, fields):
    jg, tg = grids
    jp, tp = _phys()
    jc, tc = JConstants.from_units(JUnits()), Constants.from_units(Units())
    f = fields
    s, e = f["sigma"], f["energy"]
    pv_j = tuple(jnp.asarray(x) for x in f["pv"])
    pv_t = tuple(T(x) for x in f["pv"])
    cs = eos.sound_speed(tp, tc, tg, T(s), T(e), None, pv_t)
    _close(cs, j_eos.sound_speed(jp, jc, jg, jnp.asarray(s), jnp.asarray(e),
                                 None, pv_j))
    _close(eos.pressure(tp, tc, T(s), T(e), cs, pv_t),
           j_eos.pressure(jp, jc, jnp.asarray(s), jnp.asarray(e), None,
                          pv_j))
    _close(eos.scale_height(tp, tc, tg, cs, pv_t),
           j_eos.scale_height(jp, jc, jg, jnp.asarray(cs.numpy()), pv_j))
    for pv in (None, "pv"):
        args_t = (T(s), T(e), None, pv_t if pv else None)
        args_j = (jnp.asarray(s), jnp.asarray(e), None,
                  pv_j if pv else None)
        _close(eos.temperature(tp, tc, *args_t),
               j_eos.temperature(jp, jc, *args_j))
        _close(eos.energy_floor_ceiling(tp, tc, T(s), T(e * 1e-8),
                                        args_t[3]),
               j_eos.energy_floor_ceiling(jp, jc, jnp.asarray(s),
                                          jnp.asarray(e * 1e-8), args_j[3]))


def test_kappa_tau_eff_and_thermal_cooling(fields):
    ju, tu = _units()
    jc, tc = JConstants.from_units(ju), Constants.from_units(tu)
    for kw in ({}, {"opacity_mode": "simple"}):
        jp, tp = _phys(**kw)
        f = fields
        temp = f["energy"] / f["sigma"] * 50.0
        got = energy_ops.kappa_tau_eff(tp, tc, tu, T(f["sigma"]), T(temp),
                                       T(f["h"]))
        ref = j_energy.kappa_tau_eff(jp, jc, ju, jnp.asarray(f["sigma"]),
                                     jnp.asarray(temp), jnp.asarray(f["h"]))
        _close(got, ref, rtol=1e-11)
        _close(energy_ops.thermal_cooling(tp, tc, T(temp), got[2]),
               j_energy.thermal_cooling(jp, jc, jnp.asarray(temp), ref[2]),
               rtol=1e-11)


@pytest.mark.parametrize("with_pv", [False, True])
def test_substep3_surface_cooling(grids, fields, with_pv):
    """SubStep3 of the PDS70 setup: viscous heating, thermal surface
    cooling, the radiative correction and the near-floor equilibrium,
    with the PVTE grids or the constant gamma."""
    jg, tg = grids
    jp, tp = _phys()
    ju, tu = _units()
    jc, tc = JConstants.from_units(ju), Constants.from_units(tu)
    f = fields
    nu = f["energy"] * 1e-2
    stress = visc.viscous_stress_tensor(tp, tg, T(f["sigma"]), T(f["vrad"]),
                                        T(f["vaz"]), T(nu))
    pv_t = tuple(T(x) for x in f["pv"]) if with_pv else None
    pv_j = tuple(jnp.asarray(x) for x in f["pv"]) if with_pv else None
    got = energy_ops.substep3(tp, tc, tg, T(f["sigma"]), T(f["energy"]),
                              T(nu), *stress, T(f["h"]), T(1.5), T(0.003),
                              units=tu, pvte_vals=pv_t)
    sig_j = jnp.asarray(f["sigma"])
    ref = j_energy.substep3(
        jp, jc, jg, sig_j, jnp.asarray(f["energy"]), jnp.asarray(f["vrad"]),
        jnp.asarray(f["vaz"]), jnp.asarray(nu),
        *[jnp.asarray(s.numpy()) for s in stress], jnp.asarray(f["h"]),
        sig_j, jnp.asarray(f["energy"]), jnp.zeros_like(sig_j),
        jnp.float64(1.5), jnp.float64(0.003), units=ju, pvte_vals=pv_j)
    _close(got, ref, rtol=1e-11, atol=1e-30)
    # the near-floor cells took the heating/cooling equilibrium
    assert float(got[0][NR // 2, 4]) != float(f["energy"][NR // 2, 4])


def test_viscosity_grid_of_pvte_sound_speed(grids, fields):
    jg, tg = grids
    jp, tp = _phys()
    f = fields
    _close(visc.kinematic_viscosity(tp, tg, T(f["energy"]), T(f["h"])),
           j_visc.kinematic_viscosity(jp, jg, jnp.asarray(f["energy"]),
                                      jnp.asarray(f["h"])))
