"""The cataclysmic variables' cooling (ROADMAP A.9, second half) of
fargocpt_torch against the JAX package, both in float64 on the CPU, on
seeded fields in V1504 Cyg's units (l0 = 0.00318 au, m0 = 0.765 solar
masses), rtol 1e-12:

* ``ops/energy.scurve_cooling``, the dwarf-nova S-curve, in both
  calibrations (Kimura et al. 2020 and Ichikawa & Osaki 1992), on cells
  of each branch (cold, intermediate, hot), below each validity threshold
  (2 g/cm^2, 1200 K) and at the blackbody limit, with a constant mean
  molecular weight and with a PVTE grid of it;
* SubStep3 (``ops/energy.substep3``) with the S-curve (its tau_eff
  replaces the thermal one in the near-floor equilibrium), with and
  without PVTE grids;
* SubStep3 with local beta cooling under the Ziampras et al. (2023)
  local beta (``CoolingBetaMethod`` surf / mid / tot, the reference's
  pow(3, 1/2) = 1 kept), ``CoolingBetaReference: model`` and ``floor``,
  with and without PVTE grids.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fargocpt_tpu.constants import Constants as JConstants
from fargocpt_tpu.grid import Geometry as JGeometry
from fargocpt_tpu.ops import energy as j_energy
from fargocpt_tpu.ops.common import prepare_geom as j_prepare_geom
from fargocpt_tpu.params import Physics as JPhysics
from fargocpt_tpu.units import Units as JUnits

from fargocpt_torch.constants import Constants
from fargocpt_torch.grid import Geometry
from fargocpt_torch.ops import energy as energy_ops, viscosity as visc
from fargocpt_torch.ops.common import Geom
from fargocpt_torch.params import Physics
from fargocpt_torch.units import Units

torch.set_num_threads(2)

NR, NAZ = 24, 48
RTOL = 1e-12
L0, M0 = "0.00318 au", "0.765 solMass"


@pytest.fixture(scope="module")
def setup():
    jun = JUnits.from_config_strings(L0, M0)
    tun = Units.from_config_strings(L0, M0)
    jgeo = JGeometry.build(NR, NAZ, 0.05, 0.703, "Log")
    tgeo = Geometry.build(NR, NAZ, 0.05, 0.703, "Log")
    return (jun, tun, JConstants.from_units(jun), Constants.from_units(tun),
            j_prepare_geom(jgeo, jnp.float64), Geom(tgeo, torch.float64))


def _phys(tun, **kw):
    base = dict(eos="adiabatic", adiabatic_index=1.4, mu=0.6,
                sigma0=12.5 / tun.surface_density, sigma_floor=1e-3,
                density_factor=2.5, tau_factor=0.5, tau_min=0.01,
                minimum_temperature=10.0 / tun.temperature,
                maximum_temperature=3e5 / tun.temperature,
                heating_viscous=True, viscous_alpha=0.1,
                aspectratio_ref=0.002, flaring_index=0.0)
    base.update(kw)
    return JPhysics(**base), Physics(**base)


@pytest.fixture(scope="module")
def fields(setup):
    """sigma from 0.1 to 1e4 g/cm^2 and T from 300 K to 1e5 K, log-uniform
    and independent, so every branch and both thresholds have cells; a
    few rings of sigma under ten times the floor (the near-floor
    equilibrium)."""
    _, tun, _, tc, _, _ = setup
    rng = np.random.default_rng(41)
    sigma_cgs = 10.0 ** rng.uniform(-1.0, 4.0, (NR, NAZ))
    sigma_cgs[3:5] = 10.0 ** rng.uniform(-1.5, -1.0, (2, NAZ))
    temp_k = 10.0 ** rng.uniform(math.log10(300.0), 5.0, (NR, NAZ))
    sigma = sigma_cgs / tun.surface_density
    temp = temp_k / tun.temperature
    mu, gam = 0.6, 1.4
    energy = temp * tc.R * sigma / (mu * (gam - 1.0))
    return dict(sigma=sigma, energy=energy, temp=temp,
                vrad=(rng.random((NR + 1, NAZ)) - 0.5) * 0.05,
                vaz=(rng.random((NR, NAZ)) - 0.5) * 0.1 + 1.0,
                h=rng.uniform(1e-4, 3e-3, (NR, NAZ)),
                nu=rng.uniform(1e-7, 1e-5, (NR, NAZ)),
                mu_pvte=rng.uniform(0.6, 2.4, (NR, NAZ)),
                gam_pvte=rng.uniform(1.1, 1.67, (NR, NAZ)),
                g1_pvte=rng.uniform(1.1, 1.67, (NR, NAZ)))


def _close(got, ref, label=""):
    for k, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                   atol=RTOL * np.abs(b).max(),
                                   err_msg=f"{label} output {k}")


def _branches(tun, tc, tg, phys, sigma, temp, mu):
    """Each cell's S-curve branch (0 cold, 1 intermediate, 2 hot) and
    whether it lies under either validity threshold, from the limits of
    the reference's fit (src/SourceEuler.cpp:823-928)."""
    f_hot_const, mu_exp = (23.405, 0.31) if phys.scurve_kimura \
        else (25.49, -0.31)
    sigma_cgs = sigma * tun.surface_density
    temp_cgs = temp * tun.temperature
    sig_t = np.maximum(sigma_cgs, 2.0)
    temp_t = np.maximum(temp_cgs, 1200.0)
    r_cgs = tg.rb.numpy() * tun.length
    omega = np.sqrt(tc.cgs_G * phys.hydro_center_mass * tun.mass
                    / r_cgs ** 3)
    lsb = math.log10(tc.cgs_sigma_sb)
    log_ta = -1.0 / 5.49 * (0.62 * np.log10(omega) + 1.62 * np.log10(sig_t)
                            + mu_exp * np.log10(mu) - 25.48 - lsb)
    log_fb = np.maximum(11.0 + 0.4 * np.log10(2e10 / r_cgs),
                        lsb + 4.0 * log_ta)
    log_tb = (log_fb + np.log10(omega) + 2.0 * np.log10(sig_t)
              + 0.5 * np.log10(mu) + f_hot_const) / 8.0
    branch = np.where(temp_t < 10.0 ** log_ta, 0,
                      np.where(temp_t > 10.0 ** log_tb, 2, 1))
    return branch, (sigma_cgs < 2.0), (temp_cgs < 1200.0)


@pytest.mark.parametrize("pvte_mu", [False, True])
@pytest.mark.parametrize("kimura", [True, False])
def test_scurve_cooling_matches_jax(setup, fields, kimura, pvte_mu):
    jun, tun, jc, tc, jg, tg = setup
    jp, tp = _phys(tun, cooling_scurve_enabled=True, scurve_kimura=kimura)
    f = fields
    mu = f["mu_pvte"] if pvte_mu else np.full((NR, NAZ), tp.mu)
    ref = j_energy.scurve_cooling(jp, jc, jun, jg, jnp.asarray(f["sigma"]),
                                  jnp.asarray(f["temp"]), jnp.asarray(mu))
    got = energy_ops.scurve_cooling(tp, tc, tun, tg,
                                    torch.tensor(f["sigma"]),
                                    torch.tensor(f["temp"]),
                                    torch.tensor(mu))
    _close(got, ref, "S-curve")
    branch, thin, cold = _branches(tun, tc, tg, tp, f["sigma"], f["temp"],
                                   mu)
    for b in (0, 1, 2):
        assert (branch == b).sum() >= 10, (b, np.bincount(branch.ravel()))
    assert thin.sum() >= 10 and cold.sum() >= 10
    # some cells sit at the blackbody limit
    f_bb = 2.0 * tc.sigma_sb * f["temp"] ** 4
    assert (np.isclose(got[0].numpy(), f_bb, rtol=1e-14)).sum() >= 1


def _substep3(setup, fields, jp, tp, pvte: bool, time=2.5, dt=1e-5):
    jun, tun, jc, tc, jg, tg = setup
    f = fields
    T = torch.tensor
    stress = visc.viscous_stress_tensor(tp, tg, T(f["sigma"]), T(f["vrad"]),
                                        T(f["vaz"]), T(f["nu"]))
    pv = (f["gam_pvte"], f["mu_pvte"], f["g1_pvte"]) if pvte else None
    # the reference profile: the fields of a slightly cooler disk
    sig0, e0 = f["sigma"] * 1.1, f["energy"] * 0.8
    got = energy_ops.substep3(
        tp, tc, tg, T(f["sigma"]), T(f["energy"]), T(f["nu"]), *stress,
        T(f["h"]), time, torch.tensor(dt, dtype=torch.float64), units=tun,
        pvte_vals=tuple(T(a) for a in pv) if pv else None,
        ref=(T(sig0), T(e0)))
    J = jnp.asarray
    ref = j_energy.substep3(
        jp, jc, jg, J(f["sigma"]), J(f["energy"]), J(f["vrad"]),
        J(f["vaz"]), J(f["nu"]), *[J(s.numpy()) for s in stress], J(f["h"]),
        J(sig0), J(e0), jnp.zeros((NR, NAZ)), jnp.float64(time),
        jnp.float64(dt), units=jun,
        pvte_vals=tuple(J(a) for a in pv) if pv else None)
    return got, ref


@pytest.mark.parametrize("pvte", [False, True])
@pytest.mark.parametrize("kimura", [True, False])
def test_substep3_with_the_scurve_matches_jax(setup, fields, kimura, pvte):
    """The S-curve's Q- and its tau_eff, which the near-floor equilibrium
    then reads (rings 3 and 4 lie under ten times the floor)."""
    _, tun = setup[:2]
    jp, tp = _phys(tun, cooling_scurve_enabled=True, scurve_kimura=kimura)
    got, ref = _substep3(setup, fields, jp, tp, pvte)
    _close(got, ref, "SubStep3 with the S-curve")
    near = fields["sigma"] < 10.0 * tp.sigma0 * tp.sigma_floor
    assert near[3:5].all() and near.sum() >= 2 * NAZ
    # the near-floor cells went to the equilibrium: Q- equals Q+ there
    np.testing.assert_array_equal(got[2].numpy()[3:5], got[1].numpy()[3:5])


BETA_VARIANTS = {
    "surf": dict(cooling_beta_method="surf"),
    "mid": dict(cooling_beta_method="mid"),
    "tot": dict(cooling_beta_method="tot"),
    "model": dict(cooling_beta_model=True),
    "floor": dict(cooling_beta_floor=True),
    "floor, ramp": dict(cooling_beta_floor=True, cooling_beta_ramp_up=7.0),
    "tot, thermal": dict(cooling_beta_method="tot",
                         cooling_surface_enabled=True),
}


@pytest.mark.parametrize("pvte", [False, True])
@pytest.mark.parametrize("variant", sorted(BETA_VARIANTS))
def test_substep3_beta_variants_match_jax(setup, fields, variant, pvte):
    _, tun = setup[:2]
    jp, tp = _phys(tun, cooling_beta_enabled=True, cooling_beta=10.0,
                   **BETA_VARIANTS[variant])
    got, ref = _substep3(setup, fields, jp, tp, pvte)
    _close(got, ref, f"SubStep3 with beta {variant}")
    plain = _phys(tun, cooling_beta_enabled=True, cooling_beta=10.0)[1]
    base, _ = _substep3(setup, fields, jp, plain, pvte)
    # the variant changes Q-: it is not the plain beta cooling
    assert not torch.equal(got[2], base[2])
