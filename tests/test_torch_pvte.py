"""fargocpt_torch's PVTE equation of state against fargocpt_tpu's on the
same seeded (rho, e) in cgs, spanning the molecular, dissociating and
ionising gas (e from 1e9 to 1e14 erg/g, rho from 1e-13 to 1e-5 g/cm^3),
on the CPU.

Tolerances. float64 pipeline: T rtol 1e-12 (48 halvings decide signs of
residuals that libm rounding can flip only at the root itself, 2.5e-14 in
log10 T), gamma_eff and mu rtol 1e-13, gamma1 rtol 1e-10 (its finite
differences with eps = 1e-4 scale the rounding by 1e4). float32 fast path,
cold and warm: rtol 2e-5, the solver's own tolerance (~1e-5): XLA's and
PyTorch's float32 exp and log differ by an ulp, which moves the iterates
within it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fargocpt_tpu.ops import pvte as j_pvte
from fargocpt_tpu.params import Physics as JPhysics
from fargocpt_tpu.units import Units as JUnits

from fargocpt_torch import telemetry
from fargocpt_torch.ops import kernels, pvte
from fargocpt_torch.params import Physics
from fargocpt_torch.units import Units

torch.set_num_threads(2)

X_MF = 0.75
N = 3000
F32_RTOL = 2e-5


@pytest.fixture(scope="module")
def rho_e():
    rng = np.random.default_rng(3)
    rho = 10.0 ** rng.uniform(-13, -5, N)
    e = 10.0 ** rng.uniform(9, 14, N)
    return rho, e


def _tabs(dtype_j, dtype_t):
    lo, w, c = j_pvte.funcdum_poly()
    return (lo, w, jnp.asarray(c, dtype_j)), \
        (lo, w, torch.tensor(c, dtype=dtype_t))


def _close(got, ref, rtol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=0.0)


def test_tables_equal_jax():
    lo, w, c = pvte.funcdum_poly()
    jlo, jw, jc = j_pvte.funcdum_poly()
    assert (lo, w) == (jlo, jw)
    np.testing.assert_array_equal(c, jc)
    assert pvte.funcdum_elem_tables() == j_pvte.funcdum_elem_tables()


def test_gamma_mu_f64(rho_e):
    rho, e = rho_e
    jt, tt = _tabs(jnp.float64, torch.float64)
    T_ref = j_pvte.temperature_from_energy(jnp.asarray(e), jnp.asarray(rho),
                                           X_MF, jt)
    T = pvte.temperature_from_energy(torch.tensor(e), torch.tensor(rho),
                                     X_MF, tt)
    _close(T, T_ref, 1e-12)
    T_ref = np.asarray(T_ref)
    assert T_ref.min() < 100.0 and T_ref.max() > 2e4   # all three regimes
    ref = j_pvte._gamma_mu_at(jnp.asarray(rho), jnp.asarray(T_ref), X_MF, jt)
    got = pvte._gamma_mu_at(torch.tensor(rho), torch.tensor(T_ref), X_MF, tt)
    for k in (2, 4):                      # mu, gamma_eff
        _close(got[k], ref[k], 1e-13)
    _close(pvte.gamma1_at(torch.tensor(rho), T, X_MF, tt),
           j_pvte.gamma1_at(jnp.asarray(rho), jnp.asarray(T_ref), X_MF, jt),
           1e-10)


def test_hybrid_solver_f32(rho_e):
    """The legacy float32 solve of temperature_from_energy."""
    rho, e = (a.astype(np.float32) for a in rho_e)
    jt, tt = _tabs(jnp.float32, torch.float32)
    _close(pvte.temperature_from_energy(torch.tensor(e), torch.tensor(rho),
                                        X_MF, tt),
           j_pvte.temperature_from_energy(jnp.asarray(e), jnp.asarray(rho),
                                          X_MF, jt), F32_RTOL)


def test_fast_path_f32_cold_and_warm(rho_e):
    rho, e = (a.astype(np.float32) for a in rho_e)
    ref = j_pvte.gamma_mu_fast(jnp.asarray(rho), jnp.asarray(e), X_MF)
    got = pvte.gamma_mu_fast(torch.tensor(rho), torch.tensor(e), X_MF)
    for a, b in zip(got, ref):
        _close(a, b, F32_RTOL)
    # a warm refresh after the energy moved by ~0.3%, from the same guess
    rng = np.random.default_rng(4)
    e2 = (e * (1.0 + 3e-3 * rng.standard_normal(N))).astype(np.float32)
    guess_j = (ref[0], ref[1])
    guess_t = tuple(torch.tensor(np.asarray(x)) for x in guess_j)
    for n_newton in (1, 3):
        ref_w = j_pvte.gamma_mu_fast(jnp.asarray(rho), jnp.asarray(e2),
                                     X_MF, guess=guess_j, n_newton=n_newton)
        got_w = pvte.gamma_mu_fast(torch.tensor(rho), torch.tensor(e2),
                                   X_MF, guess=guess_t, n_newton=n_newton)
        for a, b in zip(got_w, ref_w):
            _close(a, b, F32_RTOL)
        assert all(bool(torch.isfinite(a).all()) for a in got_w)


@pytest.mark.parametrize("n_newton", [1, 3])
def test_pvte_class_in_code_units(n_newton):
    """PVTE.gamma_mu on code-unit grids: the float64 pipeline and the
    float32 warm refresh with ``n_newton`` steps, against the JAX class
    (its Newton count set the way it reads it)."""
    rng = np.random.default_rng(5)
    shape = (16, 32)
    sigma = rng.uniform(1e-5, 1e-3, shape)
    energy = sigma * rng.uniform(1e-5, 1e-2, shape)
    h = rng.uniform(0.01, 0.1, shape)
    kw = dict(eos="adiabatic", variable_gamma=True, adiabatic_index=1.4)
    jphys, tphys = JPhysics(**kw), Physics(**kw)
    junits, tunits = JUnits(), Units()
    for dtype_j, dtype_t, rtol in ((jnp.float64, torch.float64, 1e-10),
                                   (jnp.float32, torch.float32, F32_RTOL)):
        jp = j_pvte.PVTE(jphys, junits, dtype_j)
        jp.n_newton = n_newton
        tp = pvte.PVTE(tphys, tunits, dtype_t, n_newton=n_newton)
        before = telemetry.value("pvte.refresh")
        assert tp.fast == jp.fast == (dtype_t == torch.float32)
        args_j = [jnp.asarray(a, dtype_j) for a in (sigma, energy, h)]
        args_t = [torch.tensor(a, dtype=dtype_t) for a in (sigma, energy, h)]
        cold_j = jp.gamma_mu(*args_j)
        cold_t = tp.gamma_mu(*args_t)
        for a, b in zip(cold_t, cold_j):
            _close(a, b, rtol)
        args_j[1] = args_j[1] * 1.002
        args_t[1] = args_t[1] * 1.002
        warm_j = jp.gamma_mu(*args_j, guess=(cold_j[0], cold_j[1]))
        warm_t = tp.gamma_mu(*args_t, guess=(cold_t[0], cold_t[1]))
        for a, b in zip(warm_t, warm_j):
            _close(a, b, rtol)
        assert telemetry.value("pvte.refresh") - before == 2


def test_lookup_table_mode_is_refused(monkeypatch):
    """The lookup table, once refused, now ported: a PVTE evaluator in
    lookup mode gives the JAX package's (gamma_eff, mu, gamma1) on the same
    tables to rtol 1e-12 (the tables are held against each other in
    tests/test_torch_pvte_lookup.py; here the JAX package reads the
    port's), and no warm start."""
    monkeypatch.setattr(j_pvte, "lookup_tables", lambda x_mf: tuple(
        t.numpy() for t in pvte.lookup_tables(x_mf, "cpu")))
    phys = Physics(variable_gamma=True, pvte_lookup_table=True)
    ev = pvte.PVTE(phys, Units(), torch.float64)
    assert ev.lookup and not ev.fast
    j_ev = j_pvte.PVTE(JPhysics(variable_gamma=True, pvte_lookup_table=True),
                       JUnits(), jnp.float64)
    rng = np.random.default_rng(12)
    sigma = rng.uniform(1e-5, 1e-3, (8, 16))
    energy = sigma * rng.uniform(1e-6, 1e-3, (8, 16))
    h = rng.uniform(0.01, 0.1, (8, 16))
    got = ev.gamma_mu(*(torch.tensor(a) for a in (sigma, energy, h)))
    ref = j_ev.gamma_mu(sigma, energy, h)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)


def _refresh_before(pv, sigma, energy, h):
    """PVTE.gamma_mu's float64 pipeline as it stood before the refresh
    became an op, written out."""
    un = pv.units
    if pv.shock_tube > 0:
        rho_cgs = sigma * un.density
    else:
        rho_cgs = sigma / (pv.density_factor * h) * un.density
    e_spec_cgs = energy / sigma * (un.energy_density / un.surface_density)
    T = pvte.temperature_from_energy(e_spec_cgs, rho_cgs, pv.x_mf, pv.tabs)
    _, _, mu, _, gamma_eff = pvte._gamma_mu_at(rho_cgs, T, pv.x_mf, pv.tabs)
    g1 = pvte.gamma1_at(rho_cgs, T, pv.x_mf, pv.tabs)
    return gamma_eff, mu, g1


@pytest.mark.parametrize("shock_tube", [0, 2])
def test_pvte_refresh_plain_is_the_pipeline_before(shock_tube):
    """On the CPU the op's plain version, and PVTE.gamma_mu through the op,
    give the float64 pipeline's grids bit for bit, the shock-tube form
    included; no kernel is launched and the refresh is counted once."""
    rng = np.random.default_rng(21 + shock_tube)
    shape = (24, 40)
    sigma = torch.tensor(rng.uniform(1e-5, 1e-3, shape))
    energy = sigma * torch.tensor(rng.uniform(1e-6, 1e-2, shape))
    h = torch.tensor(rng.uniform(0.01, 0.1, shape))
    pv = pvte.PVTE(Physics(variable_gamma=True, shock_tube=shock_tube),
                   Units(), torch.float64)
    assert not (pv.fast or pv.lookup)
    ref = _refresh_before(pv, sigma, energy, h)
    before = telemetry.value("pvte.refresh")
    for got in (kernels.pvte_refresh_plain(pv, sigma, energy, h),
                pv.gamma_mu(sigma, energy, h)):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert telemetry.value("pvte.refresh") == before + 1
    assert telemetry.value("launch.pvte_refresh") == 0
