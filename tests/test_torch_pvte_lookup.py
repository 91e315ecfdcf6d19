"""The PVTE lookup table and the PVTE shock tube on fargocpt_torch: the
last golden, float64 on the CPU.

* The tables: the port's 1000 x 1000 (rho, e) tables (built once, a
  module fixture) against the JAX package's table build run on every
  tenth row and column (its ``_ref_brent_temperature``, ``_gamma_mu_at``
  and ``gamma1_at`` on those 10^4 points, as its ``lookup_tables`` runs
  them on all 10^6): rho and e bit for bit, mu and gamma_eff to rtol
  1e-12, gamma1 (finite differences of the solved temperature, which
  amplify roundoff) to rtol 1e-9.
* The lookup: ``lookup_gamma_mu`` of both packages on the same tables at
  seeded points in and off the table (the weights extrapolate) to rtol
  1e-12.
* The goldens (tests/test_reference_golden.py's gates):
  ``shocktube_pvte@lookup`` (2e-4, 3283 steps at 1000x2, about a minute)
  and ``shocktube_pvte`` with the bisection solve (6e-3, slow: several
  minutes), and the bisection tube's first 200 steps against the JAX
  package (rtol 1e-10; v_rad 1e-9 of its largest value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fargocpt_tpu.ops import pvte as j_pvte

from fargocpt_torch import flagship, output as out
from fargocpt_torch.ops import pvte
from fargocpt_torch.sim import Simulation

from longtail_pairs import (assert_fields, build_pair, moved, snapshot,
                            step_pair)
from test_torch_goldens import GOLDENS, compare_golden

torch.set_num_threads(2)

SHOCKTUBE = str(GOLDENS / "shocktube_pvte" / "setup.yml")


@pytest.fixture(scope="module")
def tables():
    return pvte.lookup_tables(0.75, "cpu")


def _jax_table_rows(step: int = 10):
    """The JAX package's table build (fargocpt_tpu/ops/pvte.py
    ``lookup_tables``) on every ``step``-th row and column of the grid."""
    lo, w, coeffs = j_pvte.funcdum_poly()
    tabs = (lo, w, jnp.asarray(coeffs, jnp.float64))
    rho_t = 10.0 ** (j_pvte.DLOG_RHO * np.arange(j_pvte.N_RHO)) \
        * j_pvte.RHO_MIN
    e_t = 10.0 ** (j_pvte.DLOG_E * np.arange(j_pvte.N_E)) * j_pvte.E_MIN
    rho2, e2 = np.broadcast_arrays(rho_t[::step, None], e_t[None, ::step])
    rho2, e2 = jnp.asarray(rho2), jnp.asarray(e2)
    T = j_pvte._ref_brent_temperature(e2, rho2, 0.75, tabs)
    _, _, mu, _, geff = j_pvte._gamma_mu_at(rho2, T, 0.75, tabs)
    g1 = j_pvte.gamma1_at(rho2, T, 0.75, tabs)
    return rho_t, e_t, np.asarray(mu), np.asarray(geff), np.asarray(g1)


def test_lookup_tables_match_jax(tables):
    jax_t = _jax_table_rows()
    names = ("rho", "e", "mu", "gamma_eff", "gamma1")
    rtols = (0.0, 0.0, 1e-12, 1e-12, 1e-9)
    for k, (t, j, name, rtol) in enumerate(zip(tables, jax_t, names,
                                               rtols)):
        assert t.dtype == torch.float64
        got = t.numpy()[::10] if k < 2 else t.numpy()[::10, ::10]
        np.testing.assert_allclose(got, j if k >= 2 else j[::10], rtol=rtol,
                                   atol=0.0, err_msg=name)
    assert tables[2].shape == (pvte.N_RHO, pvte.N_E)


def test_lookup_gamma_mu_matches_jax(tables):
    jax_t = tuple(t.numpy() for t in tables)
    rng = np.random.default_rng(9)
    # log-uniform points a decade past each edge: off the table the
    # weights extrapolate
    rho = 10.0 ** rng.uniform(-24.0, 1.0, (64, 32))
    e = 10.0 ** rng.uniform(7.0, 16.0, (64, 32))
    j_out = j_pvte.lookup_gamma_mu(rho, e, jax_t)
    t_out = pvte.lookup_gamma_mu(torch.tensor(rho), torch.tensor(e),
                                 tables)
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)


def _run_golden(tmp_path, lookup: bool):
    sim = Simulation(flagship.shocktube_pvte(lookup=lookup), outdir=str(tmp_path / "out"), dtype="float64",
                     device="cpu")
    assert sim.stepper.pvte.lookup == lookup
    writer = out.OutputWriter(sim)
    sim.run()
    writer.close()
    return sim


def test_shocktube_pvte_lookup_golden(tmp_path):
    sim = _run_golden(tmp_path, lookup=True)
    compare_golden("shocktube_pvte", sim, 2e-4, tmp_path / "out")


@pytest.mark.slow
def test_shocktube_pvte_golden(tmp_path):
    sim = _run_golden(tmp_path, lookup=False)
    compare_golden("shocktube_pvte", sim, 6e-3, tmp_path / "out")


def test_shocktube_pvte_first_steps_match_jax():
    js, ts = build_pair(path=SHOCKTUBE)
    assert ts.stepper.pvte.shock_tube == 2 and not ts.stepper.pvte.lookup
    before = snapshot(ts)
    step_pair(js, ts, 200)
    assert_fields(ts.state, js.state, q=False)
    assert moved(ts, before)["sigma"] > 1e-3
