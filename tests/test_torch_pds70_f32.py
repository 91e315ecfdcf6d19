"""The PDS70 gas slice in float32 (the fast PVTE path with its warm-start
chain) against the JAX package's on the CPU, and the PVTE refreshes per
step of both packages.

Tolerance at 64x128 after 10 steps: rel-L2 < 2e-6 per field (v_rad
measured against |v_az|, as tests/test_dtype_budget.py does) and the
final PVTE guesses to rtol 1e-6. The sound run reads sigma 1.1e-7, v_rad
5.6e-8, v_az 9.3e-8, e 4.8e-7 and the guesses 8.4e-8 and 1.0e-7: the two
packages' float32 exp and log differ by an ulp, which the step carries.

The fields cannot tell a wrong warm-start chain: one Newton step from any
of the step's earlier grids lands within rounding of the root, and a
chain that warms every refresh from the state's guess moves the fields by
< 2e-8 over these 10 steps. So the chain's order is held by a record of
where each refresh's guess came from, equal in both packages, and a
planted wrong chain is shown to fail that check.
"""

import numpy as np
import pytest
import torch

from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.sim import Simulation as JSimulation

from fargocpt_torch import telemetry
from fargocpt_torch.config import Config
from fargocpt_torch.flagship import PDS70_GAS, pds70_gas
from fargocpt_torch.sim import Simulation

torch.set_num_threads(2)

FIELDS = ("sigma", "vrad", "vaz", "energy")


def _cfg(nr, naz, **kw):
    return dict(PDS70_GAS, Nrad=str(nr), Naz=str(naz), **kw)


def test_ten_steps_f32_fast_pvte():
    js = JSimulation(JConfig.from_dict(_cfg(64, 128)), dtype="float32")
    ts = Simulation(pds70_gas(64, 128), dtype="float32", device="cpu")
    assert ts.stepper.pvte.fast and ts.state.pvte_guess is not None
    for _ in range(10):
        dj = js.calculate_time_step()
        js.step_once(dj)
        ts.step_once(torch.tensor(dj, dtype=torch.float32))
    vaz = np.asarray(js.state.fields.vaz, np.float64)
    for name in FIELDS:
        ref = np.asarray(getattr(js.state.fields, name), np.float64)
        got = getattr(ts.state.fields, name).double().numpy()
        scale = np.linalg.norm(vaz if name == "vrad" else ref)
        err = np.linalg.norm(got - ref) / scale
        assert err < 2e-6, (name, err)
    for k in range(2):
        np.testing.assert_allclose(ts.state.pvte_guess[k].numpy(),
                                   np.asarray(js.state.pvte_guess[k]),
                                   rtol=1e-6)


class _GuessSources:
    """Wraps a PVTE evaluator's ``gamma_mu`` and records, per refresh,
    where its warm-start guess came from: None (a cold solve), -k (the
    output of the refresh k places earlier in the record) or "state"
    (anything else: the state's ``pvte_guess``). The JAX package's
    refreshes happen while its step functions trace, once per refresh of
    a step, on tracers whose identity holds within a trace."""

    def __init__(self, pvte):
        self.record, self._outs = [], []
        real = pvte.gamma_mu

        def recording(sigma, energy, h, guess=None):
            src = None
            if guess is not None:
                n = len(self._outs)
                src = next((k - n for k, o in enumerate(self._outs)
                            if o[0] is guess[0] and o[1] is guess[1]),
                           "state")
            out = real(sigma, energy, h, guess=guess)
            self.record.append(src)
            self._outs.append(out)
            return out

        pvte.gamma_mu = recording

    def clear(self):
        self.record.clear()
        self._outs.clear()


# calculate_time_step + step_once: the CFL's refresh and the step's first
# warm from the state's guess, the step's second (after the artificial
# viscosity) from the step's first
STANDALONE = ["state", "state", -1]


def test_pvte_refreshes_per_step_equal_jax():
    """The refreshes of each package and where each one's guess came from.
    calculate_time_step + step_once: three (STANDALONE). run(): the CFL's
    refresh serves its step's start, so two a step, and both warm from the
    state's guess, the previous step's last refresh: the loop carry in the
    JAX trace, -1 and -2 in the port."""
    cfg = _cfg(16, 32, MonitorTimestep="0.006")
    js = JSimulation(JConfig.from_dict(dict(cfg)), dtype="float32")
    ts = Simulation(Config.from_dict(dict(cfg)), dtype="float32",
                    device="cpu")
    jrec, trec = _GuessSources(js.stepper.pvte), _GuessSources(ts.stepper.pvte)
    before = telemetry.value("pvte.refresh")
    js.step_once(js.calculate_time_step())
    ts.step_once(ts.calculate_time_step())
    assert jrec.record == trec.record == STANDALONE
    assert telemetry.value("pvte.refresh") - before == 3

    jrec.clear()
    trec.clear()
    before = telemetry.value("pvte.refresh")
    js.run()               # traces one step of the run loop
    ts.run()
    n = ts.n_hydro_iter - 1
    assert ts.n_hydro_iter == js.n_hydro_iter > 3
    assert telemetry.value("pvte.refresh") - before == len(trec.record)
    assert jrec.record == ["state", "state"]
    # run() first takes two CFL steps, which the JAX package had traced
    assert trec.record == ["state"] * 4 + [-1, -2] * (n - 1)


@pytest.mark.parametrize("fault", ["stale", "cold"])
def test_wrong_pvte_chain_is_caught(fault):
    """A planted wrong chain, every refresh warmed from the state's guess
    ("stale") or solved cold, fails the check above."""
    ts = Simulation(pds70_gas(16, 32), dtype="float32", device="cpu")
    rec = _GuessSources(ts.stepper.pvte)
    recording = ts.stepper.pvte.gamma_mu

    def wrong(sigma, energy, h, guess=None):
        return recording(sigma, energy, h, guess=ts.state.pvte_guess
                         if fault == "stale" else None)

    ts.stepper.pvte.gamma_mu = wrong
    ts.step_once(ts.calculate_time_step())
    assert rec.record == (["state"] * 3 if fault == "stale" else [None] * 3)
    assert rec.record != STANDALONE
