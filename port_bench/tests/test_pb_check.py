"""The comparison that decides ``correct``, on the CPU at a small size:
sound runs pass; the control (the program's float32 path) and each fault
the cells can have, planted under the timed path, fail."""

import time

import numpy as np
import pytest
import torch

from port_bench import harness

SMALL = {"Nrad": "16", "Naz": "32"}
CELLS = {
    "adiabatic_disk.run": {},
    "pvte_fld_sg_dust.run": {"NumberOfParticles": "64"},
    "adiabatic_disk.snap": {"MonitorTimestep": "0.01", "Nmonitor": "2"},
}


def run(cell, seed=2 ** 31 + 77, **kw):
    return harness.run_cell(cell, seed, 0.3, False, time.perf_counter(),
                            device="cpu", overrides={**SMALL, **CELLS[cell]},
                            **kw)


def failed(result):
    return {k for k, c in result["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_float32_is_not_correct(cell):
    r = run(cell, dtype="float32")
    assert not r["correct"]
    assert {"start_gap", "end_gap"} <= failed(r)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_step_returning_its_state_is_not_correct(cell, monkeypatch):
    from fargocpt_torch import step
    monkeypatch.setattr(step.HydroStep, "step",
                        lambda self, state, time, dt: state)
    r = run(cell)
    assert not r["correct"]
    assert {"start_gap", "end_gap"} <= failed(r)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_altered_answer_is_not_correct(cell, monkeypatch):
    """One cell of sigma moved by a millionth where the step produces it,
    on the window's steps only (the warm-up's are sound)."""
    from fargocpt_torch import step
    sound = step.HydroStep.step
    calls = [0]

    def altered(self, state, time, dt):
        out = sound(self, state, time, dt)
        calls[0] += 1
        if calls[0] <= harness.load_cell(cell)["warmup_steps"]:
            return out
        sigma = out.fields.sigma.clone()
        sigma[5, 7] *= 1.0 + 1e-6
        return out.replace(fields=out.fields.replace(sigma=sigma))

    monkeypatch.setattr(step.HydroStep, "step", altered)
    r = run(cell)
    assert not r["correct"]
    # the window's last call reads it; the cell may also set the CFL dt
    assert "end_gap" in failed(r) and "start_gap" not in failed(r)


def test_altered_snapshot_is_not_correct(monkeypatch):
    from fargocpt_torch import output
    sound = output.OutputWriter.write_snapshot

    def altered(self, *a, **kw):
        out = sound(self, *a, **kw)
        path = self.snapshot_dir / "Sigma.dat"
        arr = np.fromfile(path, dtype="<f8")
        arr[3] *= 1.0 + 1e-9
        arr.tofile(path)
        return out

    monkeypatch.setattr(output.OutputWriter, "write_snapshot", altered)
    r = run("adiabatic_disk.snap")
    assert failed(r) == {"snap_gap"}


def test_reference_follows_the_port_on_the_cpu():
    """The plain reference and the port's CPU path, both from the cell's
    configuration at a small size, agree bit for bit over a few calls."""
    from fargocpt_torch.config import Config
    from fargocpt_torch.sim import Simulation
    from port_bench.reference.fargo_plain.config import Config as RConfig
    from port_bench.reference.fargo_plain.sim import Simulation as RSim
    for cell, extra in (("adiabatic_disk.run", {}),
                        ("pvte_fld_sg_dust.run", {"NumberOfParticles": "64"})):
        spec = harness.load_cell(cell)
        setup = harness.setup_dict(harness.load_config(spec["config"]),
                                   spec, 3, {**SMALL, **extra})
        a = Simulation(Config.from_dict(dict(setup)), device="cpu")
        b = RSim(RConfig.from_dict(dict(setup)), device="cpu")
        for sim in (a, b):
            sim.begin()
            harness.warm_up(sim, 6)
        for k in ("sigma", "vrad", "vaz", "energy"):
            assert torch.equal(getattr(a.fields, k), getattr(b.fields, k))
        assert float(a.time) == float(b.time)
