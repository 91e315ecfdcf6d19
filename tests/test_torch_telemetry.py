"""The port's own measurement (``fargocpt_torch/telemetry.py``) on the CPU:
spans are the shared no-op without a profiler and leave no record; the
host syncs are counted by site, the same on the CPU as on the card; a
profiled call leaves a record whose steps are the steps run and whose
spans nest in the Chrome trace; a snapshot leaves its record; and the
state is the same bits with the profiler on and off."""

import json
import shutil
from pathlib import Path

import pytest
import torch
import yaml

from fargocpt_torch import __main__ as cli, telemetry
from fargocpt_torch.config import Config
from fargocpt_torch.flagship import FLAGSHIP, PDS70
from fargocpt_torch.ops.fld import FLDSolver
from fargocpt_torch.output import OutputWriter
from fargocpt_torch.sim import Simulation
from fargocpt_torch.state import system_state_to_numpy

ROOT = Path(__file__).resolve().parent.parent
# the run path's spans of every step on the CPU (the plain versions of
# the fused ops run inside their kernels' spans)
RUN_SPANS = {
    "sim.advance_monitor", "step.advance_start", "step.cfl_dt", "step.step",
    "step.bodies", "step.frame", "step.substeps", "boundary.apply",
    "kernels.transport", "step.floors", "step.drift", "step.bookkeeping",
    "step.landing", "sim.dt_stats"}
# those of the adiabatic disk's fused ops, and those of the PVTE, FLD,
# self-gravity and dust disk's unfused substeps
ADIABATIC_SPANS = {"kernels.cfl", "kernels.sources", "kernels.viscous_kick"}
PVTE_SPANS = {"pvte.gamma_mu", "fld.radiative_diffusion", "fld.solve",
              "selfgravity.accelerations", "dust.integrate",
              "kernels.artvisc_sn", "energy.substep3", "opacity.opacity",
              "cfl.condition", "sources.update", "step.derived"}
# those of PDS 70 b and c in their disk: the bodies, the damping zones, TW
# viscosity, the irradiation and the swarm
PLANET_SPANS = {"kernels.cfl", "kernels.sources", "gravity.nbody_potential",
                "gravity.disk_on_bodies", "gravity.indirect_term",
                "nbody.ias15", "nbody.roche_radius", "step.bodies_on_grid",
                "kernels.bodies_on_grid",
                "damping.apply", "artvisc.tw", "energy.substep3",
                "energy.irradiation", "opacity.opacity", "dust.integrate"}

def pvte_disk(tmp_path, **extra):
    """PVTE + FLD + symmetric FFT self-gravity + 64 particles at 16 x 32,
    with its writer."""
    cfg = dict(PDS70, Nrad="16", Naz="32", NumberOfParticles="64",
               MonitorTimestep="6.28", Nmonitor="100")
    cfg.update(extra)
    sim = Simulation(Config.from_dict(cfg), outdir=str(tmp_path / "out"),
                     device="cpu")
    return sim, OutputWriter(sim)


def planet_disk(tmp_path, **extra):
    """setups/PDS70.yml with its unit moved to planet b's orbit (l0 22.7
    au, Sigma0 kept in code units, the semi-major axes in au), so that
    both planets orbit inside the grid; 16 x 32 and 64 particles, with
    its writer."""
    cfg = yaml.safe_load((ROOT / "setups" / "PDS70.yml").read_text())
    cfg.update(l0="22.7 au", Sigma0="3.66915 g/cm2", Nrad=16, Naz=32,
               NumberOfParticles=64, MonitorTimestep="6.28", Nmonitor=100)
    for body, axis in zip(cfg["nbody"], ("0.0 au", "22.7 au", "30.2 au")):
        body["semi-major axis"] = axis
    cfg.update(extra)
    with pytest.warns(UserWarning, match="CartesianParticles"):
        sim = Simulation(Config.from_dict(cfg),
                         outdir=str(tmp_path / "out"), device="cpu")
    return sim, OutputWriter(sim)


def adiabatic_disk(tmp_path, **extra):
    cfg = dict(FLAGSHIP, Nrad="16", Naz="32", MonitorTimestep="6.28",
               Nmonitor="100")
    cfg.update(extra)
    sim = Simulation(Config.from_dict(cfg), outdir=str(tmp_path / "out"),
                     device="cpu")
    return sim, OutputWriter(sim)


def deltas(fn):
    """The counters ``fn()`` moved."""
    before = dict(telemetry.COUNTERS)
    fn()
    return {k: v - before.get(k, 0) for k, v in telemetry.COUNTERS.items()
            if v != before.get(k, 0)}


def profiled(fn, tmp_path=None):
    """``fn()`` under a CPU profiler; the Chrome trace's complete events
    when ``tmp_path`` is given."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    if tmp_path is None:
        return None
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def test_span_is_the_shared_noop_without_a_profiler(tmp_path):
    assert telemetry.span("step.step") is telemetry.NOOP
    assert telemetry.span("fld.radiative_diffusion") is telemetry.NOOP

    @telemetry.spanned("x.y")
    def f(a, b=2):
        return a + b
    assert f(1, b=3) == 4 and f.__name__ == "f"
    sim, w = adiabatic_disk(tmp_path)
    sim.begin()
    n = len(telemetry.RECORDS)
    sim.advance_monitor(3)
    w.close()
    assert len(telemetry.RECORDS) == n
    assert sim.monitor_stats["n_steps"] == 3
    assert 0.0 < sim.monitor_stats["walltime"] < 600.0


def test_counters_values_and_reset():
    telemetry.count("test.a")
    telemetry.count("test.a", 2)
    telemetry.count("test.b", 0.5)
    assert telemetry.value("test.a") == 3
    assert telemetry.values("test.", ("a", "c")) == {"a": 3, "c": 0}
    telemetry.reset("test.")
    assert telemetry.values("test.", ("a", "b")) == {"a": 0, "b": 0}
    assert telemetry.value("test.never") == 0


def test_sync_sites_of_the_pvte_disk_are_pinned(tmp_path):
    """A call of 3 steps cut short by ``max_steps``: the landing test once
    a step, the five scalar uploads, the dt statistics and the stop test
    once a call, FLD's first norm, block test and count once a solve
    (every solve converges in its first block here); two PVTE refreshes
    a step on the run path."""
    sim, w = pvte_disk(tmp_path)
    sim.begin()
    sim.advance_monitor(2)
    moved = deltas(lambda: sim.advance_monitor(3))
    w.close()
    assert sim.monitor_stats["n_steps"] == 3
    syncs = {k: v for k, v in moved.items() if k.startswith("sync.")}
    assert syncs == {"sync.landing": 3, "sync.upload": 5,
                     "sync.dt_stats": 1, "sync.stop_test": 1,
                     "sync.fld_upload": 3, "sync.fld_block": 3,
                     "sync.fld_iterations": 3}
    assert moved["pvte.refresh"] == 2 * 3
    assert not any(k.startswith("launch.") for k in moved)


def test_fld_iterations_are_the_solves_counts(tmp_path, monkeypatch):
    sim, w = pvte_disk(tmp_path)
    sim.begin()
    got = []
    solve = FLDSolver.solve

    def recorded(self, *a, **kw):
        out = solve(self, *a, **kw)
        got.append(out[1])
        return out
    monkeypatch.setattr(FLDSolver, "solve", recorded)
    moved = deltas(lambda: sim.advance_monitor(4))
    w.close()
    assert len(got) == 4
    assert moved["fld.sor_iterations"] == sum(got) > 0


def test_monitor_boundary_counts_the_writers_reads(tmp_path):
    """A call that reaches the output time: the hooks' reads, each once,
    and no stop test; ``walltime`` from the root's clock."""
    sim, w = adiabatic_disk(tmp_path, MonitorTimestep="0.002")
    sim.begin()
    moved = deltas(lambda: sim.advance_monitor())
    w.close()
    n = sim.monitor_stats["n_steps"]
    assert n >= 1 and sim.n_monitor == 1
    syncs = {k: v for k, v in moved.items() if k.startswith("sync.")}
    assert syncs == {"sync.landing": n, "sync.upload": 5, "sync.dt_stats": 1,
                     "sync.monitor.disk_radius": 1,
                     "sync.monitor.pdivv_dt": 1, "sync.monitor.time": 1,
                     "sync.monitor.bodies": 1, "sync.output.to_host": 2}
    stamp = (tmp_path / "out" / "monitor" / "timestepLogging.dat") \
        .read_text().splitlines()[-1].split("\t")
    assert float(stamp[3]) == pytest.approx(sim.monitor_stats["walltime"],
                                            rel=1e-5)


def test_planet_disk_monitor_boundary_counts_each_bodys_read(tmp_path):
    """PDS 70 b and c in their disk: a call that reaches the output time
    counts the writers' reads as the lone star's disk does, but one
    ``monitor.bodies`` read a body (the orbital elements of each body's
    file); the planets' step (IAS15, the feedback, the damping, TW)
    reads nothing."""
    sim, w = planet_disk(tmp_path, MonitorTimestep="0.2")
    sim.begin()
    moved = deltas(lambda: sim.advance_monitor())
    w.close()
    n = sim.monitor_stats["n_steps"]
    assert n >= 2 and sim.n_monitor == 1 and sim.state.nbody.n == 3
    syncs = {k: v for k, v in moved.items() if k.startswith("sync.")}
    assert syncs == {"sync.landing": n, "sync.upload": 5, "sync.dt_stats": 1,
                     "sync.monitor.disk_radius": 1,
                     "sync.monitor.pdivv_dt": 1, "sync.monitor.time": 1,
                     "sync.monitor.bodies": 3, "sync.output.to_host": 2}
    assert len((tmp_path / "out" / "monitor" / "nbody2.dat").read_text()
               .splitlines()) > 2


def test_snapshot_leaves_its_record(tmp_path):
    sim, w = adiabatic_disk(tmp_path)
    sim.begin()
    n = len(telemetry.SNAPSHOTS)
    moved = deltas(lambda: w.write_snapshot("7", register=False))
    w.close()
    rec = telemetry.SNAPSHOTS[-1]
    assert len(telemetry.SNAPSHOTS) == min(n + 1, telemetry.SNAPSHOTS.maxlen)
    files = sum(p.stat().st_size
                for p in (tmp_path / "out" / "snapshots" / "7").iterdir())
    assert rec.bytes == files == moved["output.snapshot_bytes"] > 0
    assert set(rec.parts) == {"to_host", "dump", "flush"}
    assert 0.0 < sum(rec.parts.values()) <= rec.seconds
    assert moved["sync.output.to_host"] == 1


@pytest.mark.parametrize("disk", ["adiabatic", "pvte", "planets"])
def test_profiled_call_nests_its_spans_in_the_trace(tmp_path, disk):
    sim, w = {"adiabatic": adiabatic_disk, "pvte": pvte_disk,
              "planets": planet_disk}[disk](tmp_path)
    sim.begin()
    sim.advance_monitor(2)
    n = len(telemetry.RECORDS)
    events = profiled(lambda: (sim.advance_monitor(2),
                               sim.advance_monitor(3)), tmp_path)
    w.close()
    assert telemetry.span("step.step") is telemetry.NOOP
    recs = list(telemetry.RECORDS)[n:]
    assert [r.steps for r in recs] == [2, 3]
    assert telemetry.window(5) == recs and telemetry.window(4) is None
    assert recs[1].counters["sync.landing"] == 3
    expected = RUN_SPANS | {"adiabatic": ADIABATIC_SPANS, "pvte": PVTE_SPANS,
                            "planets": PLANET_SPANS}[disk]
    spans = {e["name"][3:]: [] for e in events
             if e["name"].startswith("fc:")}
    for e in events:
        if e["name"].startswith("fc:"):
            spans[e["name"][3:]].append((e["ts"], e["ts"] + e["dur"]))
    assert expected <= set(spans)
    assert len(spans["sim.advance_monitor"]) == 2
    assert len(spans["step.step"]) == 5
    assert expected - {"sim.advance_monitor"} <= set(recs[1].spans)
    for rec in recs:
        for name, st in rec.spans.items():
            assert st.calls >= 1 and st.host_s >= 0.0
            outer = [iv for parent in st.parents for iv in spans[parent]]
            for a, b in spans[name]:
                assert any(pa <= a and b <= pb for pa, pb in outer)
    assert recs[1].spans["step.step"].calls == 3
    assert recs[1].spans["step.landing"].calls == 3


def test_profiler_on_and_off_give_the_same_bits(tmp_path):
    states = []
    for on in (True, False):
        sim, w = pvte_disk(tmp_path / str(on))
        sim.begin()
        run = lambda: sim.advance_monitor(5)  # noqa: E731
        if on:
            profiled(run)
        else:
            run()
        w.close()
        states.append((system_state_to_numpy(sim.state), float(sim.time)))
    (a, ta), (b, tb) = states
    assert ta == tb and a.keys() == b.keys()
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_cli_profile_trace_nests_spans_under_the_monitor_call(tmp_path):
    setup = tmp_path / "adiabatic_disk.yml"
    shutil.copyfile(ROOT / "examples" / "adiabatic_disk.yml", setup)
    rc = cli.main(["start", str(setup), "--device", "cpu", "-N", "2", "-q",
                   "-o", str(tmp_path / "out"), "--profile",
                   str(tmp_path / "prof")])
    assert rc == 0
    events = [e for e in json.loads(
        (tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
        if e.get("ph") == "X" and e["name"].startswith("fc:")]
    roots = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e["name"] == "fc:sim.advance_monitor"]
    assert len(roots) == 1
    steps = [e for e in events if e["name"] == "fc:step.step"]
    assert len(steps) == 2
    inside = [e for e in events if e["name"] != "fc:sim.advance_monitor"
              and roots[0][0] <= e["ts"]
              and e["ts"] + e["dur"] <= roots[0][1]]
    assert {e["name"] for e in inside} >= {
        "fc:step.cfl_dt", "fc:step.step", "fc:kernels.transport",
        "fc:step.landing"}
