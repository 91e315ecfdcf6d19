"""FargoCPT's PDS 70 setup as the benchmark runs it (``pds70_planets``)
and its plain reference ``fargo_planets``, on the CPU at 16x32: the
configuration keeps the file's physics in code units with the planets
inside the grid; the reference follows the port bit for bit, the swarm
and a monitor row included, and refuses by name what it lacks; the cell
is correct, and its float32 control and a planted body fault are not; the
readers of ``bodies_ms_per_step`` and ``artvisc_ms_per_step`` see every
call of the step."""

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT
from port_bench import harness, trace

CONFIG = "pds70_planets"
CELL = "pds70_planets.run"
SMALL = {"Nrad": "16", "Naz": "32", "NumberOfParticles": "64"}
SEED = 2 ** 31 + 4099
# the keys the configuration changes, the unit moved to planet b's orbit
MOVED = {"l0": "22.7 au", "Sigma0": "3.66915 g/cm2", "Nrad": "2048",
         "Naz": "6144"}
AXES = ["0.0 au", "22.7 au", "30.2 au"]


def shipped():
    import yaml
    return yaml.safe_load((ROOT / "setups" / "PDS70.yml").read_text())


def setup(overrides=None, seed=3):
    return harness.setup_dict(harness.load_config(CONFIG),
                              harness.load_cell(CELL), seed,
                              {**SMALL, **(overrides or {})})


def port_sim(cfg):
    from fargocpt_torch.config import Config
    from fargocpt_torch.sim import Simulation
    with pytest.warns(UserWarning, match="CartesianParticles"):
        return Simulation(Config.from_dict(dict(cfg)), device="cpu")


def reference():
    return harness.load_reference("fargo_planets")


def test_setup_is_the_files_but_for_the_unit_and_the_grid():
    """Every key of ``setups/PDS70.yml`` as written, but l0, Sigma0, the
    grid and the semi-major axes; the output cadence is the cell's."""
    cfg = harness.load_config(CONFIG)
    assert cfg["reference"] == "fargo_planets" and cfg["reduced"] == []
    assert cfg["dtype"] == "float64"
    text = (ROOT / "setups" / "PDS70.yml").read_text()
    file = shipped()
    cadence = {"Nsnapshots", "Nmonitor", "MonitorTimestep"}
    assert set(cfg["setup"]) == set(file) - cadence
    assert cadence == set(harness.load_cell(CELL)["output"])
    for key, value in cfg["setup"].items():
        if key in MOVED:
            assert value == MOVED[key]
        elif key != "nbody":
            assert f"\n{key}: {value}\n" in text, key
    for body, axis, given in zip(cfg["setup"]["nbody"], AXES, file["nbody"]):
        assert body["semi-major axis"] == axis
        assert {k: str(v) for k, v in given.items()
                if k != "semi-major axis"} == {
            k: v for k, v in body.items() if k != "semi-major axis"}


def test_configuration_keeps_the_files_physics_in_code_units():
    """Sigma0, h, flaring, alpha and the bodies' masses in code units are
    the file's; both planets' pericentre and apocentre lie inside [Rmin,
    Rmax], where the file as shipped puts their orbits 7-12 times beyond
    Rmax."""
    moved = port_sim(setup())
    as_shipped = port_sim({**shipped(), **SMALL})
    a, b = moved.phys, as_shipped.phys
    assert a.sigma0 == pytest.approx(b.sigma0, rel=1e-5)
    assert (a.aspectratio_ref, a.flaring_index, a.viscous_alpha) \
        == (b.aspectratio_ref, b.flaring_index, b.viscous_alpha)
    assert [x.mass for x in moved.bodies] == [x.mass for x in
                                              as_shipped.bodies]
    rmin, rmax = moved.geometry.rmin, moved.geometry.rmax
    for planet in moved.bodies[1:]:
        a_p, e = planet.semi_major_axis, planet.eccentricity
        assert rmin < a_p * (1.0 - e) and a_p * (1.0 + e) < rmax
    for planet in as_shipped.bodies[1:]:
        assert planet.semi_major_axis > 7.0 * rmax
    x = moved.state.nbody.x.tolist()
    assert x[0] == pytest.approx(0.0, abs=1e-15)
    assert x[1:] == pytest.approx([0.830, 1.288], abs=1e-3)


def test_reference_follows_the_port_through_a_monitor_row():
    """The port and ``fargo_planets`` from the configuration at 16x32,
    through the warm-up and a monitor row: the fields, Q+ and Q-, the
    time, the bodies, the frame and the swarm, bit for bit."""
    cfg = setup({"MonitorTimestep": "0.0314"})
    a = port_sim(cfg)
    ref = reference()
    b = ref.sim.Simulation(ref.config.Config.from_dict(dict(cfg)),
                           device="cpu")
    steps = harness.load_cell(CELL)["warmup_steps"]
    for sim in (a, b):
        sim.begin()
        harness.warm_up(sim, steps)
        sim.advance_monitor(8)
    assert a.n_monitor == b.n_monitor >= 1
    assert float(a.time) == float(b.time)
    for k in ("sigma", "vrad", "vaz", "energy"):
        assert torch.equal(getattr(a.fields, k), getattr(b.fields, k)), k
    for k in ("qplus", "qminus", "omega_frame", "frame_angle"):
        assert torch.equal(getattr(a.state, k), getattr(b.state, k)), k
    for k in ("x", "y", "vx", "vy", "mass"):
        assert torch.equal(getattr(a.state.nbody, k),
                           getattr(b.state.nbody, k)), k
    pa, pb = a.state.particles, b.state.particles
    assert int(pa.alive.sum()) > 32
    for k in ("r", "phi", "r_dot", "phi_dot", "alive"):
        assert torch.equal(getattr(pa, k), getattr(pb, k)), k


@pytest.mark.parametrize("change, name", [
    ({"nbody.1": {"accretion efficiency": "1"}}, "accretion onto bodies"),
    ({"Frame": "C"}, "a corotating frame"),
    ({"Integrator": "LeapFrog"}, "the leapfrog"),
    ({"InnerBoundary": "centerofmass"}, "the centerofmass or custom boundary"),
    ({"EquationOfState": "PVTE"}, "PVTE"),
    ({"RadiativeDiffusion": "yes"}, "FLD"),
    ({"SelfGravity": "yes", "SelfGravityMode": "symmetric"},
     "self-gravity"),
    ({"NbodyIntegrator": "rk4"}, "an N-body integrator other than IAS15"),
    ({"DampingEnergyInner": "mean"},
     "damping toward a target other than the initial state"),
])
def test_reference_refuses_by_name_what_it_lacks(change, name):
    cfg = setup()
    cfg["nbody"] = [dict(body) for body in cfg["nbody"]]
    for key, value in change.items():
        if key.startswith("nbody."):
            cfg["nbody"][int(key[6:])].update(value)
        else:
            cfg[key] = value
    ref = reference()
    with pytest.raises(ValueError, match="does not cover") as err:
        ref.sim.Simulation(ref.config.Config.from_dict(cfg), device="cpu")
    assert name in str(err.value).split(": ", 1)[1].split(", ")


def run(seed=SEED, **kw):
    """One untraced run of the cell at 16x32: the window is one call."""
    return harness.run_cell(CELL, seed, 0.0, False, time.perf_counter(),
                            device="cpu", overrides=SMALL, **kw)


def failed(result):
    return {k for k, c in result["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]}


@pytest.fixture(scope="module")
def sound():
    return run()


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert set(sound["checks"]) == {"start_gap", "end_gap", "time_gap",
                                    "swarm_gap", "bodies_gap"}
    assert sound["attempted"] > 0 and sound["failed"] == 0


def test_control_float32_is_not_correct():
    r = run(dtype="float32")
    assert not r["correct"]
    assert {"start_gap", "end_gap", "bodies_gap"} <= failed(r)


def test_planted_body_fault_reads_bodies_gap(sound, monkeypatch):
    """Planet c's x times (1 + 1e-9) in the window's last step: only
    bodies_gap reads it, at ~1e-9 (c is the body farthest out)."""
    from fargocpt_torch import step
    last = harness.load_cell(CELL)["warmup_steps"] + sound["attempted"]
    honest = step.HydroStep.step
    calls = [0]

    def planted(self, state, time, dt):
        out = honest(self, state, time, dt)
        calls[0] += 1
        if calls[0] != last:
            return out
        x = out.nbody.x.clone()
        x[2] *= 1.0 + 1e-9
        return out.replace(nbody=out.nbody.replace(x=x))

    monkeypatch.setattr(step.HydroStep, "step", planted)
    r = run()
    assert calls[0] == last
    assert failed(r) == {"bodies_gap"}
    assert r["checks"]["bodies_gap"]["value"] == pytest.approx(1e-9,
                                                               rel=1e-3)


def readers():
    return {name: harness.load_reader(name)
            for name in ("bodies_ms_per_step", "artvisc_ms_per_step")}


def test_readers_see_every_call_of_the_step(tmp_path):
    """Under the readers' wrappers and a profiler, over steps that cross
    a monitor row with the writer on: each wrapped callable opens its
    range as often as the port's own span inside it opens (the disk's
    indirect term once a step), and each predictor holds the first of
    each pair of ``integrate`` calls."""
    from fargocpt_torch.output import OutputWriter
    cfg = setup({"MonitorTimestep": "0.0314"})
    sim = port_sim(cfg)
    writer = OutputWriter(sim, str(tmp_path / "out"))
    sim.begin()
    harness.warm_up(sim, 10)
    specs = [s for r in readers().values() for s in r.SPANS]
    with trace.wrapped(specs):
        prof = trace.profile_start("cpu")
        n0 = sim.n_monitor
        sim.advance_monitor(16)
        sim.advance_monitor(16)
        prof.stop()
    writer.close()
    assert sim.n_monitor > n0
    events = trace.trace_events(prof)

    def ranges(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") == "user_annotation"
                      and e["name"] == name)

    def pb(spec):
        return ranges(trace.span_label(spec))
    bodies = {s[2]: s for s in readers()["bodies_ms_per_step"].SPANS}
    (artvisc,) = readers()["artvisc_ms_per_step"].SPANS
    for attr, span in (("integrate", "nbody.ias15"),
                       ("indirect_term_nbody_predictor",
                        "gravity.indirect_term"),
                       ("disk_on_body_accel", "gravity.disk_on_bodies"),
                       ("indirect_term_disk", "step.step"),
                       ("nbody_potential", "gravity.nbody_potential"),
                       ("bodies_on_grid", "step.bodies_on_grid")):
        assert len(pb(bodies[attr])) == len(ranges("fc:" + span)) > 0, attr
    assert len(pb(artvisc)) == len(ranges("fc:artvisc.tw")) > 0
    integ = pb(bodies["integrate"])
    pred = pb(bodies["indirect_term_nbody_predictor"])
    assert len(integ) == 2 * len(pred)
    for (a, b), (c, d) in zip(pred, integ[0::2]):
        assert a <= c and d <= b
    for (a, b), (c, d) in zip(pred, integ[1::2]):
        assert d < a or b < c


def test_bodies_reader_counts_the_predictors_integration_once():
    from port_bench.trace import TraceReadings, span_label
    mod = readers()["bodies_ms_per_step"]
    tr = TraceReadings(nr=1, naz=1, dtype=torch.float64, traced_steps=2)
    spans = {span_label(s): [] for s in mod.SPANS}
    spans[span_label(mod.INTEGRATE)] = [1e-3, 2e-3, 1e-3, 2e-3]
    spans[span_label(mod.PREDICTOR)] = [1.5e-3, 1.5e-3]
    spans[span_label(mod.SPANS[2])] = [4e-3, 4e-3]
    tr.spans = spans
    assert mod.read(tr) == pytest.approx(1e3 * (6e-3 + 3e-3 + 8e-3 - 2e-3)
                                         / 2)
    spans[span_label(mod.PREDICTOR)] = [1.5e-3]
    assert mod.read(tr) is None
    tr.spans = {}
    assert mod.read(tr) is None
    assert readers()["artvisc_ms_per_step"].read(tr) is None


def test_reference_loads_neither_jax_nor_the_port():
    probe = ("import json, sys; sys.path.insert(0, {root!r})\n"
             "import port_bench.reference.fargo_planets.sim\n"
             "print(json.dumps(sorted({{m.split('.')[0] "
             "for m in sys.modules}})))").format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "port_bench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "fargocpt_tpu",
                         "fargocpt_torch"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [0, 1])
def test_planets_cell_on_the_card(cuda, traced):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 5), "--seconds", "3", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    kind = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in harness.cell_metrics(
        harness.load_manifest(), CELL, kind)}
    assert names <= set(result["metrics"])
    if traced:
        assert result["metrics"]["host_syncs_per_step"]["value"] == \
            result["metrics"]["host_syncs_counted_per_step"]["value"]
    assert math.isfinite(result["metrics"].get(
        "mcell_updates_per_s", result["metrics"].get(
            "bodies_ms_per_step"))["value"])
