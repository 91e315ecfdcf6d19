"""One run of one benchmark cell: set-up, the measured window on the
port's run path, the traced readings, and the comparison with the plain
reference.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration and its metrics; ``configs/<config>.json`` holds the
setup as it is run, ``cells/<cell>.json`` the traffic (the output
cadence, the warm-up, the steps of one call, the perturbation, the
limits), ``metrics/<metric>.py`` the reader of each per-layer metric, and
``reference/<name>/`` the plain reference that a configuration names
(``load_reference``). A later cell, configuration, metric or reference is
new files and new entries, with no edit here.

The window is the run path users run (``python -m fargocpt_torch
start``): a ``Simulation`` with an ``OutputWriter`` on an output
directory, ``begin()``, then ``advance_monitor(max_steps=chunk_steps)``
(``HydroStep.advance_to``) until the window's seconds have passed; the
last call's end, which reads its statistics to the host, closes it.
"""

from __future__ import annotations

import ast
import gc
import hashlib
import importlib
import importlib.util
import json
import math
import random
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import check, trace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "configs" / f"{name}.json") as f:
        return json.load(f)


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "cells" / f"{name}.json") as f:
        return json.load(f)


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The reader module of a per-layer metric, ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# what a reference package must hold: each module, by its file under the
# package, with the top-level names the harness and the check take from it
REFERENCE_PARTS = {
    "__init__.py": (),
    "config.py": ("Config",),
    "sim.py": ("Simulation",),
    "state.py": ("FieldState", "SystemState", "MonitorAccum"),
    "nbody/system.py": ("NBodyState",),
    "particles/dust.py": ("ParticleState",),
    "ops/eos.py": ("temperature",),
    "scope.py": ("refuse_outside",),
}


def reference_name(config: dict) -> str:
    """The plain reference a configuration names (its optional key
    ``reference``), ``fargo_plain`` where it names none."""
    return config.get("reference", "fargo_plain")


def reference_missing(name: str, bench_dir: Path = BENCH_DIR) -> list[str]:
    """The parts of the contract that ``reference/<name>/`` lacks, by
    reading its files without importing them; empty where it has all.

    The contract: a package of plain PyTorch that imports neither JAX nor
    the program, with
    ``config.Config`` (``Config.from_dict(setup)``, the setup as it is
    run); ``sim.Simulation`` (``Simulation(config, dtype=, device=)``
    with the program's ``begin()``, ``advance_monitor(max_steps)``,
    ``state``, ``fields``, ``time``, ``last_dt``, ``n_monitor``,
    ``n_hydro_iter``, ``monitor_stats``, ``device``, ``dtype``, ``phys``,
    ``constants`` and ``stepper.pvte``/``stepper.pvte_vals``);
    ``state.FieldState``, ``state.SystemState`` and ``state.MonitorAccum``,
    ``nbody.system.NBodyState`` and ``particles.dust.ParticleState``,
    dataclasses whose fields are the program's by name (the program's
    state is rebuilt in them); ``ops.eos.temperature`` (a snapshot's
    temperature); and ``scope.refuse_outside``, which its ``Simulation``
    calls to refuse a setup outside what the copy covers.
    """
    if not (isinstance(name, str) and name.isidentifier()):
        return [f"a package name, not {name!r}"]
    root = bench_dir / "reference" / name
    missing = []
    for rel, names in REFERENCE_PARTS.items():
        path = root / rel
        if not path.is_file():
            missing.append(rel)
            continue
        defined = set()
        for node in ast.parse(path.read_text(), str(path)).body:
            if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
                defined.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                defined.update((a.asname or a.name).split(".")[0]
                               for a in node.names)
            elif isinstance(node, ast.Assign):
                defined.update(t.id for t in node.targets
                               if isinstance(t, ast.Name))
        missing += [f"{rel[:-3].replace('/', '.')}.{n}" for n in names
                    if n not in defined]
    return missing


def load_reference(name: str, bench_dir: Path = BENCH_DIR):
    """The package ``reference/<name>/`` under ``bench_dir``, imported from
    its files with the modules of the contract (``reference_missing``), so
    that a checkout runs its own copy. Its module name is made from its
    path: two checkouts' copies never share a module."""
    path = (bench_dir / "reference" / name).resolve()
    modname = f"port_bench_reference_{name}_" \
        + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    if modname not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            modname, path / "__init__.py",
            submodule_search_locations=[str(path)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[modname] = pkg
        spec.loader.exec_module(pkg)
    for rel in REFERENCE_PARTS:
        if rel != "__init__.py":
            importlib.import_module(
                f"{modname}.{rel[:-3].replace('/', '.')}")
    return sys.modules[modname]


def cell_metrics(manifest: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without a ``workloads`` key and those that list it."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


def setup_dict(config: dict, cell: dict, seed: int,
               overrides: dict | None = None) -> dict:
    """The configuration as it is run: the setup, the cell's output
    cadence, the seed of the swarm's draw, and ``overrides`` (the tests'
    small grids)."""
    return {**config["setup"], **cell["output"],
            "RandomSeed": str(seed % (2 ** 63)), **(overrides or {})}


def perturbation(seed: int, fields, device) -> dict:
    """The seeded noise on the initial fields, drawn on ``device`` in
    float64: u in [-1, 1) per cell (the disk is axisymmetric, which would
    leave the azimuthal stencils and the FARGO shift untested). The same
    ``seed`` gives both sides the same draw."""
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    return {k: 2.0 * torch.rand(getattr(fields, k).shape, generator=gen,
                                device=device, dtype=torch.float64) - 1.0
            for k in check.FIELDS}


def perturbed(fields, noise: dict, amp: dict):
    """The fields with the noise: sigma and energy take a relative ``amp``
    of it, v_rad and v_az an added one."""
    def rel(t, u, a):
        return t * (1.0 + a * u.to(t.dtype))

    def add(t, u, a):
        return t + a * u.to(t.dtype)
    return fields.replace(
        sigma=rel(fields.sigma, noise["sigma"], amp["sigma_rel"]),
        vrad=add(fields.vrad, noise["vrad"], amp["vrad_add"]),
        vaz=add(fields.vaz, noise["vaz"], amp["vaz_add"]),
        energy=rel(fields.energy, noise["energy"], amp["energy_rel"]))


def warm_up(sim, steps: int) -> None:
    """After ``begin()``, the warm-up calls: dt grows from FirstDT towards
    its CFL value, every shape and writer of the window runs once."""
    while sim.n_hydro_iter < steps:
        sim.advance_monitor(steps - sim.n_hydro_iter)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Kept:
    """Host copies, made once the window has closed, of what the check
    reads: the state at the window's start, before its last call and at
    its end, and a snapshot's state."""

    def __init__(self, sim):
        self.state, self.time = sim.state, sim.time
        self.last_dt, self.n_monitor = sim.last_dt, sim.n_monitor
        self.n_hydro_iter = sim.n_hydro_iter

    def to_host(self):
        self.state = check.to_host(self.state)
        self.time = float(self.time)
        self.last_dt = check.to_host(self.last_dt)
        return self

    def load_into(self, sim, classes: dict) -> None:
        sim.state = check.to_reference(self.state, classes, sim.device,
                                       sim.dtype)
        sim.time = torch.tensor(self.time, dtype=sim.dtype,
                                device=sim.device)
        sim.last_dt = self.last_dt.to(sim.device, sim.dtype)
        sim.n_monitor, sim.n_hydro_iter = self.n_monitor, self.n_hydro_iter
        sim._dt_primed = True


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             t_process: float, device: str = "cuda",
             dtype: str | None = None, overrides: dict | None = None,
             root: Path = ROOT) -> dict:
    """One run of ``workload``; returns the result line's object, with
    the window's own numbers under ``window``. ``dtype``
    runs the program in another precision than the configuration's (the
    control); ``overrides`` replace setup keys (the tests' small grids).
    A configuration whose reference lacks a part of the contract
    (``reference_missing``) raises ValueError before anything is built."""
    bench_dir = root / "port_bench"
    manifest = load_manifest(root)
    cell = load_cell(workload, bench_dir)
    config = load_config(cell["config"], bench_dir)
    missing = reference_missing(reference_name(config), bench_dir)
    if missing:
        raise ValueError(
            f"configuration {cell['config']!r} names the reference "
            f"{reference_name(config)!r}, which lacks: {', '.join(missing)}")
    setup = setup_dict(config, cell, seed, overrides)
    dtype = dtype or config["dtype"]

    from fargocpt_torch.config import Config
    from fargocpt_torch.output import OutputWriter
    from fargocpt_torch.sim import Simulation

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    outdir = Path(tempfile.mkdtemp(prefix="port_bench_"))
    readers = {m["name"]: load_reader(m["name"], bench_dir)
               for m in cell_metrics(manifest, workload, "per_layer")} \
        if traced else {}
    specs = [s for r in readers.values() for s in getattr(r, "SPANS", ())]
    labels = {trace.span_label(s) for s in specs}
    writer = None
    parts = {"imports": time.perf_counter() - t_process}
    try:
        sim = Simulation(Config.from_dict(dict(setup)), outdir=str(outdir),
                         dtype=dtype, device=device)
        sync(device)
        parts["simulation"] = time.perf_counter() - t_process
        noise = perturbation(seed, sim.fields, device)
        sim.state = sim.state.replace(fields=perturbed(
            sim.fields, noise, cell["perturbation"]))
        del noise
        writer = OutputWriter(sim)
        parts["writer"] = time.perf_counter() - t_process
        tr = trace.TraceReadings(nr=sim.geometry.nrad, naz=sim.geometry.naz,
                                 dtype=sim.dtype)
        snapshots = []
        in_window = [False]

        def keep_snapshot(s):
            if in_window[0]:
                snapshots.append((s.n_snapshot, Kept(s)))
        stalls = []
        sim.snapshot_hooks[:] = [trace.timed_hook(h, stalls, keep_snapshot)
                                 for h in sim.snapshot_hooks]
        with trace.wrapped(specs):
            sim.begin()
            sync(device)
            parts["begin"] = time.perf_counter() - t_process
            warm_up(sim, cell["warmup_steps"])
            sync(device)
            start = Kept(sim)
            start_snapshot = sim.n_snapshot
            t0 = time.perf_counter()
            setup_s = t0 - t_process
            time0 = float(sim.time)
            stalls.clear()
            in_window[0] = True
            steps, calls, chunk = 0, 0, cell["chunk_steps"]
            n_trace = cell["trace_chunks"] if traced else 0
            prof = None
            while True:
                before = Kept(sim)
                phase, k = divmod(calls, n_trace) if n_trace else (2, 0)
                if phase == 0:
                    # the traced window: the card's and the host's activity
                    if k == 0:
                        prof = trace.profile_start(device)
                        t_tr = time.perf_counter()
                    sim.advance_monitor(chunk)
                    tr.traced_steps += sim.monitor_stats["n_steps"]
                    if k == n_trace - 1:
                        sync(device)
                        tr.window_s = time.perf_counter() - t_tr
                        prof.stop()
                elif phase == 1:
                    # the next as many calls counting the host syncs
                    with trace.counting_syncs(tr, device):
                        sim.advance_monitor(chunk)
                    tr.sync_steps += sim.monitor_stats["n_steps"]
                else:
                    sim.advance_monitor(chunk)
                steps += sim.monitor_stats["n_steps"]
                calls += 1
                if time.perf_counter() - t0 >= seconds \
                        and calls >= 2 * n_trace:
                    break
            sync(device)
            window_s = time.perf_counter() - t0
            in_window[0] = False
        time1 = float(sim.time)
        last_steps = sim.monitor_stats["n_steps"]
        end = Kept(sim)
        memory_peak = torch.cuda.max_memory_allocated() \
            if torch.device(device).type == "cuda" else 0
        nr, naz = sim.geometry.nrad, sim.geometry.naz
        metrics = {
            "mcell_updates_per_s": nr * naz * steps / window_s / 1e6,
            "s_per_orbit": window_s * 2.0 * math.pi / (time1 - time0),
            "setup_s": setup_s,
        }
        if traced:
            tr.snapshot_stalls_s = list(stalls)
            trace.read_profile(prof, labels, tr)
        writer.close()
        writer = None

        # the program's state to the host, then freed
        for k in (start, before, end):
            k.to_host()
        # a snapshot is due where the window crossed a snapshot boundary
        snap = {} if sim.n_snapshot > start_snapshot else None
        if snapshots:
            sid, kept = snapshots[random.Random(seed).randrange(
                len(snapshots))]
            snap = {"files": check.read_snapshot(
                        outdir / "snapshots" / str(sid), nr, naz),
                    "kept": {k: getattr(kept.state.fields, k).detach().cpu()
                             for k in check.FIELDS}}
            snap["kept"]["time"] = float(kept.time)
        del sim, snapshots
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

        ref = load_reference(reference_name(config), bench_dir)
        readings = compare(ref, config, cell, setup, seed, device, start,
                           before, end, last_steps, snap)
    finally:
        if writer is not None:
            writer.close()
        shutil.rmtree(outdir, ignore_errors=True)

    limits = cell["limits"]
    correct = all(readings[k] is not None and readings[k] <= limits[k]
                  for k in limits)
    per_layer = {}
    for name, reader in readers.items():
        value = reader.read(tr)
        if value is not None:
            per_layer[name] = value
    units = {m["name"]: m["unit"] for k in ("end_to_end", "per_layer")
             for m in manifest[k]}
    reported = per_layer if traced else {
        m["name"]: metrics[m["name"]]
        for m in cell_metrics(manifest, workload, "end_to_end")}
    result = {
        "correct": correct,
        "attempted": steps,
        "failed": 0 if correct else steps,
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in reported.items()},
        "device": {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name()
                   if device == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak},
    }
    if traced:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown
    result["window"] = {"steps": steps, "seconds": window_s,
                        "simulated_time": time1 - time0,
                        "dt_at_start": float(start.last_dt),
                        "dt_at_end": float(end.last_dt),
                        "mean_dt": (time1 - time0) / max(steps, 1),
                        "snapshots": len(stalls),
                        "setup_parts_s": parts,
                        "end_to_end": metrics}
    result["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                        for k in limits}
    return result


def compare(reference, config, cell, setup, seed, device, start, before,
            end, last_steps, snap) -> dict:
    """The readings of the reference package ``reference`` (``check``):
    from its own initial conditions through the warm-up, from the
    program's state before the window's last call through that call, and
    the snapshot."""
    classes = check.reference_classes(reference)
    ref = reference.sim.Simulation(
        reference.config.Config.from_dict(dict(setup)),
        dtype=config["dtype"], device=device)
    amp = cell["perturbation"]
    noise = perturbation(seed, ref.fields, device)
    ref.state = ref.state.replace(fields=perturbed(ref.fields, noise, amp))
    del noise
    ref.begin()
    warm_up(ref, cell["warmup_steps"])
    out = {"start_gap": check.fields_gap(start.state.fields, ref.fields)}
    t_gap = check.time_gap(start.time, ref.time)
    s_gap = check.swarm_gap(start.state.particles, ref.state.particles)
    b_gap = check.bodies_gap(start.state, ref.state)

    before.load_into(ref, classes)
    ref.advance_monitor(cell["chunk_steps"])
    out["end_gap"] = check.fields_gap(end.state.fields, ref.fields)
    if ref.monitor_stats["n_steps"] != last_steps:
        out["end_gap"] = math.inf
    t_gap = check.worst(t_gap, check.time_gap(end.time, ref.time))
    s_gap = check.worst(s_gap, check.swarm_gap(end.state.particles,
                                               ref.state.particles))
    b_gap = check.worst(b_gap, check.bodies_gap(end.state, ref.state))
    out["time_gap"] = t_gap
    if "swarm_gap" in cell["limits"]:
        out["swarm_gap"] = s_gap
    if "bodies_gap" in cell["limits"]:
        out["bodies_gap"] = b_gap
    if "snap_gap" in cell["limits"]:
        # none due: nothing to compare; due and not written: never came
        out["snap_gap"] = 0.0 if snap is None else math.inf if not snap \
            else check.snapshot_gap(snap["files"], snap["kept"], ref,
                                    reference.ops.eos)
    return {k: (v if math.isfinite(v) else None) for k, v in out.items()}
