"""One traced run of a benchmark cell, read through the port's own spans:
where the card idles by the innermost ``fc:`` span the host was in, the
host syncs by site, each span's calls and times, and each snapshot's
parts beside the harness's clock around its hook.

    python tools/idle_by_span.py --workload adiabatic_disk.run \
        --seed 7 --seconds 51 [--out chiprun_out/idle.json]

It runs ``port_bench/run.py``'s ``main`` with ``--trace 1`` in this
process (its result line is printed as the command prints it), keeping
the profiler's events, then splits every idle stretch of the card inside
the traced calls by the innermost span open on the host at each instant
(not by a stretch's midpoint). A span's device time is the sum of the
kernels launched inside it (tied by the launch's correlation id), nested
spans included. Needs a CUDA device and a program with
``fargocpt_torch.telemetry``.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def innermost_segments(spans):
    """(start, end, name) pieces of time, each labelled with the innermost
    of the properly nested ``spans`` (start, end, name) open then."""
    segs, stack = [], []

    def close_until(t):
        while stack and stack[-1][1] <= t:
            _, end, name, cursor = stack.pop()
            if cursor < end:
                segs.append((cursor, end, name))
            if stack:
                stack[-1][3] = end

    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(start)
        if stack:
            top = stack[-1]
            if top[3] < start:
                segs.append((top[3], start, top[2]))
            top[3] = end
        stack.append([start, end, name, start])
    close_until(float("inf"))
    return sorted(segs)


def idle_stretches(events, lo, hi):
    """The stretches of [lo, hi] in which no device interval runs."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in events if e.get("cat") in DEVICE_CATS)
    out, t = [], lo
    for a, b in dev:
        if b <= t:
            continue
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def host_spans(events):
    """(start, end, name) of the ``fc:`` ranges on the host thread of the
    root span ``sim.advance_monitor`` (the device-side annotations of the
    same names sit on the streams' timelines), and the roots."""
    fc = [e for e in events if str(e.get("name", "")).startswith("fc:")
          and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    roots = [e for e in fc if e["name"] == "fc:sim.advance_monitor"]
    if not roots:
        return [], []
    tid = roots[0].get("tid")
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][3:])
            for e in fc if e.get("tid") == tid], roots


def kernel_us_by_span(events) -> dict:
    """Microseconds of the kernels launched inside each span name's ranges
    (every enclosing range counts a kernel, as ``port_bench/trace.py``'s
    ``read_ranges`` counts one for its ranges)."""
    spans, roots = host_spans(events)
    if not spans:
        return {}
    tid = roots[0].get("tid")
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS and e.get("tid") == tid
                and e.get("args", {}).get("correlation") is not None}
    kernels = sorted((launches[e["args"]["correlation"]],
                      float(e.get("dur", 0.0))) for e in events
                     if e.get("cat") == "kernel"
                     and e.get("args", {}).get("correlation") in launches)
    starts = [t for t, _ in kernels]
    out: dict[str, float] = {}
    for a, b, name in spans:
        i, j = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        out[name] = out.get(name, 0.0) + sum(d for _, d in kernels[i:j])
    return out


def idle_by_span(events) -> dict:
    """Microseconds of the card's idle inside the traced calls, by the
    innermost program span the host was in."""
    spans, roots = host_spans(events)
    if not roots:
        return {}
    lo = min(float(e["ts"]) for e in roots)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in roots)
    segs = innermost_segments(spans)
    out: dict[str, float] = {}
    for a, b in idle_stretches(events, lo, hi):
        covered = 0.0
        for s0, s1, name in segs:
            if s1 <= a:
                continue
            if s0 >= b:
                break
            piece = min(b, s1) - max(a, s0)
            if piece > 0:
                out[name] = out.get(name, 0.0) + piece
                covered += piece
        if b - a - covered > 1e-9:
            out["(between the calls)"] = out.get("(between the calls)", 0.0) \
                + (b - a - covered)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "port_bench"))
    import run as bench_run
    from port_bench import trace
    from fargocpt_torch import telemetry

    kept, stall_lists = [], []
    trace_events, timed_hook = trace.trace_events, trace.timed_hook

    def keeping(prof):
        events = trace_events(prof)
        kept.append(events)
        return events

    def hooked(hook, stalls, on_call=None):
        stall_lists.append(stalls)
        return timed_hook(hook, stalls, on_call)
    trace.trace_events, trace.timed_hook = keeping, hooked
    n_rec, n_snap = len(telemetry.RECORDS), len(telemetry.SNAPSHOTS)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.main(["--workload", args.workload, "--seed",
                             str(args.seed), "--seconds", str(args.seconds),
                             "--trace", "1"])
    line = out.getvalue().strip().splitlines()[-1] if rc == 0 else "{}"
    print(line, flush=True)
    if rc != 0:
        return rc
    result = json.loads(line)
    recs = list(telemetry.RECORDS)[n_rec:]
    steps = sum(r.steps for r in recs)
    syncs, spans = {}, {}
    for r in recs:
        for k, v in r.counters.items():
            if k.startswith("sync."):
                syncs[k[5:]] = syncs.get(k[5:], 0) + v
        for name, st in r.spans.items():
            row = spans.setdefault(name, {"calls": 0, "host_ms": 0.0})
            row["calls"] += st.calls
            row["host_ms"] += 1e3 * st.host_s
    per = max(steps, 1)
    kernel_us = kernel_us_by_span(kept[0]) if kept else {}
    idle = idle_by_span(kept[0]) if kept else {}
    idle_total = sum(idle.values())
    n = result["window"]["snapshots"]
    snaps = list(telemetry.SNAPSHOTS)[n_snap:][-n:] if n else []
    stalls = stall_lists[0][-n:] if stall_lists and n else []
    report = {
        "workload": args.workload, "seed": args.seed,
        "device": result["device"], "traced_steps": steps,
        "traced_ms_per_step": 1e3 * result["device"]["window_s"] / per,
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "idle_ms_per_step_by_span": {k: v / 1e3 / per
                                     for k, v in idle.items()},
        "idle_share_outside_root": (
            1.0 - idle.get("sim.advance_monitor", 0.0) / idle_total
            - idle.get("(between the calls)", 0.0) / idle_total)
        if idle_total else None,
        "syncs_per_step_by_site": {k: v / per for k, v in
                                   sorted(syncs.items(), key=lambda kv:
                                          -kv[1])},
        "spans_per_step": {k: {"calls": v["calls"] / per,
                               "host_ms": v["host_ms"] / per,
                               "kernel_ms": kernel_us.get(k, 0.0) / 1e3 / per}
                           for k, v in spans.items()},
        "snapshots": [{"bytes": s.bytes, "seconds": s.seconds,
                       "parts": s.parts, "hook_seconds": h}
                      for s, h in zip(snaps, stalls)],
        "window": result["window"], "checks": result["checks"],
        "breakdown": result.get("breakdown"),
    }
    text = json.dumps(report, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
