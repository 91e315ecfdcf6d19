"""What a traced run reads: profiler ranges around the program's calls,
the device's kernel intervals, the host syncs, and the host clock around
the snapshot hooks.

Everything here is the benchmark's own, so that no change to the program
moves it. The program's functions are wrapped from outside, attribute by
attribute, in ``torch.profiler.record_function`` ranges (the method of
the port's ``profile_step.phases``); a metric's reader names the calls it
needs in its ``SPANS``. The profiler's trace is read from its Chrome-trace
export: each device kernel is tied to the range whose host interval holds
its launch (by the launch's correlation id), and the device's busy time is
the union of the kernel, copy and set intervals, not their sum. The host
syncs are counted over the calls that follow the traced ones.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import tempfile
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def span_label(spec: tuple[str, str, str]) -> str:
    """The range name of a span spec (module, owner, attribute); owner ""
    is the module itself."""
    module, owner, attr = spec
    return f"pb:{module}:{owner + '.' if owner else ''}{attr}"


@contextmanager
def wrapped(specs):
    """Wrap each (module, owner, attribute) in a profiler range named by
    ``span_label`` for the duration of the block; the originals are put
    back on exit."""
    undo = []
    try:
        for spec in dict.fromkeys(specs):
            module, owner, attr = spec
            obj = importlib.import_module(module)
            for part in filter(None, owner.split(".")):
                obj = getattr(obj, part)
            fn = getattr(obj, attr)
            label = span_label(spec)

            def inner(*a, __fn=fn, __label=label, **kw):
                with torch.profiler.record_function(__label):
                    return __fn(*a, **kw)

            setattr(obj, attr, inner)
            undo.append((obj, attr, fn))
        yield
    finally:
        for obj, attr, fn in reversed(undo):
            setattr(obj, attr, fn)


@dataclass
class TraceReadings:
    """What the metric readers read: the traced window's, the host syncs'
    calls' and the snapshot hooks'. Times in seconds."""
    nr: int
    naz: int
    dtype: torch.dtype
    traced_steps: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: list = field(default_factory=list)    # (name, seconds)
    # span label -> per call [device seconds launched inside it]
    spans: dict = field(default_factory=dict)
    sync_steps: int = 0
    syncs: int = 0
    snapshot_stalls_s: list = field(default_factory=list)
    breakdown: dict = field(default_factory=dict)


def profile_start(device):
    """A started profiler of the host's ops (the ranges among them) and of
    the card's activity."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def read_profile(prof, labels, tr: TraceReadings) -> None:
    """Fill ``tr`` from the trace of the stopped ``prof``."""
    events = trace_events(prof)
    read_device(events, tr)
    read_ranges(events, labels, tr)


def trace_events(prof) -> list:
    """The complete events of a stopped profiler's Chrome-trace export."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return [e for e in events if e.get("ph") == "X"]


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_intervals(events) -> list:
    """(start, end, name, cat, correlation) of every device event, in
    microseconds."""
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            ts = float(e.get("ts", 0.0))
            out.append((ts, ts + float(e.get("dur", 0.0)), e.get("name", ""),
                        e["cat"], e.get("args", {}).get("correlation")))
    return out


def read_device(events, tr: TraceReadings, top: int = 10) -> None:
    """The union of the device intervals, the kernels, and the device
    operations that took most time, by name."""
    dev = device_intervals(events)
    tr.busy_s = union_s((a, b) for a, b, *_ in dev) / 1e6
    tr.kernels = [(name, (b - a) / 1e6)
                  for a, b, name, cat, _ in dev if cat == "kernel"]
    by_op: dict[str, float] = {}
    for a, b, name, *_ in dev:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    tr.breakdown["device_ops"] = [
        [k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]]


def read_ranges(events, labels, tr: TraceReadings) -> None:
    """The device time launched inside each range whose label is in
    ``labels`` (a kernel belongs to every range, nested ones
    too, whose host interval on its thread holds its launch, tied by the
    launch's correlation id), and the idle gaps by host event."""
    dev = device_intervals(events)
    launches, ranges, host = {}, [], []
    for e in events:
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, e.get("tid"))
        if cat == "user_annotation" and e.get("name") in labels:
            ranges.append((ts, ts + dur, e.get("name"), e.get("tid")))
        if cat in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "")))
    spans = {label: [] for label in labels}
    for a, b, label, tid in sorted(ranges):
        spans[label].append([a, b, tid, 0.0])
    starts = {label: [r[0] for r in rs] for label, rs in spans.items()}
    for a, b, name, cat, corr in dev:
        if cat != "kernel" or corr not in launches:
            continue
        t_launch, tid = launches[corr]
        for label, rs in spans.items():
            i = bisect.bisect_right(starts[label], t_launch)
            # ranges of one label do not overlap, except by recursion
            for r in rs[max(0, i - 2):i]:
                if r[0] <= t_launch <= r[1] and r[2] == tid:
                    r[3] += (b - a) / 1e6
    tr.spans = {label: [r[3] for r in rs] for label, rs in spans.items()}
    tr.breakdown["idle_gaps"] = idle_gaps(dev, host)


def idle_gaps(dev, host, top: int = 10) -> list:
    """The idle gaps between device intervals, summed by the innermost
    host event that holds each gap's middle."""
    host = sorted(host)
    host_starts = [h[0] for h in host]
    gaps: dict[str, float] = {}
    end = None
    for a, b, *_ in sorted(dev):
        if end is not None and a > end:
            mid, name, best = 0.5 * (a + end), "no host event", None
            i = bisect.bisect_right(host_starts, mid)
            for h in host[max(0, i - 400):i]:
                if h[0] <= mid <= h[1] and (best is None
                                            or h[1] - h[0] < best):
                    best, name = h[1] - h[0], h[2]
            gaps[name] = gaps.get(name, 0.0) + (a - end) / 1e6
        end = b if end is None else max(end, b)
    return [[k, v] for k, v in sorted(gaps.items(),
                                      key=lambda kv: -kv[1])[:top]]


@contextmanager
def counting_syncs(tr: TraceReadings, device):
    """Count the host syncs of the block as CUDA's sync debug mode warns of
    them (each ``.item()``, ``bool()``, ``.tolist()`` of a device tensor,
    each blocking copy to the host); none off the card."""
    if torch.device(device).type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tr.syncs += sum(1 for w in caught if "synchroniz" in str(w.message))


def timed_hook(hook, stalls: list, on_call=None):
    """``hook`` with the host clock around each call appended to
    ``stalls``; ``on_call(sim)`` runs after it, outside the clock."""
    def inner(sim):
        t0 = time.perf_counter()
        hook(sim)
        stalls.append(time.perf_counter() - t0)
        if on_call is not None:
            on_call(sim)
    return inner
