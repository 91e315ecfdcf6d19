"""What the per-layer readers of the program's own measurement take from
it: ``fargocpt_torch.telemetry``'s records of the calls made under the
profiler, which are the traced window's calls (the profiler's start and
stop bracket them), and its snapshot records.

A program without that module, or whose records do not add up to the
traced window's steps, reads as nothing: every function here returns
None rather than raise."""

from __future__ import annotations


def _telemetry():
    try:
        from fargocpt_torch import telemetry
    except ImportError:
        return None
    return telemetry


def window(tr):
    """The program's records of the traced window's calls, oldest first;
    None unless their steps sum to ``tr.traced_steps``."""
    tm = _telemetry()
    if tm is None or tr.traced_steps <= 0 or not hasattr(tm, "window"):
        return None
    return tm.window(tr.traced_steps)


def counter_per_step(tr, prefix: str):
    """The traced window's deltas of the counters named ``prefix`` or
    starting with ``prefix`` + ".", summed, per hydro step."""
    recs = window(tr)
    if not recs:
        return None
    total = sum(v for r in recs for k, v in r.counters.items()
                if k == prefix or k.startswith(prefix + "."))
    return total / tr.traced_steps


def snapshots(n: int):
    """The program's records of the last ``n`` snapshots; None where it
    kept fewer, or ``n`` is 0."""
    tm = _telemetry()
    kept = list(getattr(tm, "SNAPSHOTS", ())) if tm is not None else []
    if n <= 0 or len(kept) < n:
        return None
    return kept[-n:]
