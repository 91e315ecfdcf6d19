"""device_idle_pct: the share of the traced window's wall time in which no
kernel, copy or set runs on the card: 100 (1 - busy / window), busy the
union of the device intervals of the profiler's trace, not their sum. The
profiler's own cost on the host lengthens the traced window, so the share
reads above that of an untraced window."""

SPANS = ()


def read(tr):
    if tr.busy_s <= 0.0 or tr.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
