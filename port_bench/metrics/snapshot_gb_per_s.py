"""snapshot_gb_per_s: the bytes of the snapshots written in the window
over their host seconds, in 1e9 bytes a second, from the program's own
snapshot records (``fargocpt_torch.telemetry.SNAPSHOTS``: the copy to the
host, the native writer's dumps and their flush), the last as many as
the harness timed in the window. None where the window wrote none or the
program keeps no such records."""

from port_bench import program

SPANS = ()


def read(tr):
    recs = program.snapshots(len(tr.snapshot_stalls_s))
    if not recs:
        return None
    seconds = sum(r.seconds for r in recs)
    if seconds <= 0.0:
        return None
    return sum(r.bytes for r in recs) / seconds / 1e9
