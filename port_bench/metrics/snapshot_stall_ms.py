"""snapshot_stall_ms: the host clock around the simulation's snapshot
hooks (``OutputWriter.write_snapshot``: the copy to the host, the native
writer's dumps and their flush), mean per snapshot written in the
window."""

SPANS = ()


def read(tr):
    if not tr.snapshot_stalls_s:
        return None
    return 1e3 * sum(tr.snapshot_stalls_s) / len(tr.snapshot_stalls_s)
