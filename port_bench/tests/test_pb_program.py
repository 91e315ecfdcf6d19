"""The readers of the program's own measurement (``port_bench/program.py``
and the metrics that use it) on the CPU at the small size: each gives a
number where its docstring says it does, and None where it says it does
not (off the card, outside its cells, with a window that does not add
up)."""

import time

import pytest
import torch

from port_bench import harness, trace

SMALL = {"Nrad": "16", "Naz": "32"}
CELLS = {
    "adiabatic_disk.run": {},
    "pvte_fld_sg_dust.run": {"NumberOfParticles": "64"},
    "adiabatic_disk.snap": {"MonitorTimestep": "0.01", "Nmonitor": "2"},
}
NEW = ("host_syncs_counted_per_step", "fld_sor_iters_per_step",
       "snapshot_gb_per_s")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_new_readers_on_a_traced_cpu_run(cell):
    r = harness.run_cell(cell, 2 ** 31 + 11, 0.3, True, time.perf_counter(),
                         device="cpu", overrides={**SMALL, **CELLS[cell]})
    assert r["correct"], r["checks"]
    got = r["metrics"]
    # the host loop's syncs: counted on the CPU too, at least the landing
    # test a step and the dt statistics a call
    assert got["host_syncs_counted_per_step"]["value"] > 1.0
    if cell == "pvte_fld_sg_dust.run":
        assert got["fld_sor_iters_per_step"]["value"] >= 1.0
    else:
        assert "fld_sor_iters_per_step" not in got
    if cell == "adiabatic_disk.snap":
        assert r["window"]["snapshots"] >= 1
        assert got["snapshot_gb_per_s"]["value"] > 0.0
    else:
        assert "snapshot_gb_per_s" not in got

def test_readers_give_none_where_the_window_does_not_add_up():
    tr = trace.TraceReadings(nr=16, naz=32, dtype=torch.float64)
    for name in NEW:
        assert harness.load_reader(name).read(tr) is None
    tr.traced_steps = 10 ** 9          # more steps than any record holds
    tr.snapshot_stalls_s = [1.0] * 10 ** 4
    for name in NEW:
        assert harness.load_reader(name).read(tr) is None
