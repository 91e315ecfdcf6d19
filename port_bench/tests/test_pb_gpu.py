"""On the card: one short run of each cell through the benchmark's command
is correct and reports every metric the manifest gives it. Skipped where
there is no CUDA device (``-m gpu`` selects these)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from port_bench import harness


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["adiabatic_disk.run", "pvte_fld_sg_dust.run",
                                  "adiabatic_disk.snap"])
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_on_the_card(cuda, cell, traced):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", "3", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    manifest = harness.load_manifest()
    kind = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in harness.cell_metrics(manifest, cell, kind)}
    if cell == "adiabatic_disk.snap" and traced:
        names.discard("snapshot_stall_ms")     # no snapshot in 3 s
    assert names <= set(result["metrics"])
    assert result["device"]["platform"] == "gpu"
