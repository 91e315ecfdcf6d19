"""The benchmark is driven by data: every cell, configuration and
per-layer metric of BENCHMARK.json is found from its files, and one added
in a copy is run with no edit of the harness."""

import json
import re
import shutil
import time

import pytest

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"Nrad": "16", "Naz": "32"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_manifest_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "port_bench/run.py"]
    assert manifest["paths"] == ["port_bench"]
    assert 1 <= manifest["run_seconds"] <= 51
    names = [c["name"] for c in manifest["configs"]] \
        + [w["name"] for w in manifest["workloads"]] \
        + [m["name"] for k in ("end_to_end", "per_layer")
           for m in manifest[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for k in ("end_to_end", "per_layer"):
        for m in manifest[k]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", ["adiabatic_disk.run", "pvte_fld_sg_dust.run",
                                  "adiabatic_disk.snap"])
def test_cell_found_from_files(manifest, cell):
    entry = {w["name"]: w for w in manifest["workloads"]}[cell]
    spec = harness.load_cell(cell)
    assert spec["config"] == entry["config"]
    assert spec["chips"] == entry["chips"] == 1
    config = harness.load_config(spec["config"])
    files = {c["name"]: c["file"] for c in manifest["configs"]}
    assert files[spec["config"]] == f"port_bench/configs/{spec['config']}.json"
    assert set(config["reduced"]) <= set(config["setup"])
    assert {c["name"]: c["reduced"] for c in manifest["configs"]}[
        spec["config"]] == config["reduced"]
    assert set(spec["limits"]) >= {"start_gap", "end_gap", "time_gap"}
    per_layer = harness.cell_metrics(manifest, cell, "per_layer")
    assert per_layer
    for m in per_layer:
        assert callable(harness.load_reader(m["name"]).read)
    assert len(harness.cell_metrics(manifest, cell, "end_to_end")) == 3


@pytest.mark.parametrize("config", [c["name"] for c in
                                    harness.load_manifest()["configs"]])
def test_named_reference_meets_the_contract(config):
    name = harness.reference_name(harness.load_config(config))
    assert harness.reference_missing(name) == []
    ref = harness.load_reference(name)
    assert callable(ref.scope.refuse_outside)


def test_added_cell_config_and_metric_run_without_edit(tmp_path, manifest):
    """A cell, a configuration and a per-layer metric added as files and
    entries in a copy are listed and run on the CPU at a small size."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "port_bench"
    cfg = json.loads((bench / "configs" / "adiabatic_disk.json").read_text())
    cfg["name"] = "cool_disk"
    cfg["setup"]["CoolingBeta"] = "20"
    (bench / "configs" / "cool_disk.json").write_text(json.dumps(cfg))
    cell = json.loads((bench / "cells" / "adiabatic_disk.run.json")
                      .read_text())
    cell.update(name="cool_disk.short", config="cool_disk", warmup_steps=4,
                chunk_steps=8, trace_chunks=2)
    (bench / "cells" / "cool_disk.short.json").write_text(json.dumps(cell))
    (bench / "metrics" / "traced_steps.py").write_text(
        "SPANS = ()\n\n\ndef read(tr):\n    return float(tr.traced_steps)\n")
    m = json.loads(json.dumps(manifest))
    m["configs"].append({"name": "cool_disk", "source": "a test",
                         "file": "port_bench/configs/cool_disk.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "cool_disk.short", "config": "cool_disk",
                           "traffic": "short", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "traced_steps", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "a test", "moves": "setup_s",
                           "workloads": ["cool_disk.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    listed = harness.cell_metrics(harness.load_manifest(root),
                                  "cool_disk.short", "per_layer")
    assert "traced_steps" in [x["name"] for x in listed]
    assert "traced_steps" not in [x["name"] for x in harness.cell_metrics(
        harness.load_manifest(root), "adiabatic_disk.run", "per_layer")]
    r = harness.run_cell("cool_disk.short", 5, 0.2, True, time.perf_counter(),
                         device="cpu", overrides=SMALL, root=root)
    assert r["correct"]
    assert r["metrics"]["traced_steps"]["value"] == 2 * 8
