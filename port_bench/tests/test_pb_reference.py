"""A configuration names its own plain reference, and the check holds the
N-body state to it: in a copied checkout, references, configurations and
cells added as files and entries run with no edit of the harness."""

import json
import math
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from port_bench import check, harness

SMALL = {"Nrad": "16", "Naz": "32"}
SEED = 2 ** 31 + 101
# G a hundred-thousandth high: the reference's Kepler speeds move by ~5e-6
ALTERED = ("G = u.CGS_G /", "G = 1.00001 * u.CGS_G /")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with references ``plain_copy`` (``fargo_plain``
    renamed), ``plain_altered`` (one constant altered) and
    ``plain_partial`` (no ``scope.refuse_outside``), a configuration
    naming each and one naming a package that is not there, and a cell of
    the adiabatic disk that lists ``bodies_gap``."""
    root = tmp_path_factory.mktemp("checkout")
    bench = root / "port_bench"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    refs = bench / "reference"
    for name in ("plain_copy", "plain_altered", "plain_partial"):
        shutil.copytree(refs / "fargo_plain", refs / name,
                        ignore=shutil.ignore_patterns("__pycache__"))
    constants = refs / "plain_altered" / "constants.py"
    text = constants.read_text()
    assert text.count(ALTERED[0]) == 1
    constants.write_text(text.replace(*ALTERED))
    scope = refs / "plain_partial" / "scope.py"
    scope.write_text(scope.read_text().replace("def refuse_outside(",
                                               "def refuse_nothing("))

    manifest = harness.load_manifest()
    config = harness.load_config("adiabatic_disk")
    cell = harness.load_cell("adiabatic_disk.run")
    for name, ref in (("disk_copy", "plain_copy"),
                      ("disk_altered", "plain_altered"),
                      ("disk_partial", "plain_partial"),
                      ("disk_missing", "no_such_reference")):
        (bench / "configs" / f"{name}.json").write_text(json.dumps(
            {**config, "name": name, "reference": ref}))
        (bench / "cells" / f"{name}.run.json").write_text(json.dumps(
            {**cell, "name": f"{name}.run", "config": name}))
        manifest["configs"].append({
            "name": name, "source": "a test",
            "file": f"port_bench/configs/{name}.json", "reduced": [],
            "why": "a test"})
        manifest["workloads"].append({
            "name": f"{name}.run", "config": name, "traffic": "run",
            "chips": 1, "why": "a test"})
    (bench / "cells" / "adiabatic_disk.bodies.json").write_text(json.dumps(
        {**cell, "name": "adiabatic_disk.bodies",
         "limits": {**cell["limits"], "bodies_gap": 1e-12}}))
    manifest["workloads"].append({
        "name": "adiabatic_disk.bodies", "config": "adiabatic_disk",
        "traffic": "bodies", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def run(root, cell, seconds=0.0, **kw):
    """One run on the CPU at 16x32; 0 seconds makes the window one call."""
    return harness.run_cell(cell, SEED, seconds, False, time.perf_counter(),
                            device="cpu", overrides=SMALL, root=root, **kw)


def failed(result):
    return {k for k, c in result["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]}


def test_named_copy_is_the_reference_read(root):
    """The renamed copy reads as ``fargo_plain`` does, number for number;
    with one constant altered its start_gap fails."""
    plain = run(root, "adiabatic_disk.run")
    copy = run(root, "disk_copy.run")
    assert plain["correct"], plain["checks"]
    assert copy["checks"] == plain["checks"]
    altered = run(root, "disk_altered.run")
    assert not altered["correct"]
    assert "start_gap" in failed(altered)


@pytest.mark.parametrize("config, lacks", [
    ("disk_missing", "__init__.py"),
    ("disk_partial", "scope.refuse_outside")])
def test_reference_outside_the_contract_is_refused_before_set_up(
        root, monkeypatch, config, lacks):
    from fargocpt_torch import sim

    def built(*a, **kw):
        raise AssertionError("the Simulation was built")
    monkeypatch.setattr(sim, "Simulation", built)
    with pytest.raises(ValueError, match=lacks) as err:
        run(root, f"{config}.run")
    assert config in str(err.value)


def test_cell_listing_bodies_gap(root):
    """A cell that lists ``bodies_gap`` reports it and is correct; its
    float32 control is not."""
    r = run(root, "adiabatic_disk.bodies", 0.3)
    assert r["correct"], r["checks"]
    assert "bodies_gap" in r["checks"]
    assert "bodies_gap" not in run(root, "adiabatic_disk.run")["checks"]
    control = run(root, "adiabatic_disk.bodies", 0.3, dtype="float32")
    assert not control["correct"]
    assert {"start_gap", "end_gap"} <= failed(control)


def test_body_altered_where_the_step_produces_it(root, monkeypatch):
    """The star moved by 1e-11 in the window's steps (the warm-up's are
    sound): bodies_gap reads it, the gas (~6e-9 in end_gap) does not."""
    from fargocpt_torch import step
    sound = step.HydroStep.step
    calls = [0]

    def altered(self, state, time, dt):
        out = sound(self, state, time, dt)
        calls[0] += 1
        if calls[0] <= harness.load_cell("adiabatic_disk.run")[
                "warmup_steps"]:
            return out
        return out.replace(nbody=out.nbody.replace(x=out.nbody.x + 1e-11))

    monkeypatch.setattr(step.HydroStep, "step", altered)
    r = run(root, "adiabatic_disk.bodies")
    assert failed(r) == {"bodies_gap"}


def system(x, y=None, omega=0.0):
    x = torch.tensor(x, dtype=torch.float64)
    y = torch.zeros_like(x) if y is None else torch.tensor(y, dtype=x.dtype)
    nbody = SimpleNamespace(x=x, y=y, vx=-0.5 * y, vy=0.5 * x,
                            mass=torch.linspace(1.0, 1e-3, len(x)).double())
    return SimpleNamespace(nbody=nbody,
                           omega_frame=torch.tensor(omega, dtype=x.dtype))


def test_bodies_gap():
    ref = system([0.0, 1.0, -5.2], [0.0, 0.3, 0.1], omega=0.5)
    assert check.bodies_gap(system([0.0, 1.0, -5.2], [0.0, 0.3, 0.1],
                                   omega=0.5), ref) == 0.0
    moved = system([0.0, 1.0, -5.2], [0.0, 0.3, 0.1], omega=0.5)
    moved.nbody.x[2] *= 1.0 + 1e-9
    assert check.bodies_gap(moved, ref) == pytest.approx(1e-9, rel=1e-6)
    assert check.bodies_gap(system([0.0, 1.0], [0.0, 0.3], omega=0.5),
                            ref) == math.inf
    spun = system([0.0, 1.0, -5.2], [0.0, 0.3, 0.1], omega=0.5 + 1e-9)
    assert check.bodies_gap(spun, ref) == pytest.approx(2e-9, rel=1e-6)
    lost = system([0.0, 1.0, -5.2], [0.0, 0.3, 0.1], omega=0.5)
    lost.nbody.vy[2] = math.nan
    assert math.isnan(check.bodies_gap(lost, ref))


def test_a_gap_not_finite_in_any_field_is_not_passed_by():
    fields = SimpleNamespace(**{k: torch.ones(4, 4, dtype=torch.float64)
                                for k in check.FIELDS})
    for k in check.FIELDS:
        bad = SimpleNamespace(**vars(fields))
        bad_field = getattr(fields, k).clone()
        bad_field[1, 2] = math.nan
        setattr(bad, k, bad_field)
        assert math.isnan(check.fields_gap(bad, fields))
