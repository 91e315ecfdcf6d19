"""The port's flagship setup (``fargocpt_torch/flagship.py``, which
``chip_smoke.py`` and ``python -m fargocpt_torch.profile_step`` run) is the
JAX package's ``__graft_entry__._flagship``: the same Physics and Geometry
once each Simulation is built, at NR on and off a multiple of 16. The one
extra key, ``FirstDT``, is run control and reaches neither."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import __graft_entry__  # noqa: E402
from fargocpt_torch.flagship import FLAGSHIP, flagship  # noqa: E402
from fargocpt_torch.ops import transport  # noqa: E402
from fargocpt_torch.sim import Simulation  # noqa: E402

torch.set_num_threads(2)


def _assert_same(a, b, path):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{k}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("nrad", [40, 64])
def test_flagship_is_the_jax_flagship(nrad):
    js = __graft_entry__._flagship(nrad, 32, "float64")
    ts = Simulation(flagship(nrad, 32), device="cpu")
    _assert_same(js.phys, ts.phys, "physics")
    _assert_same(js.geometry, ts.geometry, "geometry")
    assert ts.stepper.ops.route == transport.route(nrad) == "whole"
    assert "Nrad" not in FLAGSHIP and "Naz" not in FLAGSHIP


def test_planet_disk_is_the_quickstart_physics():
    """``flagship.planet_disk`` is examples/quickstart.yml's physics, its
    grid and run control aside."""
    from pathlib import Path
    import yaml
    from fargocpt_torch.flagship import PLANET_DISK, planet_disk
    quick = yaml.safe_load((Path(__file__).resolve().parent.parent
                            / "examples" / "quickstart.yml").read_text())
    run_control = {"Nrad", "Naz", "Nsnapshots", "Nmonitor",
                   "MonitorTimestep", "FirstDT"}
    mine = {k: v for k, v in PLANET_DISK.items() if k not in run_control}
    theirs = {k: v for k, v in quick.items() if k not in run_control}
    assert set(mine) == set(theirs)

    def norm(v):
        if isinstance(v, bool):
            return "yes" if v else "no"
        try:
            return float(str(v).split()[0])
        except ValueError:
            return str(v).lower()

    for key in mine:
        if key == "nbody":
            for a, b in zip(mine[key], theirs[key]):
                assert {k: norm(v) for k, v in a.items()} == \
                    {k: norm(v) for k, v in b.items()}
        else:
            assert norm(mine[key]) == norm(theirs[key]), key
    cfg = planet_disk(16, 32)
    assert cfg.get("Nrad", 0, type=int) == 16
