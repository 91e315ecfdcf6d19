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


@pytest.mark.parametrize("name", ["planet_torque", "planet_accretion"])
def test_planet_setups_are_their_goldens_physics(name):
    """``flagship.planet_torque`` and ``flagship.planet_accretion`` are the
    goldens' setup.yml files on another grid: the same Physics and bodies
    once each Simulation is built, but for the monitor grids
    ``planet_accretion`` turns on (its golden writes none)."""
    import yaml
    from fargocpt_torch import flagship as setups
    from fargocpt_torch.config import Config
    golden = yaml.safe_load((ROOT / "tests" / "goldens" / name
                             / "setup.yml").read_text())
    golden.pop("cps")
    golden.update(Nrad=64, Naz=128)
    ref = Simulation(Config.from_dict(golden), device="cpu")
    ts = Simulation(getattr(setups, name)(64, 128), device="cpu")
    monitors = {"write_massflow": ref.phys.write_massflow,
                "write_gas_torques": ref.phys.write_gas_torques}
    _assert_same(ref.phys, ts.phys.with_(**monitors), "physics")
    _assert_same(ref.geometry, ts.geometry, "geometry")
    assert ref.bodies == ts.bodies
    if name == "planet_accretion":
        assert ts.phys.write_massflow and ts.phys.write_gas_torques
        assert ts.phys.corotating and ts.stepper.any_accretion
