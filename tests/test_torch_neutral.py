"""The framework-neutral modules copied into fargocpt_torch (units, config,
constants, params, grid, theo; log, usercfg, analysis, overview and the
native writer's C++ source) stay equal to the JAX package's: the same
source text, and the same Physics, Geometry, Units and Constants for the
flagship configuration and every setup file."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fargocpt_tpu import config as j_config, constants as j_constants, \
    grid as j_grid, params as j_params, units as j_units
from fargocpt_torch import config as t_config, constants as t_constants, \
    grid as t_grid, params as t_params, units as t_units

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

FLAGSHIP = {
    "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
    "AspectRatio": "0.05", "FlaringIndex": "0.25",
    "ViscousAlpha": "0.001",
    "Sigma0": "200 g/cm2", "SigmaSlope": "0.5",
    "HeatingViscous": "Yes", "CoolingBetaLocal": "Yes",
    "CoolingBeta": "10",
    "ArtificialViscosity": "SN",
    "Nrad": "64", "Naz": "128",
    "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Log",
    "InnerBoundary": "outflow", "OuterBoundary": "outflow",
    "Transport": "FARGO",
    "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "1.0",
}


@pytest.mark.parametrize("name", ["units", "constants", "params", "grid",
                                  "theo", "log", "usercfg", "analysis",
                                  "overview", "native/async_writer.cpp"])
def test_copied_module_source_is_identical(name):
    name = name if "." in name else f"{name}.py"
    a = (ROOT / "fargocpt_tpu" / name).read_text()
    b = (ROOT / "fargocpt_torch" / name).read_text()
    assert a == b


def test_config_copy_differs_only_by_the_lazy_yaml_import():
    a = (ROOT / "fargocpt_tpu" / "config.py").read_text().splitlines()
    b = (ROOT / "fargocpt_torch" / "config.py").read_text().splitlines()
    strip = lambda lines: [ln for ln in lines   # noqa: E731
                           if ln.strip() not in ("import yaml", "")]
    assert strip(a) == strip(b)
    assert "import yaml" not in b[:20]


def _load(cfg, config_mod, units_mod, constants_mod, params_mod, grid_mod):
    """Units -> Constants -> Physics -> Geometry, as Simulation does."""
    for key in ("l0", "m0", "t0", "temp0"):
        cfg.get_raw(key)
    un = units_mod.Units.from_config_strings(
        str(cfg.get_raw("l0", "1.0")), str(cfg.get_raw("m0", "1.0")),
        str(cfg.get_raw("t0")) if "t0" in cfg else None,
        str(cfg.get_raw("temp0")) if "temp0" in cfg else None)
    const = constants_mod.Constants.from_units(un)
    cfg.set_units(un)
    phys = params_mod.physics_from_config(cfg, un)
    geom = grid_mod.Geometry.from_config(cfg)
    return un, const, phys, geom


def _both(source):
    out = []
    for mods in ((j_config, j_units, j_constants, j_params, j_grid),
                 (t_config, t_units, t_constants, t_params, t_grid)):
        cfg = mods[0].Config.from_dict(dict(source)) \
            if isinstance(source, dict) else mods[0].Config.from_file(source)
        try:
            out.append(_load(cfg, *mods))
        except Exception as exc:   # noqa: BLE001 - compared below
            out.append(exc)
    return out


def _assert_same(a, b, path="value"):
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


SETUPS = sorted((ROOT / "setups").rglob("*.yml"))


@pytest.mark.parametrize("source", [FLAGSHIP] + SETUPS,
                         ids=["flagship"] + [p.stem for p in SETUPS])
def test_neutral_objects_match(source):
    jax_out, torch_out = _both(source)
    if isinstance(jax_out, Exception):
        assert type(torch_out) is type(jax_out)
        return
    for a, b, name in zip(jax_out, torch_out,
                          ("units", "constants", "physics", "geometry")):
        _assert_same(a, b, name)


def test_port_never_imports_jax():
    code = ("import sys, fargocpt_torch, fargocpt_torch.sim, "
            "fargocpt_torch.ops.kernels, fargocpt_torch.output, "
            "fargocpt_torch.__main__, fargocpt_torch.analysis, "
            "fargocpt_torch.native; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'fargocpt_tpu')); "
            "print(bad); assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr

