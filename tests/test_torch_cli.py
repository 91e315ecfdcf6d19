"""``python -m fargocpt_torch``: start / auto / restart on the CPU, the
``data`` and ``config`` subcommands (as tests/test_output_restart.py and
tests/test_cli_info.py drive ``python -m fargocpt_tpu``), and what the
command line refuses."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from fargocpt_torch import __main__ as cli, output as tout

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import compare_output  # noqa: E402

SETUP = {
    "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
    "AspectRatio": "0.05", "FlaringIndex": "0.25", "ViscousAlpha": "0.001",
    "Sigma0": "200 g/cm2", "SigmaSlope": "0.5",
    "HeatingViscous": "Yes", "CoolingBetaLocal": "Yes", "CoolingBeta": "10",
    "ArtificialViscosity": "SN",
    "Nrad": "32", "Naz": "64", "Rmin": "0.4", "Rmax": "2.5",
    "RadialSpacing": "Log",
    "InnerBoundary": "outflow", "OuterBoundary": "outflow",
    "Transport": "FARGO",
    "Nsnapshots": "2", "Nmonitor": "1", "MonitorTimestep": "0.02",
    "FirstDT": "1e-3", "BitwiseExactRestarting": "yes",
}


# the user config store (default dtype and output directory) of the
# command line, kept empty in the runs below
_CONFIG_HOME = {}


def _cli(args, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               **_CONFIG_HOME)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "fargocpt_torch", *args],
                          capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=ROOT)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    _CONFIG_HOME["XDG_CONFIG_HOME"] = str(base / "config_home")
    path = base / "setup.yml"
    path.write_text(yaml.safe_dump(SETUP))
    return path


@pytest.fixture(scope="module")
def straight(setup):
    """One uninterrupted start to the last output."""
    out = setup.parent / "straight"
    r = _cli(["start", str(setup), "--device", "cpu", "-o", str(out)])
    assert r.returncode == 0, r.stderr
    return out


def test_start_writes_the_jax_layout(straight):
    for name in ("snapshots/0/Sigma.dat", "snapshots/2/misc.bin",
                 "snapshots/list.txt", "snapshots/timeSnapshot.dat",
                 "monitor/Quantities.dat", "monitor/timestepLogging.dat",
                 "parameters/setup.yml", "units.yml", "info2D.yml",
                 "dimensions.dat", "used_rad.dat", "fargocpt_output_v1_4",
                 "fargocpt.pid", "logs/fargocpt.log", "logs/log_0.txt"):
        assert (straight / name).exists(), name
    assert (straight / "snapshots" / "list.txt").read_text() == "0\n1\n2\n"
    misc = tout.load_misc(straight / "snapshots" / "2")
    assert misc["n_monitor"] == 2 and misc["time"] == pytest.approx(0.04)
    q = np.loadtxt(straight / "monitor" / "Quantities.dat")
    assert q.shape == (3, len(tout.QUANTITIES_COLUMNS))
    log = (straight / "logs" / "log_0.txt").read_text()
    assert "snapshot writer: native" in log and "device cpu" in log


def test_start_with_max_iterations_then_auto_is_bitwise(setup, straight,
                                                        tmp_path):
    out = tmp_path / "cut"
    r = _cli(["start", str(setup), "--device", "cpu", "-N", "5", "-o",
              str(out)])
    assert r.returncode == 0, r.stderr
    assert "stopped after 5 hydro steps" in r.stdout
    assert (out / "snapshots" / "list.txt").read_text() == "0\n"
    # auto resumes from the last snapshot and runs to the end
    r2 = _cli(["auto", str(setup), "--device", "cpu", "-o", str(out)])
    assert r2.returncode == 0, r2.stderr
    assert "resuming from snapshot 0" in r2.stdout
    assert compare_output.compare_dir(straight / "snapshots" / "2",
                                      out / "snapshots" / "2", 0.0)
    np.testing.assert_array_equal(
        np.loadtxt(out / "monitor" / "Quantities.dat"),
        np.loadtxt(straight / "monitor" / "Quantities.dat"))
    assert (out / "snapshots" / "list.txt").read_text() == "0\n1\n2\n"


def test_restart_last_is_bitwise(setup, straight, tmp_path):
    out = tmp_path / "restart"
    one = setup.parent / "one.yml"
    one.write_text(yaml.safe_dump(dict(SETUP, Nsnapshots="1")))
    r = _cli(["start", str(one), "--device", "cpu", "-o", str(out),
              "--dtype", "float64"])
    assert r.returncode == 0, r.stderr
    r2 = _cli(["restart", "last", str(setup), "--device", "cpu", "-o",
               str(out)])
    assert r2.returncode == 0, r2.stderr
    assert "restarted from snapshot 1" in r2.stdout
    assert compare_output.compare_dir(straight / "snapshots" / "2",
                                      out / "snapshots" / "2", 0.0)


def test_in_process_runs_put_the_process_back(setup, tmp_path, capsys):
    import signal
    before = signal.getsignal(signal.SIGTERM)
    stdout = sys.stdout
    assert cli.main(["start", str(setup), "--device", "cpu", "-N", "2",
                     "-o", str(tmp_path / "a")]) == 0
    assert signal.getsignal(signal.SIGTERM) is before
    assert sys.stdout is stdout
    assert "stopped after 2 hydro steps" in capsys.readouterr().out


def test_data_subcommand_reads_the_port_output(straight):
    r = _cli(["data", str(straight)])
    assert r.returncode == 0, r.stderr
    assert "snapshots: ['0', '1', '2']" in r.stdout
    assert "grid: 32 x 64" in r.stdout
    r = _cli(["data", str(straight), "gas.Sigma", "1"])
    assert r.returncode == 0, r.stderr
    r = _cli(["data", str(straight.parent / "nope")])
    assert r.returncode == 1


def test_data_and_config_do_not_import_torch(straight):
    code = ("import sys; from fargocpt_torch.__main__ import main; "
            f"main(['data', {str(straight)!r}]); "
            "main(['config', 'show']); "
            "assert 'torch' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr


def test_config_subcommand(tmp_path):
    env = {"XDG_CONFIG_HOME": str(tmp_path / "cfg")}
    r = _cli(["config", "set", "default_dtype", "float32"], env)
    assert r.returncode == 0, r.stderr
    stored = json.loads((tmp_path / "cfg" / "fargocpt_tpu"
                         / "config.json").read_text())
    assert stored["default_dtype"] == "float32"
    r = _cli(["config", "get", "default_dtype"], env)
    assert r.stdout.strip() == "float32"
    r = _cli(["config", "remove", "default_dtype"], env)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("argv,name", [
    (["bench"], "bench"),
    (["start", "setup.yml", "--device", "cpu", "--debug-nans"],
     "--debug-nans"),
])
def test_refused_options_raise(argv, name):
    with pytest.raises(NotImplementedError, match=name):
        cli.main(argv)


def test_port_loader_and_run_entry(straight):
    import fargocpt_torch
    ld = fargocpt_torch.Loader(straight)
    assert ld.snapshots == ["0", "1", "2"]
    assert fargocpt_torch.build_info().startswith("fargocpt_torch ")
