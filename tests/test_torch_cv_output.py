"""The Roche-lobe tracker in fargocpt_torch's output: each snapshot's
``massflow_tracker.bin`` ([0, averaging time, rate], float64; reference
src/massflow_tracker.cpp) and its restore.

* On a state carried from the JAX package (``setups/CloseBinaries/
  OY_Car.yml`` at 16x32, three steps of a stream that carries mass), the
  port's writer writes the JAX writer's ``massflow_tracker.bin`` byte for
  byte; each package restores the rate from the other's snapshot.
* ``python -m fargocpt_torch start`` of OY_Car at 32x64 on the CPU through
  two snapshots, against one snapshot and ``restart last``: every file of
  the last snapshot, the tracker's among them, bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import yaml

from fargocpt_tpu import output as jout
from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.sim import Simulation as JSimulation

from fargocpt_torch import output as tout
from fargocpt_torch.config import Config
from fargocpt_torch.flagship import OY_CAR, setup_file
from fargocpt_torch.sim import Simulation
from fargocpt_torch.state import system_state_from_numpy

from test_torch_output import carry_refs, jax_state_tree

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import compare_output  # noqa: E402

torch.set_num_threads(2)

SHORT_RAMP = {"ROFrampingtime": "1e-7", "FirstDT": "1e-7"}


def test_tracker_file_is_the_jax_writers(tmp_path):
    cfg = setup_file(OY_CAR, 16, 32, **SHORT_RAMP)
    js = JSimulation(JConfig.from_dict(dict(cfg)))
    for _ in range(3):
        js.step_once(js.calculate_time_step())
    tree = jax_state_tree(js.state)
    tree["monitor_acc.rof_mdot"] = np.array(js.state.monitor_acc.rof_mdot)
    assert tree["monitor_acc.rof_mdot"] != 0.0
    ts = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    carry_refs(ts, js)
    ts.state = system_state_from_numpy(tree, "cpu", ts.dtype)
    jout.OutputWriter(js, tmp_path / "jax").write_snapshot("1",
                                                           register=False)
    tw = tout.OutputWriter(ts, tmp_path / "torch")
    tw.write_snapshot("1", register=False)
    tw.close()
    a = (tmp_path / "jax" / "snapshots" / "1" / "massflow_tracker.bin")
    b = (tmp_path / "torch" / "snapshots" / "1" / "massflow_tracker.bin")
    assert a.read_bytes() == b.read_bytes()
    vals = np.fromfile(b, np.float64)
    assert vals[0] == 0.0 and vals[1] == ts.stepper.rof_averaging_time()
    assert vals[2] == tree["monitor_acc.rof_mdot"]

    # each package restores the rate from the other's snapshot
    fresh = Simulation(Config.from_dict(dict(cfg)), device="cpu")
    tout.restore_simulation(fresh, tmp_path / "jax", 1)
    assert float(fresh.state.monitor_acc.rof_mdot) == vals[2]
    jfresh = JSimulation(JConfig.from_dict(dict(cfg)))
    jout.restore_simulation(jfresh, tmp_path / "torch", 1)
    assert float(jfresh.state.monitor_acc.rof_mdot) == vals[2]


def _cli(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               XDG_CONFIG_HOME=str(tmp_path / "config_home"))
    r = subprocess.run([sys.executable, "-m", "fargocpt_torch", *args],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr
    return r


def _setup(path: Path, n_snapshots: int) -> Path:
    """OY_Car at 32x64, monitor intervals of about six steps, the stream
    carrying mass, Q+ / Q- in the snapshots (the CFL reads them)."""
    cfg = setup_file(OY_CAR, 32, 64, Nsnapshots=n_snapshots, Nmonitor=1,
                     MonitorTimestep=2e-6, BitwiseExactRestarting="yes",
                     **SHORT_RAMP)
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_command_line_restart_is_bitwise(tmp_path):
    straight, cut = tmp_path / "straight", tmp_path / "cut"
    two = _setup(tmp_path / "two.yml", 2)
    one = _setup(tmp_path / "one.yml", 1)
    _cli(["start", str(two), "--device", "cpu", "-o", str(straight)],
         tmp_path)
    _cli(["start", str(one), "--device", "cpu", "-o", str(cut)], tmp_path)
    r = _cli(["restart", "last", str(two), "--device", "cpu", "-o",
              str(cut)], tmp_path)
    assert "restarted from snapshot 1" in r.stdout
    sdir = straight / "snapshots" / "2"
    rate = np.fromfile(sdir / "massflow_tracker.bin", np.float64)[2]
    assert rate != 0.0
    assert compare_output.compare_dir(sdir, cut / "snapshots" / "2", 0.0)
