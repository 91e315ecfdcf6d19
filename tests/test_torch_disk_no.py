"""``Disk: no`` on fargocpt_torch against the JAX package, float64 on the
CPU: no gas substeps, boundaries, transport or floors and no monitor
bookkeeping, the time step kept at last_dt without a CFL evaluation
(fargocpt_tpu/sim.py:405-413, step.py:1438-1475, :1647-1653), while the
bodies drift and FLD still runs (reference src/simulation.cpp:205-208).

* ``setups/single_planet_no_disk.yml``: a star and an eccentric Jupiter,
  ten steps of ``step_once`` and then a monitor interval of ``run`` (the
  host loop's branch), the bodies to rtol 1e-12 of the largest
  coordinate, the gas untouched, dt constant; then the output: the
  N-body monitor and a snapshot, with the disk's torque written as 0.
* The FLD-only configuration of tests/test_fld1d.py at 64 rings: ten
  steps, the energy to rtol 1e-10, sigma and the velocities untouched.
"""

import numpy as np
import torch

from fargocpt_torch import flagship, output as out

from longtail_pairs import (FIELDS, assert_bodies, build_pair, moved,
                            snapshot, step_pair)

torch.set_num_threads(2)

NO_DISK = str(flagship.SINGLE_PLANET_NO_DISK)

# tests/test_fld1d.py's reference test/FLD1D setup at 64 rings
FLD1D = dict(flagship.FLD1D, Nrad="64", Naz="2", Nsnapshots="1",
             Nmonitor="1")


def _assert_gas_untouched(ts, before, names=FIELDS):
    for name in names:
        assert torch.equal(getattr(ts.state.fields, name), before[name]), name


def test_single_planet_no_disk_matches_jax(tmp_path):
    js, ts = build_pair(path=NO_DISK)
    assert not ts.phys.calculate_disk and ts.stepper.n_bodies == 2
    before = snapshot(ts)
    y0 = ts.state.nbody.y.clone()
    step_pair(js, ts, 10)
    # Disk: no keeps the first dt
    np.testing.assert_allclose(float(ts.last_dt), 1e-3, rtol=1e-15)
    assert_bodies(ts.state, js.state)
    assert float((ts.state.nbody.y - y0).abs().max()) > 1e-2
    _assert_gas_untouched(ts, before)
    acc = ts.state.monitor_acc.mass_delta
    assert not acc.any()


def test_no_disk_run_and_output_match_jax(tmp_path):
    """A monitor interval of ``run`` (60 steps of the first dt) in both
    packages, with the output: the bodies to rtol 1e-12 and the N-body
    monitor's rows with the disk's torque 0."""
    cfg = flagship.setup_file(flagship.SINGLE_PLANET_NO_DISK, 32, 64,
                              MonitorTimestep="0.06", Nmonitor="1",
                              Nsnapshots="1")
    js, ts = build_pair(cfg)
    from fargocpt_tpu import output as j_out
    j_out.OutputWriter(js, str(tmp_path / "j"))
    writer = out.OutputWriter(ts, str(tmp_path / "t"))
    js.run()
    ts.run()
    writer.close()
    assert ts.n_hydro_iter == js.n_hydro_iter == 60
    np.testing.assert_allclose(float(ts.time), js.time, rtol=1e-14)
    assert_bodies(ts.state, js.state)
    for k in (0, 1):
        t_rows = np.loadtxt(tmp_path / "t" / "monitor" / f"nbody{k}.dat")
        j_rows = np.loadtxt(tmp_path / "j" / "monitor" / f"nbody{k}.dat")
        assert t_rows.shape == j_rows.shape
        np.testing.assert_allclose(t_rows, j_rows, rtol=1e-9, atol=1e-12)
    assert (tmp_path / "t" / "snapshots" / "1" / "Sigma.dat").exists()


def test_fld_only_disk_matches_jax():
    js, ts = build_pair(FLD1D)
    assert ts.stepper.fld is not None and not ts.phys.calculate_disk
    before = snapshot(ts)
    step_pair(js, ts, 10)
    np.testing.assert_allclose(ts.state.fields.energy.numpy(),
                               np.asarray(js.state.fields.energy),
                               rtol=1e-10)
    _assert_gas_untouched(ts, before, ("sigma", "vrad", "vaz"))
    assert moved(ts, before)["energy"] > 1e-4
