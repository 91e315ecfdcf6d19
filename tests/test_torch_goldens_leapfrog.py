"""The leapfrog goldens of tests/goldens/ on fargocpt_torch, compared as
tests/test_torch_goldens.py compares the Euler ones (every field by its
largest deviation over its largest value, the reference's hydro step
counts and last dt), at the tolerances of tests/test_reference_golden.py:

* ``planet_torque`` (< 1e-6): the reference's type-I torque test
  (test/planet_torque/torque_test.yml): a ramped 2e-5 planet in a locally
  isothermal disk, TW artificial viscosity, reflecting + balanced
  boundaries, ``Initial`` v_rad damping, the smoothing at the planet's
  location; 76 steps on 221x755;
* ``binary_gceph`` (< 1e-5): a gamma-Cephei-like binary, the secondary at
  periapsis at the outer edge: cubic smoothing, the N-body indirect term,
  thermal cooling (the unfused substeps), viscous outflow and reflecting
  boundaries, mean and zero damping; 92 steps;
* ``temperature_test`` (< 1e-6): an adiabatic disk on 100x2 with a
  constant viscosity, viscous heating and thermal surface cooling (the
  unfused substeps), reflecting boundaries, zero v_rad damping, the
  MassFlow monitor grid; 240 steps;
* ``temperature_fld`` (< 1e-6): the same with FLD radiative diffusion;
* ``planet_accretion`` (< 1e-6): a 2e-5 planet accreting by Kley's
  two-zone scheme with disk feedback in the corotating frame, the
  torque test's disk otherwise; 76 steps on 221x755;
* ``binary_gceph_long`` at its first snapshot (< 5e-3, slow): the same
  binary over a quarter orbit through the chaotic periapsis transient;
  step counts within 5 %.

The temperature goldens' ``MassFlow.dat`` is held to the golden's too,
at the deviation the JAX package's own CPU run leaves on it (4.1e-11 in
``temperature_test``, 1.3e-8 in ``temperature_fld``), rounded up.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from fargocpt_torch import output as out
from fargocpt_torch.config import Config
from fargocpt_torch.params import LEAPFROG
from fargocpt_torch.sim import Simulation

from test_torch_goldens import GOLDENS, compare_golden, run_golden

torch.set_num_threads(2)


@pytest.mark.parametrize("name,tol", [("planet_torque", 1e-6),
                                      ("binary_gceph", 1e-5),
                                      ("temperature_test", 1e-6),
                                      ("temperature_fld", 1e-6),
                                      ("planet_accretion", 1e-6)])
def test_leapfrog_golden_matches_reference_binary(name, tol, tmp_path):
    sim = run_golden(name, tmp_path)
    assert sim.phys.hydro_integrator == LEAPFROG
    compare_golden(name, sim, tol, tmp_path / "out")


@pytest.mark.parametrize("name,tol", [("temperature_test", 1e-10),
                                      ("temperature_fld", 3e-8)])
def test_massflow_matches_reference_binary(name, tol, tmp_path):
    """The accumulated MassFlow grid of each snapshot against the
    reference's. Its file holds NR + 1 rows, one a face; the JAX package's
    and the port's NR, the outer face's flux added to the last ring. With
    reflecting walls the outer face carries no mass: the reference's last
    row is zero, and the first NR rows are compared."""
    sim = run_golden(name, tmp_path)
    nr, na = sim.geometry.nrad, sim.geometry.naz
    for snap in ("0", "1", "2"):
        ref = np.fromfile(GOLDENS / name / "snapshots" / snap
                          / "MassFlow.dat").reshape(nr + 1, na)
        got = np.fromfile(tmp_path / "out" / "snapshots" / snap
                          / "MassFlow.dat").reshape(nr, na)
        assert not ref[nr].any()
        scale = np.abs(ref).max()
        if snap == "0":
            assert scale == 0.0 and not got.any()
            continue
        err = np.abs(got - ref[:nr]).max() / scale
        assert err < tol, f"{name} snapshot {snap}: MassFlow {err:.3e}"


@pytest.mark.slow
def test_binary_gceph_long_first_snapshot(tmp_path: Path):
    golden = GOLDENS / "binary_gceph_long"
    cfg = Config.from_file(str(golden / "setup.yml"))
    cfg._raw["nsnapshots"] = "1"
    sim = Simulation(cfg, outdir=str(tmp_path / "out"), dtype="float64",
                     device="cpu")
    writer = out.OutputWriter(sim)
    sim.run()
    writer.close()
    nr = sim.geometry.nrad
    for field, rows in (("Sigma", nr), ("vrad", nr + 1), ("vazi", nr),
                        ("energy", nr)):
        g = np.fromfile(golden / "snapshots" / "1" / f"{field}.dat")
        m = np.fromfile(tmp_path / "out" / "snapshots" / "1" / f"{field}.dat")
        assert g.shape == m.shape == (rows * sim.geometry.naz,)
        err = np.max(np.abs(g - m)) / np.max(np.abs(g))
        assert err < 5e-3, f"{field}: max rel dev {err:.3e}"
    bg = (golden / "snapshots" / "1" / "misc.bin").read_bytes()
    bm = (tmp_path / "out" / "snapshots" / "1" / "misc.bin").read_bytes()
    ng = int(np.frombuffer(bg[40:44], np.uint32)[0])
    nm = int(np.frombuffer(bm[40:44], np.uint32)[0])
    assert abs(ng - nm) / ng < 0.05, (ng, nm)
