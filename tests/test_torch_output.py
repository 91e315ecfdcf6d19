"""fargocpt_torch's output layer against the JAX package's: the flagship
(no planets) at 32x64 with seeded azimuthal noise, so the eccentricity and
the torques are not roundoff, in float64 and float32.

* Writer parity. The JAX run's state at each monitor (t = 0 and one
  monitor interval later) is carried into the port, and the port's writer
  writes what the JAX writer wrote from it. The field files, Q+/Q-,
  misc.bin and nbody.bin are byte for byte the JAX package's
  (``tools/compare_output.py``'s rtol 0), and so are the text files. The
  derived files (Temperature, the 1-D profiles, the Quantities.dat
  columns) are computations of each framework: in float64 they agree to
  rtol 1e-12; in float32 the sums run in another order, so Temperature
  and the 1-D profiles are held to rtol 1e-6 (8 float32 units in the last
  place) and the Quantities columns to rtol 1e-5. A column that sums
  cells of either sign (the three torques, pdivv) cancels to a small part
  of its terms, so it is held to the rtol of the sum of its cells'
  magnitudes. One exception in float32: the JAX package keeps last_dt as a
  Python float between its host-side dt updates, the port as a float32
  tensor, so snapshot 0's last_dt is the JAX value rounded to float32.
* Parity after stepping: the port starts from the JAX state at t = 0 and
  runs one monitor interval; snapshot 1 agrees at
  ``tests/test_torch_slice.py``'s tolerances for a seeded port (float64)
  or within the float32 trajectory budget.
* Restart: two monitors uninterrupted against one plus
  ``restore_simulation``, bit for bit, in both dtypes.
* Cross-package restore: a JAX snapshot restores into the port with equal
  tensors, and a port snapshot into the JAX package (only called).
"""

import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fargocpt_tpu import output as jout
from fargocpt_tpu.config import Config as JConfig
from fargocpt_tpu.sim import Simulation as JSimulation

from fargocpt_torch import output as tout
from fargocpt_torch.analysis import Loader
from fargocpt_torch.config import Config
from fargocpt_torch.ops.boundary import RefValues
from fargocpt_torch.sim import Simulation
from fargocpt_torch.state import (MONITOR_GRIDS, state_keys,
                                  system_state_from_numpy,
                                  system_state_to_numpy)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import compare_output  # noqa: E402

torch.set_num_threads(2)

CFG = {
    "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
    "AspectRatio": "0.05", "FlaringIndex": "0.25",
    "ViscousAlpha": "0.001",
    "Sigma0": "200 g/cm2", "SigmaSlope": "0.5",
    "HeatingViscous": "Yes", "CoolingBetaLocal": "Yes",
    "CoolingBeta": "10",
    "ArtificialViscosity": "SN",
    "Nrad": "32", "Naz": "64",
    "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Log",
    "InnerBoundary": "outflow", "OuterBoundary": "outflow",
    "Transport": "FARGO",
    "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "0.02",
    "FirstDT": "1e-3", "BitwiseExactRestarting": "yes",
}
# every optional output the slice writes: the Write* snapshot fields, the
# ring-integrated Q-/Q+ and the lightcurves
WRITE_FIELDS = {
    "WriteTemperature": ("Temperature",), "WriteSoundSpeed": ("SoundSpeed",),
    "WritePressure": ("Pressure",), "WriteToomre": ("Toomre",),
    "WriteEccentricity": ("EccentricityX", "EccentricityY"),
    "WritePotential": ("Potential",), "WriteKappa": ("Kappa",),
    "WriteTauCool": ("TauCool",), "WriteAlphaGrav": ("AlphaGrav",),
    "WriteAlphaReynolds": ("AlphaReynolds",),
    "WriteAspectratio": ("AspectRatio",),
    "WriteVerticalOpticalDepth": ("tau_eff",),
    "WriteVisibility": ("visiblity",), "WriteViscosity": ("Viscosity",),
    "WriteDivV": ("DivV",), "WriteTReynolds": ("TReynolds",),
    "WriteTGravitational": ("TGravitational",),
    "WriteEffectiveGamma": ("GammaEff",),
    "WriteFirstAdiabaticIndex": ("Gamma1",),
    "WriteMeanMolecularWeight": ("Mu",), "WriteAlpha": ("Alpha",),
    "WriteScaleHeight": ("ScaleHeight",), "WritepDV": ("PdivV",),
    "WriteTau": ("Tau",), "WriteSGAccelRad": ("SGAccelRad",),
    "WriteSGAccelAzi": ("SGAccelAzi",),
}
WRITE_ALL = {**{flag: "Yes" for flag in WRITE_FIELDS},
             "WriteRadialLuminosity": "Yes", "WriteRadialDissipation": "Yes",
             "WriteLightCurves": "Yes", "WriteLightCurvesRadii": "0.8, 1.5"}
DTYPES = ("float64", "float32")
FIELD_FILES = ("Sigma.dat", "vrad.dat", "vazi.dat", "energy.dat",
               "Qplus.dat", "Qminus.dat", "misc.bin", "nbody.bin")
TEXT_FILES = ("info2D.yml", "info1D.yml", "units.yml", "constants.yml",
              "dimensions.dat", "used_rad.dat", "parameters/setup.yml",
              "snapshots/timeSnapshot.dat", "snapshots/list.txt",
              "snapshots/0/config.yml", "snapshots/1/config.yml")


def jax_state_tree(state) -> dict[str, np.ndarray]:
    tree = {}
    for key in state_keys():
        obj = state
        for part in key.split("."):
            obj = getattr(obj, part)
        tree[key] = np.array(obj)
    for name in MONITOR_GRIDS:
        grid = getattr(state.monitor_acc, name)
        if grid is not None:
            tree[f"monitor_acc.{name}"] = np.array(grid)
    return tree


class Capture:
    """A monitor hook that records the JAX run's state and counters before
    its writer's hooks run (and zero the monitor's mass bookkeeping)."""

    def __init__(self):
        self.records = []

    def __call__(self, sim):
        self.records.append({
            "tree": jax_state_tree(sim.state), "time": sim.time,
            "last_dt": sim.last_dt, "n_monitor": sim.n_monitor,
            "n_hydro_iter": sim.n_hydro_iter,
            "monitor_stats": dict(sim.monitor_stats)})


def perturb(js, seed=7):
    """Seeded noise on the JAX run's initial fields (numpy)."""
    rng = np.random.default_rng(seed)
    f = js.state.fields

    def noisy(a, amp):
        a = np.asarray(a)
        return jnp.asarray(
            (a * (1.0 + amp * rng.standard_normal(a.shape))).astype(a.dtype))
    js.state = js.state.replace(fields=f.replace(
        sigma=noisy(f.sigma, 1e-2), energy=noisy(f.energy, 1e-2),
        vrad=noisy(f.vrad, 1e-2), vaz=noisy(f.vaz, 1e-3)))


def port_sim(dtype, **extra) -> Simulation:
    return Simulation(Config.from_dict(dict(CFG, **extra)), device="cpu",
                      dtype=dtype)


def carry(ts, rec) -> None:
    """The JAX run's state and counters at one monitor, into the port."""
    ts.state = system_state_from_numpy(rec["tree"], "cpu", ts.dtype)
    ts.time = torch.tensor(rec["time"], dtype=ts.dtype)
    ts.last_dt = torch.tensor(rec["last_dt"], dtype=ts.dtype)
    ts.n_monitor = rec["n_monitor"]
    ts.n_hydro_iter = rec["n_hydro_iter"]
    ts.monitor_stats = rec["monitor_stats"]
    ts._dt_primed = True


def carry_refs(ts, js) -> None:
    rv = js.stepper.ref_values
    ts.stepper.set_ref_values(RefValues(**{
        k: torch.tensor(np.asarray(getattr(rv, k)))
        for k in ("sigma0", "energy0", "vrad0", "vaz0")}))


def replay(dtype, root, extra: dict) -> dict:
    """One JAX run of one monitor interval with its writer, and the port's
    writer replaying it from the carried states."""
    js = JSimulation(JConfig.from_dict(dict(CFG, **extra)), dtype=dtype)
    perturb(js)
    jout.OutputWriter(js, root / "jax")
    cap = Capture()
    js.monitor_hooks.insert(0, cap)
    js.run()
    assert [r["n_monitor"] for r in cap.records] == [0, 1]

    ts = port_sim(dtype, **extra)
    carry_refs(ts, js)
    tw = tout.OutputWriter(ts, root / "torch")
    for rec in cap.records:
        carry(ts, rec)
        ts._handle_outputs()
    tw.close()
    return {"dtype": dtype, "root": root, "jax": js, "port": ts,
            "records": cap.records}


@pytest.fixture(scope="module", params=DTYPES)
def runs(request, tmp_path_factory):
    dtype = request.param
    return replay(dtype, tmp_path_factory.mktemp(f"output_{dtype}"),
                  WRITE_ALL)


# the monitor grids' flags, and the files each writes
MONITORS = {"WriteMassFlow": ("MassFlow",),
            "WriteGasTorques": ("AdvectionTorque", "ViscousTorque",
                                "GravitationalTorqueNotIntegrated"),
            "WriteAlphaGravMean": ("alpha_grav_mean",),
            "WriteAlphaReynoldsMean": ("alpha_reynolds_mean",),
            "WriteEccentricityChange": ()}


@pytest.fixture(scope="module", params=DTYPES)
def monitor_runs(request, tmp_path_factory):
    """``runs`` with every monitor grid on and symmetric self-gravity (the
    alpha-grav grid reads its accelerations)."""
    dtype = request.param
    return replay(dtype, tmp_path_factory.mktemp(f"monitor_{dtype}"), {
        **{flag: "Yes" for flag in MONITORS}, "SelfGravity": "Yes",
        "SelfGravityMode": "symmetric"})


def test_field_files_are_byte_identical(runs):
    root = runs["root"]
    for sid in ("reference", "0", "1"):
        a, b = root / "jax" / "snapshots" / sid, root / "torch" / "snapshots" \
            / sid
        assert ({p.name for p in a.iterdir()}
                == {p.name for p in b.iterdir()}), sid
        for name in FIELD_FILES:
            if sid == "reference" and name not in (
                    "Sigma.dat", "vrad.dat", "vazi.dat", "energy.dat"):
                continue
            if sid == "0" and name == "misc.bin" \
                    and runs["dtype"] == "float32":
                continue                  # test_float32_misc_at_time_zero
            assert (a / name).read_bytes() == (b / name).read_bytes(), \
                f"snapshot {sid}: {name}"


def test_float32_misc_at_time_zero(runs):
    a = jout.load_misc(runs["root"] / "jax" / "snapshots" / "0")
    b = tout.load_misc(runs["root"] / "torch" / "snapshots" / "0")
    if runs["dtype"] == "float32":
        assert b["last_dt"] == float(np.float32(a["last_dt"]))
        a["last_dt"] = b["last_dt"]
    assert a == b


def test_text_files_are_byte_identical(runs):
    root = runs["root"]
    for name in TEXT_FILES:
        assert (root / "jax" / name).read_bytes() \
            == (root / "torch" / name).read_bytes(), name


def test_derived_files_agree(runs):
    """Temperature and the 1-D profiles of the prognostic fields, of the
    temperature, the aspect ratio and the ring-integrated Q-/Q+; the
    lightcurves."""
    root = runs["root"]
    f64 = runs["dtype"] == "float64"
    rtol = 1e-12 if f64 else 1e-6
    names = ["Temperature.dat"] + [
        f"{n}1D.dat" for n in ("Sigma", "vrad", "vazi", "energy",
                               "Temperature", "aspectratio", "Luminosity",
                               "Dissipation")]
    for sid in ("0", "1"):
        a, b = root / "jax" / "snapshots" / sid, root / "torch" / "snapshots" \
            / sid
        for name in names:
            np.testing.assert_allclose(
                np.fromfile(b / name, np.float64),
                np.fromfile(a / name, np.float64), rtol=rtol, atol=0.0,
                err_msg=f"snapshot {sid}: {name}")
    for name in ("luminosity.dat", "dissipation.dat"):
        np.testing.assert_allclose(
            np.loadtxt(root / "torch" / "monitor" / name),
            np.loadtxt(root / "jax" / "monitor" / name),
            rtol=1e-12 if f64 else 1e-5, atol=0.0, err_msg=name)


def test_write_fields_agree(runs):
    """The Write* snapshot fields and their 1-D profiles. Several are
    differences of nearly equal terms (DivV, the Reynolds stress, the
    eccentricity vector), so each grid is held at its own scale: float64
    rtol 1e-12 with an atol of 1e-12 of the grid's largest magnitude. In
    float32 the ring means and sums of the two frameworks round apart by
    ~1e-7 of terms that cancel to ~1e-3, so only the files and their
    non-finite cells are checked there."""
    root = runs["root"]
    f64 = runs["dtype"] == "float64"
    names = [n for fields in WRITE_FIELDS.values() for n in fields
             if n != "Temperature"]
    for sid in ("0", "1"):
        a, b = root / "jax" / "snapshots" / sid, root / "torch" / "snapshots" \
            / sid
        for name in names:
            for fname in (f"{name}.dat", f"{name}1D.dat"):
                ref = np.fromfile(a / fname, np.float64)
                got = np.fromfile(b / fname, np.float64)
                assert got.shape == ref.shape, fname
                # TauCool divides by Q-, which is 0 in the ghost rings
                np.testing.assert_array_equal(np.isfinite(got),
                                              np.isfinite(ref), fname)
                if f64:
                    np.testing.assert_allclose(
                        got, ref, rtol=1e-12,
                        atol=1e-12 * np.abs(ref[np.isfinite(ref)]).max(),
                        err_msg=f"snapshot {sid}: {fname}")


def test_quantities_columns_agree(runs):
    root = runs["root"]
    qa = np.loadtxt(root / "jax" / "monitor" / "Quantities.dat")
    qb = np.loadtxt(root / "torch" / "monitor" / "Quantities.dat")
    assert qa.shape == qb.shape == (2, len(tout.QUANTITIES_COLUMNS))
    assert tout.QUANTITIES_COLUMNS == jout.QUANTITIES_COLUMNS
    rtol = 1e-12 if runs["dtype"] == "float64" else 1e-5
    scales = [signed_sum_scales(rec) for rec in runs["records"]]
    for col, name in enumerate(tout.QUANTITIES_COLUMNS):
        atol = np.array([rtol * sc.get(name, 0.0) for sc in scales])
        assert np.all(np.abs(qb[:, col] - qa[:, col])
                      <= rtol * np.abs(qa[:, col]) + atol), \
            (name, qa[:, col], qb[:, col])
    # the axisymmetry is broken: these are not roundoff
    for name in ("eccentricity", "gravitational torque"):
        col = tout.QUANTITIES_COLUMNS.index(name)
        assert np.all(np.abs(qa[:, col]) > 1e-14), name
    # the mass bookkeeping was read before the writer reset it
    col = tout.QUANTITIES_COLUMNS.index("inner boundary mass outflow")
    assert qa[1, col] == qb[1, col] != 0.0


def signed_sum_scales(rec) -> dict[str, float]:
    """For the Quantities columns that are sums of cells of either sign,
    the sum of the cells' magnitudes (float64, the port's ops on the
    record's state): such a sum cancels to a small part of its terms, and
    rounding is relative to the terms."""
    from fargocpt_torch.ops import gravity, quantities as quant, sources
    ts = port_sim("float64")
    carry(ts, rec)
    st, f, g = ts.stepper, ts.fields, ts.stepper.g
    cs, _, h = st.derived(f.sigma, f.energy)
    zero = torch.zeros((), dtype=torch.float64)
    cell_x, cell_y = st.ops.cell_xy()
    pot = gravity.nbody_potential(ts.phys, ts.constants, g,
                                  st.bodies_on_grid(ts.state.nbody, ts.time),
                                  st.n_bodies, cell_x, cell_y, h, zero, zero)
    grids = {
        "gravitational torque": quant.gravitational_torque_increment(
            g, f.sigma, pot, 1.0),
        "advection torque": quant.advection_torque_increment(
            g, f.sigma, f.vrad, f.vaz, 1.0),
        "viscous torque": quant.viscous_torque_increment(
            g, f.sigma, st.viscosity_grid(cs, h), f.vrad, f.vaz, 1.0),
        "pdivv": 0.4 * rec["last_dt"] * sources.divergence_v(
            g, f.vrad, f.vaz) * f.energy,
    }
    return {name: float(grid[1:-1].abs().sum())
            for name, grid in grids.items()}


def test_nbody_monitor_agrees(runs):
    root = runs["root"]
    a = np.loadtxt(root / "jax" / "monitor" / "nbody0.dat")
    b = np.loadtxt(root / "torch" / "monitor" / "nbody0.dat")
    np.testing.assert_array_equal(b, a)


def test_nbody_monitor_of_an_accreting_planet_agrees(tmp_path):
    """An accreting planet in the corotating frame: each body's monitor
    rows written from the carried JAX states, the accreted-mass column (the
    mass gained over the configured mass) and the frame's rate bit for bit,
    the rest at float64 rtol 1e-12 (the disk's torque is a sum over the
    grid)."""
    bodies = {"nbody": [
        {"name": "star", "semi-major axis": "0.0", "mass": "1.0"},
        {"name": "planet", "semi-major axis": "1.0", "mass": "1e-3",
         "accretion efficiency": "1.0", "accretion method": "kley"}],
        "Frame": "C", "DiskFeedback": "Yes"}
    rec = replay("float64", tmp_path, bodies)
    assert float(rec["port"].state.nbody.mass[1]) > 1e-3
    cols = {"accreted mass": 19, "omega frame": 8}
    for k in (0, 1):
        a = np.loadtxt(tmp_path / "jax" / "monitor" / f"nbody{k}.dat")
        b = np.loadtxt(tmp_path / "torch" / "monitor" / f"nbody{k}.dat")
        assert a.shape == b.shape == (2, 21)
        for name, col in cols.items():
            np.testing.assert_array_equal(b[:, col], a[:, col], err_msg=name)
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-300)
    assert np.loadtxt(tmp_path / "torch" / "monitor" / "nbody1.dat")[1, 19] > 0


def test_parity_after_one_monitor_interval(runs, tmp_path):
    """float64: the slice's tolerances for a seeded port; float32: the
    trajectory budget of tests/test_dtype_budget.py (rel-L2 < 1e-3, v_rad
    scaled by v_az), since the two frameworks' float32 sums round
    differently from the first step."""
    f64 = runs["dtype"] == "float64"
    ts = port_sim(runs["dtype"])
    carry_refs(ts, runs["jax"])
    carry(ts, runs["records"][0])
    ts.monitor_stats = {}
    tout.OutputWriter(ts, tmp_path)
    ts.run()
    a = runs["root"] / "jax" / "snapshots" / "1"
    b = tmp_path / "snapshots" / "1"
    vaz = np.fromfile(a / "vazi.dat")
    for name in ("Sigma", "vazi", "energy", "vrad", "Qplus", "Qminus"):
        ref = np.fromfile(a / f"{name}.dat")
        got = np.fromfile(b / f"{name}.dat")
        if f64:
            atol = 1e-10 * np.abs(ref).max() if name in (
                "vrad", "Qplus", "Qminus") else 0.0
            np.testing.assert_allclose(got, ref, rtol=1e-10, atol=atol,
                                       err_msg=name)
        else:
            scale = np.linalg.norm(vaz if name == "vrad" else ref)
            assert np.linalg.norm(got - ref) / scale < 1e-3, name
    ma, mb = jout.load_misc(a), tout.load_misc(b)
    assert mb["n_hydro_iter"] == ma["n_hydro_iter"] > 3
    assert mb["time"] == ma["time"]
    assert mb["last_dt"] == pytest.approx(ma["last_dt"],
                                          rel=1e-12 if f64 else 1e-5)


def _run(root, dtype, monitors, restore_from=None):
    ts = port_sim(dtype, Nsnapshots=str(monitors))
    tout.OutputWriter(ts, root)
    if restore_from is not None:
        tout.restore_simulation(ts, root, restore_from)
    ts.run()
    return ts


@pytest.mark.parametrize("dtype", DTYPES)
def test_restart_is_bitwise(dtype, tmp_path):
    a = _run(tmp_path / "a", dtype, 2)
    _run(tmp_path / "b", dtype, 1)
    c = _run(tmp_path / "b", dtype, 2, restore_from=1)
    assert c.n_monitor == a.n_monitor == 2
    assert c.n_hydro_iter == a.n_hydro_iter
    sa, sc = system_state_to_numpy(a.state), system_state_to_numpy(c.state)
    assert set(sa) == set(sc)
    for key in sa:
        np.testing.assert_array_equal(sc[key], sa[key], err_msg=key)
    for name in ("time", "last_dt"):
        assert torch.equal(getattr(c, name), getattr(a, name)), name
    assert compare_output.compare_dir(tmp_path / "a" / "snapshots" / "2",
                                      tmp_path / "b" / "snapshots" / "2",
                                      0.0)
    qa = np.loadtxt(tmp_path / "a" / "monitor" / "Quantities.dat")
    qb = np.loadtxt(tmp_path / "b" / "monitor" / "Quantities.dat")
    np.testing.assert_array_equal(qb, qa)
    assert (tmp_path / "b" / "snapshots" / "list.txt").read_text() \
        == "0\n1\n2\n"


def carried_by_restore(key: str) -> bool:
    """Whether a restore reads ``key`` from the snapshot. The monitor
    accumulators start from zero and the corotation reference from the
    fresh run's bodies, in both packages."""
    return not key.startswith(("monitor_acc", "corot"))


def planet_setup(integrator: str, monitors: int) -> Config:
    """examples/quickstart.yml at 32x64 in the corotating frame, its
    Jupiter accreting (Kley), MassFlow and the gas torques on."""
    import yaml
    cfg = yaml.safe_load((ROOT / "examples" / "quickstart.yml").read_text())
    cfg.pop("OutputDir", None)
    cfg.update({"Nrad": 32, "Naz": 64, "FirstDT": 0.01, "Frame": "C",
                "Integrator": integrator, "MonitorTimestep": 0.05,
                "Nmonitor": 1, "Nsnapshots": monitors,
                "WriteMassFlow": "Yes", "WriteGasTorques": "Yes"})
    cfg["nbody"][1]["accretion efficiency"] = 1.0
    return Config.from_dict(cfg)


@pytest.mark.parametrize("integrator", ["LeapFrog", "Euler"])
def test_restart_with_accretion_monitors_and_corotation_is_bitwise(
        integrator, tmp_path):
    """Two monitors uninterrupted against one plus ``restore_simulation``:
    the bodies' accreted masses come from nbody.bin, the frame's rate from
    misc.bin, the monitor grids start from zero as they are at a snapshot,
    and the corotation reference from the fresh run's bodies, as in the
    JAX package (whose own restart of this run is bit for bit under both
    integrators)."""
    def run(root, monitors, restore_from=None):
        ts = Simulation(planet_setup(integrator, monitors), device="cpu")
        tout.OutputWriter(ts, root)
        if restore_from is not None:
            tout.restore_simulation(ts, root, restore_from)
        ts.run()
        return ts
    a = run(tmp_path / "a", 2)
    run(tmp_path / "b", 1)
    c = run(tmp_path / "b", 2, restore_from=1)
    assert c.n_hydro_iter == a.n_hydro_iter
    assert float(a.state.nbody.mass[1]) > 1e-3
    sa, sc = system_state_to_numpy(a.state), system_state_to_numpy(c.state)
    assert set(sa) == set(sc) >= {"monitor_acc.massflow",
                                  "monitor_acc.t_grav"}
    for key in sa:
        np.testing.assert_array_equal(sc[key], sa[key], err_msg=key)
    assert compare_output.compare_dir(tmp_path / "a" / "snapshots" / "2",
                                      tmp_path / "b" / "snapshots" / "2",
                                      0.0)
    for name in ("MassFlow", "AdvectionTorque", "ViscousTorque",
                 "GravitationalTorqueNotIntegrated"):
        assert (tmp_path / "a" / "snapshots" / "2" / f"{name}.dat"
                ).read_bytes() == (tmp_path / "b" / "snapshots" / "2"
                                   / f"{name}.dat").read_bytes(), name


def test_jax_snapshot_restores_into_the_port(runs):
    ts = port_sim(runs["dtype"])
    tout.restore_simulation(ts, runs["root"] / "jax", 1)
    rec = runs["records"][1]
    got = system_state_to_numpy(ts.state)
    # what the JAX package's own restore of the snapshot holds
    js = JSimulation(JConfig.from_dict(dict(CFG)), dtype=runs["dtype"])
    jout.restore_simulation(js, runs["root"] / "jax", 1)
    restored = jax_state_tree(js.state)
    for key in state_keys():
        want = rec["tree"][key] if carried_by_restore(key) \
            else restored[key]
        np.testing.assert_array_equal(
            got[key], want.astype(got[key].dtype), err_msg=key)
    assert float(ts.time) == rec["time"]
    assert float(ts.last_dt) == rec["last_dt"]
    assert (ts.n_monitor, ts.n_snapshot, ts.n_hydro_iter) \
        == (1, 1, rec["n_hydro_iter"])
    assert ts._restored and ts._dt_primed


def test_port_snapshot_restores_into_jax(runs):
    js = JSimulation(JConfig.from_dict(dict(CFG)), dtype=runs["dtype"])
    jout.restore_simulation(js, runs["root"] / "torch", 1)
    want = system_state_to_numpy(runs["port"].state)
    # what the port's own restore of the snapshot holds
    ts = port_sim(runs["dtype"])
    tout.restore_simulation(ts, runs["root"] / "torch", 1)
    restored = system_state_to_numpy(ts.state)
    for key in state_keys():
        if not carried_by_restore(key):
            want[key] = restored[key]
        obj = js.state
        for part in key.split("."):
            obj = getattr(obj, part)
        np.testing.assert_array_equal(
            np.asarray(obj, np.float64), want[key].astype(np.float64),
            err_msg=key)
    assert js.time == float(runs["port"].time)
    assert js.n_hydro_iter == runs["port"].n_hydro_iter


def test_loader_opens_the_port_output(runs):
    ld = Loader(runs["root"] / "torch")
    assert (ld.nrad, ld.naz) == (32, 64)
    assert ld.snapshots == ["0", "1"]
    assert ld.misc(1)["n_monitor"] == 1
    sigma = np.fromfile(runs["root"] / "torch" / "snapshots" / "1"
                        / "Sigma.dat").reshape(32, 64)
    np.testing.assert_array_equal(np.asarray(ld.gas.get("Sigma", 1,
                                                        grid=False)), sigma)


@pytest.mark.parametrize("flag,attr,name", [
    ("DistributedOutput", "distributed_output", "DistributedOutput"),
])
def test_outputs_outside_the_slice_raise(flag, attr, name):
    phys = port_sim("float64").phys
    tout.check_supported(phys)
    with pytest.raises(NotImplementedError, match=name):
        tout.check_supported(phys.with_(**{attr: True}))


@pytest.mark.parametrize("flag", list(MONITORS))
def test_monitor_flag_writes_its_files(flag, tmp_path):
    """Each monitor flag alone: its grids' files and 1-D files in every
    snapshot (zero at t = 0, cleared after each write), or
    eccentricity_change.dat a row a monitor."""
    ts = port_sim("float64", **{flag: "Yes"})
    tout.OutputWriter(ts, tmp_path)
    ts.run()
    snaps = tmp_path / "snapshots"
    for name in MONITORS[flag]:
        assert not np.fromfile(snaps / "0" / f"{name}.dat").any()
        for sid in ("0", "1"):
            assert (snaps / sid / f"{name}1D.dat").exists()
        grid = np.fromfile(snaps / "1" / f"{name}.dat")
        assert grid.shape == (32 * 64,)
        assert grid.any() or name == "alpha_grav_mean"   # no self-gravity
    acc = ts.state.monitor_acc
    for grid in MONITOR_GRIDS:
        if getattr(acc, grid) is not None:
            assert not getattr(acc, grid).any(), grid
    ecc = tmp_path / "monitor" / "eccentricity_change.dat"
    assert ecc.exists() == (flag == "WriteEccentricityChange")
    if ecc.exists():
        rows = np.loadtxt(ecc)
        assert rows.shape == (2, 13) and rows[1, 3:].any()


def test_monitor_files_are_byte_identical(monitor_runs):
    """Each monitor grid's file and 1-D file in both snapshots, and
    eccentricity_change.dat, written from the carried JAX states."""
    root = monitor_runs["root"]
    for sid in ("0", "1"):
        a, b = root / "jax" / "snapshots" / sid, root / "torch" / "snapshots" \
            / sid
        for name in (n for names in MONITORS.values() for n in names):
            for fname in (f"{name}.dat", f"{name}1D.dat"):
                assert (a / fname).read_bytes() == (b / fname).read_bytes(), \
                    f"snapshot {sid}: {fname}"
            if sid == "1":
                assert np.fromfile(b / f"{name}.dat").any(), name
    name = "monitor/eccentricity_change.dat"
    assert (root / "jax" / name).read_bytes() \
        == (root / "torch" / name).read_bytes()
    assert np.loadtxt(root / "torch" / name)[1, 3:].any()


@pytest.mark.parametrize("flag", ["DistributedOutput"])
def test_writer_refuses_outputs_the_simulation_runs(flag, tmp_path):
    ts = port_sim("float64", **{flag: "Yes"})
    with pytest.raises(NotImplementedError, match=flag):
        tout.OutputWriter(ts, tmp_path)


def test_sharded_snapshot_restore_raises(runs, tmp_path):
    shutil.copytree(runs["root"] / "torch", tmp_path / "out")
    sdir = tmp_path / "out" / "snapshots" / "1"
    (sdir / "Sigma.dat").rename(sdir / "Sigma.r00000-00032.dat")
    with pytest.raises(NotImplementedError, match="DistributedOutput"):
        tout.restore_simulation(port_sim(runs["dtype"]), tmp_path / "out", 1)
