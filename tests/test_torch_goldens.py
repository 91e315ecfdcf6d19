"""The reference-binary goldens (tests/goldens/) on fargocpt_torch, and the
analytic physics checks of tests/test_spreading_ring.py and
tests/test_shocktube.py (their Euler cases) run on the port.

The goldens run in float64 on the CPU through ``fargocpt_torch.output``,
and the snapshots are compared as tests/test_reference_golden.py compares
the JAX package's: every field by its largest deviation over its largest
value, equal hydro step counts, and the last dt from ``misc.bin``:

* ``spreading_ring`` (< 1e-9): the isothermal viscous ring, outflow
  boundaries, 660 steps on 256x2;
* ``shocktube_sn`` (< 1e-6): the Sod tube between reflecting walls, 255
  steps on 100x2;
* ``cold_disk_planet`` (< 1e-6): a ramped planet, reflecting boundaries,
  ``Initial`` damping, ``CoolingBetaReference``, 28 steps on 97x376;
* ``longrun_planet`` (< 1e-5, slow: 2800 steps, several minutes).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import integrate

from fargocpt_torch import output as out
from fargocpt_torch.config import Config
from fargocpt_torch.sim import Simulation

from analytic import SodSolution, spreading_ring_sigma

torch.set_num_threads(2)
GOLDENS = Path(__file__).parent / "goldens"


def run_golden(name: str, tmp_path: Path):
    cfg = Config.from_file(str(GOLDENS / name / "setup.yml"))
    sim = Simulation(cfg, outdir=str(tmp_path / "out"), dtype="float64",
                     device="cpu")
    writer = out.OutputWriter(sim)
    sim.run()
    writer.close()
    return sim


def compare_golden(name: str, sim, tol: float, outdir: Path,
                   snaps=("1", "2")) -> dict:
    """Max relative deviation of each field of each snapshot; asserts the
    grid, the fields under ``tol``, the step counts and the last dt."""
    golden = GOLDENS / name
    nr, na = sim.geometry.nrad, sim.geometry.naz
    ref_rad = np.loadtxt(golden / "used_rad.dat")
    assert ref_rad.shape[0] == nr + 1
    np.testing.assert_allclose(sim.geometry.radii[:nr + 1], ref_rad,
                               rtol=1e-12)
    fields = [("Sigma", nr), ("vrad", nr + 1), ("vazi", nr)]
    if (golden / "snapshots" / "1" / "energy.dat").exists():
        fields.append(("energy", nr))
    devs = {}
    for snap in snaps:
        for field, rows in fields:
            g = np.fromfile(golden / "snapshots" / snap / f"{field}.dat")
            m = np.fromfile(outdir / "snapshots" / snap / f"{field}.dat")
            assert g.shape == m.shape == (rows * na,)
            err = np.max(np.abs(g - m)) / np.max(np.abs(g))
            devs[(snap, field)] = err
            assert err < tol, (f"{name} snapshot {snap} {field}: max rel "
                               f"dev {err:.3e} >= {tol}")
        bg = (golden / "snapshots" / snap / "misc.bin").read_bytes()
        bm = (outdir / "snapshots" / snap / "misc.bin").read_bytes()
        ng = int(np.frombuffer(bg[40:44], np.uint32)[0])
        nm = int(np.frombuffer(bm[40:44], np.uint32)[0])
        assert ng == nm, f"hydro step count differs: ref {ng} vs {nm}"
        dt_g = float(np.frombuffer(bg[32:40], np.float64)[0])
        dt_m = float(np.frombuffer(bm[32:40], np.float64)[0])
        assert abs(dt_g - dt_m) / dt_g < max(1e-6, tol)
    return devs


@pytest.mark.parametrize("name,tol", [
    ("spreading_ring", 1e-9),
    ("shocktube_sn", 1e-6),
    ("cold_disk_planet", 1e-6),
    pytest.param("longrun_planet", 1e-5, marks=pytest.mark.slow),
])
def test_fields_match_reference_binary(name, tol, tmp_path):
    sim = run_golden(name, tmp_path)
    compare_golden(name, sim, tol, tmp_path / "out")


# ---------------------------------------------------------------------------
# tests/test_spreading_ring.py and tests/test_shocktube.py on the port
# ---------------------------------------------------------------------------

NU = 4.77e-5


def ring_config(monitor_timestep: str) -> Config:
    return Config.from_dict({
        "Integrator": "Euler", "SpreadingRing": "Yes",
        "Sigma0": "8.83829e+05 g/cm2", "SetSigma0": "Yes", "DiskMass": "1.0",
        "SigmaFloor": "1.e-8", "AspectRatio": "0.0",
        "ConstantViscosity": str(NU),
        "ArtificialViscosity": "None",
        "ArtificialViscosityDissipation": "No",
        "EquationOfState": "Isothermal",
        "MinimumTemperature": "1e-9 K", "CFL": "0.5",
        "InitializeVradialZero": "Yes", "ThicknessSmoothing": "0.0",
        "Transport": "FARGO",
        "InnerBoundary": "outflow", "OuterBoundary": "outflow",
        "Nrad": "256", "Naz": "2", "Rmin": "0.2", "Rmax": "1.8",
        "RadialSpacing": "Log",
        "Nsnapshots": "1", "Nmonitor": "1",
        "MonitorTimestep": monitor_timestep,
    })


def test_spreading_ring_starts_with_unit_mass():
    sim = Simulation(ring_config("1.0"), device="cpu")
    mass0 = float(torch.sum(sim.fields.sigma[1:-1]
                            * torch.tensor(sim.geometry.surf[1:-1, None])))
    assert abs(mass0 - 1.0) < 1e-12
    assert (sim.fields.energy == 0.0).all()


@pytest.mark.slow
def test_spreading_ring():
    """Fifty orbits against the Lynden-Bell & Pringle solution: mean
    relative deviation < 0.007 (some 50000 steps: slow)."""
    sim = Simulation(ring_config("314.159265359"), device="cpu")
    sim.run()
    assert sim.n_hydro_iter > 1000
    sigma = sim.fields.sigma.numpy().mean(1)
    theo = spreading_ring_sigma(sim.geometry.rmed, float(sim.time), NU)
    diff = np.abs(sigma / theo - 1.0)
    assert diff.mean() < 0.007, f"mean rel. deviation {diff.mean():.5f}"


THRESHOLDS = {"vrad": 0.0153, "Sigma": 0.0073,
              "Temperature": 0.016, "energy": 0.014}


def shocktube_config(artvisc: str) -> Config:
    return Config.from_dict({
        "Integrator": "Euler", "ShockTube": "1",
        "Sigma0": "1.0", "SigmaFloor": "1.e-100",
        "AspectRatio": "1.0", "FlaringIndex": "0.5",
        "ConstantViscosity": "0.0", "ViscousAlpha": "0.0",
        "ArtificialViscosity": artvisc,
        "ArtificialViscosityDissipation": "Yes",
        "ArtificialViscosityFactor": "1.41",
        "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
        "HeatingViscous": "No",
        "MinimumTemperature": "1e-9 K", "MaximumTemperature": "1e100 K",
        "CFL": "0.5", "ThicknessSmoothing": "0.6",
        "Transport": "FARGO",
        "InnerBoundary": "Reflecting", "OuterBoundary": "Reflecting",
        "Disk": "YES", "OmegaFrame": "0.0", "Frame": "F",
        "Nrad": "100", "Naz": "2",
        "Rmin": "1000.0", "Rmax": "1001.0",
        "RadialSpacing": "Arithmetic",
        "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "0.228",
    })


@pytest.mark.parametrize("artvisc", ["SN", "TW"])
def test_shocktube_euler(artvisc):
    """The Sod problem against the exact Riemann solution, the reference's
    integrated-|diff| thresholds (test/shockTube/check_results.py:17-23)."""
    sim = Simulation(shocktube_config(artvisc), device="cpu")
    sim.run()
    assert abs(float(sim.time) - 0.228) < 1e-12
    geom = sim.geometry
    sigma = sim.fields.sigma.numpy().mean(1)
    vrad = sim.fields.vrad.numpy().mean(1)
    energy = sim.fields.energy.numpy().mean(1)
    r1 = 0.5 * (geom.radii[1:] + geom.radii[:-1]) - geom.radii[0]
    vr_c = 0.5 * (vrad[1:] + vrad[:-1])
    jump = np.argmax((geom.rmed - geom.rmed[0]) > 0.5)
    x0 = geom.radii[jump] - geom.radii[0]
    mask = (r1 >= 0) & (r1 <= 1)
    x = r1[mask]
    rho_a, u_a, p_a = SodSolution()(x, 0.228, x0)
    gamma = 1.4
    results = {
        "vrad": (vr_c[mask], u_a),
        "Sigma": (sigma[mask], rho_a),
        "Temperature": ((gamma - 1) * energy[mask] / sigma[mask],
                        p_a / rho_a),
        "energy": (energy[mask], p_a / (gamma - 1)),
    }
    for name, (num, ana) in results.items():
        diff = integrate.simpson(np.abs(num - ana), x=x)
        assert diff < THRESHOLDS[name], \
            f"{name}: integrated diff {diff:.5f} >= {THRESHOLDS[name]}"
