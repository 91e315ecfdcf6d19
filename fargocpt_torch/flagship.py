"""The setups that ``chip_smoke.py`` and ``profile_step`` run.

``pds70``: ``__graft_entry__._pds70`` whole (BASELINE.json configs[4]):
the gas setup below with its Lagrangian dust, 16384 particles of 4 sizes
from 1 cm, the exponential midpoint integrator.

``flagship``: the JAX package's ``__graft_entry__._flagship`` (adiabatic
disk, alpha viscosity, SN artificial viscosity, viscous heating, local beta
cooling, FARGO transport, one star).

``planet_disk``: ``examples/quickstart.yml``'s physics (the README's first
setup): the locally isothermal disk (h = 0.05, alpha 1e-3, SN artificial
viscosity), outflow boundaries with damping zones (1.10 / 0.90), FARGO
transport, a star and a 1e-3 planet at r = 1 whose mass the gas feels
ramped up over ten orbits, with disk feedback.

``planet_torque``: the reference's type-I torque test
(test/planet_torque/torque_test.yml, the ``planet_torque`` golden's
setup.yml without its cell-per-scale-height sizing): the leapfrog
integrator, a locally isothermal disk (h = 0.05, Sigma ~ r^-1.5, no
viscosity), TW artificial viscosity without dissipation, reflecting
boundaries with a balanced v_az, ``Initial`` v_rad damping, a star and a
2e-5 planet at r = 1 ramped over ten orbits, smoothed with eps h at the
planet's location (CompatibilitySmoothingPlanetLoc), no disk feedback.

``planet_accretion``: the reference's accretion test (the
``planet_accretion`` golden's setup.yml without its sizing): the torque
test's disk in the corotating frame, its planet accreting by Kley's
two-zone scheme (efficiency 1) with disk feedback; the MassFlow and
gas-torque monitor grids on.

``binary_gcfull``: ``setups/gamma_cephei_full.yml`` read as it stands,
its writers and the MassFlow monitor grid included, on a given grid (the
``binary_gcfull`` golden's physics at the setup's own radii): a circumprimary
disk in the full eccentric (e = 0.4) gamma Cephei binary, the leapfrog,
N-body-centred initial conditions with the inner profile cutoff and the
circumbinary ring, AspectRatioMode 1, AlphaMode 2, StabilizeViscosity 1,
TW artificial viscosity, thermal cooling with irradiation from both
stars, a viscous inner and a center-of-mass outer boundary with damping
zones, the quadrupole-supported v_az, and the secondary accreting by the
viscous method.

``oy_car``: ``setups/CloseBinaries/OY_Car.yml`` read as it stands, on a
given grid: the dwarf-nova disk of OY Carinae fed by Roche-lobe overflow
from the secondary, the Euler step in the secondary's corotating frame,
an ideal gas with viscous heating and thermal surface cooling, SN
artificial viscosity, a viscous inner and an outflow outer boundary, the
Roche-lobe stream at the outer ghost ring with its tracker.

``v1504cyg``: ``setups/V1504Cyg.yml`` read as it stands, on a given grid:
the dwarf nova V1504 Cyg, the leapfrog in the secondary's corotating
frame, the PVTE equation of state, AspectRatioMode 1, AlphaMode 1 (the
S-curve's cold and hot alpha), StabilizeViscosity 1, TW artificial
viscosity, S-curve cooling (Kimura et al. 2020), the Roche-lobe stream
ramped in over five orbits, the MassFlow monitor grid.

``planet_disk_sg``: ``examples/quickstart.yml`` with ``SelfGravity: Yes``
and no mode, so the default Bessel kernel: a planet in a
self-gravitating locally isothermal disk; its scale height takes the
disk's Toomre Q.

``full_physics``: ``examples/full_physics.yml`` read as it stands: an
ideal gas with viscous heating, thermal surface cooling, FLD, symmetric
FFT self-gravity, SN artificial viscosity, an irradiating star and 2000
dust particles of 4 sizes that diffuse.

``single_planet_no_disk``: ``setups/single_planet_no_disk.yml``, ``Disk:
no``: a star and an eccentric Jupiter, no gas step.

``fld1d``: the reference's test/FLD1D (tests/test_fld1d.py), ``Disk:
no``: a passive disk of constant opacity that evolves by FLD alone, the
flux limiter held at 1/3, one star.

``shocktube_pvte``: the ``shocktube_pvte`` golden's setup
(tests/goldens/shocktube_pvte/setup.yml): the Sod tube with the PVTE
equation of state in the PVTE shock tube's units, reflecting walls, TW
artificial viscosity, on 1000 x 2 cells, with the reference's lookup table
(``PVTELookupTable``) by default.

``pds70_gas``: the gas part of ``__graft_entry__._pds70`` (BASELINE.json
configs[4]): the variable-gamma PVTE equation of state, FLD radiative
diffusion, symmetric FFT self-gravity, thermal surface cooling, viscous
heating, SN artificial viscosity, FARGO transport, one star, without the
dust (``IntegrateParticles: no``).
"""

from __future__ import annotations

from pathlib import Path

from .config import Config

# run control, not physics: start near the CFL limit, so short runs evolve
# and a timed window runs at the steady step size
_RUN = {"Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "1.0",
        "FirstDT": "1e-3"}

FLAGSHIP = {
    "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
    "AspectRatio": "0.05", "FlaringIndex": "0.25",
    "ViscousAlpha": "0.001",
    "Sigma0": "200 g/cm2", "SigmaSlope": "0.5",
    "HeatingViscous": "Yes", "CoolingBetaLocal": "Yes",
    "CoolingBeta": "10",
    "ArtificialViscosity": "SN",
    "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Log",
    "InnerBoundary": "outflow", "OuterBoundary": "outflow",
    "Transport": "FARGO",
    **_RUN,
}

PDS70_GAS = {
    "EquationOfState": "PVTE",
    "AspectRatio": "0.05", "FlaringIndex": "0.25",
    "ViscousAlpha": "0.002",
    "Sigma0": "2000 g/cm2", "SigmaSlope": "0.5",
    "HeatingViscous": "Yes", "SurfaceCooling": "thermal",
    "RadiativeDiffusion": "Yes",
    # an SOR tolerance float32 can reach (the reference's 1e-10 default
    # would run MaxIterations every solve)
    "RadiativeDiffusionTolerance": "1e-5",
    "RadiativeDiffusionMaxIterations": "1000",
    "SelfGravity": "Yes", "SelfGravityMode": "symmetric",
    "ArtificialViscosity": "SN",
    "IntegrateParticles": "no",
    "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Log",
    "InnerBoundary": "outflow", "OuterBoundary": "outflow",
    "Transport": "FARGO",
    **_RUN,
}

PDS70 = {
    **PDS70_GAS,
    "IntegrateParticles": "yes",
    "ParticleRadius": "1 cm", "ParticleSpeciesNumber": "4",
    "ParticleIntegrator": "midpoint",
}


PLANET_DISK = {
    "EquationOfState": "Isothermal",
    "AspectRatio": "0.05", "FlaringIndex": "0.0",
    "ViscousAlpha": "1e-3",
    "Sigma0": "200 g/cm2", "SigmaSlope": "0.5",
    "ArtificialViscosity": "SN", "ThicknessSmoothing": "0.6",
    "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Logarithmic",
    "InnerBoundary": "outflow", "OuterBoundary": "outflow",
    "Damping": "Yes", "DampingInnerLimit": "1.10",
    "DampingOuterLimit": "0.90",
    "Transport": "FARGO", "DiskFeedback": "Yes",
    "nbody": [
        {"name": "star", "semi-major axis": "0.0", "mass": "1.0"},
        {"name": "jupiter", "semi-major axis": "1.0", "mass": "1e-3",
         "ramp-up time": "10"},
    ],
    **_RUN,
}


PLANET_TORQUE = {
    "l0": "1 au", "m0": "1 solMass", "mu": "2.35",
    "EquationOfState": "Isothermal", "AdiabaticIndex": "1.4",
    "Sigma0": "3.76e-4", "SigmaSlope": "1.5", "SigmaFloor": "1e-9",
    "AspectRatio": "0.05", "AspectRatioMode": "0", "FlaringIndex": "0",
    "ConstantViscosity": "0", "ViscousAlpha": "0e-3",
    "StabilizeViscosity": "0", "ArtificialViscosity": "TW",
    "ArtificialViscosityDissipation": "No",
    "ArtificialViscosityFactor": "1.41", "CFL": "0.4",
    "ThicknessSmoothing": "0.4", "ThicknessSmoothingSG": "0.0",
    "CompatibilitySmoothingPlanetLoc": "yes",
    "CompatibilityNoStarSmoothing": "yes", "CorrectDiskSelfgravity": "yes",
    "RadialViscosityFactor": "1",
    "InnerBoundary": "Reflecting", "OuterBoundary": "Reflecting",
    "InnerBoundaryVAzi": "Balanced", "OuterBoundaryVAzi": "Balanced",
    "Damping": "Yes", "DampingInnerLimit": "1.24",
    "DampingOuterLimit": "0.84", "DampingVRadialInner": "initial",
    "DampingVRadialOuter": "initial",
    "Transport": "FARGO", "Integrator": "LeapFrog", "Disk": "yes",
    "OmegaFrame": "0.0", "Frame": "F", "DiskFeedback": "no",
    "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Logarithmic",
    "HydroFrameCenter": "primary", "BodyForceFromPotential": "Yes",
    "nbody": [
        {"name": "star", "semi-major axis": "1.0", "mass": "1.0",
         "eccentricity": "0.0", "radius": "1.0 solRadius",
         "temperature": "0 K", "ramp-up time": "0.0"},
        {"name": "planet", "semi-major axis": "1", "mass": "2e-05",
         "eccentricity": "0.0", "radius": "1.0 solRadius",
         "temperature": "0 K", "ramp-up time": "10"},
    ],
    **_RUN,
}


PLANET_ACCRETION = {
    **PLANET_TORQUE,
    "Frame": "C", "DiskFeedback": "Yes",
    "WriteMassFlow": "Yes", "WriteGasTorques": "Yes",
    "nbody": [
        PLANET_TORQUE["nbody"][0],
        {**PLANET_TORQUE["nbody"][1], "accretion efficiency": "1.0",
         "accretion method": "kley"},
    ],
}


# the repo's setup files that the setups below read as they stand
SETUPS_DIR = Path(__file__).resolve().parents[1] / "setups"
EXAMPLES_DIR = Path(__file__).resolve().parents[1] / "examples"
QUICKSTART = EXAMPLES_DIR / "quickstart.yml"
FULL_PHYSICS = EXAMPLES_DIR / "full_physics.yml"
SINGLE_PLANET_NO_DISK = SETUPS_DIR / "single_planet_no_disk.yml"
SHOCKTUBE_PVTE = Path(__file__).resolve().parents[1] / "tests" / "goldens" \
    / "shocktube_pvte" / "setup.yml"
GAMMA_CEPHEI_FULL = SETUPS_DIR / "gamma_cephei_full.yml"
OY_CAR = SETUPS_DIR / "CloseBinaries" / "OY_Car.yml"
V1504CYG = SETUPS_DIR / "V1504Cyg.yml"

# binary_gcfull at 128x256 on the golden's radii (Rmin 0.05, Rmax 12) after
# 20 steps, float32 on the card against float64 on the CPU on the card's dt
# sequence, rel-L2 of each field: twice the JAX package's own float32 run's
# rel-L2 from its float64 run there, rounded up (4.2344e-7, 8.3582e-7,
# 8.0540e-7, 4.1481e-6 by ``python tests/test_torch_binary_f32.py 128 256
# 20``; the port's own CPU float32 run: 4.2344e-7, 8.3542e-7, 7.9950e-7,
# 4.1252e-6): the center-of-mass boundary's drift nests two five-point
# differences, rounding in float32 in both packages. chip_smoke.py and the
# GPU tests hold the card's trajectory to them.
BINARY_F32_LIMITS = {"sigma": 8.5e-7, "vrad": 1.7e-6, "vaz": 1.7e-6,
                     "energy": 8.3e-6}


# the reference's test/FLD1D setup (tests/test_fld1d.py) without its
# output keys, 512 x 2 there
FLD1D = {
    "Disk": "no", "Sigma0": "7.570776897752835e-05", "SigmaSlope": "0.5",
    "SigmaFloor": "1e-7", "AspectRatio": "0.05", "FlaringIndex": "0",
    "ViscousAlpha": "0", "HeatingViscous": "no", "ArtificialViscosity": "TW",
    "EquationOfState": "Ideal", "AdiabaticIndex": "1.4", "mu": "2.35",
    "RadiativeDiffusion": "Yes", "RadiativeDiffusionOmega": "1.5",
    "RadiativeDiffusionAutoOmega": "No",
    "RadiativeDiffusionMaxIterations": "50000",
    "RadiativeDiffusionTest1D": "yes",
    "RadiativeDiffusionTolerance": "1e-15",
    "RadiativeDiffusionInnerBoundary": "zerogradient",
    "RadiativeDiffusionOuterBoundary": "zerogradient",
    "MinimumTemperature": "3 K", "MaximumTemperature": "1e100 K",
    "Opacity": "constant", "KappaConst": "0.1 cm2/g", "CFL": "0.5",
    "HeatingCoolingCFLlimit": "1.0", "l0": "1.0 au", "m0": "1.0 solMass",
    "ThicknessSmoothing": "0.6", "Transport": "FARGO", "Integrator": "Euler",
    "InnerBoundary": "reflecting", "OuterBoundary": "reflecting",
    "InnerBoundaryVazi": "keplerian", "OuterBoundaryVazi": "keplerian",
    "Damping": "No", "OmegaFrame": "0", "Frame": "F",
    "Rmin": "0.2", "Rmax": "10.0", "RadialSpacing": "Logarithmic",
    "Nsnapshots": "20", "Nmonitor": "2", "MonitorTimestep": "3.14159265359",
    "FirstDT": "3.14159265359e-1", "CFLmaxVar": "1.1",
}


def fld1d(nrad: int = 512, naz: int = 2, **overrides) -> Config:
    """The FLD-only disk of the reference's test/FLD1D (``Disk: no``) on an
    ``nrad`` x ``naz`` grid; ``overrides`` replace keys."""
    return Config.from_dict(dict(FLD1D, Nrad=str(nrad), Naz=str(naz),
                                 **overrides))


def flagship(nrad: int, naz: int) -> Config:
    """The flagship setup on an ``nrad`` x ``naz`` grid."""
    return Config.from_dict(dict(FLAGSHIP, Nrad=str(nrad), Naz=str(naz)))


def pds70_gas(nrad: int, naz: int) -> Config:
    """The PDS70 gas setup on an ``nrad`` x ``naz`` grid."""
    return Config.from_dict(dict(PDS70_GAS, Nrad=str(nrad), Naz=str(naz)))


def pds70(nrad: int, naz: int, n_particles: int = 16384) -> Config:
    """The whole PDS70 setup, dust included, on an ``nrad`` x ``naz``
    grid."""
    return Config.from_dict(dict(PDS70, Nrad=str(nrad), Naz=str(naz),
                                 NumberOfParticles=str(n_particles)))


def planet_disk(nrad: int, naz: int) -> Config:
    """``examples/quickstart.yml``'s physics on an ``nrad`` x ``naz``
    grid."""
    cfg = dict(PLANET_DISK, Nrad=str(nrad), Naz=str(naz))
    cfg["nbody"] = [dict(b) for b in PLANET_DISK["nbody"]]
    return Config.from_dict(cfg)


def planet_torque(nrad: int, naz: int) -> Config:
    """The reference's type-I torque test (the leapfrog) on an ``nrad`` x
    ``naz`` grid."""
    cfg = dict(PLANET_TORQUE, Nrad=str(nrad), Naz=str(naz))
    cfg["nbody"] = [dict(b) for b in PLANET_TORQUE["nbody"]]
    return Config.from_dict(cfg)


def planet_accretion(nrad: int, naz: int) -> Config:
    """The reference's accretion test (the leapfrog, the corotating frame,
    a Kley-accreting planet, the MassFlow and gas-torque monitor grids) on
    an ``nrad`` x ``naz`` grid."""
    cfg = dict(PLANET_ACCRETION, Nrad=str(nrad), Naz=str(naz))
    cfg["nbody"] = [dict(b) for b in PLANET_ACCRETION["nbody"]]
    return Config.from_dict(cfg)


def setup_file(path: Path, nrad: int | None = None, naz: int | None = None,
               **overrides) -> dict:
    """A setup file of the repo as a mapping, on an ``nrad`` x ``naz``
    grid (the file's own where None), ``overrides`` replacing keys."""
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f)
    for key, n in (("Nrad", nrad), ("Naz", naz)):
        if n is not None:
            cfg[key] = str(n)
    cfg.update(overrides)
    return cfg


def binary_gcfull_setup(nrad: int, naz: int, **overrides) -> dict:
    """``setups/gamma_cephei_full.yml`` as a mapping, on an ``nrad`` x
    ``naz`` grid, ``overrides`` replacing keys (the tests' ``Rmin`` /
    ``Rmax``, ``StabilizeViscosity: 2``, ``AspectRatioMode: 2``,
    ``HydroFrameCenter: binary``)."""
    return setup_file(GAMMA_CEPHEI_FULL, nrad, naz, **overrides)


def binary_gcfull(nrad: int, naz: int, **overrides) -> Config:
    """``setups/gamma_cephei_full.yml`` (the circumbinary-disk menu, its
    writers and monitor grids included) on an ``nrad`` x ``naz`` grid;
    ``overrides`` replace keys."""
    return Config.from_dict(binary_gcfull_setup(nrad, naz, **overrides))


def oy_car(nrad: int = 200, naz: int = 200, **overrides) -> Config:
    """``setups/CloseBinaries/OY_Car.yml`` (the Roche-lobe-fed dwarf-nova
    disk, the Euler step) on an ``nrad`` x ``naz`` grid, its own 200 x 200
    by default; ``overrides`` replace keys (``ROFrampingtime`` makes the
    stream carry mass within a short run)."""
    return Config.from_dict(setup_file(OY_CAR, nrad, naz, **overrides))


def v1504cyg(nrad: int = 450, naz: int = 1070, **overrides) -> Config:
    """``setups/V1504Cyg.yml`` (PVTE, S-curve cooling, the Roche-lobe
    stream, the leapfrog) on an ``nrad`` x ``naz`` grid, its own 450 x 1070
    by default; ``overrides`` replace keys."""
    return Config.from_dict(setup_file(V1504CYG, nrad, naz, **overrides))


def planet_disk_sg_setup(nrad: int, naz: int, **overrides) -> dict:
    """``examples/quickstart.yml`` with ``SelfGravity: Yes`` (the Bessel
    kernel) as a mapping, on an ``nrad`` x ``naz`` grid, with the run
    control of the other timed setups; ``overrides`` replace keys."""
    return setup_file(QUICKSTART, nrad, naz, SelfGravity="Yes",
                      **{**_RUN, **overrides})


def planet_disk_sg(nrad: int, naz: int, **overrides) -> Config:
    """A planet in a self-gravitating disk (Bessel-kernel self-gravity) on
    an ``nrad`` x ``naz`` grid."""
    return Config.from_dict(planet_disk_sg_setup(nrad, naz, **overrides))


def full_physics(nrad: int = 128, naz: int = 256, **overrides) -> Config:
    """``examples/full_physics.yml`` (FLD, self-gravity, surface cooling,
    irradiation, 2000 diffusing dust particles) on an ``nrad`` x ``naz``
    grid, its own 128 x 256 by default; ``overrides`` replace keys."""
    return Config.from_dict(setup_file(FULL_PHYSICS, nrad, naz, **overrides))


def single_planet_no_disk(nrad: int | None = None, naz: int | None = None,
                          **overrides) -> Config:
    """``setups/single_planet_no_disk.yml`` (``Disk: no``) on an ``nrad``
    x ``naz`` grid, its own 32 x 64 by default; ``overrides`` replace
    keys."""
    return Config.from_dict(setup_file(SINGLE_PLANET_NO_DISK, nrad, naz,
                                       **overrides))


def shocktube_pvte(nrad: int = 1000, naz: int = 2, lookup: bool = True,
                   **overrides) -> Config:
    """The PVTE shock tube of the ``shocktube_pvte`` golden on an ``nrad``
    x ``naz`` grid, its own 1000 x 2 by default; ``lookup`` the
    reference's lookup table, else the bisection solve."""
    return Config.from_dict(setup_file(
        SHOCKTUBE_PVTE, nrad, naz,
        PVTELookupTable="Yes" if lookup else "No", **overrides))
