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


# setups/gamma_cephei_full.yml, which binary_gcfull reads as it stands
GAMMA_CEPHEI_FULL = Path(__file__).resolve().parents[1] / "setups" \
    / "gamma_cephei_full.yml"

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


def binary_gcfull_setup(nrad: int, naz: int, **overrides) -> dict:
    """``setups/gamma_cephei_full.yml`` as a mapping, on an ``nrad`` x
    ``naz`` grid, ``overrides`` replacing keys (the tests' ``Rmin`` /
    ``Rmax``, ``StabilizeViscosity: 2``, ``AspectRatioMode: 2``,
    ``HydroFrameCenter: binary``)."""
    import yaml
    with open(GAMMA_CEPHEI_FULL) as f:
        cfg = yaml.safe_load(f)
    cfg.update(Nrad=str(nrad), Naz=str(naz), **overrides)
    return cfg


def binary_gcfull(nrad: int, naz: int, **overrides) -> Config:
    """``setups/gamma_cephei_full.yml`` (the circumbinary-disk menu, its
    writers and monitor grids included) on an ``nrad`` x ``naz`` grid;
    ``overrides`` replace keys."""
    return Config.from_dict(binary_gcfull_setup(nrad, naz, **overrides))
