"""The setups that ``chip_smoke.py`` and ``profile_step`` run.

``pds70``: ``__graft_entry__._pds70`` whole (BASELINE.json configs[4]):
the gas setup below with its Lagrangian dust, 16384 particles of 4 sizes
from 1 cm, the exponential midpoint integrator.

``flagship``: the JAX package's ``__graft_entry__._flagship`` (adiabatic
disk, alpha viscosity, SN artificial viscosity, viscous heating, local beta
cooling, FARGO transport, one star).

``pds70_gas``: the gas part of ``__graft_entry__._pds70`` (BASELINE.json
configs[4]): the variable-gamma PVTE equation of state, FLD radiative
diffusion, symmetric FFT self-gravity, thermal surface cooling, viscous
heating, SN artificial viscosity, FARGO transport, one star, without the
dust (``IntegrateParticles: no``).
"""

from __future__ import annotations

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
