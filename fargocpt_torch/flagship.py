"""The flagship setup: the JAX package's ``__graft_entry__._flagship``
(adiabatic disk, alpha viscosity, SN artificial viscosity, viscous heating,
local beta cooling, FARGO transport, one star), the configuration that
``chip_smoke.py`` and ``profile_step`` run."""

from __future__ import annotations

from .config import Config

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
    "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "1.0",
    # run control, not physics: start near the CFL limit, so short runs
    # evolve and a timed window runs at the steady step size
    "FirstDT": "1e-3",
}


def flagship(nrad: int, naz: int) -> Config:
    """The flagship setup on an ``nrad`` x ``naz`` grid."""
    return Config.from_dict(dict(FLAGSHIP, Nrad=str(nrad), Naz=str(naz)))
