"""Physical constants in code units.

Mirrors reference src/constants.cpp (G = 1 in code units; kB, amu,
sigma_SB, R from NIST 2019 SI). Values are plain Python floats so they are
baked into jitted computations as compile-time constants.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import units as u


@dataclass(frozen=True)
class Constants:
    G: float = 1.0
    # specific gas constant ("R" in the reference = kB/amu) in code units
    R: float = 1.0
    sigma_sb: float = 0.0  # Stefan-Boltzmann
    c: float = 0.0         # speed of light
    cgs_G: float = u.CGS_G
    cgs_sigma_sb: float = u.CGS_SIGMA_SB

    @classmethod
    def from_units(cls, un: u.Units) -> "Constants":
        # G in code units: G_cgs / (L0^3 M0^-1 T0^-2) == 1 when T0 derived.
        G = u.CGS_G / (un.L0 ** 3 / (un.M0 * un.T0 ** 2))
        # specific gas constant: erg/(g K) -> code (velocity^2 / Temp0)
        R = u.CGS_RGAS / (un.velocity ** 2 / un.Temp0)
        # Stefan-Boltzmann for a 2-D code: erg cm^-2 s^-1 K^-4
        sigma_sb = u.CGS_SIGMA_SB / (un.energy_flux / un.Temp0 ** 4)
        c = u.CGS_C / un.velocity
        return cls(G=G, R=R, sigma_sb=sigma_sb, c=c)

    @classmethod
    def shock_tube(cls) -> "Constants":
        """Reference sets G = R = 1 exactly for shock-tube runs
        (src/init.cpp:511-517)."""
        return cls(G=1.0, R=1.0, sigma_sb=u.CGS_SIGMA_SB, c=u.CGS_C)
