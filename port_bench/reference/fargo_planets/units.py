"""Code-unit system.

Mirrors the semantics of the reference unit system (reference:
src/units.cpp:133-189 ``set_baseunits`` and :270 ``calculate_unit_factors``)
without the vendored LLNL units library: base units L0 (length), M0 (mass),
T0 (time) and Temp0 (temperature) define conversion factors from code units
to cgs; every derived quantity's factor is a product of powers of those.

Unit strings in config values ("1 au", "0.334 solMass", "1890.673 g/cm2")
are parsed with a small dimensional-analysis parser over a table of known
cgs-convertible units.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass


# --- cgs values of named units -------------------------------------------
# dimension vector: (length, mass, time, temperature)

Dim = tuple[float, float, float, float]

DIMLESS: Dim = (0.0, 0.0, 0.0, 0.0)

# The values the reference CODE actually uses: LLNL-units CODATA-2019
# physical constants (src/units/units.hpp:2030-2063, selected by the
# default non-PLUTO build, src/constants.cpp:48-86) and the LLNL astro
# units (src/units.cpp:113-119). Note solMass = 1.98847e33 g — NOT the
# 1.98892e30 kg some reference yml comments quote; the golden-fidelity
# gates (<1e-6) pin these against the reference binary.
CGS_AU = 1.495978707e13           # cm (units.cpp:115, IAU 2012)
CGS_SOLMASS = 1.98847e33          # g  (units.cpp:113)
CGS_G = 6.6743e-8                 # cm^3 g^-1 s^-2 (units.hpp:2034)
CGS_YEAR = 3.15576e7              # Julian year in s
CGS_SOLRADIUS = 6.957e10          # cm (units.cpp:114)
CGS_EARTHMASS = 5.97217e27        # g  (units.cpp:118)
CGS_EARTHRADIUS = 6.371e8         # cm (units.cpp:119)
CGS_JUPITERMASS = 1.8982e30       # g  (units.cpp:116)
CGS_JUPITERRADIUS = 6.9911e9      # cm (units.cpp:117)
CGS_KB = 1.380649e-16             # erg/K (units.hpp:2063, SI exact)
CGS_AMU = 1.66053906660e-24       # g (units.hpp:2053)
CGS_RGAS = CGS_KB / CGS_AMU       # erg/(g K) — specific gas constant per amu
CGS_SIGMA_SB = 5.670374419e-5     # erg cm^-2 s^-1 K^-4 (2 pi^5 k^4 / (15 h^3 c^2))
CGS_C = 2.99792458e10             # cm/s
CGS_H_PLANCK = 6.62607015e-27     # erg s


def _dim(l=0.0, m=0.0, t=0.0, k=0.0) -> Dim:
    return (float(l), float(m), float(t), float(k))


# name -> (cgs factor, dimension)
_UNIT_TABLE: dict[str, tuple[float, Dim]] = {
    # length
    "cm": (1.0, _dim(l=1)),
    "m": (100.0, _dim(l=1)),
    "km": (1e5, _dim(l=1)),
    "au": (CGS_AU, _dim(l=1)),
    "AU": (CGS_AU, _dim(l=1)),
    "solRadius": (CGS_SOLRADIUS, _dim(l=1)),
    "earthRadius": (CGS_EARTHRADIUS, _dim(l=1)),
    "jupiterRadius": (CGS_JUPITERRADIUS, _dim(l=1)),
    # mass
    "g": (1.0, _dim(m=1)),
    "kg": (1e3, _dim(m=1)),
    "solMass": (CGS_SOLMASS, _dim(m=1)),
    "earthMass": (CGS_EARTHMASS, _dim(m=1)),
    "jupiterMass": (CGS_JUPITERMASS, _dim(m=1)),
    # time
    "s": (1.0, _dim(t=1)),
    "sec": (1.0, _dim(t=1)),
    "min": (60.0, _dim(t=1)),
    "h": (3600.0, _dim(t=1)),
    "day": (86400.0, _dim(t=1)),
    "days": (86400.0, _dim(t=1)),
    "yr": (CGS_YEAR, _dim(t=1)),
    "year": (CGS_YEAR, _dim(t=1)),
    "years": (CGS_YEAR, _dim(t=1)),
    "kyr": (1e3 * CGS_YEAR, _dim(t=1)),
    "Myr": (1e6 * CGS_YEAR, _dim(t=1)),
    # temperature
    "K": (1.0, _dim(k=1)),
    # energy (decomposes into base dims)
    "erg": (1.0, _dim(l=2, m=1, t=-2)),
    "J": (1e7, _dim(l=2, m=1, t=-2)),
}

_TOKEN_RE = re.compile(
    r"(?P<unit>[A-Za-z]+)(?:\^?(?P<exp>-?\d+(?:\.\d+)?))?"
)


class UnitError(ValueError):
    pass


def parse_unit_expr(expr: str) -> tuple[float, Dim]:
    """Parse a unit expression like ``g/cm2``, ``solMass/yr``, ``cm^2/s``.

    Returns (cgs_factor, dimension).
    """
    expr = expr.strip()
    if not expr:
        return 1.0, DIMLESS
    factor = 1.0
    dim = [0.0, 0.0, 0.0, 0.0]
    # split on '/' — segments after the first are inverted
    parts = expr.split("/")
    for iseg, seg in enumerate(parts):
        sign = 1.0 if iseg == 0 else -1.0
        seg = seg.strip()
        if not seg:
            continue
        for tok in re.split(r"[\s*]+", seg):
            tok = tok.strip()
            if not tok:
                continue
            mobj = _TOKEN_RE.fullmatch(tok)
            if mobj is None:
                raise UnitError(f"cannot parse unit token {tok!r} in {expr!r}")
            name = mobj.group("unit")
            exp = float(mobj.group("exp") or 1.0)
            if name not in _UNIT_TABLE:
                raise UnitError(f"unknown unit {name!r} in {expr!r}")
            f, d = _UNIT_TABLE[name]
            factor *= f ** (sign * exp)
            for i in range(4):
                dim[i] += sign * exp * d[i]
    return factor, tuple(dim)  # type: ignore[return-value]


def split_value_unit(value: str) -> tuple[float, str]:
    s = str(value).strip()
    m = re.match(r"^(?P<num>[-+0-9.eE]+)\s*(?P<unit>.*)$", s)
    if m is None:
        raise UnitError(f"cannot parse value {value!r}")
    return float(m.group("num")), m.group("unit").strip()


@dataclass
class Units:
    """Code-unit system: cgs conversion factors for all quantities.

    ``L0``/``M0``/``T0``/``Temp0`` are the cgs values of one code unit of
    length/mass/time/temperature (reference: src/units.cpp:133-189).
    """

    L0: float = CGS_AU
    M0: float = CGS_SOLMASS
    T0: float = 0.0     # derived if 0
    Temp0: float = 0.0  # derived if 0
    mu: float = 1.0     # mean molecular weight used to derive Temp0

    def __post_init__(self):
        if self.T0 == 0.0:
            # G = 1 in code units: T0 = sqrt(L0^3 / (G M0))
            self.T0 = math.sqrt(self.L0 ** 3 / (CGS_G * self.M0))
        if self.Temp0 == 0.0:
            # Temp0 = G mu m_u M0 / (kB L0)  (reference src/units.cpp:181-185,
            # with mu = 1 amu reference molecular weight)
            self.Temp0 = CGS_G * CGS_AMU * self.M0 / (CGS_KB * self.L0)

    @classmethod
    def from_config_strings(cls, l0: str = "1.0", m0: str = "1.0",
                            t0: str | None = None,
                            temp0: str | None = None) -> "Units":
        """Build from the YAML keys l0/m0/t0/temp0.

        Bare numbers are interpreted as multiples of au / solMass
        (reference src/units.cpp:158-167).
        """
        def _to_cgs(vs: str, implicit_cgs: float, want_dim: Dim) -> float:
            num, unit = split_value_unit(str(vs))
            if unit:
                f, d = parse_unit_expr(unit)
                if d != want_dim:
                    raise UnitError(f"unit {unit!r} has wrong dimension")
                return num * f
            return num * implicit_cgs

        L0 = _to_cgs(l0, CGS_AU, _dim(l=1))
        M0 = _to_cgs(m0, CGS_SOLMASS, _dim(m=1))
        T0 = _to_cgs(t0, 1.0, _dim(t=1)) if t0 is not None else 0.0
        Temp0 = _to_cgs(temp0, 1.0, _dim(k=1)) if temp0 is not None else 0.0
        return cls(L0=L0, M0=M0, T0=T0, Temp0=Temp0)

    # -- factor for an arbitrary dimension vector --------------------------
    def cgs_factor(self, dim: Dim) -> float:
        return (self.L0 ** dim[0]) * (self.M0 ** dim[1]) * \
               (self.T0 ** dim[2]) * (self.Temp0 ** dim[3])

    def convert_to_code(self, value: float, unit_expr: str, target_dim: Dim) -> float:
        """value given in `unit_expr` -> code units of dimension target_dim."""
        f, d = parse_unit_expr(unit_expr)
        if d != target_dim:
            raise UnitError(
                f"unit {unit_expr!r} (dim {d}) incompatible with expected dim {target_dim}")
        return value * f / self.cgs_factor(target_dim)

    # -- derived-quantity factors (code -> cgs) -----------------------------
    @property
    def length(self):
        return self.L0

    @property
    def mass(self):
        return self.M0

    @property
    def time(self):
        return self.T0

    @property
    def temperature(self):
        return self.Temp0

    @property
    def velocity(self):
        return self.L0 / self.T0

    @property
    def surface_density(self):
        return self.M0 / self.L0 ** 2

    @property
    def density(self):
        return self.M0 / self.L0 ** 3

    @property
    def energy(self):
        return self.M0 * self.L0 ** 2 / self.T0 ** 2

    @property
    def energy_density(self):
        # per-area energy density (2-D code): erg/cm^2
        return self.M0 / self.T0 ** 2

    @property
    def energy_flux(self):
        # energy / (area * time)
        return self.M0 / self.T0 ** 3

    @property
    def opacity(self):
        return self.L0 ** 2 / self.M0

    @property
    def power(self):
        return self.energy / self.T0

    @property
    def mass_accretion_rate(self):
        return self.M0 / self.T0

    @property
    def angular_momentum(self):
        return self.M0 * self.L0 ** 2 / self.T0

    @property
    def kinematic_viscosity(self):
        return self.L0 ** 2 / self.T0

    @property
    def pressure(self):
        # 2-D pressure = force/length = M/T^2
        return self.M0 / self.T0 ** 2

    @property
    def potential(self):
        return self.velocity ** 2

    @property
    def acceleration(self):
        return self.L0 / self.T0 ** 2

    @property
    def torque(self):
        return self.energy

    @property
    def frequency(self):
        return 1.0 / self.T0


# dimension vectors for the quantities used in config parsing
DIM_LENGTH = _dim(l=1)
DIM_MASS = _dim(m=1)
DIM_TIME = _dim(t=1)
DIM_TEMPERATURE = _dim(k=1)
DIM_SURFACE_DENSITY = _dim(l=-2, m=1)
DIM_DENSITY = _dim(l=-3, m=1)
DIM_VELOCITY = _dim(l=1, t=-1)
DIM_MDOT = _dim(m=1, t=-1)
DIM_KINEMATIC_VISCOSITY = _dim(l=2, t=-1)
DIM_OPACITY = _dim(l=2, m=-1)
