"""Polar-grid geometry.

Replaces the reference's global radial arrays (src/global.h:62-99,
src/init.cpp:78-255 ``init_radialarrays``). All geometry is precomputed as
numpy arrays in float64; inside a jitted step they become XLA constants.

Grid layout (reference src/polargrid.h:13-16, src/split.cpp:66-76):
  * ``NR`` scalar rings, ring 0 and ring NR-1 are ghost rings
    (GHOSTCELLS_B = 1, reference src/constants.h:19).
  * interface radii ``radii[0..NR]``; the active domain is
    [radii[1], radii[NR-1]] = [rmin, rmax].
  * radial-face ("vector") fields such as v_rad carry NR+1 rings, ring i
    living at radius radii[i].

Spacings (reference src/init.cpp:90-140): Logarithmic, Arithmetic,
Exponential, or custom interface radii.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

LOGARITHMIC = "logarithmic"
ARITHMETIC = "arithmetic"
EXPONENTIAL = "exponential"
CUSTOM = "custom"

_SPACING_ALIASES = {
    "log": LOGARITHMIC,
    "logarithmic": LOGARITHMIC,
    "arithmetic": ARITHMETIC,
    "linear": ARITHMETIC,
    "exponential": EXPONENTIAL,
    "exp": EXPONENTIAL,
    "custom": CUSTOM,
}


def normalize_spacing(name: str) -> str:
    key = str(name).strip().lower()
    if key not in _SPACING_ALIASES:
        raise ValueError(f"unknown radial spacing {name!r}")
    return _SPACING_ALIASES[key]


def interface_radii(nrad: int, rmin: float, rmax: float, spacing: str,
                    exp_cell_size_factor: float = 1.41,
                    n_extra: int = 2) -> np.ndarray:
    """Interface radii radii[0 .. nrad + n_extra].

    Matches reference src/init.cpp:90-140: radii[1] = rmin,
    radii[nrad-1] = rmax; one ghost ring extends below/above. ``n_extra``
    virtual interfaces beyond the outer ghost supply Rmed[NR] etc. for the
    transport stencils (reference allocates a 15-entry search buffer).
    """
    spacing = normalize_spacing(spacing)
    n = np.arange(nrad + n_extra + 1, dtype=np.float64)
    if spacing == LOGARITHMIC:
        g = (rmax / rmin) ** (1.0 / (nrad - 2.0))
        return rmin * g ** (n - 1.0)
    if spacing == ARITHMETIC:
        interval = (rmax - rmin) / (nrad - 2.0)
        return rmin + interval * (n - 1.0)
    if spacing == EXPONENTIAL:
        # Newton iteration for the growth factor (reference src/init.cpp:108-135)
        gf_log = (rmax / rmin) ** (1.0 / (nrad - 2.0))
        first = rmin * (gf_log - 1.0) * exp_cell_size_factor
        f = (rmax - rmin) / first
        nr = float(nrad - 2)
        x = 1.02
        for _ in range(500000):
            fx = x ** nr - x * f + f - 1.0
            dfx = nr * x ** (nr - 1.0) - f
            step = fx / dfx
            x = x - step
            if abs(step) < 1e-15:
                break
        return rmin + first * (x ** (n - 1.0) - 1.0) / (x - 1.0)
    raise ValueError("custom spacing requires explicit radii")


def _rmed(rinf: np.ndarray, rsup: np.ndarray) -> np.ndarray:
    # center-of-area radius (reference src/init.cpp:174-183)
    return (2.0 / 3.0) * (rsup ** 3 - rinf ** 3) / (rsup ** 2 - rinf ** 2)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """All radial geometry arrays + azimuthal spacing. Immutable."""

    nrad: int            # number of scalar rings (incl. 2 ghost rings)
    naz: int
    rmin: float
    rmax: float
    spacing: str

    radii: np.ndarray      # (NR+1,)  interface radii
    radii_ext: np.ndarray  # (NR+1+n_extra,) with virtual outer interfaces
    rmed: np.ndarray       # (NR,)    cell-center radii (Rb)
    rmed_ext: np.ndarray   # (NR+1,)  incl. virtual Rmed[NR]
    rinf: np.ndarray       # (NR,)    = radii[:-1]
    rsup: np.ndarray       # (NR,)    = radii[1:]
    ra: np.ndarray         # (NR+1,)  face radii (= radii)
    surf: np.ndarray       # (NR,)    cell area
    inv_surf: np.ndarray   # (NR,)
    inv_rmed: np.ndarray   # (NR,)
    inv_rinf: np.ndarray   # (NR+1,)  1/ra
    inv_diff_rmed: np.ndarray      # (NR+1,)  1/(Rmed[i]-Rmed[i-1]), [0] = 0
    inv_diff_rsup: np.ndarray      # (NR,)    1/(Rsup-Rinf)
    inv_diff_rsup_rb: np.ndarray   # (NR,)    1/((Rsup-Rinf)*Rmed)
    two_diff_ra_sq: np.ndarray     # (NR,)    2/(Rsup^2-Rinf^2)
    four_third_inv_rb_invdphi_sq: np.ndarray  # (NR,)
    dphi: float
    invdphi: float
    phi: np.ndarray        # (NAZ,) azimuth of cell centers j*dphi
    cos_phi: np.ndarray
    sin_phi: np.ndarray

    @classmethod
    def build(cls, nrad: int, naz: int, rmin: float, rmax: float,
              spacing: str = LOGARITHMIC, exp_cell_size_factor: float = 1.41,
              custom_radii: np.ndarray | None = None) -> "Geometry":
        spacing = normalize_spacing(spacing) if custom_radii is None else CUSTOM
        n_extra = 2
        if custom_radii is not None:
            base = np.asarray(custom_radii, dtype=np.float64)
            if base.size < nrad + 1:
                raise ValueError("custom radii must have nrad+1 entries")
            # extrapolate virtual interfaces geometrically
            g = base[-1] / base[-2]
            extra = [base[-1] * g ** (k + 1) for k in range(n_extra)]
            radii_ext = np.concatenate([base[:nrad + 1], np.array(extra)])
        else:
            radii_ext = interface_radii(nrad, rmin, rmax, spacing,
                                        exp_cell_size_factor, n_extra)
        radii = radii_ext[:nrad + 1]
        rinf_ext = radii_ext[:-1]
        rsup_ext = radii_ext[1:]
        rmed_all = _rmed(rinf_ext, rsup_ext)   # (NR+n_extra,)
        rmed = rmed_all[:nrad]
        rmed_ext = rmed_all[:nrad + 1]
        rinf = radii[:-1]
        rsup = radii[1:]
        dphi = 2.0 * math.pi / naz
        surf = math.pi * (rsup ** 2 - rinf ** 2) / naz
        inv_diff_rmed = np.zeros(nrad + 1)
        inv_diff_rmed[1:] = 1.0 / (rmed_ext[1:] - rmed_ext[:-1])
        phi = np.arange(naz, dtype=np.float64) * dphi
        return cls(
            nrad=nrad, naz=naz, rmin=float(rmin), rmax=float(rmax),
            spacing=spacing,
            radii=radii, radii_ext=radii_ext, rmed=rmed, rmed_ext=rmed_ext,
            rinf=rinf, rsup=rsup, ra=radii, surf=surf,
            inv_surf=1.0 / surf, inv_rmed=1.0 / rmed, inv_rinf=1.0 / radii,
            inv_diff_rmed=inv_diff_rmed,
            inv_diff_rsup=1.0 / (rsup - rinf),
            inv_diff_rsup_rb=1.0 / ((rsup - rinf) * rmed),
            two_diff_ra_sq=2.0 / (rsup ** 2 - rinf ** 2),
            four_third_inv_rb_invdphi_sq=(4.0 / 3.0) / rmed / dphi ** 2,
            dphi=dphi, invdphi=1.0 / dphi,
            phi=phi, cos_phi=np.cos(phi), sin_phi=np.sin(phi),
        )

    @classmethod
    def from_config(cls, cfg) -> "Geometry":
        nrad = cfg.get("Nrad", 64, type=int)
        naz = cfg.get("Naz", 64, type=int)
        from .units import DIM_LENGTH
        rmin = cfg.get("Rmin", 0.4, dim=DIM_LENGTH, type=float)
        rmax = cfg.get("Rmax", 2.5, dim=DIM_LENGTH, type=float)
        spacing = cfg.get("RadialSpacing", "Logarithmic", type=str)
        # 'cps' (cells per scale height) overrides Nrad/Naz (reference
        # src/Interpret.cpp:206-228): the grid is sized so each cell spans
        # H/cps radially and matches that size azimuthally.
        cps = cfg.get("cps", -1.0, type=float)
        if cps > 0:
            h = cfg.get("AspectRatio", 0.05, type=float)
            kind = normalize_spacing(spacing)
            if kind == ARITHMETIC:
                nrad = round(cps * (rmax - rmin) / h)
                naz = round(2.0 * math.pi / (rmax - rmin) * nrad)
            elif kind == LOGARITHMIC:
                nrad = round(math.log(rmax / rmin) / math.log(1.0 + h / cps))
                naz = round(2.0 * math.pi /
                            ((rmax / rmin) ** (1.0 / nrad) - 1.0))
            else:
                raise ValueError(
                    "cps grid sizing requires Log or Arithmetic spacing")
        ecf = cfg.get("ExponentialCellSizeFactor", 1.41, type=float)
        custom = None
        if spacing.lower().startswith("cus"):
            # custom interface radii from file (reference
            # src/init.cpp:143-160 reads 'radii.dat': NR+1 ascii floats)
            path = cfg.get("RadiiFile", "radii.dat", type=str)
            custom = np.loadtxt(path).ravel()
        return cls.build(nrad, naz, rmin, rmax, spacing, ecf,
                         custom_radii=custom)


    # convenience: column views for broadcasting against (NR, NAZ) fields
    def col(self, name: str) -> np.ndarray:
        return getattr(self, name)[:, None]

    @property
    def n_active(self) -> int:
        return self.nrad - 2

    def cell_centers_xy(self) -> tuple[np.ndarray, np.ndarray]:
        """Cartesian cell centers, shape (NR, NAZ) each."""
        x = self.rmed[:, None] * self.cos_phi[None, :]
        y = self.rmed[:, None] * self.sin_phi[None, :]
        return x, y
