"""Analysis loader for simulation output.

Python data API replacing the reference python module
(python_module/fargocpt/data.py ``Loader``): units-aware reading of
snapshots, 1-D profiles, monitor scalars and per-body orbit files from the
reference-layout output directory. Pure numpy (astropy-free): unit
conversion is exposed as plain cgs factors from units.yml.

Example::

    from fargocpt_tpu.analysis import Loader
    l = Loader("output/out")
    r, phi, sigma = l.gas.get("Sigma", N=5)         # code units
    sigma_cgs = sigma * l.units["mass surface density"]["factor"]
    t, mass = l.quantities("time", "mass")
    orbit = l.nbody(1)                              # dict of columns
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import yaml


class GasVars:
    def __init__(self, loader: "Loader"):
        self._l = loader

    def get(self, name: str, N: int | str = "last", grid: bool = True,
            cgs: bool = False):
        """2-D field of snapshot N. Returns (R, PHI, data) cell-center
        meshes when ``grid`` else just the data array; ``cgs`` applies the
        info2D.yml code->cgs factor."""
        l = self._l
        sid = l.resolve_snapshot(N)
        path = l.outdir / "snapshots" / sid / f"{name}.dat"
        data = np.fromfile(path, np.float64)
        nrad = data.size // l.naz
        data = data.reshape(nrad, l.naz)
        if cgs:
            data = data * self.cgs_factor(name)
        if not grid:
            return data
        if nrad == l.nrad + 1:        # radial-face field
            r = l.radii
        else:
            r = l.rmed
        phi = (np.arange(l.naz) + 0.0) * 2 * np.pi / l.naz
        R, PHI = np.meshgrid(r[:nrad], phi, indexing="ij")
        return R, PHI, data

    def avg(self, name: str, N: int | str = "last"):
        """(radius, azimuthal average) from the 1-D profile file, falling
        back to averaging the 2-D field."""
        l = self._l
        sid = l.resolve_snapshot(N)
        path1d = l.outdir / "snapshots" / sid / f"{name}1D.dat"
        if path1d.exists():
            raw = np.fromfile(path1d, np.float64).reshape(-1, 4)
            return raw[:, 0], raw[:, 1]
        data = self.get(name, N, grid=False)
        r = l.radii if data.shape[0] == l.nrad + 1 else l.rmed
        return r[:data.shape[0]], data.mean(axis=1)

    def minmax(self, name: str, N: int | str = "last"):
        l = self._l
        raw = np.fromfile(
            l.outdir / "snapshots" / l.resolve_snapshot(N)
            / f"{name}1D.dat", np.float64).reshape(-1, 4)
        return raw[:, 0], raw[:, 2], raw[:, 3]

    def var_names(self, N: int | str = "last") -> list[str]:
        """2-D field names present in snapshot N."""
        l = self._l
        sdir = l.outdir / "snapshots" / l.resolve_snapshot(N)
        return sorted(p.stem for p in sdir.glob("*.dat")
                      if not p.stem.endswith("1D")
                      and p.stem not in ("used_rad",))

    def cgs_factor(self, name: str) -> float:
        """code->cgs factor of a 2-D field from info2D.yml (1.0 when the
        field has no registered unit)."""
        spec = self._l.info2d.get(name, {})
        return float(spec.get("code_to_cgs_factor", 1.0))


class ParticleVars:
    """Reader of the per-snapshot ``particles.bin`` records, described by
    ``infoParticles.yml`` (reference python_module/fargocpt/data.py
    ``Particles``: per-variable access, derived cartesian coordinates,
    multi-snapshot timeseries)."""

    _DERIVED = ("x", "y", "vx", "vy")

    def __init__(self, loader: "Loader"):
        self._l = loader
        self.columns: list[str] = []
        self.factors: dict[str, float] = {}
        info = loader.outdir / "infoParticles.yml"
        if info.exists():
            spec = yaml.safe_load(info.read_text()) or {}
            for col in (spec.get("particles", {}) or {}).get("columns", []):
                self.columns.append(str(col["name"]))
                self.factors[str(col["name"])] = float(col.get("factor", 1.0))

    @property
    def var_names(self) -> list[str]:
        return self.columns + [n for n in self._DERIVED if self.columns]

    def _raw(self, N):
        path = self._l.outdir / "snapshots" \
            / self._l.resolve_snapshot(N) / "particles.bin"
        raw = np.fromfile(path, np.float64)
        ncols = len(self.columns) or 9
        if raw.size % ncols:                      # older 7-column records
            ncols = 7
        return raw.reshape(-1, ncols)

    def get(self, varname: str, N: int | str = "last", cgs: bool = False):
        """One column (or derived cartesian variable) for snapshot N."""
        arr = self._raw(N)
        cols = self.columns or ["r", "phi", "r dot", "phi dot", "size",
                                "stokes", "alive", "timestep", "facold"]
        if varname in self._DERIVED:
            r, phi = arr[:, cols.index("r")], arr[:, cols.index("phi")]
            if varname == "x":
                out = r * np.cos(phi)
            elif varname == "y":
                out = r * np.sin(phi)
            else:
                rd = arr[:, cols.index("r dot")]
                pd = arr[:, cols.index("phi dot")]
                if varname == "vx":
                    out = rd * np.cos(phi) - r * pd * np.sin(phi)
                else:
                    out = rd * np.sin(phi) + r * pd * np.cos(phi)
            fac = self.factors.get("r", 1.0)
            if varname in ("vx", "vy"):
                fac = self.factors.get("r dot", 1.0)
            return out * fac if cgs else out
        idx = cols.index(varname)
        if idx >= arr.shape[1]:
            raise KeyError(f"column {varname!r} absent from this snapshot")
        out = arr[:, idx]
        return out * self.factors.get(varname, 1.0) if cgs else out

    def timeseries(self, varnames, snapshots=None, cgs: bool = False):
        """dict of (n_snapshots, n_particles) arrays over the requested
        snapshots (default: all registered)."""
        if isinstance(varnames, str):
            varnames = [varnames]
        sids = snapshots if snapshots is not None else self._l.snapshots
        return {v: np.stack([self.get(v, sid, cgs=cgs) for sid in sids])
                for v in varnames}


class Params:
    """Config provenance of a snapshot (the copied ``config.yml``),
    dict-like (reference python_module/fargocpt/data.py ``Params``)."""

    def __init__(self, loader: "Loader", N: int | str = "last"):
        path = loader.outdir / "snapshots" / loader.resolve_snapshot(N) \
            / "config.yml"
        if not path.exists():                      # fall back to the run copy
            path = loader.outdir / "parameters" / "setup.yml"
        self._data = yaml.safe_load(path.read_text()) or {}

    def __getitem__(self, key):
        for k, v in self._data.items():
            if str(k).lower() == str(key).lower():
                return v
        raise KeyError(key)

    def __contains__(self, key):
        try:
            self[key]
            return True
        except KeyError:
            return False

    def keys(self):
        return self._data.keys()


class Loader:
    """Units-aware reader of a simulation output directory."""

    def __init__(self, outdir: str | Path):
        self.outdir = Path(outdir)
        dims = np.genfromtxt(self.outdir / "dimensions.dat", dtype=None,
                             encoding=None, names=True)
        header = open(self.outdir / "dimensions.dat").readlines()[1].split()
        self.rmin = float(header[0])
        self.rmax = float(header[1])
        self.nrad = int(header[4])
        self.naz = int(header[5])
        self.radii = np.genfromtxt(self.outdir / "used_rad.dat")
        rinf, rsup = self.radii[:-1], self.radii[1:]
        self.rmed = (2.0 / 3.0) * (rsup ** 3 - rinf ** 3) \
            / (rsup ** 2 - rinf ** 2)
        units_file = self.outdir / "units.yml"
        self.units = yaml.safe_load(units_file.read_text()) \
            if units_file.exists() else {}
        const_file = self.outdir / "constants.yml"
        self.constants = yaml.safe_load(const_file.read_text()) \
            if const_file.exists() else {}
        info2d_file = self.outdir / "info2D.yml"
        self.info2d = yaml.safe_load(info2d_file.read_text()) \
            if info2d_file.exists() else {}
        self.gas = GasVars(self)
        self.particles = ParticleVars(self)

    def params(self, N: int | str = "last") -> Params:
        return Params(self, N)

    # -- snapshots -----------------------------------------------------
    @property
    def snapshots(self) -> list[str]:
        path = self.outdir / "snapshots" / "list.txt"
        if not path.exists():
            return []
        return [x.strip() for x in path.read_text().split() if x.strip()]

    def resolve_snapshot(self, N) -> str:
        if N == "last":
            return self.snapshots[-1]
        return str(N)

    def misc(self, N: int | str = "last") -> dict:
        from .output import load_misc
        return load_misc(self.outdir / "snapshots" / self.resolve_snapshot(N))

    def nbody_state(self, N: int | str = "last") -> dict:
        arr = np.fromfile(
            self.outdir / "snapshots" / self.resolve_snapshot(N)
            / "nbody.bin", np.float64).reshape(-1, 5)
        return {"x": arr[:, 0], "y": arr[:, 1], "vx": arr[:, 2],
                "vy": arr[:, 3], "mass": arr[:, 4]}

    # -- monitor scalars -------------------------------------------------
    def _read_monitor(self, filename: str):
        path = self.outdir / "monitor" / filename
        cols = {}
        for line in path.read_text().splitlines():
            if line.startswith("#variable:"):
                _, rest = line.split(":", 1)
                idx, name, _unit = [p.strip() for p in rest.split("|")]
                cols[name] = int(idx)
            elif not line.startswith("#"):
                break
        data = np.loadtxt(path, ndmin=2)
        return cols, data

    def quantities(self, *names: str):
        """Columns of monitor/Quantities.dat by name."""
        cols, data = self._read_monitor("Quantities.dat")
        out = tuple(data[:, cols[n]] for n in names)
        return out if len(out) > 1 else out[0]

    def nbody(self, k: int) -> dict:
        """All columns of monitor/nbody{k}.dat keyed by name."""
        cols, data = self._read_monitor(f"nbody{k}.dat")
        return {name: data[:, idx] for name, idx in cols.items()}

    def timestep_log(self) -> dict:
        cols, data = self._read_monitor("timestepLogging.dat")
        return {name: data[:, idx] for name, idx in cols.items()}


# -- ``fargocpt_tpu data`` CLI ------------------------------------------

def _describe(obj, recursive: bool = False, indent: int = 0) -> None:
    """Print a structural summary of a Loader node (the analog of the
    reference Loader's .print(), python_module/fargocpt/data.py:1090-1151)."""
    pad = "  " * indent
    if isinstance(obj, Loader):
        print(f"{pad}Loader({obj.outdir})")
        print(f"{pad}  grid: {obj.nrad} x {obj.naz}  "
              f"r in [{obj.rmin:g}, {obj.rmax:g}]")
        print(f"{pad}  snapshots: {obj.snapshots}")
        print(f"{pad}  gas: {obj.gas.var_names()}")
        pnames = obj.particles.var_names
        pnames = pnames() if callable(pnames) else pnames
        if pnames:
            print(f"{pad}  particles: {pnames}")
        mon = sorted(p.name for p in (obj.outdir / "monitor").glob("*.dat")) \
            if (obj.outdir / "monitor").exists() else []
        print(f"{pad}  monitor: {mon}")
        print(f"{pad}  attrs: gas particles radii rmed units constants "
              f"snapshots misc nbody_state quantities params")
        if recursive:
            _describe(obj.gas, recursive, indent + 1)
    elif isinstance(obj, GasVars):
        print(f"{pad}gas 2D/1D variables: {obj.var_names()}")
        print(f"{pad}  use: gas.get(NAME, N) / gas.avg(NAME, N) / "
              f"gas.minmax(NAME, N)")
    elif isinstance(obj, ParticleVars):
        pnames = obj.var_names
        print(f"{pad}particle variables: "
              f"{pnames() if callable(pnames) else pnames}")
    else:
        print(f"{pad}{obj}")


def data_print(output_dir, path=None, N=None, recursive=False) -> None:
    """Navigate a dotted ``path`` into the Loader and print the node
    (reference python_module/fargocpt/data.py:1120-1151 ``data_print``:
    attribute access, integer list indexing, and an ``obj.get(p, N)``
    fallback for named variables)."""
    import sys as _sys
    try:
        loader = Loader(output_dir)
    except FileNotFoundError as exc:
        print(exc)
        _sys.exit(1)
    obj = loader
    if path:
        for p in path.split("."):
            try:
                idx = int(p)
            except ValueError:
                idx = None
            if idx is not None:
                obj = obj[idx]
            else:
                try:
                    obj = getattr(obj, p)
                except AttributeError:
                    if hasattr(obj, "get") and N is not None:
                        obj = obj.get(p, N)
                    else:
                        raise
        if callable(obj) and not isinstance(obj, (GasVars, ParticleVars)):
            obj = obj()
    if isinstance(obj, (Loader, GasVars, ParticleVars)):
        _describe(obj, recursive=recursive)
    else:
        print(obj)


def data_main(args) -> int:
    """``fargocpt_tpu data OUTDIR [path [N]] [-r]`` (reference
    python_module/fargocpt/data.py:1153-1162)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="fargocpt_tpu data", description="Inspect simulation output.")
    parser.add_argument("output_dir", help="simulation output directory")
    parser.add_argument("path", nargs="?", default=None,
                        help="dotted path, e.g. 'gas' or 'gas.Sigma'")
    parser.add_argument("N", nargs="?", default=None,
                        help="snapshot number (or 'last')")
    parser.add_argument("-r", "--recursive", action="store_true",
                        help="print the full data structure")
    opts = parser.parse_args(args)
    data_print(opts.output_dir, opts.path, opts.N, opts.recursive)
    return 0
