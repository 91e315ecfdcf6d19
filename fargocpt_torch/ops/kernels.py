"""The fused ops of the time step, each as a hand-written CUDA kernel
(``csrc/*.cu``) and as its plain PyTorch version composed from the ported
ops: CFL, sources, viscous kick, the FARGO transport by one of three
routes: the whole transport as one op, the split route's two ops,
``radial_momenta_sweep`` and ``fargo_theta``, or the staged route's three,
``radial_sweep``, ``theta_sweep`` and ``advect_shift``, each with the glue
between its ops as PyTorch ops (``transport.route`` picks whole or split
per grid; the staged route runs where ``KernelContext`` is built with
``transport_route="staged"``); and the Stone-Norman artificial viscosity
substep, ``artvisc_sn``, which the steps outside the fused viscous kick's
gate run (the PVTE setups). Three more kernels replace no TPU kernel:
``ias15``, a whole adaptive IAS15 call of the N-body integrator on the
device (the JAX package's ``lax.while_loop``), with planets twice an
Euler step and four times a leapfrog step; ``pvte_refresh``, the cold
float64 PVTE refresh of ``ops/pvte.py`` (``PVTE.gamma_mu`` without a
lookup table; float64 only), which the JAX package leaves to XLA; and
``bodies_on_grid``, the bodies' ramped masses, Roche radii and cubic
smoothing radii (``nbody/system.py``; float64 only), which it also
leaves to XLA.

Each op's entry point (the names in ``OPS``) takes the plain version only
for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises. There is no fallback from a failed build or
launch to the plain version.

The kernels are built at first use with ``nvcc`` into
``build/fargocpt_torch/`` at the root of the checkout, as one shared
library with a plain C interface loaded through ``ctypes``: one ``nvcc``
per source, all started together, then one link. The library's file name
carries a hash of the sources and flags, so a stale build is never loaded.

Each op's entry point runs as the span ``kernels.<op>`` (its checks,
marshalling and launch), and ``telemetry`` counts, as ``launch.<op>``, the
calls that launched the op's kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .. import telemetry
from ..grid import Geometry
from ..nbody import ias15 as ias15_ops, system as nbody_sys
from ..params import Physics, ARTVISC_SN, ARTVISC_TW, LEAPFROG
from . import artvisc, cfl as cfl_ops, energy as energy_ops, eos, gravity, \
    pvte as pvte_ops, sources as src_ops, transport as tr_ops, \
    viscosity as visc
from .common import Geom

OPS = ("cfl", "sources", "viscous_kick", "transport",
       "radial_momenta_sweep", "fargo_theta", "artvisc_sn",
       "radial_sweep", "theta_sweep", "advect_shift", "ias15",
       "pvte_refresh", "bodies_on_grid")
# the ops whose library exports a float64 function only
F64_ONLY = ("pvte_refresh", "bodies_on_grid")
ROUTES = ("whole", "split", "staged")


# ---------------------------------------------------------------------------
# geometry columns shared by the kernels (order = csrc/common.cuh enum Col)
# ---------------------------------------------------------------------------

KERNEL_COLUMNS = (
    "rb", "inv_rb", "ra", "inv_ra", "invdrm", "inv_diff_rsup",
    "inv_diff_rsup_rb", "two_diff_ra_sq", "inv_surf", "cm", "cp", "coef",
    "src_invdxtheta", "hfac", "cs_iso", "omega_k", "drift", "inv_cell",
    "inv_dxrad", "inv_dxaz", "sum_rs_ri", "l_sq")
N_COLS = 24


def make_columns(phys: Physics, constants, geometry: Geometry) -> np.ndarray:
    """(NR+1, N_COLS) float64 table of the per-ring geometry the kernels
    read; rows past a column's length are zero."""
    nr = geometry.nrad
    rb = geometry.rmed
    rinf, rsup = geometry.rinf, geometry.rsup
    rme = geometry.rmed_ext
    dphi = geometry.dphi
    gm = constants.G * phys.hydro_center_mass
    omega_k = np.sqrt(gm / rb ** 3)
    hfac = 1.0 / (math.sqrt(phys.adiabatic_index) * omega_k) \
        if phys.is_adiabatic else 1.0 / omega_k
    dxrad = rsup - rinf
    dxaz = rb * dphi
    dr = geometry.ra[1:] - geometry.ra[:-1]
    dx_tw = np.minimum(dr, dxaz) if geometry.naz <= 16 else np.maximum(dr, dxaz)
    drift = np.zeros(nr)
    if phys.imposed_disk_drift != 0.0:
        drift = phys.imposed_disk_drift * 0.5 * rb ** (-2.5 + phys.sigma_slope)
    named = {
        "rb": rb, "inv_rb": geometry.inv_rmed, "ra": geometry.ra,
        "inv_ra": geometry.inv_rinf, "invdrm": geometry.inv_diff_rmed,
        "inv_diff_rsup": geometry.inv_diff_rsup,
        "inv_diff_rsup_rb": geometry.inv_diff_rsup_rb,
        "two_diff_ra_sq": geometry.two_diff_ra_sq,
        "inv_surf": geometry.inv_surf,
        "cm": np.concatenate([[0.0], rme[1:] - rme[:-1]]),
        "cp": np.concatenate([rme[1:] - rme[:-1], [0.0]]),
        "coef": dxrad,
        "src_invdxtheta": 2.0 / (dphi * (rsup + rinf)),
        "hfac": hfac,
        "cs_iso": phys.aspectratio_ref * rb ** phys.flaring_index
        * np.sqrt(gm / rb),
        "omega_k": omega_k,
        "drift": drift,
        "inv_cell": 1.0 / np.minimum(dxrad, dxaz),
        "inv_dxrad": 1.0 / dxrad,
        "inv_dxaz": 1.0 / dxaz,
        "sum_rs_ri": rsup + rinf,
        "l_sq": phys.artificial_viscosity_factor ** 2 * dx_tw ** 2,
    }
    table = np.zeros((nr + 1, N_COLS))
    for k, name in enumerate(KERNEL_COLUMNS):
        a = np.asarray(named[name], np.float64)
        table[:a.shape[0], k] = a
    return table


class KernelContext(nn.Module):
    """Everything the ops read besides the fields: the physics and
    constants, the ``Geom`` columns, the kernels' column table, the
    azimuth rows, the isothermal sound-speed profile, and the transport
    route: the grid's (``transport.route``) unless ``transport_route``
    names one of ``ROUTES``. All tensors are buffers, so ``.to(device)``
    moves every one of them."""

    def __init__(self, phys: Physics, constants, geometry: Geometry,
                 dtype: torch.dtype, device: torch.device | str | None = None,
                 transport_route: str | None = None):
        super().__init__()
        if transport_route not in (None, *ROUTES):
            raise ValueError(f"transport_route must be one of {ROUTES} or "
                             f"None, got {transport_route!r}")
        self.phys = phys
        self.constants = constants
        self.route = transport_route or tr_ops.route(geometry.nrad)
        self.g = Geom(geometry, dtype, device)
        self.register_buffer("cols", torch.tensor(
            make_columns(phys, constants, geometry), dtype=dtype,
            device=device))
        self.register_buffer("cos_row", torch.tensor(
            geometry.cos_phi, dtype=dtype, device=device))
        self.register_buffer("sin_row", torch.tensor(
            geometry.sin_phi, dtype=dtype, device=device))
        self.register_buffer("cs_iso", eos.sound_speed_iso_profile(
            phys, constants, self.g.rb))
        self._scratch: dict[tuple, tuple[torch.Tensor, ...]] = {}

    def transport_scratch(self, like: torch.Tensor, k: int):
        """The whole-transport kernel's scratch for fields like ``like``:
        the radially swept batch (K, NR, NAZ) and one plane (NR, NAZ).
        Allocated at first use and kept, one pair per dtype, K, device and
        CUDA stream, so two calls in flight on different streams never
        share one; calls on one stream run in order, and every call
        overwrites all it reads."""
        key = (like.dtype, k, like.device,
               torch.cuda.current_stream(like.device).cuda_stream)
        if key not in self._scratch:
            nr, naz = self.g.nrad, self.g.naz
            self._scratch[key] = tuple(
                torch.empty(shape, dtype=like.dtype, device=like.device)
                for shape in ((k, nr, naz), (nr, naz)))
        return self._scratch[key]

    def cfl_counter(self, like: torch.Tensor) -> torch.Tensor:
        """The cfl kernel's block counter: one int32, zero between calls
        (the kernel's last block sets it back to 0). Made at first use and
        kept per device and CUDA stream, like the transport's scratch, so
        two calls in flight on different streams never share one."""
        key = ("cfl", like.device,
               torch.cuda.current_stream(like.device).cuda_stream)
        if key not in self._scratch:
            self._scratch[key] = torch.zeros(1, dtype=torch.int32,
                                             device=like.device)
        return self._scratch[key]

    def cell_xy(self):
        """Cartesian cell centers (NR, NAZ)."""
        return self.g.rb * self.cos_row[None, :], \
            self.g.rb * self.sin_row[None, :]


# ---------------------------------------------------------------------------
# plain PyTorch versions (the definitions the kernels are held to)
# ---------------------------------------------------------------------------

def derived(ctx: KernelContext, sigma, energy, pvte_vals=None):
    """Sound speed, pressure and scale height (AspectRatioMode 0), with the
    PVTE grids ``pvte_vals`` when given."""
    phys, constants, g = ctx.phys, ctx.constants, ctx.g
    cs = eos.sound_speed(phys, constants, g, sigma, energy, ctx.cs_iso,
                         pvte_vals)
    press = eos.pressure(phys, constants, sigma, energy, cs, pvte_vals)
    h = eos.scale_height(phys, constants, g, cs, pvte_vals)
    return cs, press, h


def cfl_plain(ctx: KernelContext, sigma, vrad, vaz, energy, qplus, qminus):
    """CFL dt (0-d) from the ported condition_cfl."""
    cs, _, h = derived(ctx, sigma, energy)
    nu = visc.kinematic_viscosity(ctx.phys, ctx.g, cs, h)
    return cfl_ops.condition_cfl(ctx.phys, ctx.g, sigma, vrad, vaz, energy,
                                 cs, nu, qplus, qminus)


def sources_plain(ctx: KernelContext, sigma, vrad, vaz, energy,
                  bodies: gravity.BodiesOnGrid, indirect, omega_frame, dt,
                  h_smooth=None):
    """N-body potential + momentum source terms, without the compression
    heating. The potential's per-cell smoothing is eps times ``h_smooth``
    (NR, NAZ) where given, else eps times the scale height of the current
    fields. Returns (vrad, vaz)."""
    phys = ctx.phys
    _, press, h = derived(ctx, sigma, energy)
    cell_x, cell_y = ctx.cell_xy()
    pot = gravity.nbody_potential(phys, ctx.constants, ctx.g, bodies,
                                  bodies.x.shape[0], cell_x, cell_y,
                                  h if h_smooth is None else h_smooth,
                                  indirect[0], indirect[1])
    vrad, vaz, _ = src_ops.update_with_sourceterms(
        phys, ctx.g, sigma, press, pot, vrad, vaz, energy,
        omega_frame.to(sigma.dtype), dt, compress=False)
    return vrad, vaz


def viscous_kick_plain(ctx: KernelContext, sigma, vrad, vaz, energy, dt,
                       time, compress: bool = True, want_cs: bool = False):
    """Compression heating (optional), artificial viscosity, the clamp,
    viscosity and SubStep3. Returns (vrad, vaz, energy, qplus, qminus),
    with ``want_cs`` and the in-kick sound speed: the one the viscosity
    stage derives from the energy after the artificial viscosity and the
    clamp."""
    phys, constants, g = ctx.phys, ctx.constants, ctx.g
    if compress:
        energy = src_ops.compression_heating(phys, g, energy, vrad, vaz, dt)
    vrad, vaz, energy = artvisc.update_with_artificial_viscosity(
        phys, g, sigma, vrad, vaz, energy, dt)
    if phys.is_adiabatic and phys.artificial_viscosity_dissipation:
        energy = eos.energy_floor_ceiling(phys, constants, sigma, energy)
    cs, _, h = derived(ctx, sigma, energy)
    nu = visc.kinematic_viscosity(phys, g, cs, h)
    trr, tpp, trp, divv = visc.viscous_stress_tensor(phys, g, sigma, vrad,
                                                     vaz, nu)
    vrad, vaz = visc.update_velocities_with_viscosity(
        phys, g, sigma, vrad, vaz, trr, tpp, trp, dt)
    if not phys.is_adiabatic:
        qplus = qminus = torch.zeros_like(sigma)
    else:
        energy, qplus, qminus = energy_ops.substep3(
            phys, constants, g, sigma, energy, nu, trr, tpp, trp, divv, h,
            time, dt)
    if want_cs:
        return vrad, vaz, energy, qplus, qminus, cs
    return vrad, vaz, energy, qplus, qminus


def transport_plain(ctx: KernelContext, sigma, vrad, vaz, energy,
                    omega_frame, dt, shift, route=None):
    """The composed FARGO transport by ``route`` (the context's when
    None). Returns (sigma, vrad, vaz, energy, mass_flux)."""
    compose = {"whole": tr_ops.transport, "split": tr_ops.transport_split,
               "staged": tr_ops.transport_staged}[route or ctx.route]
    return compose(ctx.phys, ctx.g, sigma, vrad, vaz, energy,
                   omega_frame.to(sigma.dtype), dt, shift=shift)


def radial_momenta_sweep_plain(ctx: KernelContext, sigma, vrad, vaz, energy,
                               base, dt, omega_frame):
    """Momenta + radial sweep of the split route; (K, NR, NAZ)."""
    return tr_ops.radial_momenta_sweep(ctx.phys, ctx.g, sigma, vrad, vaz,
                                       energy, base, dt,
                                       omega_frame.to(sigma.dtype))


def fargo_theta_plain(ctx: KernelContext, qs, vres, vconst, nshift, dt,
                      two_pass: bool):
    """Azimuthal sweeps + integer roll of the split route; (K, NR, NAZ)."""
    return tr_ops.fargo_theta(ctx.phys, ctx.g, qs, vres, vconst, nshift, dt,
                              two_pass)


def radial_sweep_plain(ctx: KernelContext, qs, sigma, vrad, base, dt):
    """Radial sweep of the given batch of the staged route; (K, NR, NAZ)."""
    return tr_ops.radial_sweep(ctx.phys, ctx.g, qs, sigma, vrad, base, dt)


def theta_sweep_plain(ctx: KernelContext, qs, v, dt):
    """One azimuthal sweep of the batch of the staged route; (K, NR, NAZ)."""
    return tr_ops.theta_sweep(ctx.phys, ctx.g, qs, v, dt)


def advect_shift_plain(qs, nshift):
    """The per-ring integer roll of the staged route; (K, NR, NAZ)."""
    return tr_ops.advect_shift(qs, nshift)


def artvisc_sn_plain(ctx: KernelContext, sigma, vrad, vaz, energy, dt):
    """The Stone-Norman artificial viscosity. Returns (vrad, vaz, energy)."""
    return artvisc.update_sn(ctx.phys, ctx.g, sigma, vrad, vaz, energy, dt)


def ias15_plain(x, y, vx, vy, m, G, dt, counts: list | None = None):
    """One IAS15 call of ``nbody/ias15.py``: the bodies advanced by exactly
    ``dt`` in float64. Returns (x, y, vx, vy)."""
    return ias15_ops.integrate_ias15(x, y, vx, vy, m, G, dt, counts=counts)


def pvte_refresh_plain(pv: pvte_ops.PVTE, sigma, energy, scale_height):
    """The cold float64 PVTE refresh of the evaluator ``pv``: the cells'
    cgs density and specific energy (``PVTE.cgs``), then
    ``pvte.gamma_mu_bisect``. Returns (gamma_eff, mu, gamma1)."""
    rho_cgs, e_spec_cgs = pv.cgs(sigma, energy, scale_height)
    return pvte_ops.gamma_mu_bisect(rho_cgs, e_spec_cgs, pv.x_mf, pv.tabs)


def bodies_on_grid_plain(nb: nbody_sys.NBodyState, ramp_time=None,
                         cubic_factor=None, time=0.0):
    """The bodies as the gas sees them at ``time``: the masses ramped over
    ``ramp_time`` (``rampup_masses``; None: unramped), the dimensionless
    Roche radii (``roche_radius_plain``) and the cubic smoothing radii,
    Roche radius x distance to the primary x ``cubic_factor`` (None:
    zeros). Returns (mass, roche, cubic), float64 (N,)."""
    mass = nb.mass if ramp_time is None \
        else nbody_sys.rampup_masses(nb, ramp_time, time)
    roche = nbody_sys.roche_radius_plain(nb)
    if cubic_factor is None:
        cubic = torch.zeros_like(nb.x)
    else:
        cubic = roche * nbody_sys.dist_to_primary(nb) * cubic_factor
    return mass, roche, cubic


# ---------------------------------------------------------------------------
# build and launch
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" \
    / "fargocpt_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")


@dataclass
class BuildInfo:
    library: Path
    nvcc: str
    seconds: float      # compile + link time; 0.0 when a built library
                        # was found


_LIB: ctypes.CDLL | None = None
BUILD: BuildInfo | None = None


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found ($CUDA_HOME/bin, PATH, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libfargocpt_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{err}")


def _compile_and_link(nvcc: str, lib_path: Path) -> None:
    """Each source to an object, all at once, then the shared library;
    written under a temporary name and renamed, so a reader never finds
    half a library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"objects.{os.getpid()}"
    work.mkdir(exist_ok=True)
    try:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [work / f"{f.stem}.o" for f in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(f), "-o", str(o)]
                  for f, o in zip(srcs, objs)])
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def build() -> BuildInfo:
    """Build (if needed) and load the kernel library; idempotent."""
    global _LIB, BUILD
    if _LIB is not None:
        return BUILD
    lib_path = library_path()
    nvcc = find_nvcc()
    seconds = 0.0
    if not lib_path.exists():
        t0 = time.perf_counter()
        _compile_and_link(nvcc, lib_path)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    args = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    for op in OPS:
        for sfx in ("f64",) if op in F64_ONLY else ("f32", "f64"):
            fn = getattr(lib, f"fc_{op}_{sfx}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    lib.fc_error_string.argtypes = [ctypes.c_int]
    lib.fc_error_string.restype = ctypes.c_char_p
    _LIB = lib
    BUILD = BuildInfo(library=lib_path, nvcc=nvcc, seconds=seconds)
    return BUILD


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name: str, t: torch.Tensor, shape, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {like.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_nshift(nshift: torch.Tensor, nr: int, like: torch.Tensor) -> None:
    if nshift.dtype != torch.int32 or tuple(nshift.shape) != (nr,) \
            or nshift.device != like.device or not nshift.is_contiguous():
        raise ValueError("nshift must be a contiguous int32 (NR,) tensor on "
                         f"{like.device}")


def _launch(op: str, like: torch.Tensor, tensors: list[torch.Tensor],
            fp: list[float], ip: list[int], min_nr: int = 4) -> None:
    """Call fc_<op>_<dtype> on the current stream; raise on a CUDA error.
    ``ip`` starts with NR and NAZ; the op takes NR >= ``min_nr``. A None
    in ``tensors`` is a null pointer: an optional input or output that the
    call leaves out."""
    if like.device.type != "cuda":
        raise RuntimeError(f"{op}: the CUDA kernel needs CUDA tensors, got "
                           f"{like.device}")
    if like.dtype not in _SUFFIX:
        raise TypeError(f"{op}: kernels take float32 or float64, got "
                        f"{like.dtype}")
    if ip[0] < min_nr or ip[1] < 1:
        raise ValueError(f"{op}: the kernel needs NR >= {min_nr} and "
                         f"NAZ >= 1, got {ip[0]} x {ip[1]}")
    build()
    fn = getattr(_LIB, f"fc_{op}_{_SUFFIX[like.dtype]}")
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    fpa = (ctypes.c_double * len(fp))(*[float(x) for x in fp])
    ipa = (ctypes.c_int * len(ip))(*[int(x) for x in ip])
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ptrs, fpa, ipa, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {rc} "
                           f"({_LIB.fc_error_string(rc).decode()})")
    telemetry.count("launch." + op)


def _device_scalar(like: torch.Tensor, v, dtype: torch.dtype) -> torch.Tensor:
    """``v`` (a 0-d tensor or a float) as a one-element ``dtype`` tensor on
    ``like``'s device: a view, with no launch, where it already is one."""
    if torch.is_tensor(v):
        return v.reshape(1).to(device=like.device, dtype=dtype)
    return torch.full((1,), float(v), dtype=dtype, device=like.device)


def _scalar_as_held(like: torch.Tensor, v) -> tuple[torch.Tensor, int]:
    """``v`` (a 0-d tensor or a float) as a one-element tensor on ``like``'s
    device in the type the caller holds it in, and whether that is float64
    rather than ``like``'s type: a tensor in either is a view, with no
    launch; anything else becomes float64."""
    if torch.is_tensor(v) and v.dtype == like.dtype:
        return _device_scalar(like, v, like.dtype), 0
    return _device_scalar(like, v, torch.float64), 1


def _scalars(like: torch.Tensor, values) -> torch.Tensor:
    """Device vector of the field dtype from 0-d tensors / floats, built
    without a host round trip."""
    return torch.cat([_device_scalar(like, v, like.dtype) for v in values])


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@telemetry.spanned("kernels.cfl")
def cfl(ctx: KernelContext, sigma, vrad, vaz, energy, qplus, qminus):
    """CFL dt as a 0-d tensor of the field dtype."""
    if sigma.device.type == "cpu":
        return cfl_plain(ctx, sigma, vrad, vaz, energy, qplus, qminus)
    phys, g = ctx.phys, ctx.g
    nr, naz = g.nrad, g.naz
    if phys.stabilize_viscosity == 2:
        raise NotImplementedError(
            "StabilizeViscosity 2 lies outside the cfl kernel's gate "
            "(step.gates): the step takes ops/cfl.condition_cfl")
    for name, t, shape in (("sigma", sigma, (nr, naz)),
                           ("vrad", vrad, (nr + 1, naz)),
                           ("vaz", vaz, (nr, naz)),
                           ("energy", energy, (nr, naz)),
                           ("qplus", qplus, (nr, naz)),
                           ("qminus", qminus, (nr, naz)),
                           ("cols", ctx.cols, (nr + 1, N_COLS))):
        _check(name, t, shape, sigma)
    # the ring means and the ring maxima
    scratch = torch.empty(2 * nr, dtype=sigma.dtype, device=sigma.device)
    out = torch.empty((), dtype=sigma.dtype, device=sigma.device)
    lf = 0.6 if phys.hydro_integrator == LEAPFROG else 1.0
    fp = [phys.adiabatic_index, phys.viscous_alpha, phys.constant_viscosity,
          phys.artificial_viscosity_factor ** 2, lf,
          1.0 / phys.heating_cooling_cfl_limit, phys.cfl, g.dphi, g.invdphi]
    ip = [nr, naz, int(phys.is_adiabatic),
          int(phys.artificial_viscosity == ARTVISC_SN),
          int(phys.fast_transport)]
    _launch("cfl", sigma, [sigma, energy, vrad, vaz, qplus, qminus,
                           ctx.cols, scratch, ctx.cfl_counter(sigma), out],
            fp, ip, min_nr=3)
    return out


_SMOOTH_MODE = {"zero": 0, "scalar": 1, "cell": 2}


def smoothing_modes(phys: Physics, n_bodies: int) -> tuple[str, ...]:
    """Per-body potential smoothing: none (star in compatibility mode), a
    scalar eps*h at the body, or eps*H per cell."""
    return tuple(
        "zero" if (phys.compatibility_no_star_smoothing and k == 0)
        else "scalar" if phys.compatibility_smoothing_planetloc
        else "cell" for k in range(n_bodies))


def _body_vector(name: str, t: torch.Tensor, n: int,
                 like: torch.Tensor) -> torch.Tensor:
    """A per-body tensor as the kernel reads it: float64, contiguous, (n,),
    on ``like``'s device. The N-body state's tensors already are, so this
    is a view of them and launches nothing."""
    if tuple(t.shape) != (n,):
        raise ValueError(f"bodies.{name} has shape {tuple(t.shape)}, "
                         f"expected {(n,)}")
    return t.to(device=like.device, dtype=torch.float64).contiguous()


@telemetry.spanned("kernels.sources")
def sources(ctx: KernelContext, sigma, vrad, vaz, energy,
            bodies: gravity.BodiesOnGrid, indirect, omega_frame, dt,
            h_smooth=None):
    """Potential + momentum source terms, any number of bodies; the
    potential's "cell" smoothing is eps times ``h_smooth`` (NR, NAZ) where
    given (``sources_plain``). Returns (vrad, vaz)."""
    if sigma.device.type == "cpu":
        return sources_plain(ctx, sigma, vrad, vaz, energy, bodies,
                             indirect, omega_frame, dt, h_smooth)
    phys, g = ctx.phys, ctx.g
    nr, naz = g.nrad, g.naz
    if phys.is_polytropic:
        raise NotImplementedError(
            "the polytropic EoS lies outside the sources kernel's gate "
            "(step.gates)")
    for name, t, shape in (("sigma", sigma, (nr, naz)),
                           ("vrad", vrad, (nr + 1, naz)),
                           ("vaz", vaz, (nr, naz)),
                           ("energy", energy, (nr, naz)),
                           ("cols", ctx.cols, (nr + 1, N_COLS)),
                           ("cos_row", ctx.cos_row, (naz,)),
                           ("sin_row", ctx.sin_row, (naz,))):
        _check(name, t, shape, sigma)
    n_bodies = bodies.x.shape[0]
    if n_bodies < 1:
        raise ValueError("sources: the kernel takes at least one body")
    modes = smoothing_modes(phys, n_bodies)
    if h_smooth is not None and (not phys.is_adiabatic
                                 or "cell" not in modes):
        # the plane reaches only the "cell" smoothing, and a locally
        # isothermal H is the static profile the kernel derives itself:
        # without either the plane changes nothing, and is not read
        h_smooth = None
    if h_smooth is not None:
        _check("h_smooth", h_smooth, (nr, naz), sigma)
    # the kernel reads the bodies' float64 tensors, dt in the field type and
    # the frame rate and indirect terms as the caller holds them, and casts
    # them where the plain version does: no launch to pack them
    per_body = [_body_vector(name, getattr(bodies, name), n_bodies, sigma)
                for name in ("x", "y", "mass", "cubic_smoothing_radius")]
    held = [_scalar_as_held(sigma, v)
            for v in (omega_frame, indirect[0], indirect[1])]
    scal = [_device_scalar(sigma, dt, sigma.dtype)] + [t for t, _ in held]
    scalar_f64 = sum(is64 << k for k, (_, is64) in enumerate(held))
    vrad_out = torch.empty_like(vrad)
    vaz_out = torch.empty_like(vaz)
    fp = [phys.adiabatic_index, phys.thickness_smoothing, ctx.constants.G,
          phys.aspectratio_ref, phys.flaring_index]
    ip = [nr, naz, int(phys.is_adiabatic), n_bodies,
          int(phys.imposed_disk_drift != 0.0), _SMOOTH_MODE[modes[0]],
          _SMOOTH_MODE[modes[-1]], scalar_f64]
    _launch("sources", sigma, [sigma, energy, vaz, vrad, ctx.cols,
                               ctx.cos_row, ctx.sin_row, *scal, *per_body,
                               vrad_out, vaz_out, h_smooth], fp, ip)
    return vrad_out, vaz_out


@telemetry.spanned("kernels.viscous_kick")
def viscous_kick(ctx: KernelContext, sigma, vrad, vaz, energy, dt, time,
                 compress: bool = True, want_cs: bool = False):
    """Returns (vrad, vaz, energy, qplus, qminus), with ``want_cs`` and the
    in-kick sound speed (``viscous_kick_plain``), which the kernel then
    writes in the same launch."""
    if sigma.device.type == "cpu":
        return viscous_kick_plain(ctx, sigma, vrad, vaz, energy, dt, time,
                                  compress, want_cs)
    phys, constants, g = ctx.phys, ctx.constants, ctx.g
    nr, naz = g.nrad, g.naz
    if phys.is_adiabatic and energy_ops.beta_or_scurve_cooling(phys):
        raise NotImplementedError(
            "S-curve cooling, CoolingBetaMethod, CoolingBetaModel and "
            "CoolingBetaFloor lie outside the viscous_kick kernel's gate "
            "(step.gates): the step takes the unfused substeps")
    if phys.stabilize_viscosity != 0:
        raise NotImplementedError(
            "StabilizeViscosity lies outside the viscous_kick kernel's gate "
            "(step.gates): the step takes the unfused substeps")
    if phys.is_polytropic:
        raise NotImplementedError(
            "the polytropic EoS lies outside the viscous_kick kernel's gate "
            "(step.gates)")
    for name, t, shape in (("sigma", sigma, (nr, naz)),
                           ("vrad", vrad, (nr + 1, naz)),
                           ("vaz", vaz, (nr, naz)),
                           ("energy", energy, (nr, naz)),
                           ("cols", ctx.cols, (nr + 1, N_COLS))):
        _check(name, t, shape, sigma)
    # dt is read from the device; 1/beta is a static float unless the
    # cooling ramp makes it a tensor of the time
    dt_dev = _device_scalar(sigma, dt, sigma.dtype)
    beta_inv = energy_ops.beta_inverse(phys, time)
    beta_dev = torch.is_tensor(beta_inv)
    beta_ptr = _device_scalar(sigma, beta_inv, sigma.dtype) if beta_dev \
        else dt_dev
    outs = [torch.empty_like(vrad), torch.empty_like(vaz),
            torch.empty_like(energy), torch.empty_like(sigma),
            torch.empty_like(sigma)]
    cs_out = torch.empty_like(sigma) if want_cs else None
    gam = phys.adiabatic_index
    av = {ARTVISC_SN: 1, ARTVISC_TW: 2}.get(phys.artificial_viscosity, 0)
    fp = [gam, phys.viscous_alpha, phys.constant_viscosity,
          phys.artificial_viscosity_factor ** 2,
          phys.heating_viscous_factor, phys.radial_viscosity_factor,
          phys.minimum_temperature,
          eos.finite_in(phys.maximum_temperature, sigma.dtype),
          phys.mu, constants.R, constants.sigma_sb, constants.c,
          10.0 * phys.sigma0 * phys.sigma_floor, g.invdphi,
          0.0 if beta_dev else beta_inv]
    ip = [nr, naz, int(phys.is_adiabatic), av,
          int(phys.artificial_viscosity_dissipation), int(compress),
          int(phys.heating_viscous), int(phys.cooling_beta_enabled),
          int(beta_dev), int(want_cs)]
    _launch("viscous_kick", sigma,
            [sigma, vrad, vaz, energy, ctx.cols, dt_dev, beta_ptr, *outs,
             cs_out], fp, ip)
    return (*outs, cs_out) if want_cs else tuple(outs)


@telemetry.spanned("kernels.transport")
def transport(ctx: KernelContext, sigma, vrad, vaz, energy, omega_frame, dt,
              shift=None, route=None):
    """FARGO transport by ``route`` (the context's when None): on the
    whole route one op, on the split route ``radial_momenta_sweep`` and
    ``fargo_theta``, on the staged route ``radial_sweep``, ``theta_sweep``
    per pass and ``advect_shift``, with the glue between them. ``shift``
    is ``transport.fargo_shift``'s (vmean, nshift, vconst); computed here
    when not given. Returns (sigma, vrad, vaz, energy, mass_flux)."""
    if shift is None:
        shift = tr_ops.fargo_shift(ctx.g, vaz, dt)
    route = route or ctx.route
    if route == "staged":
        return tr_ops.transport_staged(
            ctx.phys, ctx.g, sigma, vrad, vaz, energy,
            omega_frame.to(sigma.dtype), dt, shift,
            radial=partial(radial_sweep, ctx),
            theta=partial(theta_sweep, ctx), roll=advect_shift)
    if route == "split":
        return tr_ops.transport_split(
            ctx.phys, ctx.g, sigma, vrad, vaz, energy,
            omega_frame.to(sigma.dtype), dt, shift,
            radial=partial(radial_momenta_sweep, ctx),
            theta=partial(fargo_theta, ctx))
    if sigma.device.type == "cpu":
        return transport_plain(ctx, sigma, vrad, vaz, energy, omega_frame,
                               dt, shift, "whole")
    phys, g = ctx.phys, ctx.g
    nr, naz = g.nrad, g.naz
    vmean, nshift, vconst = shift
    for name, t, shape in (("sigma", sigma, (nr, naz)),
                           ("vrad", vrad, (nr + 1, naz)),
                           ("vaz", vaz, (nr, naz)),
                           ("energy", energy, (nr, naz)),
                           ("cols", ctx.cols, (nr + 1, N_COLS)),
                           ("vmean", vmean, (nr, 1)),
                           ("vconst", vconst, (nr, 1))):
        _check(name, t, shape, sigma)
    _check_nshift(nshift, nr, sigma)
    k = 6 if phys.is_adiabatic else 5
    # the kernel reads dt in the field type and omega_frame in float64 (the
    # state's type) and casts it: no launch to pack them
    scal = [_device_scalar(sigma, dt, sigma.dtype),
            _device_scalar(sigma, omega_frame, torch.float64)]
    outs = [torch.empty_like(sigma), torch.empty_like(vrad),
            torch.empty_like(vaz), torch.empty_like(energy),
            torch.empty_like(vrad)]
    ip = [nr, naz, int(phys.is_adiabatic), phys.flux_limiter_type,
          int(phys.fast_transport)]
    _launch("transport", sigma,
            [sigma, vrad, vaz, energy, ctx.cols, *scal, vmean, nshift,
             vconst, *outs, *ctx.transport_scratch(sigma, k)], [g.dphi], ip)
    return tuple(outs)


@telemetry.spanned("kernels.radial_momenta_sweep")
def radial_momenta_sweep(ctx: KernelContext, sigma, vrad, vaz, energy, base,
                         dt, omega_frame):
    """The momenta [rp, rm, ap, am, (energy), sigma] built from the fields
    and swept radially with the sigma flux ``base`` (NR+1, NAZ), NR >= 3.
    Returns (K, NR, NAZ), K = 6 adiabatic, 5 isothermal."""
    if sigma.device.type == "cpu":
        return radial_momenta_sweep_plain(ctx, sigma, vrad, vaz, energy,
                                          base, dt, omega_frame)
    phys, g = ctx.phys, ctx.g
    nr, naz = g.nrad, g.naz
    for name, t, shape in (("sigma", sigma, (nr, naz)),
                           ("vrad", vrad, (nr + 1, naz)),
                           ("vaz", vaz, (nr, naz)),
                           ("energy", energy, (nr, naz)),
                           ("base", base, (nr + 1, naz)),
                           ("cols", ctx.cols, (nr + 1, N_COLS))):
        _check(name, t, shape, sigma)
    k = 6 if phys.is_adiabatic else 5
    out = torch.empty((k, nr, naz), dtype=sigma.dtype, device=sigma.device)
    _launch("radial_momenta_sweep", sigma,
            [sigma, vrad, vaz, energy, base, ctx.cols,
             _scalars(sigma, [dt, omega_frame]), out], [],
            [nr, naz, int(phys.is_adiabatic), phys.flux_limiter_type],
            min_nr=3)
    return out


@telemetry.spanned("kernels.fargo_theta")
def fargo_theta(ctx: KernelContext, qs, vres, vconst, nshift, dt,
                two_pass: bool):
    """Residual sweep of the (K, NR, NAZ) batch with ``vres`` (NR, NAZ),
    with ``two_pass`` the uniform sweep with ``vconst`` (NR, 1), then the
    per-ring roll by ``nshift`` (int32, NR). Returns (K, NR, NAZ)."""
    if qs.device.type == "cpu":
        return fargo_theta_plain(ctx, qs, vres, vconst, nshift, dt, two_pass)
    g = ctx.g
    nr, naz = g.nrad, g.naz
    k = qs.shape[0]
    for name, t, shape in (("qs", qs, (k, nr, naz)),
                           ("vres", vres, (nr, naz)),
                           ("vconst", vconst, (nr, 1)),
                           ("cols", ctx.cols, (nr + 1, N_COLS))):
        _check(name, t, shape, qs)
    _check_nshift(nshift, nr, qs)
    out = torch.empty_like(qs)
    _launch("fargo_theta", qs,
            [qs, vres, vconst, nshift, ctx.cols,
             _device_scalar(qs, dt, qs.dtype), out], [g.dphi],
            [nr, naz, k, ctx.phys.flux_limiter_type, int(two_pass)],
            min_nr=1)
    return out


@telemetry.spanned("kernels.radial_sweep")
def radial_sweep(ctx: KernelContext, qs, sigma, vrad, base, dt):
    """The batch ``qs`` (K, NR, NAZ), any K >= 1 and NR >= 3, swept
    radially in specific form (divided by ``sigma``) with the sigma flux
    ``base`` (NR+1, NAZ). Returns (K, NR, NAZ)."""
    if qs.device.type == "cpu":
        return radial_sweep_plain(ctx, qs, sigma, vrad, base, dt)
    g = ctx.g
    nr, naz = g.nrad, g.naz
    k = qs.shape[0]
    for name, t, shape in (("qs", qs, (k, nr, naz)),
                           ("sigma", sigma, (nr, naz)),
                           ("vrad", vrad, (nr + 1, naz)),
                           ("base", base, (nr + 1, naz)),
                           ("cols", ctx.cols, (nr + 1, N_COLS))):
        _check(name, t, shape, qs)
    out = torch.empty_like(qs)
    _launch("radial_sweep", qs,
            [qs, sigma, vrad, base, ctx.cols, _scalars(qs, [dt]), out], [],
            [nr, naz, k, ctx.phys.flux_limiter_type], min_nr=3)
    return out


@telemetry.spanned("kernels.theta_sweep")
def theta_sweep(ctx: KernelContext, qs, v, dt):
    """One azimuthal sweep of the batch ``qs`` (K, NR, NAZ), any K >= 1,
    entry K-1 the density, with the velocity ``v`` (NR, NAZ). Returns
    (K, NR, NAZ)."""
    if qs.device.type == "cpu":
        return theta_sweep_plain(ctx, qs, v, dt)
    g = ctx.g
    nr, naz = g.nrad, g.naz
    k = qs.shape[0]
    for name, t, shape in (("qs", qs, (k, nr, naz)), ("v", v, (nr, naz)),
                           ("cols", ctx.cols, (nr + 1, N_COLS))):
        _check(name, t, shape, qs)
    out = torch.empty_like(qs)
    _launch("theta_sweep", qs,
            [qs, v, ctx.cols, _device_scalar(qs, dt, qs.dtype), out],
            [g.dphi], [nr, naz, k, ctx.phys.flux_limiter_type], min_nr=1)
    return out


@telemetry.spanned("kernels.advect_shift")
def advect_shift(qs, nshift):
    """The per-ring integer roll of the batch ``qs`` (K, NR, NAZ) by
    ``nshift`` (int32, NR; any sign and size):
    out[k, i, j] = qs[k, i, (j - nshift[i]) mod NAZ]."""
    if qs.device.type == "cpu":
        return advect_shift_plain(qs, nshift)
    if qs.dim() != 3:
        raise ValueError(f"qs has shape {tuple(qs.shape)}, expected "
                         "(K, NR, NAZ)")
    k, nr, naz = qs.shape
    _check("qs", qs, (k, nr, naz), qs)
    _check_nshift(nshift, nr, qs)
    out = torch.empty_like(qs)
    _launch("advect_shift", qs, [qs, nshift, out], [], [nr, naz, k])
    return out


@telemetry.spanned("kernels.artvisc_sn")
def artvisc_sn(ctx: KernelContext, sigma, vrad, vaz, energy, dt):
    """The Stone-Norman artificial viscosity substep. Returns (vrad, vaz,
    energy)."""
    if sigma.device.type == "cpu":
        return artvisc_sn_plain(ctx, sigma, vrad, vaz, energy, dt)
    phys, g = ctx.phys, ctx.g
    nr, naz = g.nrad, g.naz
    for name, t, shape in (("sigma", sigma, (nr, naz)),
                           ("vrad", vrad, (nr + 1, naz)),
                           ("vaz", vaz, (nr, naz)),
                           ("energy", energy, (nr, naz)),
                           ("cols", ctx.cols, (nr + 1, N_COLS))):
        _check(name, t, shape, sigma)
    outs = [torch.empty_like(vrad), torch.empty_like(vaz),
            torch.empty_like(energy)]
    dissipation = phys.is_adiabatic and phys.artificial_viscosity_dissipation
    _launch("artvisc_sn", sigma,
            [sigma, vrad, vaz, energy, ctx.cols, _scalars(sigma, [dt])]
            + outs, [phys.artificial_viscosity_factor ** 2, g.invdphi],
            [nr, naz, int(dissipation)])
    return tuple(outs)


IAS15_LOCAL_BODIES = 16     # the per-thread arrays of csrc/ias15.cu
IAS15_WORK_VALUES = 66      # float64 workspace values a body beyond them


@telemetry.spanned("kernels.ias15")
def ias15(x, y, vx, vy, m, G, dt, counts: torch.Tensor | None = None):
    """The bodies (float64 (N,) tensors) advanced under mutual gravity by
    exactly ``dt`` (a 0-d tensor of the run dtype, or a float) with the
    adaptive IAS15 integrator, any N >= 2. On the GPU one launch runs the
    whole call, its substeps and corrector iterations, on the device, with
    no host read: up to 16 bodies in the thread's own arrays, beyond in a
    float64 workspace this wrapper allocates. ``counts``, an int32 (2,)
    tensor on the device, receives (accepted substeps, trial steps).
    Returns (x, y, vx, vy)."""
    if x.device.type == "cpu":
        got = []
        out = ias15_plain(x, y, vx, vy, m, G, dt, got)
        if counts is not None:
            counts.copy_(torch.tensor(got[0], dtype=torch.int32))
        return out
    n = x.shape[0]
    if n < 2:
        raise ValueError(f"ias15: the kernel takes 2 or more bodies, got {n}")
    for name, t in (("x", x), ("y", y), ("vx", vx), ("vy", vy),
                    ("mass", m)):
        _check(name, t, (n,), x)
    if x.dtype != torch.float64:
        raise TypeError(f"ias15: the bodies must be float64, got {x.dtype}")
    # dt in the type the caller holds it (float32 or float64), read on the
    # device: the suffix of the C function names it
    dt_dev = dt.reshape(1) if torch.is_tensor(dt) and dt.dtype in _SUFFIX \
        else torch.full((1,), float(dt), dtype=torch.float64,
                        device=x.device)
    if dt_dev.device != x.device:
        raise ValueError(f"ias15: dt is on {dt_dev.device}, expected "
                         f"{x.device}")
    if counts is None:
        counts = torch.empty(2, dtype=torch.int32, device=x.device)
    outs = [torch.empty_like(x) for _ in range(4)]
    work = torch.empty(IAS15_WORK_VALUES * n, dtype=torch.float64,
                       device=x.device) if n > IAS15_LOCAL_BODIES else None
    _launch("ias15", dt_dev, [x, y, vx, vy, m, dt_dev, *outs, counts, work],
            [G, ias15_ops.EPS_DEFAULT], [n, 1], min_nr=2)
    return tuple(outs)


def pvte_constants(pv: pvte_ops.PVTE) -> dict[str, float]:
    """The float parameters of csrc/pvte_refresh.cu, in the order of its
    ``PvteArgs``, each folded from Python floats as the plain version
    folds it (``ops/pvte.py``: ionization_fraction,
    dissociation_fraction, mean_molecular_weight, gas_energy_eps,
    func_dum_ln, temperature_from_energy, gamma1_at, PVTE.cgs), so that
    the kernel computes the same values."""
    x_mf, un = pv.x_mf, pv.units
    lo, w, coeffs = pv.tabs
    P = pvte_ops
    epsn = 1e-4
    return {
        "x_mf": x_mf,
        "cx": P.CGS_M_H / x_mf * (P.CGS_M_E * P.CGS_KB
                                  / (2 * math.pi * P.CGS_HBAR ** 2)) ** 1.5,
        "cy": P.CGS_M_H / (2.0 * x_mf)
        * (P.CGS_M_H * P.CGS_KB / (4 * math.pi * P.CGS_HBAR ** 2)) ** 1.5,
        "ex": -13.60 * P.CGS_EV,
        "ey": -4.48 * P.CGS_EV,
        "kb": P.CGS_KB,
        "two_xmf": 2.0 * x_mf,
        "c_hi": 1.5 * x_mf,
        "eps_he": 0.375 * (1.0 - x_mf),
        "c_hh": 4.48 * P.CGS_EV * x_mf,
        "two_kb": 2.0 * P.CGS_KB,
        "c_hii": 13.60 * P.CGS_EV * x_mf,
        "c_h2": 0.5 * x_mf,
        "fd_lo": lo,
        "fd_hi": lo + coeffs.shape[0] * w,
        "fd_w": w,
        "fd_inv_w": 1.0 / w,
        "inv_r": 1.0 / (P.CGS_KB / P.CGS_MP),
        "lo_fac": 1 - epsn,
        "hi_fac": 1 + epsn,
        "density_factor": pv.density_factor,
        "to_density": un.density,
        "to_e_spec": un.energy_density / un.surface_density,
    }


@telemetry.spanned("kernels.pvte_refresh")
def pvte_refresh(pv: pvte_ops.PVTE, sigma, energy, scale_height):
    """(gamma_eff, mu, gamma1) of the cells of ``sigma`` and ``energy``
    (any shape; ``scale_height`` of the same shape, unread for a shock
    tube) by the evaluator ``pv``'s cold float64 refresh: 48 halvings of
    log10 T and gamma1 by finite differences. Float64 only. On the GPU one
    launch, a thread a cell."""
    if sigma.dtype != torch.float64:
        raise TypeError(f"pvte_refresh: the refresh is float64, got "
                        f"{sigma.dtype}")
    if sigma.device.type == "cpu":
        return pvte_refresh_plain(pv, sigma, energy, scale_height)
    shock_tube = pv.shock_tube > 0
    h = None if shock_tube else scale_height
    coeffs = pv.tabs[2]
    for name, t in (("sigma", sigma), ("energy", energy),
                    ("scale_height", h)):
        if t is not None:
            _check(name, t, sigma.shape, sigma)
    _check("funcdum coefficients", coeffs, (pvte_ops.FUNCDUM_SEGMENTS,
                                            pvte_ops.FUNCDUM_DEGREE + 1),
           sigma)
    n = sigma.numel()
    if n >= 2 ** 31:
        raise ValueError(f"pvte_refresh: {n} cells, the kernel takes fewer "
                         "than 2**31")
    outs = [torch.empty_like(sigma) for _ in range(3)]
    _launch("pvte_refresh", sigma, [sigma, energy, h, coeffs, *outs],
            list(pvte_constants(pv).values()), [n, 1, int(shock_tube)],
            min_nr=1)
    return tuple(outs)


@telemetry.spanned("kernels.bodies_on_grid")
def bodies_on_grid(nb: nbody_sys.NBodyState, ramp_time=None,
                   cubic_factor=None, time=0.0):
    """``bodies_on_grid_plain``'s (mass, roche, cubic) of the float64
    bodies ``nb`` (any N >= 1) at ``time``, a float or a 0-d tensor of the
    run type. On the GPU one launch, a thread a body, with no host read and
    no upload: a device ``time`` is read by the kernel, a float is one of
    its arguments."""
    like = nb.mass
    if like.dtype != torch.float64:
        raise TypeError(f"bodies_on_grid: the bodies are float64, got "
                        f"{like.dtype}")
    if like.device.type == "cpu":
        return bodies_on_grid_plain(nb, ramp_time, cubic_factor, time)
    n = like.shape[0]
    per_body = []
    for name, t in (("x", nb.x), ("y", nb.y), ("mass", nb.mass),
                    ("ramp_time", ramp_time),
                    ("cubic_factor", cubic_factor)):
        if t is not None:
            t = t.contiguous()
            _check(name, t, (n,), like)
        per_body.append(t)
    if torch.is_tensor(time) and time.device.type != "cpu":
        if time.device != like.device:
            raise ValueError(f"bodies_on_grid: time is on {time.device}, "
                             f"expected {like.device}")
        if time.dtype not in _SUFFIX or time.numel() != 1:
            raise TypeError("bodies_on_grid: time must be one float32 or "
                            f"float64 value, got {time.dtype} "
                            f"{tuple(time.shape)}")
        t_dev, t_arg = time.reshape(1), 0.0
        kind = 1 if time.dtype == torch.float32 else 2
    else:
        t_dev, t_arg, kind = None, float(time), 0
    out = torch.empty((3, n), dtype=torch.float64, device=like.device)
    outs = [out[0], out[1], out[2]]
    _launch("bodies_on_grid", like, [*per_body, t_dev, *outs],
            [t_arg, math.pi / 2.0], [n, 1, kind], min_nr=1)
    return tuple(outs)
