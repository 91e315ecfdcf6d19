"""Runs fargocpt_torch's main paths on one CUDA GPU and checks them.

    python3 chip_smoke.py

Two setups (fargocpt_torch/flagship.py). The flagship (constant gamma)
takes the fused kernels: cfl, sources, viscous_kick, and the transport by
one of two routes (fargocpt_torch/ops/transport.route): the
whole-transport kernel when NR is a multiple of 16 (1024x3072), else the
split route's two kernels, radial_momenta_sweep and fargo_theta
(1000x3072). The PDS70 gas setup (PVTE, FLD, FFT self-gravity, surface
cooling) takes the unfused substeps with the artvisc_sn kernel and the
whole-transport kernel (1024x3072). All three paths are driven here.

Phases (any failure raises, so the exit code is not 0):
  1. environment: GPU name and power limit, torch/CUDA versions, nvcc,
     and the build of the CUDA kernels from fargocpt_torch/csrc;
  2. per-kernel parity: each of the seven kernels against its plain
     PyTorch version on the same GPU tensors, at full size in float32 (a
     setup's state with seeded noise: the flagship at 1024x3072 for the
     whole route's four kernels and at 1000x3072 for the split route's
     two, the PDS70 gas state at 1024x3072 for artvisc_sn, whose outputs
     are measured against the plain version's increments) and at 130x200
     float64 (seeded random fields), plus each one's time beside the plain
     version's (CUDA events, median of 25 calls) and its least time on the
     card: the bytes of its inputs and outputs at the memory rate against
     the floating-point operations of its plain version (counted by
     FlopCounter) at the float32 rate; and the split route as a whole
     against the whole-transport kernel on the same 1000x3072 state;
  3. the slices: the flagship Simulation on the GPU at 1024x3072 and at
     1000x3072 float32 (10 warm-up and 60 timed steps each of
     calculate_time_step + step_once), the 1000x3072 step through each
     route in turns (split, whole, whole, split), and the PDS70 gas
     Simulation at 1024x3072 float32 (3 warm-up and 15 timed steps, then
     the run path's advance_to over about 15 steps), each with the launch
     counters set to 0 before and read after; the PDS70 lines add the FLD
     SOR iterations and the PVTE refreshes per step;
  4. the trajectories against the CPU: the flagship, whole route, 256x512
     float32 for 200 steps (rel-L2 < 1e-3 per field) and 128x256 float64
     for 20 steps (rel-L2 < 1e-9); split route 250x512 float32 for 200
     steps and 130x256 float64 for 20 steps, the same budgets; the PDS70
     gas setup at 64x128, float32 for 200 steps and float64 for 20, the
     same budgets. The GPU run goes through the kernels and the CPU run
     through the plain versions, both on the GPU run's dt sequence. Then
     the PDS70 gas setup at 128x384 float32 for 200 steps on the GPU with
     one warm PVTE Newton step against three (rel-L2 < 1e-4, the budget
     of a warm against a cold PVTE refresh).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits with code 2 and prints neither.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

NR, NAZ = 1024, 3072          # whole transport route
NR_SPLIT = 1000               # split transport route (NR % 16 != 0)
ROUTE_OPS = {"whole": ("transport",),
             "split": ("radial_momenta_sweep", "fargo_theta")}

KERNELS = {
    "cfl": ("fargocpt_torch/csrc/cfl.cu",
            "fargocpt_tpu/ops/pallas_kernels.py:838"),
    "sources": ("fargocpt_torch/csrc/sources.cu",
                "fargocpt_tpu/ops/pallas_kernels.py:396"),
    "viscous_kick": ("fargocpt_torch/csrc/viscous_kick.cu",
                     "fargocpt_tpu/ops/pallas_kernels.py:1470"),
    "transport": ("fargocpt_torch/csrc/transport.cu",
                  "fargocpt_tpu/ops/pallas_kernels.py:1098"),
    "radial_momenta_sweep": ("fargocpt_torch/csrc/radial_momenta_sweep.cu",
                             "fargocpt_tpu/ops/pallas_kernels.py:192"),
    "fargo_theta": ("fargocpt_torch/csrc/fargo_theta.cu",
                    "fargocpt_tpu/ops/pallas_kernels.py:495"),
    "artvisc_sn": ("fargocpt_torch/csrc/artvisc_sn.cu",
                   "fargocpt_tpu/ops/pallas_kernels.py:721"),
}
# The card's published peaks (H100 SXM data sheet, at 700 W): device
# memory rate, and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 at full size, as a fraction of each output's scale (velocities are
# scaled by max|vaz|, as in tests/test_dtype_budget.py; every plane of a
# (K, NR, NAZ) batch by its own max): the kernels read geometry columns
# computed in float64 and the plain versions difference float32 radii
# (Rsup - Rinf ~ 2e-3 r); the two have differed by <= 6.4e-6 of the scale
# on the perturbed flagship state
F32_TOL = 1e-5
# f64 at 130x200: the tolerances of tests/test_torch_kernels.py
# (rtol 1e-11 for the split route's two kernels, 1e-12 for artvisc_sn)
F64_RTOL = {"cfl": 1e-12, "sources": 1e-11, "viscous_kick": 1e-10,
            "transport": 1e-11, "radial_momenta_sweep": 1e-11,
            "fargo_theta": 1e-11, "artvisc_sn": 1e-12}


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def flagship(nr, naz, dtype, device):
    from fargocpt_torch.flagship import flagship as flagship_config
    from fargocpt_torch.sim import Simulation
    return Simulation(flagship_config(nr, naz), dtype=dtype, device=device)


def pds70(nr, naz, dtype, device):
    from fargocpt_torch.flagship import pds70_gas
    from fargocpt_torch.sim import Simulation
    return Simulation(pds70_gas(nr, naz), dtype=dtype, device=device)


def time_ms(fn, reps=25) -> float:
    """Median over ``reps`` calls of the device time of ``fn``."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# --- phase 2 -----------------------------------------------------------------

def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class FlopCounter(TorchDispatchMode):
    """Counts the floating-point operations of the PyTorch calls made
    under it: each arithmetic op, math function, min/max and compare on
    floating-point tensors counts once per element of its largest operand
    or result (so a reduction counts its input). Data movement (copies,
    casts, cat, stack, roll, gather) and selects count nothing."""

    COUNTED = frozenset((
        "add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "rsqrt",
        "reciprocal", "exp", "log", "pow", "floor", "sign", "maximum",
        "minimum", "clamp", "clamp_min", "clamp_max", "max", "min", "amax",
        "amin", "sum", "mean", "gt", "lt", "ge", "le", "eq", "ne"))

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__.rstrip("_") in self.COUNTED:
            ts = [t for t in (*args, *(kwargs or {}).values(),
                              *(out if isinstance(out, tuple) else (out,)))
                  if torch.is_tensor(t)]
            if any(t.is_floating_point() for t in ts):
                self.flops += max(t.numel() for t in ts)
        return out


def flops_of(fn) -> int:
    """The floating-point operations of one call of ``fn``, a plain
    version: the function itself, each value computed once per element."""
    with FlopCounter() as fc:
        fn()
    return fc.flops


def bound(inputs, outputs, flops) -> dict:
    """Least time on the card: each input read once and each output
    written once at the memory rate, against the function's operations
    at the float32 rate; the larger of the two."""
    t_bytes = (nbytes(inputs) + nbytes(outputs)) / HBM_BYTES_PER_S
    t_ops = flops / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def op_calls(ctx, f, q, bodies, omega, dt):
    """name -> (kernel call, plain call, output names, inputs) of the
    whole route's four ops on one state."""
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops import transport as tr
    zero = torch.zeros((), dtype=torch.float64, device=f["sigma"].device)
    shift = tr.fargo_shift(ctx.g, f["vaz"], dt)
    s, vr, va, e = f["sigma"], f["vrad"], f["vaz"], f["energy"]
    fields = [s, vr, va, e, ctx.cols]
    return {
        "cfl": (lambda: (K.cfl(ctx, s, vr, va, e, *q),),
                lambda: (K.cfl_plain(ctx, s, vr, va, e, *q),), ("dt",),
                fields + list(q)),
        "sources": (
            lambda: K.sources(ctx, s, vr, va, e, bodies, (zero, zero),
                              omega, dt),
            lambda: K.sources_plain(ctx, s, vr, va, e, bodies, (zero, zero),
                                    omega, dt), ("vrad", "vaz"),
            fields + [ctx.cos_row, ctx.sin_row]),
        "viscous_kick": (
            lambda: K.viscous_kick(ctx, s, vr, va, e, dt, 0.0),
            lambda: K.viscous_kick_plain(ctx, s, vr, va, e, dt, 0.0),
            ("vrad", "vaz", "energy", "qplus", "qminus"), fields),
        "transport": (
            lambda: K.transport(ctx, s, vr, va, e, omega, dt, shift,
                                route="whole"),
            lambda: K.transport_plain(ctx, s, vr, va, e, omega, dt, shift,
                                      route="whole"),
            ("sigma", "vrad", "vaz", "energy", "mass_flux"),
            fields + list(shift)),
    }


def split_calls(ctx, f, omega, dt):
    """name -> (kernel call, plain call, output names, inputs) of the split
    route's two ops on one state, each fed what the transport feeds it."""
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops import transport as tr
    g, phys = ctx.g, ctx.phys
    s, vr, va, e = f["sigma"], f["vrad"], f["vaz"], f["energy"]
    vmean, nshift, vconst = tr.fargo_shift(g, va, dt)
    base = tr.sigma_flux(phys, g, s, vr, dt)
    rms = (s, vr, va, e, base, dt, omega)
    qs = K.radial_momenta_sweep_plain(ctx, *rms)
    vres = va - vmean
    if not phys.fast_transport:
        vres = vres + vconst
    ft = (qs, vres, vconst, nshift, dt, phys.fast_transport)
    return {
        "radial_momenta_sweep": (
            lambda: (K.radial_momenta_sweep(ctx, *rms),),
            lambda: (K.radial_momenta_sweep_plain(ctx, *rms),), ("qs",),
            [s, vr, va, e, base, ctx.cols]),
        "fargo_theta": (
            lambda: (K.fargo_theta(ctx, *ft),),
            lambda: (K.fargo_theta_plain(ctx, *ft),), ("qs",),
            [qs, vres, vconst, nshift, ctx.cols]),
    }


def perturbed(sim) -> dict:
    """The simulation's fields with seeded noise (the unperturbed disk is
    axisymmetric, which would leave the azimuthal stencils untested)."""
    st = sim.state
    gen = torch.Generator(device=st.fields.sigma.device).manual_seed(7)

    def noisy(t, rel=0.0, add=0.0):
        u = 2.0 * torch.rand(t.shape, generator=gen, device=t.device,
                             dtype=t.dtype) - 1.0
        return t * (1.0 + rel * u) + add * u

    return {"sigma": noisy(st.fields.sigma, rel=1e-2),
            "vrad": noisy(st.fields.vrad, add=1e-4),
            "vaz": noisy(st.fields.vaz, add=1e-3),
            "energy": noisy(st.fields.energy, rel=1e-2)}


def output_scales(name, oname, ref, f) -> list[float]:
    """The scale each output's error is measured against: velocities by
    max|vaz| (as in tests/test_dtype_budget.py), each plane of a
    (K, NR, NAZ) batch by its own max (rp and rm, sigma vrad, are ~1e-4
    of the angular momenta), every other quantity by its own max.
    artvisc_sn adds small increments to its inputs (on the perturbed PDS70
    state ~3e-5 of max|vaz| to vaz, ~8e-6 of max e to e), so each of its
    outputs is measured against the plain version's increment, max
    |plain - input| in float64 (the error of the increments is the error of
    the outputs). One float32 ulp of vaz or e is then ~5e-3 of the scale:
    the check holds only where kernel and plain agree bit for bit, as a
    kernel that follows its plain version operation by operation does. An
    increment of 0 everywhere raises, as it would test nothing."""
    if name == "artvisc_sn":
        inc = float((ref.double() - f[oname].double()).abs().max())
        if not inc > 0.0:
            raise AssertionError(f"artvisc_sn leaves {oname} unchanged")
        return [inc]
    if oname in ("vrad", "vaz"):
        return [float(f["vaz"].abs().max())]
    if oname == "qs":
        return [float(ref[k].abs().max()) for k in range(ref.shape[0])]
    return [float(ref.abs().max())]


def check_f32(name, got, ref, names, f, nr) -> float:
    """Worst error over the outputs as a fraction of their scale; raises
    above F32_TOL. Returns the largest absolute error."""
    worst, max_abs = 0.0, 0.0
    for oname, a, b in zip(names, got, ref):
        scales = output_scales(name, oname, b, f)
        parts = [(a[k], b[k]) for k in range(b.shape[0])] \
            if oname == "qs" else [(a, b)]
        errs = [float((x - y).abs().max()) for x, y in parts]
        rel = max(e / sc for e, sc in zip(errs, scales))
        max_abs = max(max_abs, *errs)
        worst = max(worst, rel)
        log(f"  {name:20s} {oname:9s} f32 {nr}x{NAZ}: max|k-p| = "
            f"{max(errs):.3e}  / scale = {rel:.3e}  (scale "
            f"{max(scales):.3e})")
    if not worst <= F32_TOL:
        raise AssertionError(f"{name}: f32 kernel/plain mismatch "
                             f"{worst:.3e} > {F32_TOL}")
    return max_abs


def measure(calls, f, nr) -> dict:
    """Parity, times and bound of each kernel in ``calls``."""
    out = {}
    for name, (kern, plain, names, inputs) in calls.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        max_abs = check_f32(name, got, ref, names, f, nr)
        ms, plain_ms = time_ms(kern), time_ms(plain)
        flops = flops_of(plain)
        b = bound(inputs, got, flops)
        log(f"  {name:20s} kernel {ms:.4f} ms   plain {plain_ms:.4f} ms   "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
            f"{nbytes(inputs) + nbytes(got)} B, {flops} flops = "
            f"{flops / (nr * NAZ):.1f} per cell)")
        out[name] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                     **b, "library_ms": None}
    return out


def parity_f32_flagship(sim) -> dict:
    """The whole route's four kernels against their plain versions at
    1024x3072 on the perturbed flagship state."""
    st = sim.state
    f = perturbed(sim)
    dt = sim.stepper.cfl_dt(st)
    bodies = sim.stepper.bodies_on_grid(st.nbody)
    calls = op_calls(sim.stepper.ops, f, (st.qplus, st.qminus), bodies,
                     st.omega_frame, dt)
    return measure(calls, f, NR)


def artvisc_calls(ctx, f, dt):
    """name -> (kernel call, plain call, output names, inputs) of
    artvisc_sn on one state."""
    from fargocpt_torch.ops import kernels as K
    args = (ctx, f["sigma"], f["vrad"], f["vaz"], f["energy"], dt)
    return {"artvisc_sn": (lambda: K.artvisc_sn(*args),
                           lambda: K.artvisc_sn_plain(*args),
                           ("vrad", "vaz", "energy"),
                           [f["sigma"], f["vrad"], f["vaz"], f["energy"],
                            ctx.cols])}


def parity_f32_pds70(sim) -> dict:
    """artvisc_sn against its plain version at 1024x3072 on the perturbed
    PDS70 gas state."""
    f = perturbed(sim)
    return measure(artvisc_calls(sim.stepper.ops, f,
                                 sim.stepper.cfl_dt(sim.state)), f, NR)


def parity_f32_split(sim) -> tuple[dict, dict]:
    """The split route's two kernels against their plain versions at
    1000x3072 on the perturbed flagship state; then the split route as a
    whole against the whole-transport kernel on the same state (outputs
    and times). Returns (per-kernel results, route times in ms)."""
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops import transport as tr
    st, ctx = sim.state, sim.stepper.ops
    f = perturbed(sim)
    dt = sim.stepper.cfl_dt(st)
    out = measure(split_calls(ctx, f, st.omega_frame, dt), f, NR_SPLIT)

    shift = tr.fargo_shift(ctx.g, f["vaz"], dt)
    args = (ctx, f["sigma"], f["vrad"], f["vaz"], f["energy"],
            st.omega_frame, dt, shift)
    routes = {r: (lambda r=r: K.transport(*args, route=r))
              for r in ("split", "whole")}
    names = ("sigma", "vrad", "vaz", "energy", "mass_flux")
    check_f32("split vs whole", routes["split"](), routes["whole"](), names,
              f, NR_SPLIT)
    # in turns: split, whole, whole, split
    t = {"split": [], "whole": []}
    for r in ("split", "whole", "whole", "split"):
        t[r].append(time_ms(routes[r]))
    times = {r: float(np.mean(v)) for r, v in t.items()}
    log(f"  transport at {NR_SPLIT}x{NAZ} f32: split route "
        f"{times['split']:.4f} ms, whole-transport kernel "
        f"{times['whole']:.4f} ms (event medians, mean of two turns each)")
    return out, times


def parity_f64_ragged(device) -> None:
    """Kernel vs plain at 130x200 float64 on seeded random fields: the
    whole route's four, then the split route's two over K = 5 and 6, both
    limiters and one or two azimuthal sweeps, with shifts of either sign."""
    from fargocpt_torch.constants import Constants
    from fargocpt_torch.grid import Geometry
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops.gravity import BodiesOnGrid
    from fargocpt_torch.params import Physics
    from fargocpt_torch.units import Units
    nr, naz = 130, 200
    phys = Physics(eos="adiabatic", adiabatic_index=1.4, viscous_alpha=1e-3,
                   aspectratio_ref=0.05, flaring_index=0.25,
                   artificial_viscosity="sn", heating_viscous=True,
                   cooling_beta_enabled=True, cooling_beta=10.0,
                   minimum_temperature=1e-6, sigma0=1.0, sigma_floor=1e-6,
                   thickness_smoothing=0.6, imposed_disk_drift=1e-4)
    geometry = Geometry.build(nr, naz, 0.4, 2.5, "Log")
    constants = Constants.from_units(Units())
    ctx = K.KernelContext(phys, constants, geometry, torch.float64, device)
    rng = np.random.default_rng(11)
    t = lambda a: torch.tensor(a, dtype=torch.float64,  # noqa: E731
                               device=device)
    sigma = rng.random((nr, naz)) + 0.5
    sigma[nr // 3, 3:7] = 5e-6
    f = {"sigma": t(sigma), "energy": t(rng.random((nr, naz)) * 1e-3 + 1e-3),
         "vaz": t((rng.random((nr, naz)) - 0.5) * 0.1 + 1.0),
         "vrad": t((rng.random((nr + 1, naz)) - 0.5) * 0.05)}
    q = (t(rng.random((nr, naz)) * 1e-6), t(rng.random((nr, naz)) * 1e-6))
    bodies = BodiesOnGrid(x=t([0.0, 1.0]), y=t([0.0, 0.3]),
                          mass=t([1.0, 1e-3]),
                          cubic_smoothing_radius=t([0.0, 0.05]))

    def check(name, label, got, ref, onames):
        for oname, a, b in zip(onames, got, ref):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            atol = 1e-13 * float(np.abs(b).max())
            err = float(np.abs(a - b).max())
            log(f"  {name:20s} {oname:9s} f64 {nr}x{naz}{label}: max|k-p| = "
                f"{err:.3e}  (rtol {F64_RTOL[name]:.0e}, atol {atol:.1e})")
            np.testing.assert_allclose(a, b, rtol=F64_RTOL[name], atol=atol,
                                       err_msg=f"{name}.{oname}{label}")

    calls = op_calls(ctx, f, q, bodies, t(0.4), t(0.003))
    for name, (kern, plain, names, _) in calls.items():
        check(name, "", kern(), plain(), names)
    for dissipation in (True, False):
        c = K.KernelContext(phys.with_(artificial_viscosity_dissipation=(
            dissipation)), constants, geometry, torch.float64, device)
        kern, plain, names, _ = artvisc_calls(c, f, t(0.01))["artvisc_sn"]
        check("artvisc_sn", f" dissipation={dissipation}", kern(), plain(),
              names)

    dt, omega = t(0.01), t(0.3)
    shifts = torch.tensor(rng.integers(-2 * naz, 2 * naz, nr),
                          dtype=torch.int32, device=device)
    if not (bool((shifts < 0).any()) and bool((shifts > 0).any())):
        raise AssertionError("the shifts need both signs")
    for eos_name in ("adiabatic", "isothermal"):
        for limiter in (0, 1):
            c = K.KernelContext(phys.with_(eos=eos_name,
                                           flux_limiter_type=limiter),
                                constants, geometry, torch.float64, device)
            calls = split_calls(c, f, omega, dt)
            for name in ("radial_momenta_sweep", "fargo_theta"):
                kern, plain, names, inputs = calls[name]
                label = f" K={6 if eos_name == 'adiabatic' else 5} " \
                    f"limiter={limiter}"
                if name == "radial_momenta_sweep":
                    check(name, label, kern(), plain(), names)
                    continue
                qs, vres, vconst = inputs[:3]
                for two_pass in (True, False):
                    ft = (qs, vres, vconst, shifts, dt, two_pass)
                    check(name, label + f" two_pass={two_pass}",
                          (K.fargo_theta(c, *ft),),
                          (K.fargo_theta_plain(c, *ft),), names)


# --- phase 3 -----------------------------------------------------------------

def run_slice(sim, warmup=10, steps=60) -> dict:
    """The flagship's steps on its route, with the launch counters set to 0
    just before and read just after: every op of the route at least once a
    step, the other route's ops never."""
    from fargocpt_torch.ops import kernels as K
    route = sim.stepper.ops.route
    nr = sim.geometry.nrad
    K.reset_launches()
    for _ in range(warmup):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    t_start = sim.time.clone()
    t0 = time.perf_counter()
    for _ in range(steps):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    other = [op for r, ops in ROUTE_OPS.items() if r != route for op in ops]
    for name in K.OPS:
        if name in other or name == "artvisc_sn":
            if launches[name] != 0:
                raise AssertionError(f"{route} route at {nr} rings launched "
                                     f"{name} {launches[name]} times")
        elif launches[name] < warmup + steps:
            raise AssertionError(f"kernel {name} launched {launches[name]} "
                                 f"times in {warmup + steps} steps")
    check_state(sim)
    mean_dt = float(sim.time - t_start) / steps
    per_step = seconds / steps
    return {"route": route, "launches": launches, "seconds": seconds,
            "per_step": per_step, "mcell": nr * NAZ / per_step / 1e6,
            "mean_dt": mean_dt,
            "s_per_orbit": 2.0 * math.pi / mean_dt * per_step}


PDS70_OPS = ("transport", "artvisc_sn")


def check_state(sim) -> None:
    from fargocpt_torch.sim import reachable_tensors
    f = sim.fields
    for name in ("sigma", "vrad", "vaz", "energy"):
        if not bool(torch.isfinite(getattr(f, name)).all()):
            raise AssertionError(f"{name} is not finite")
    if not bool((f.sigma > 0).all()):
        raise AssertionError("sigma <= 0 somewhere")
    on_cpu = [p for p, tsr in reachable_tensors(sim)
              if tsr.device.type != "cuda"]
    if on_cpu:
        raise AssertionError(f"tensors left on the CPU: {on_cpu[:10]}")


def check_pds70_launches(launches, steps) -> None:
    """One transport and one artvisc_sn launch a step, no other kernel."""
    for name, n in launches.items():
        want = steps if name in PDS70_OPS else 0
        if n != want:
            raise AssertionError(f"PDS70 gas: kernel {name} launched {n} "
                                 f"times in {steps} steps, expected {want}")


def run_pds70(sim, warmup=3, steps=15, run_steps=15) -> dict:
    """The PDS70 gas steps through calculate_time_step + step_once, then
    through the run path (advance_to to a time about ``run_steps`` steps
    ahead), each with the launch counters set to 0 just before and read
    just after."""
    from fargocpt_torch.ops import kernels as K
    st = sim.stepper
    nr, naz = sim.geometry.nrad, sim.geometry.naz
    for _ in range(warmup):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    K.reset_launches()
    fld0, pv0 = st.fld.iterations, st.pvte.refreshes
    t_start = sim.time.clone()
    t0 = time.perf_counter()
    for _ in range(steps):
        sim.step_once(sim.calculate_time_step())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check_pds70_launches(launches, steps)
    mean_dt = float(sim.time - t_start) / steps
    per_step = seconds / steps
    res = {"launches": launches, "seconds": seconds, "per_step": per_step,
           "mcell": nr * naz / per_step / 1e6, "mean_dt": mean_dt,
           "s_per_orbit": 2.0 * math.pi / mean_dt * per_step,
           "fld_iterations_per_step": (st.fld.iterations - fld0) / steps,
           "pvte_refreshes_per_step": (st.pvte.refreshes - pv0) / steps,
           "sg_kernel_rebuilds": st.selfgravity.rebuilds}

    # the run path: each step's CFL refresh serves its step
    K.reset_launches()
    fld0, pv0 = st.fld.iterations, st.pvte.refreshes
    target = sim.time + run_steps * mean_dt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, time_, last_dt, n, *_ = st.advance_to(sim.state, sim.time,
                                                 sim.last_dt, target)
    torch.cuda.synchronize()
    run_seconds = time.perf_counter() - t0
    sim.state, sim.time, sim.last_dt = state, time_, last_dt
    sim.n_hydro_iter += n
    check_pds70_launches(dict(K.LAUNCHES), n)
    res.update({"run_steps": n, "run_per_step": run_seconds / n,
                "run_mcell": nr * naz / (run_seconds / n) / 1e6,
                "run_fld_iterations_per_step":
                    (st.fld.iterations - fld0) / n,
                "run_pvte_refreshes_per_step":
                    (st.pvte.refreshes - pv0) / n})
    check_state(sim)
    return res


def log_pds70(res, gpu) -> None:
    log(f"  launches {res['launches']}")
    log(f"  PDS70 gas {NR}x{NAZ} float32, calculate_time_step + step_once: "
        f"{res['per_step'] * 1e3:.4f} ms/step, {res['mcell']:.2f} "
        f"Mcell-updates/s, mean dt {res['mean_dt']:.4e}, "
        f"{res['s_per_orbit']:.2f} s per orbit at r = 1; FLD "
        f"{res['fld_iterations_per_step']:.2f} SOR iterations/step, PVTE "
        f"{res['pvte_refreshes_per_step']:.2f} refreshes/step [{gpu}]")
    log(f"  PDS70 gas {NR}x{NAZ} float32, run path (advance_to, "
        f"{res['run_steps']} steps): {res['run_per_step'] * 1e3:.4f} "
        f"ms/step, {res['run_mcell']:.2f} Mcell-updates/s; FLD "
        f"{res['run_fld_iterations_per_step']:.2f} SOR iterations/step, "
        f"PVTE {res['run_pvte_refreshes_per_step']:.2f} refreshes/step; "
        f"self-gravity kernel rebuilds so far "
        f"{res['sg_kernel_rebuilds']} [{gpu}]")


def log_slice(res, nr, gpu) -> None:
    log(f"  {res['route']} route, launches {res['launches']}")
    log(f"  {nr}x{NAZ} float32: {res['per_step'] * 1e3:.4f} ms/step "
        f"(CFL + step), {res['mcell']:.1f} Mcell-updates/s, mean dt "
        f"{res['mean_dt']:.4e}, {res['s_per_orbit']:.2f} s per orbit at "
        f"r = 1 [{gpu}]")


def route_turns(sim, warmup=5, steps=50) -> dict:
    """ms per step of ``sim`` through each transport route in turns
    (split, whole, whole, split), in this process. The whole-transport
    kernel takes any NR: at 1000 rings it is the route the port took
    before the split route existed."""
    ctx = sim.stepper.ops
    own = ctx.route
    times = {"split": [], "whole": []}
    try:
        for r in ("split", "whole", "whole", "split"):
            ctx.route = r
            for _ in range(warmup):
                sim.step_once(sim.calculate_time_step())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                sim.step_once(sim.calculate_time_step())
            torch.cuda.synchronize()
            times[r].append((time.perf_counter() - t0) / steps * 1e3)
    finally:
        ctx.route = own
    return times


def host_sync_cost(sim, steps=20) -> float:
    """Seconds per step that one host read of a device scalar adds (the
    landing test of the host time loop)."""
    def loop(sync):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            dt = sim.calculate_time_step()
            sim.step_once(dt)
            if sync:
                bool(dt > 0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps
    a, b, c, d = loop(False), loop(True), loop(True), loop(False)
    return (b + c - a - d) / 2.0


# --- phase 4 -----------------------------------------------------------------

def trajectory(nr, naz, dtype, steps, budget, setup=flagship) -> dict:
    gpu = setup(nr, naz, dtype, "cuda")
    cpu = setup(nr, naz, dtype, "cpu")
    for _ in range(steps):
        dt = gpu.calculate_time_step()
        gpu.step_once(dt)
        cpu.step_once(dt.cpu())
    errs = {}
    vaz_ref = cpu.fields.vaz.double()
    for name in ("sigma", "vrad", "vaz", "energy"):
        a = getattr(gpu.fields, name).double().cpu()
        b = getattr(cpu.fields, name).double()
        scale = torch.linalg.norm(vaz_ref if name == "vrad" else b)
        errs[name] = float(torch.linalg.norm(a - b) / scale)
    log(f"  {setup.__name__} {nr}x{naz} {dtype} {gpu.stepper.ops.route} "
        f"route, {steps} steps "
        f"(t = {float(gpu.time):.4e}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"  (budget {budget:.0e})")
    for name, err in errs.items():
        if not err < budget:
            raise AssertionError(f"trajectory {nr}x{naz} {dtype}: {name} "
                                 f"rel-L2 {err:.3e} >= {budget}")
    return errs


def newton_budget(nr, naz, steps, budget=1e-4) -> dict:
    """The PDS70 gas setup on the GPU with one warm PVTE Newton step
    against three, on the first run's dt sequence."""
    one = pds70(nr, naz, "float32", "cuda")
    three = pds70(nr, naz, "float32", "cuda")
    three.stepper.pvte.n_newton = 3
    for _ in range(steps):
        dt = one.calculate_time_step()
        one.step_once(dt)
        three.step_once(dt)
    errs = {}
    for name in ("sigma", "vrad", "vaz", "energy"):
        a = getattr(one.fields, name).double()
        b = getattr(three.fields, name).double()
        scale = torch.linalg.norm(three.fields.vaz.double() if name == "vrad"
                                  else b)
        errs[name] = float(torch.linalg.norm(a - b) / scale)
    log(f"  PDS70 gas {nr}x{naz} float32, {steps} steps: PVTE n_newton 1 vs "
        "3: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"  (budget {budget:.0e}, warm vs cold)")
    for name, err in errs.items():
        if not err < budget:
            raise AssertionError(f"n_newton 1 vs 3: {name} rel-L2 {err:.3e}"
                                 f" >= {budget}")
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA "
              "device", file=sys.stderr)
        return 2
    from fargocpt_torch.ops import kernels as K

    t_main = time.perf_counter()
    log("== 1. environment")
    gpu = gpu_line()
    log(gpu)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    info = K.build()
    log(f"nvcc {info.nvcc}; library {os.path.relpath(info.library, HERE)}; "
        f"compile + link {info.seconds:.2f} s (one nvcc per source, "
        f"concurrent); build+load "
        f"{time.perf_counter() - t0:.2f} s")

    log("== 2. per-kernel parity (kernel vs plain on the GPU)")
    t0 = time.perf_counter()
    sim = flagship(NR, NAZ, "float32", "cuda")
    sim_split = flagship(NR_SPLIT, NAZ, "float32", "cuda")
    log(f"  flagship {NR}x{NAZ} and {NR_SPLIT}x{NAZ} float32 built in "
        f"{time.perf_counter() - t0:.2f} s")
    measured = parity_f32_flagship(sim)
    split_measured, route_ms = parity_f32_split(sim_split)
    measured.update(split_measured)
    t0 = time.perf_counter()
    sim_pds = pds70(NR, NAZ, "float32", "cuda")
    log(f"  PDS70 gas {NR}x{NAZ} float32 built in "
        f"{time.perf_counter() - t0:.2f} s")
    measured.update(parity_f32_pds70(sim_pds))
    parity_f64_ragged(torch.device("cuda"))
    log(f"  phase 2 done at {time.perf_counter() - t_main:.1f} s")

    log("== 3. the slices: flagship Simulation on the GPU, both routes; "
        "PDS70 gas")
    res = {"whole": run_slice(sim), "split": run_slice(sim_split)}
    log_slice(res["whole"], NR, gpu)
    log_slice(res["split"], NR_SPLIT, gpu)
    turns = route_turns(sim_split)
    log(f"  {NR_SPLIT}x{NAZ} float32 in turns (split, whole, whole, split): "
        f"split route {turns['split']} ms/step, whole-transport kernel "
        f"{turns['whole']} ms/step [{gpu}]")
    sync = host_sync_cost(sim)
    log(f"  host sync of one device scalar per step: {sync * 1e3:.4f} ms "
        f"[{gpu}]")
    del sim_split
    res["pds70"] = run_pds70(sim_pds)
    log_pds70(res["pds70"], gpu)
    log(f"  phase 3 done at {time.perf_counter() - t_main:.1f} s")

    log("== 4. trajectory: GPU kernels vs CPU plain path")
    trajectory(256, 512, "float32", 200, 1e-3)
    trajectory(128, 256, "float64", 20, 1e-9)
    trajectory(250, 512, "float32", 200, 1e-3)
    trajectory(130, 256, "float64", 20, 1e-9)
    trajectory(64, 128, "float32", 200, 1e-3, setup=pds70)
    trajectory(64, 128, "float64", 20, 1e-9, setup=pds70)
    newton = newton_budget(128, 384, 200)
    log(f"  phase 4 done at {time.perf_counter() - t_main:.1f} s")

    # launches: each kernel's count from the run of its own path (the
    # whole route for cfl, sources and viscous_kick as well, the PDS70 gas
    # step for artvisc_sn)
    def route_of(name):
        if name == "artvisc_sn":
            return "pds70"
        return "split" if name in ROUTE_OPS["split"] else "whole"
    kernels = [{"name": name, "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1],
                "launches": res[route_of(name)]["launches"][name],
                **measured[name]}
               for name in K.OPS]
    log(json.dumps({"pvte_newton_1_vs_3_rel_l2": newton,
                    "transport_routes_ms": route_ms,
                    f"step_ms_in_turns_at_{NR_SPLIT}": turns,
                    "slices": {r: {k: v for k, v in x.items()
                                   if k != "launches"}
                               for r, x in res.items()}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
