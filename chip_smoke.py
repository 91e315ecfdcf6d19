"""Runs fargocpt_torch's main path on one CUDA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):
  1. environment: GPU name and power limit, torch/CUDA versions, nvcc,
     and the build of the CUDA kernels from fargocpt_torch/csrc;
  2. per-kernel parity: each of the four kernels against its plain PyTorch
     version on the same GPU tensors, at 1024x3072 float32 (the flagship
     state with seeded noise) and 130x200 float64 (seeded random fields),
     plus each one's time beside the plain version's (CUDA events, median
     of 25 calls);
  3. the slice: the flagship Simulation at 1024x3072 float32 on the GPU,
     20 warm-up and 120 timed steps of calculate_time_step + step_once,
     with the launch counters of the four kernels checked afterwards;
  4. the trajectory against the CPU: 256x512 float32 for 200 steps
     (rel-L2 < 1e-3 per field) and 128x256 float64 for 20 steps
     (rel-L2 < 1e-9), the GPU run through the kernels and the CPU run
     through the plain versions, both on the GPU run's dt sequence.

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
    # start near the CFL limit so short runs evolve and the timed window
    # runs at the steady step size (FirstDT is a run-control key)
    "FirstDT": "1e-3",
}
NR, NAZ = 1024, 3072

KERNELS = {
    "cfl": ("fargocpt_torch/csrc/cfl.cu",
            "fargocpt_tpu/ops/pallas_kernels.py:838"),
    "sources": ("fargocpt_torch/csrc/sources.cu",
                "fargocpt_tpu/ops/pallas_kernels.py:396"),
    "viscous_kick": ("fargocpt_torch/csrc/viscous_kick.cu",
                     "fargocpt_tpu/ops/pallas_kernels.py:1470"),
    "transport": ("fargocpt_torch/csrc/transport.cu",
                  "fargocpt_tpu/ops/pallas_kernels.py:1098"),
}
# f32 at 1024x3072, as a fraction of each output's scale (velocities are
# scaled by max|vaz|, as in tests/test_dtype_budget.py): the kernels read
# geometry columns computed in float64 and the plain versions difference
# float32 radii (Rsup - Rinf ~ 2e-3 r); the two have differed by <= 1e-6
# of the scale on the perturbed flagship state
F32_TOL = 1e-5
# f64 at 130x200: the tolerances of tests/test_torch_kernels.py
F64_RTOL = {"cfl": 1e-12, "sources": 1e-11, "viscous_kick": 1e-10,
            "transport": 1e-11}


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def flagship(nr, naz, dtype, device):
    from fargocpt_torch.config import Config
    from fargocpt_torch.sim import Simulation
    cfg = Config.from_dict(dict(FLAGSHIP, Nrad=str(nr), Naz=str(naz)))
    return Simulation(cfg, dtype=dtype, device=device)


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

def op_calls(ctx, f, q, bodies, omega, dt):
    """name -> (kernel call, plain call, output names) on one state."""
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.ops import transport as tr
    zero = torch.zeros((), dtype=torch.float64, device=f["sigma"].device)
    shift = tr.fargo_shift(ctx.g, f["vaz"], dt)
    s, vr, va, e = f["sigma"], f["vrad"], f["vaz"], f["energy"]
    return {
        "cfl": (lambda: (K.cfl(ctx, s, vr, va, e, *q),),
                lambda: (K.cfl_plain(ctx, s, vr, va, e, *q),), ("dt",)),
        "sources": (
            lambda: K.sources(ctx, s, vr, va, e, bodies, (zero, zero),
                              omega, dt),
            lambda: K.sources_plain(ctx, s, vr, va, e, bodies, (zero, zero),
                                    omega, dt), ("vrad", "vaz")),
        "viscous_kick": (
            lambda: K.viscous_kick(ctx, s, vr, va, e, dt, 0.0),
            lambda: K.viscous_kick_plain(ctx, s, vr, va, e, dt, 0.0),
            ("vrad", "vaz", "energy", "qplus", "qminus")),
        "transport": (
            lambda: K.transport(ctx, s, vr, va, e, omega, dt, shift),
            lambda: K.transport_plain(ctx, s, vr, va, e, omega, dt, shift),
            ("sigma", "vrad", "vaz", "energy", "mass_flux")),
    }


def parity_f32_flagship(sim) -> dict:
    """Kernel vs plain at full size on the flagship state, perturbed by
    seeded noise (the unperturbed disk is axisymmetric, which would leave
    the azimuthal stencils untested); returns
    name -> {max_abs_err, ms, plain_ms}."""
    st = sim.state
    gen = torch.Generator(device=st.fields.sigma.device).manual_seed(7)

    def noisy(t, rel=0.0, add=0.0):
        u = 2.0 * torch.rand(t.shape, generator=gen, device=t.device,
                             dtype=t.dtype) - 1.0
        return t * (1.0 + rel * u) + add * u

    f = {"sigma": noisy(st.fields.sigma, rel=1e-2),
         "vrad": noisy(st.fields.vrad, add=1e-4),
         "vaz": noisy(st.fields.vaz, add=1e-3),
         "energy": noisy(st.fields.energy, rel=1e-2)}
    dt = sim.stepper.cfl_dt(st)
    bodies = sim.stepper.bodies_on_grid(st.nbody)
    calls = op_calls(sim.stepper.ops, f, (st.qplus, st.qminus), bodies,
                     st.omega_frame, dt)
    vscale = float(f["vaz"].abs().max())
    out = {}
    for name, (kern, plain, names) in calls.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        worst, max_abs = 0.0, 0.0
        for oname, a, b in zip(names, got, ref):
            err = float((a - b).abs().max())
            scale = vscale if oname in ("vrad", "vaz") \
                else float(b.abs().max())
            max_abs = max(max_abs, err)
            worst = max(worst, err / scale)
            log(f"  {name:13s} {oname:9s} f32 {NR}x{NAZ}: max|k-p| = {err:.3e}"
                f"  / scale = {err / scale:.3e}")
        if not worst <= F32_TOL:
            raise AssertionError(f"{name}: f32 kernel/plain mismatch "
                                 f"{worst:.3e} > {F32_TOL}")
        ms, plain_ms = time_ms(kern), time_ms(plain)
        log(f"  {name:13s} kernel {ms:.4f} ms   plain {plain_ms:.4f} ms")
        out[name] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}
    return out


def parity_f64_ragged(device) -> None:
    """Kernel vs plain at 130x200 float64 on seeded random fields."""
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
    ctx = K.KernelContext(phys, Constants.from_units(Units()),
                          Geometry.build(nr, naz, 0.4, 2.5, "Log"),
                          torch.float64, device)
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
    calls = op_calls(ctx, f, q, bodies, t(0.4), t(0.003))
    for name, (kern, plain, names) in calls.items():
        for oname, a, b in zip(names, kern(), plain()):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            atol = 1e-13 * float(np.abs(b).max())
            err = float(np.abs(a - b).max())
            log(f"  {name:13s} {oname:9s} f64 {nr}x{naz}: max|k-p| = "
                f"{err:.3e}  (rtol {F64_RTOL[name]:.0e}, atol {atol:.1e})")
            np.testing.assert_allclose(a, b, rtol=F64_RTOL[name], atol=atol,
                                       err_msg=f"{name}.{oname}")


# --- phase 3 -----------------------------------------------------------------

def run_slice(sim, warmup=20, steps=120) -> dict:
    from fargocpt_torch.ops import kernels as K
    from fargocpt_torch.sim import reachable_tensors
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
    for name in K.OPS:
        if launches[name] < warmup + steps:
            raise AssertionError(f"kernel {name} launched {launches[name]} "
                                 f"times in {warmup + steps} steps")
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
    mean_dt = float(sim.time - t_start) / steps
    per_step = seconds / steps
    return {"launches": launches, "seconds": seconds, "per_step": per_step,
            "mcell": NR * NAZ / per_step / 1e6, "mean_dt": mean_dt,
            "s_per_orbit": 2.0 * math.pi / mean_dt * per_step}


def host_sync_cost(sim, steps=40) -> float:
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

def trajectory(nr, naz, dtype, steps, budget) -> dict:
    gpu = flagship(nr, naz, dtype, "cuda")
    cpu = flagship(nr, naz, dtype, "cpu")
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
    log(f"  {nr}x{naz} {dtype} {steps} steps (t = {float(gpu.time):.4e}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"  (budget {budget:.0e})")
    for name, err in errs.items():
        if not err < budget:
            raise AssertionError(f"trajectory {nr}x{naz} {dtype}: {name} "
                                 f"rel-L2 {err:.3e} >= {budget}")
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA "
              "device", file=sys.stderr)
        return 2
    from fargocpt_torch.ops import kernels as K

    log("== 1. environment")
    gpu = gpu_line()
    log(gpu)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    info = K.build()
    log(f"nvcc {info.nvcc}; library {os.path.relpath(info.library, HERE)}; "
        f"nvcc time {info.seconds:.2f} s; build+load "
        f"{time.perf_counter() - t0:.2f} s")

    log("== 2. per-kernel parity (kernel vs plain on the GPU)")
    t0 = time.perf_counter()
    sim = flagship(NR, NAZ, "float32", "cuda")
    log(f"  flagship {NR}x{NAZ} float32 built in "
        f"{time.perf_counter() - t0:.2f} s")
    measured = parity_f32_flagship(sim)
    parity_f64_ragged(torch.device("cuda"))

    log("== 3. the slice: flagship Simulation on the GPU")
    res = run_slice(sim)
    log(f"  launches {res['launches']}")
    log(f"  {NR}x{NAZ} float32: {res['per_step'] * 1e3:.4f} ms/step "
        f"(CFL + step), {res['mcell']:.1f} Mcell-updates/s, mean dt "
        f"{res['mean_dt']:.4e}, {res['s_per_orbit']:.2f} s per orbit at "
        f"r = 1 [{gpu}]")
    sync = host_sync_cost(sim)
    log(f"  host sync of one device scalar per step: {sync * 1e3:.4f} ms "
        f"[{gpu}]")

    log("== 4. trajectory: GPU kernels vs CPU plain path")
    trajectory(256, 512, "float32", 200, 1e-3)
    trajectory(128, 256, "float64", 20, 1e-9)

    kernels = [{"name": name, "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1],
                "launches": res["launches"][name], **measured[name]}
               for name in K.OPS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
