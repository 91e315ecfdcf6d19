"""Where a step's device time goes, on one CUDA GPU.

    python -m fargocpt_torch.profile_step
        [--setup flagship|pds70_gas|pds70|planet_disk|planet_torque|
                 planet_accretion|binary_gcfull|oy_car|v1504cyg]
        [--route whole|split|staged] [--nrad 1024 1000] [--naz 3072]
        [--steps 120] [--dtype float32|float64]

For each grid: the setup's Simulation in float32 or ``--dtype``
(``float64`` for the cataclysmic variables, whose float32 Q+ / Q- are
NaN from the start in both packages; ``flagship`` by default, the PDS70 gas setup, the whole PDS70 setup with its dust, the
planet in the disk of examples/quickstart.yml, the reference's torque
test on the leapfrog, its accretion test: accretion, the corotating
frame and the monitor grids, or setups/gamma_cephei_full.yml's
circumbinary disk: ``--nrad 1609 --naz 1160``, or the cataclysmic
variables, setups/CloseBinaries/OY_Car.yml: ``--nrad 200 --naz 200``
and setups/V1504Cyg.yml: ``--nrad 450 --naz 1070``), on
the grid's transport route or the one ``--route`` names, 20 warm-up steps,
the wall time of ``--steps`` steps (host clock around synchronised work),
then a ``torch.profiler`` window of 20 steps. Prints per grid the device
time per step of each hand-written kernel (grouped by op) and of the
PyTorch ops (with their heaviest kernels), the launches per step, and the
device's busy share of the wall time. A second window of 20 steps wraps
the step's phases (``phases()``: the PVTE refresh, FLD, self-gravity, the
opacity, the dust, ...) in ``record_function`` ranges and prints the device
time and kernel launches of each; ranges nest (the opacity runs inside
FLD and SubStep3, the Roche radius inside the accretion). The
last line is all of it as one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from contextlib import contextmanager

import torch

from .flagship import (binary_gcfull, flagship, oy_car, pds70, pds70_gas,
                       planet_accretion, planet_disk, planet_torque,
                       v1504cyg)
from .ops.kernels import ROUTES

SETUPS = {"flagship": flagship, "pds70_gas": pds70_gas, "pds70": pds70,
          "planet_disk": planet_disk, "planet_torque": planet_torque,
          "planet_accretion": planet_accretion,
          "binary_gcfull": binary_gcfull, "oy_car": oy_car,
          "v1504cyg": v1504cyg}

# device kernel name fragment -> the op whose CUDA source launches it
# (fargo_theta on the split route and theta_sweep on the staged route
# launch one kernel; radial_momenta_sweep and radial_sweep launch one
# kernel template, radial_march_kernel, with two source policies)
KERNEL_OPS = (("MarchFields", "radial_momenta_sweep"),
              ("theta_ring_kernel", "fargo_theta / theta_sweep"),
              ("MarchBatch", "radial_sweep"),
              ("advect_shift_vec_kernel", "advect_shift"),
              ("advect_shift_scalar_kernel", "advect_shift"),
              ("tr_radial_kernel", "transport"),
              ("tr_ring_kernel", "transport"),
              ("tr_vrad_kernel", "transport"),
              ("vk_tile_kernel", "viscous_kick"),
              ("sources_kernel", "sources"), ("cfl_ring_kernel", "cfl"),
              ("artvisc_sn_kernel", "artvisc_sn"),
              ("ias15_kernel", "ias15"))


def op_of(kernel_name: str) -> str:
    for fragment, op in KERNEL_OPS:
        if fragment in kernel_name:
            return op
    return "pytorch glue"


def _device_us(event, attrs=("self_device_time_total",
                              "self_cuda_time_total")) -> float:
    for attr in attrs:
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def phases():
    """(owner, attribute, label) of the functions a step calls, each timed
    as one profiler range."""
    from . import step
    from .nbody import system as nbody_sys
    from .ops import (accretion, boundary, cfl, damping, diskmodel, energy,
                      eos, fld, gravity, kernels, opacity, pvte,
                      selfgravity, sources, viscosity)
    return (
        (accretion, "accrete_onto_planets", "accretion"),
        (accretion, "orbital_periods", "orbital periods"),
        (nbody_sys, "dimensionless_roche_radius", "Roche radius"),
        (step.HydroStep, "_update_monitor_acc", "monitor grids"),
        (step.HydroStep, "_corotation_update", "corotation"),
        (step.HydroStep, "_integrate_particles", "dust"),
        (pvte.PVTE, "gamma_mu", "PVTE refresh"),
        (fld.FLDSolver, "radiative_diffusion", "FLD substep"),
        (fld.FLDSolver, "solve", "FLD SOR solve"),
        (selfgravity.SelfGravity, "accelerations", "self-gravity FFT"),
        (selfgravity.SelfGravity, "update_kernel", "self-gravity kernel"),
        (opacity, "opacity", "opacity"),
        (energy, "substep3", "SubStep3"),
        (sources, "update_with_sourceterms", "sources"),
        (gravity, "nbody_potential", "N-body potential"),
        (gravity, "disk_on_body_accel", "disk on the bodies"),
        (gravity, "indirect_term_nbody_predictor", "indirect term"),
        (step.HydroStep, "bodies_on_grid", "bodies on the grid"),
        (damping.DampingZones, "apply", "damping zones"),
        (viscosity, "viscous_stress_tensor", "viscous stress"),
        (viscosity, "update_velocities_with_viscosity", "viscous update"),
        (cfl, "condition_cfl", "CFL condition"),
        (kernels, "artvisc_sn", "artvisc_sn op"),
        (kernels, "transport", "transport op"),
        (boundary, "apply_boundary_conditions", "boundaries"),
        (boundary, "center_of_mass_boundary", "center-of-mass boundary"),
        (boundary, "rochelobe_overflow", "Roche-lobe stream"),
        (energy, "scurve_cooling", "S-curve cooling"),
        (diskmodel, "vr_numerical_viscous", "drift model"),
        (step.HydroStep, "derived", "derived grids"),
        (eos, "scale_height_nbody", "N-body scale height"),
        (eos, "aspect_ratio_nbody", "N-body aspect ratio"),
        (viscosity, "alpha_grid", "alpha grid"),
        (viscosity, "viscosity_correction_factors",
         "viscosity correction factors"),
        (energy, "irradiation", "irradiation"),
    )


def _launches(event) -> int:
    """The kernel launches the host made inside a range: its descendant
    runtime calls ``cudaLaunchKernel`` / ``cuLaunchKernel``."""
    n, stack = 0, list(event.cpu_children)
    while stack:
        child = stack.pop()
        n += "LaunchKernel" in child.name
        stack.extend(child.cpu_children)
    return n


@contextmanager
def ranges(targets):
    """Wraps each target in a ``record_function`` range while inside."""
    saved = []
    for owner, name, label in targets:
        fn = getattr(owner, name)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*a, **kw)

        saved.append((owner, name, fn))
        setattr(owner, name, functools.wraps(fn)(wrapped))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def profile_grid(nrad: int, naz: int, setup: str = "flagship",
                 warmup: int = 20, steps: int = 120,
                 window: int = 20, route: str | None = None,
                 dtype: str = "float32") -> dict:
    from torch.profiler import ProfilerActivity, profile
    from .sim import Simulation
    sim = Simulation(SETUPS[setup](nrad, naz), dtype=dtype,
                     transport_route=route)

    def run(n):
        for _ in range(n):
            sim.step_once(sim.calculate_time_step())

    run(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(window)
        torch.cuda.synchronize()
    ops: dict[str, dict] = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(e)
        if us <= 0.0:
            continue
        op = op_of(e.key)
        row = ops.setdefault(op, {"device_ms_per_step": 0.0,
                                  "launches_per_step": 0.0, "kernels": {}})
        row["device_ms_per_step"] += us / 1e3 / window
        row["launches_per_step"] += e.count / window
        row["kernels"][e.key[:80]] = us / 1e3 / window
    device_ms = sum(r["device_ms_per_step"] for r in ops.values())

    targets = phases()
    labels = {label for _, _, label in targets}
    with ranges(targets), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        run(window)
        torch.cuda.synchronize()
    # the host-side range events: their device time sums the kernels
    # launched inside (the device-side annotation of the same name spans
    # first kernel to last, idle gaps included, and is left out)
    phase_ms = {}
    for e in prof.events():
        if e.name in labels and e.device_type == torch.autograd.DeviceType.CPU:
            row = phase_ms.setdefault(e.name, {"device_ms_per_step": 0.0,
                                               "calls_per_step": 0.0,
                                               "launches_per_step": 0.0})
            row["device_ms_per_step"] += _device_us(
                e, ("device_time_total", "cuda_time_total")) / 1e3 / window
            row["calls_per_step"] += 1.0 / window
            row["launches_per_step"] += _launches(e) / window
    return {"setup": setup, "grid": f"{nrad}x{naz}", "dtype": dtype,
            "route": sim.stepper.ops.route,
            "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms if device_ms else None,
            "ops": ops, "phases": phase_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nrad", type=int, nargs="+", default=[1024, 1000])
    ap.add_argument("--naz", type=int, default=3072)
    ap.add_argument("--setup", choices=sorted(SETUPS), default="flagship")
    ap.add_argument("--route", choices=ROUTES,
                    default=None, help="the transport route (default: the "
                    "grid's own)")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(gpu, flush=True)
    results = []
    for nrad in args.nrad:
        r = profile_grid(nrad, args.naz, args.setup, steps=args.steps,
                         route=args.route, dtype=args.dtype)
        results.append(r)
        print(f"{args.setup} {r['grid']} {r['dtype']}, {r['route']} route: "
              f"wall {r['wall_ms_per_step']:.4f} ms/step, device "
              f"{r['device_ms_per_step']:.4f} ms/step", flush=True)
        if not r["ops"]:
            print("  the profiler recorded no device time", flush=True)
        for op, row in sorted(r["ops"].items(),
                              key=lambda kv: -kv[1]["device_ms_per_step"]):
            print(f"  {op:22s} {row['launches_per_step']:6.1f} launches  "
                  f"{row['device_ms_per_step']:.4f} ms", flush=True)
            heaviest = sorted(row["kernels"].items(), key=lambda kv: -kv[1])
            for name, ms in heaviest[:12]:
                print(f"      {ms:.4f} ms  {name}", flush=True)
        print("  phases (device time of the ranges; they nest):", flush=True)
        for label, row in sorted(r["phases"].items(),
                                 key=lambda kv: -kv[1]["device_ms_per_step"]):
            print(f"  {label:22s} {row['calls_per_step']:6.2f} calls  "
                  f"{row['launches_per_step']:7.1f} launches  "
                  f"{row['device_ms_per_step']:.4f} ms", flush=True)
    print(json.dumps({"gpu": gpu, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
