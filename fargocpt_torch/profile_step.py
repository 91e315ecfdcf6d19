"""Where a step's device time goes, on one CUDA GPU.

    python -m fargocpt_torch.profile_step
        [--setup flagship|pds70_gas|pds70|planet_disk|planet_torque|
                 planet_accretion|binary_gcfull|oy_car|v1504cyg|
                 planet_disk_sg|full_physics|shocktube_pvte]
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
and setups/V1504Cyg.yml: ``--nrad 450 --naz 1070``, or the quickstart
with Bessel-kernel self-gravity, examples/full_physics.yml: ``--nrad 128
--naz 256``, and the PVTE shock tube with the lookup table: ``--nrad 1000
--naz 2 --dtype float64``), on
the grid's transport route or the one ``--route`` names, 20 warm-up steps,
the wall time of ``--steps`` steps (host clock around synchronised work),
then a ``torch.profiler`` window of 20 steps. Prints per grid the device
time per step of each hand-written kernel (grouped by op) and of the
PyTorch ops (with their heaviest kernels), the launches per step, and the
device's busy share of the wall time; then the step's phases, the port's
own ``fc:`` spans of the same window (``telemetry``: the PVTE refresh,
FLD, self-gravity, the opacity, the dust, the kernels' wrappers, ...),
with the device time launched inside each; spans nest (the opacity runs
inside FLD and SubStep3, the Roche radius inside the accretion). The
last line is all of it as one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .flagship import (binary_gcfull, flagship, full_physics, oy_car, pds70,
                       pds70_gas, planet_accretion, planet_disk,
                       planet_disk_sg, planet_torque, shocktube_pvte,
                       v1504cyg)
from .ops.kernels import ROUTES

SETUPS = {"flagship": flagship, "pds70_gas": pds70_gas, "pds70": pds70,
          "planet_disk": planet_disk, "planet_torque": planet_torque,
          "planet_accretion": planet_accretion,
          "binary_gcfull": binary_gcfull, "oy_car": oy_car,
          "v1504cyg": v1504cyg, "planet_disk_sg": planet_disk_sg,
          "full_physics": full_physics, "shocktube_pvte": shocktube_pvte}

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
        # the spans' device-side annotations are not kernels
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key.startswith("fc:"):
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

    # the host-side span events: their device time sums the kernels
    # launched inside (the device-side annotation of the same name spans
    # first kernel to last, idle gaps included, and is left out)
    phase_ms = {}
    for e in prof.events():
        if e.name.startswith("fc:") \
                and e.device_type == torch.autograd.DeviceType.CPU:
            row = phase_ms.setdefault(e.name[3:], {"device_ms_per_step": 0.0,
                                                   "calls_per_step": 0.0})
            row["device_ms_per_step"] += _device_us(
                e, ("device_time_total", "cuda_time_total")) / 1e3 / window
            row["calls_per_step"] += 1.0 / window
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
        print("  phases (device time of the spans; they nest):", flush=True)
        for label, row in sorted(r["phases"].items(),
                                 key=lambda kv: -kv[1]["device_ms_per_step"]):
            print(f"  {label:28s} {row['calls_per_step']:6.2f} calls  "
                  f"{row['device_ms_per_step']:.4f} ms", flush=True)
    print(json.dumps({"gpu": gpu, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
