"""Where the flagship step's device time goes, on one CUDA GPU.

    python -m fargocpt_torch.profile_step [--nrad 1024 1000] [--naz 3072]

For each grid: the flagship Simulation in float32, 20 warm-up steps, the
wall time of 120 steps (host clock around synchronised work), then a
``torch.profiler`` window of 20 steps. Prints per grid the device time per
step of each hand-written kernel (grouped by op) and of the PyTorch glue,
the launches per step, and the device's busy share of the wall time; the
last line is all of it as one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .flagship import flagship

# device kernel name fragment -> the op whose CUDA source defines it
KERNEL_OPS = (("rms_kernel", "radial_momenta_sweep"),
              ("ft_sweep_kernel", "fargo_theta"),
              ("tr_radial_kernel", "transport"),
              ("tr_theta_kernel", "transport"),
              ("tr_final_kernel", "transport"),
              ("vk_artvisc_kernel", "viscous_kick"),
              ("vk_stress_kernel", "viscous_kick"),
              ("vk_update_kernel", "viscous_kick"),
              ("sources_kernel", "sources"), ("cfl_cells_kernel", "cfl"),
              ("cfl_final_kernel", "cfl"), ("vmean_kernel", "cfl"))


def op_of(kernel_name: str) -> str:
    for fragment, op in KERNEL_OPS:
        if fragment in kernel_name:
            return op
    return "pytorch glue"


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def profile_grid(nrad: int, naz: int, warmup: int = 20, steps: int = 120,
                 window: int = 20) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from .sim import Simulation
    sim = Simulation(flagship(nrad, naz), dtype="float32")

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
    return {"grid": f"{nrad}x{naz}", "route": sim.stepper.ops.route,
            "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms if device_ms else None,
            "ops": ops}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nrad", type=int, nargs="+", default=[1024, 1000])
    ap.add_argument("--naz", type=int, default=3072)
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
        r = profile_grid(nrad, args.naz)
        results.append(r)
        print(f"{r['grid']} float32, {r['route']} route: wall "
              f"{r['wall_ms_per_step']:.4f} ms/step, device "
              f"{r['device_ms_per_step']:.4f} ms/step", flush=True)
        if not r["ops"]:
            print("  the profiler recorded no device time", flush=True)
        for op, row in sorted(r["ops"].items(),
                              key=lambda kv: -kv[1]["device_ms_per_step"]):
            print(f"  {op:22s} {row['launches_per_step']:6.1f} launches  "
                  f"{row['device_ms_per_step']:.4f} ms", flush=True)
            if op != "pytorch glue":
                for name, ms in row["kernels"].items():
                    print(f"      {ms:.4f} ms  {name}", flush=True)
    print(json.dumps({"gpu": gpu, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
