"""Run one cell of the port's benchmark once, on the CUDA card(s) of this
machine, from the root of a checkout:

    python3 port_bench/run.py --workload adiabatic_disk.run --seed 7 \
        --seconds 30 --trace 0

The last line of standard output is the result, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit, which the last lines
of standard error repeat. Without a card, with fewer cards than the cell
asks for, or without the port beside this directory it exits non-zero
and prints no result; so it does if JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fargocpt_tpu")


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # the caches of whatever compiles, at fixed paths inside the checkout;
    # one host thread for the CPU's share of the work, so that runs on a
    # shared host spread less
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "port_bench" / sub)
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)

    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_PROCESS, device="cuda")
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    checks = result.pop("checks")
    result["checks"] = checks
    window = result.get("window", {})
    print(f"window: {window.get('steps')} steps in "
          f"{window.get('seconds')} s; {result['device']['kind']}, "
          f"{result['device']['power_limit']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
