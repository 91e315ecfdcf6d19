"""The readings that the limits of ``cells/<cell>.json`` are set from, in
one process on the card:

    python3 port_bench/control.py --workload pvte_fld_sg_dust.run --seconds 5 \
        --seeds 11,12,...,22 --control-seeds 31,32,33 --out FILE.jsonl

For each of ``--seeds`` one run of the cell as it is configured (the
sound runs: the largest of each number over them is its lower reading),
for each of ``--control-seeds`` one run of the control, the program's own
float32 path (the nearest precision below the configuration's float64):
the smallest of each number over them is its upper reading. Each run's
numbers go to ``--out`` as a JSON line; the last line of standard output
is both readings of each number. The benchmark's own runs do not run
this.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(rows: list[dict], pick) -> dict:
    out = {}
    for row in rows:
        for k, v in row["checks"].items():
            v = math.inf if v["value"] is None else v["value"]
            out[k] = v if k not in out else pick(out[k], v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    runs = [(int(s), None) for s in args.seeds.split(",") if s] \
        + [(int(s), "float32") for s in args.control_seeds.split(",") if s]
    sound, control = [], []
    with open(args.out, "a") as out:
        for seed, dtype in runs:
            t0 = time.perf_counter()
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 t0, dtype=dtype, root=ROOT)
            row = {"workload": args.workload, "seed": seed,
                   "dtype": dtype or "config", "correct": r["correct"],
                   "checks": r["checks"], "window": r["window"],
                   "seconds": time.perf_counter() - t0}
            out.write(json.dumps(row) + "\n")
            out.flush()
            print(json.dumps(row), file=sys.stderr)
            (control if dtype else sound).append(row)
    print(json.dumps({"workload": args.workload,
                      "lower": readings(sound, max),
                      "upper": readings(control, min)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
