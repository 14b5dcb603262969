"""The readings that the limits of ``correct`` are set from.

    python3 -m rtbench.readings --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control]

Runs the cell once a seed in one process (set-up, a short window at the
cell's own load, the comparison), and prints one JSON line a seed: the
numbers the program reads and, with ``--control``, the numbers that the
reference in the next lower precision reads in the program's place. The
lower reading of a number is the largest over the program's seeds, the
upper the smallest over the control's. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from rtbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("rtbench.readings: needs a CUDA device", file=sys.stderr)
        return 3
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = harness.run_cell(
            bench, args.workload, seed, args.seconds, False, "cuda",
            control=args.control)
        line = {"seed": seed, "units": result["attempted"],
                "program": {n: v for n, v, _ in checks}}
        if "control" in result:
            line["control"] = {n: c["value"]
                               for n, c in result["control"].items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
