"""The readings the limits are set from: for one cell, over many seeds in
one process (one kernel build, one import), the numbers the check compares
for the program and for the control (the reference in the next precision
down, put in the program's place), each after a short window at the cell's
own load.  The benchmark's own runs never run the control.

    python3 perfbench/readings.py --workload yolov8m.crowd --seeds 101-112 --seconds 4 [--out FILE]

Prints one JSON line a seed: ``{"seed", "program": {...}, "control":
{...}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seed_list(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,9,2147483659")
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    harness.use_checkout_caches()

    if not torch.cuda.is_available():
        print("perfbench: readings need a CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for seed in seed_list(args.seeds):
        r = harness.run_cell(args.workload, seed, args.seconds, False, torch.device("cuda", 0), control=True)
        line = json.dumps({"seed": seed, "program": {k: v["value"] for k, v in r["checks"].items()},
                           "control": r["control"], "stats": r["stats"], "metrics": r["metrics"]})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
