"""The program's span recorder's cost: one cell's untraced run, as
``perfbench/run.py --trace 0`` makes it, with the recorder forced on for
the whole run (``--spans 1``) or left off (``--spans 0``).  Run the two in
turns on one card and compare ``frames_per_s`` and the segment median.

    python3 perfbench/span_cost.py --workload yolov8m.drive --seed 7 --seconds 20 --spans 1

Prints one JSON line: the end-to-end metrics, the segment median and p95,
``correct``, and the spans recorded and dropped.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--spans", type=int, choices=(0, 1), required=True)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from multimodal_autonomous_driving_perception_and_planning_torch.utils.profiler import SPANS
    from perfbench import harness

    if not torch.cuda.is_available():
        print("perfbench: span_cost needs a CUDA card", file=sys.stderr)
        return 2
    harness.use_checkout_caches()
    start = harness.process_start()
    SPANS.enable(bool(args.spans))
    result = harness.run_cell(args.workload, args.seed, args.seconds, False, torch.device("cuda", 0), start=start)
    spans, dropped, _ = SPANS.drain()
    stats = result["stats"]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "spans": args.spans, "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "segment_p50_ms": stats["segment_p50_ms"], "segment_p95_ms": stats["segment_p95_ms"],
        "recorded": len(spans), "dropped": dropped, "power": result["device"].get("power"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
