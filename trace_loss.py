#!/usr/bin/env python3
"""How many records the CUDA profiler loses at the head of a trace, and
whether `chip_smoke.card_trace`'s fillers keep them, on a CUDA card.

    python3 trace_loss.py [--traces N] [--out FILE]

Traces 100 launches of each of K1, K2 and K3 (one lane, the paths' states
from `chip_smoke`), N traces a kernel, two ways: ``bare``, the way
`chip_smoke.py` traced before the fillers (one small `add_` and a
synchronise, then the launches), and ``card_trace``, behind
`chip_smoke.card_trace`'s fillers.  It does so in a fresh process, then
after `chip_smoke.measure_paths` (whose traces of the frames path hold
about 169,000 records), then after `chip_smoke.measure_lane_split`.
Prints one JSON line a stage: for each kernel the launches each trace
showed, of 100.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

REPS = 100


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--traces", type=int, default=4)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("trace_loss: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    device = torch.device("cuda")
    cs.build.kernels()
    inputs = cs.synthetic_inputs()
    cfg, est = cs.bench_config(), cs.bench_config().estimator
    table, dets = cs.tracker_state(device, inputs)
    ks, model, z, has = cs.kalman_state(device, inputs)
    rules, tstate, tdets, ttable, vrow = cs.tagging_state(device, inputs)
    launchers = {
        "tracker_step_kernel": lambda: cs.tracker_kernel.tracker_step(table, dets, cfg.tracker, cfg.tracker.min_hits),
        "kalman_step_kernel": lambda: cs.kalman_kernel.kalman_step(ks, model, z, has, est.dt, est.speed_heading_hold),
        "tagging_step_kernel": lambda: cs.tagging_kernel.tagging_step(rules, tstate, tdets, ttable, vrow),
    }
    x = torch.ones(1, device=device)

    def run(fn):
        for _ in range(REPS):
            fn()

    def bare(name, fn) -> int:
        with torch.profiler.profile(activities=cs.PROFILED) as prof:
            x.add_(1)
            torch.cuda.synchronize()
            run(fn)
            torch.cuda.synchronize()
        return sum(e.device_type == torch.autograd.DeviceType.CUDA and name in e.name for e in prof.events())

    def behind_fillers(name, fn) -> int:
        _, records = cs.card_trace(lambda: run(fn))
        return sum(name in e.name for e in records)

    lines = []

    def stage(tag: str) -> None:
        row = {"stage": tag, "reps": REPS, "fillers": cs.FILLERS}
        for name, fn in launchers.items():
            row[name] = {"bare": [bare(name, fn) for _ in range(args.traces)],
                         "card_trace": [behind_fillers(name, fn) for _ in range(args.traces)]}
        lines.append(row)
        print(json.dumps(row), flush=True)

    stage("fresh")
    road = cs.frames_inputs()
    cs.measure_paths(device, inputs, frames=road)
    stage("after_measure_paths")
    cs.measure_lane_split(device, road["frame"])
    stage("after_measure_lane_split")
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(row) + "\n" for row in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
