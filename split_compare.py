#!/usr/bin/env python3
"""Where the time of kernels K1 and K3 (and K4) goes on a CUDA card, for this
checkout and, beside it, for another checkout of the port.

    python3 split_compare.py [OTHER_CHECKOUT] [--out FILE]

Runs, in a fresh process per run, this script's `chip_smoke.measure_split`
(the launch floor, each wrapper's host split, and each kernel's device time
on inputs that take away one part of its work at a time),
`chip_smoke.measure_kernels` (each wrapper's ms a call by CUDA events and
its kernel's device time, K2 included) and `chip_smoke.measure_paths` (the
main and tagging paths' frames/s and busy share) against the package of
the checkout the run starts in.  With OTHER_CHECKOUT (for example the
parent commit unpacked with ``git archive``), the runs go in turns, other,
this, this, other, so that a drift of the card or the host falls on both;
each run builds that checkout's kernels.  Prints one JSON line a run and,
with --out, writes them all to FILE.  Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

# One run: this checkout's `chip_smoke` measurements against the package of
# the checkout the process starts in (first on the path).
_RUN = """
import importlib.util, json, subprocess, sys, time, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("split_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
t0 = time.perf_counter()
smoke.build.kernels()
build_s = time.perf_counter() - t0
device, inputs = torch.device("cuda"), smoke.synthetic_inputs()
result = {"split": smoke.measure_split(device, inputs), "kernels": smoke.measure_kernels(device, inputs),
          "paths": smoke.measure_paths(device, inputs)}
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(json.dumps({"package": smoke.pt.__file__, "card": card, "build_s": build_s, **result}))
"""


def run(checkout: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", _RUN, str(HERE / "chip_smoke.py")], cwd=checkout,
                         check=True, capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(checkout)})
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    args = list(argv)
    out_file = None
    if "--out" in args:
        i = args.index("--out")
        out_file = Path(args[i + 1])
        del args[i:i + 2]
    other = Path(args[0]).resolve() if args else None
    order = [("other", other), ("this", HERE), ("this", HERE), ("other", other)] if other else [("this", HERE)]
    results = []
    for label, checkout in order:
        result = {"run": label, **run(checkout)}
        print(json.dumps(result), flush=True)
        results.append(result)
    if out_file is not None:
        out_file.parent.mkdir(parents=True, exist_ok=True)
        out_file.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
