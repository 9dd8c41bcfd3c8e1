#!/usr/bin/env python3
"""Where the time of kernels K1 to K4 goes on a CUDA card, for this checkout
and, beside it, for another checkout of the port.

    python3 split_compare.py [OTHER_CHECKOUT] [--out FILE]
    python3 split_compare.py --resources [OTHER_CHECKOUT]

Runs, in a fresh process per run, `chip_smoke.measure_split` (the launch
floor, each wrapper's host split, and each kernel's device time on inputs
that take away one part of its work at a time), `chip_smoke.measure_kernels`
(each wrapper's ms a call by CUDA events and its kernel's device time, K2
included) and `chip_smoke.measure_paths` (the main and tagging paths'
frames/s and busy share) against the package of the checkout the run starts
in.  The runs of this checkout also time K4 on the tagging path's matrix
built as usual and built with ``-DASSOC_SPARSE_MAX=0`` (`dense_fork`: the
sparse rounds against the dense ones on one matrix).  With OTHER_CHECKOUT
(for example the parent commit unpacked with ``git archive``), the runs go
in turns, other, this, this, other, so that a drift of the card or the host
falls on both; each run builds that checkout's kernels.  Prints one JSON
line a run and, with --out, writes them all to FILE.

With --resources it prints instead, once a checkout, each kernel's
registers a thread and its stack, static shared and spilled bytes, as
``cuobjdump -res-usage`` reads them from the built library.  Needs a card
and the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_smoke():
    """This checkout's `chip_smoke`, importing the package of the checkout
    the process runs in (first on the path)."""
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location("split_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def kernel_resources(smoke) -> dict:
    """Each kernel's registers a thread (`reg`) and its stack, static shared
    and local (spilled) bytes, from ``cuobjdump -res-usage`` on the built
    kernels of the package `smoke` imports."""
    from torch.utils import cpp_extension

    lib = smoke.build.kernels()
    files = [lib.__file__] if hasattr(lib, "__file__") else sorted(map(str, smoke.build.BUILD_DIR.glob("lib*.so")))
    tool = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    usage, name = {}, None
    for f in files:
        text = subprocess.run([tool, "-res-usage", f], check=True, capture_output=True, text=True).stdout
        for line in text.splitlines():
            function = re.search(r"Function (\S+):", line)
            if function:
                name = next((k for k in smoke.KERNEL_MODULES if f"{k}_kernel" in function.group(1)), None)
                continue
            fields = {k: re.search(rf"\b{k}:(\d+)", line) for k in ("REG", "STACK", "SHARED", "LOCAL")}
            if name and fields["REG"]:
                usage[name] = {k.lower(): int(m.group(1)) for k, m in fields.items() if m}
    if set(usage) != set(smoke.KERNEL_MODULES):
        raise AssertionError(f"cuobjdump reported {sorted(usage)}, expected {sorted(smoke.KERNEL_MODULES)}")
    return usage


def dense_fork(smoke, device, inputs) -> dict:
    """K4's device time on the tagging path's matrix (`measure_split`'s
    ``base`` input), built as usual (at most 32 eligible entries take the
    sparse rounds) and built with ``-DASSOC_SPARSE_MAX=0`` (every matrix
    takes the dense rounds); both held to the plain version first."""
    import torch
    from torch.utils import cpp_extension

    build, cfg = smoke.build, smoke.bench_config().tracker
    _, _, dets, table, _ = smoke.tagging_state(device, inputs)
    iou, rank = smoke.association_inputs(table, dets)
    thr = cfg.iou_threshold
    out = tempfile.mkdtemp(dir=build.BUILD_DIR)
    lib_path = os.path.join(out, "libassociate_dense.so")
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-DASSOC_SPARSE_MAX=0", "-shared", "-Xcompiler", "-fPIC", "-o",
                    lib_path, str(build.CSRC / "associate.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.madpp_associate.argtypes = [vp] * 3 + [ci, ci, cf, vp]
    lib.madpp_associate.restype = ci
    match = torch.empty(iou.shape[0], dtype=torch.int32, device=device)
    T, D = iou.shape

    def dense():
        stream = torch.cuda.current_stream(device).cuda_stream
        if lib.madpp_associate(iou.data_ptr(), rank.data_ptr(), match.data_ptr(), T, D, thr, stream) != 0:
            raise RuntimeError("the dense-only K4 failed to launch")

    def sparse():
        return smoke.association_kernel.greedy_associate(iou, rank, thr)

    dense()
    want = smoke._greedy_associate_plain(iou, rank, thr)
    if not (torch.equal(match, want) and torch.equal(sparse(), want)):
        raise AssertionError("K4 differs from the plain version on the tagging path's matrix")
    eligible = int(((iou >= thr) & (iou >= 0)).sum())
    return {"eligible": eligible, "rounds_at_most": int((want >= 0).sum()) + 1,
            "sparse_ms": smoke.device_times({"k4": (sparse, "associate_kernel")})["k4"][0],
            "dense_ms": smoke.device_times({"k4": (dense, "associate_kernel")})["k4"][0]}


def run_one(label: str, resources: bool) -> dict:
    """One run in this process: see the module's docstring."""
    import time

    import torch

    smoke = load_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    smoke.build.kernels()
    result = {"package": smoke.pt.__file__, "card": card, "build_s": time.perf_counter() - t0}
    if resources:
        return {**result, "resources": kernel_resources(smoke)}
    device, inputs = torch.device("cuda"), smoke.synthetic_inputs()
    result.update(split=smoke.measure_split(device, inputs), kernels=smoke.measure_kernels(device, inputs),
                  paths=smoke.measure_paths(device, inputs))
    if label == "this":
        result["dense_fork"] = dense_fork(smoke, device, inputs)
    return result


def run(label: str, checkout: Path, resources: bool) -> dict:
    cmd = [sys.executable, str(HERE / "split_compare.py"), "--run-one", label] + (["--resources"] if resources else [])
    out = subprocess.run(cmd, cwd=checkout, check=True, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(checkout)})
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    args = list(argv)
    resources = "--resources" in args
    if resources:
        args.remove("--resources")
    if "--run-one" in args:
        print(json.dumps(run_one(args[args.index("--run-one") + 1], resources)))
        return 0
    out_file = None
    if "--out" in args:
        i = args.index("--out")
        out_file = Path(args[i + 1])
        del args[i:i + 2]
    other = Path(args[0]).resolve() if args else None
    if resources:
        order = [("this", HERE)] + ([("other", other)] if other else [])
    else:
        order = [("other", other), ("this", HERE), ("this", HERE), ("other", other)] if other else [("this", HERE)]
    results = []
    for label, checkout in order:
        result = {"run": label, **run(label, checkout, resources)}
        print(json.dumps(result), flush=True)
        results.append(result)
    if out_file is not None:
        out_file.parent.mkdir(parents=True, exist_ok=True)
        out_file.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
