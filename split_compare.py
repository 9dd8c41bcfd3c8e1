#!/usr/bin/env python3
"""Where the time of kernels K1 to K5 goes on a CUDA card, for this checkout
and, beside it, for another checkout of the port.

    python3 split_compare.py [OTHER_CHECKOUT] [--large] [--out FILE]
    python3 split_compare.py --resources [--sass-dir DIR] [OTHER_CHECKOUT]
    python3 split_compare.py --routes [--out FILE]

Runs, in a fresh process per run, `chip_smoke.measure_split` (the launch
floor, each wrapper's host split, and each kernel's device time on inputs
that take away one part of its work at a time; K5 on the YOLO path's first
float32 chunk and on crafted pools, `chip_smoke.nms_variants`),
`chip_smoke.measure_kernels` (each wrapper's ms a call by CUDA events and
its kernel's device time, K2 included), `chip_smoke.measure_nms_kernel`
(K5's ms a call and device time at the YOLO chunk's (64, 256)) and
`chip_smoke.measure_paths` (the main and tagging paths' frames/s and busy
share) against the package of the checkout the run starts in.  The runs
of this checkout also time K4 on the tagging path's matrix built as usual
and built with ``-DASSOC_SPARSE_MAX=0`` (`dense_fork`: the sparse rounds
against the dense ones on one matrix), and K5 on its split inputs built
with ``-DNMS_MAX_CLUSTER=1`` (`single_block_fork`: one block an image
against a cluster of blocks an image).  With OTHER_CHECKOUT (for example
the parent commit unpacked with ``git archive``), the runs go in turns,
other, this, this, other, so that a drift of the card or the host falls on
both; each run builds that checkout's kernels.  Prints one JSON line a run
and, with --out, writes them all to FILE.

With --large it times instead, in the same turns, the general and wide
instances: K1, K4 and K3 at `chip_smoke.GENERAL_SHAPES`, at (1,024, 64)
and (K1 and K4) at `WIDE_SHAPES`, K5's large instance at (64, 8,400) and
(2, 33,600) on `chip_smoke._pools`, each as device microseconds a call
(`batch_us`: `chip_smoke.kernels_device_ms` over 50 calls, the mean span
from a call's first kernel's start to its last one's end, the calls
enqueued behind a device sleep so that no gap is the host's).

With --routes it times instead, in this checkout alone, K4's general
instance by its two routes at `ROUTE_SHAPES`, general shapes up to 1,025
lines where the keys fit in the cluster's shared memory: associate.cu
built twice from a copy of the sources, its `staged_route` forced to each
route (`ROUTE_FORCE`), each fork held to the plain version, then
`batch_us` of each in turns, in-cluster, staged, staged, in-cluster.

With --resources it prints instead, once a checkout, each kernel's
registers a thread and its stack, static shared and spilled bytes, as
``cuobjdump -res-usage`` reads them from the built library, and the count
of its SASS instructions by opcode (``cuobjdump -sass``); with
``--sass-dir DIR`` it also writes each kernel's listing to
DIR/<run>_<kernel>.sass, for a diff of the two checkouts' code.  Needs a
card and the CUDA toolkit.
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
from collections import Counter
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
    return usage, files, tool


def kernel_sass(smoke, files, tool) -> dict:
    """Each kernel's SASS listing (``cuobjdump -sass``), one instruction a
    line."""
    listings, name = {}, None
    for f in files:
        text = subprocess.run([tool, "-sass", f], check=True, capture_output=True, text=True).stdout
        for line in text.splitlines():
            function = re.search(r"Function : (\S+)", line)
            if function:
                name = next((k for k in smoke.KERNEL_MODULES if f"{k}_kernel" in function.group(1)), None)
            elif name:
                ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]+);", line)
                if ins:
                    listings.setdefault(name, []).append(ins.group(1).strip())
    return listings


def opcode_counts(listing) -> dict:
    """Instructions by opcode (the predicate and the modifiers dropped)."""
    ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0] for ins in listing)
    return dict(sorted(ops.items(), key=lambda kv: (-kv[1], kv[0])))


def dense_fork(smoke, device, inputs) -> dict:
    """K4's device time on the tagging path's matrix (`measure_split`'s
    ``base`` input), built as usual (at most 32 eligible entries take the
    sparse rounds) and built with ``-DASSOC_SPARSE_MAX=0`` (every matrix
    takes the dense rounds); both held to the plain version first."""
    import torch

    cfg = smoke.bench_config().tracker
    _, _, dets, table, _ = smoke.tagging_state(device, inputs)
    iou, rank = smoke.association_inputs(table, dets)
    thr = cfg.iou_threshold
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = _fork_library(smoke, "associate.cu", "ASSOC_SPARSE_MAX=0", "madpp_associate",
                        [vp] * 3 + [ci, ci, cf, vp, vp])
    match = torch.empty(iou.shape[0], dtype=torch.int32, device=device)
    T, D = iou.shape

    def dense():
        stream = torch.cuda.current_stream(device).cuda_stream
        if lib(iou.data_ptr(), rank.data_ptr(), match.data_ptr(), T, D, thr, None, stream) != 0:
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


def _fork_library(smoke, source: str, define: str, symbol: str, argtypes):
    """``source`` built with ``-D<define>`` into a library of its own, and
    its C launcher ``symbol``."""
    from torch.utils import cpp_extension

    build = smoke.build
    out = tempfile.mkdtemp(dir=build.BUILD_DIR)
    lib_path = os.path.join(out, f"lib{Path(source).stem}_fork.so")
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    subprocess.run([nvcc, *build.NVCC_FLAGS, f"-D{define}", "-shared", "-Xcompiler", "-fPIC", "-o",
                    lib_path, str(build.CSRC / source)], check=True)
    fn = getattr(ctypes.CDLL(lib_path), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def single_block_fork(smoke, device, pools) -> dict:
    """K5's device time on `measure_split`'s K5 inputs (`nms_variants`),
    built with ``-DNMS_MAX_CLUSTER=1`` (one block an image at every B),
    each launch first held to the plain version."""
    import torch

    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = _fork_library(smoke, "nms_keep.cu", "NMS_MAX_CLUSTER=1", "madpp_nms_keep", [vp] * 3 + [ci, ci, cf, vp])
    result = {}
    for name, (boxes, scores, thr) in smoke.nms_variants(device, pools).items():
        B, K = scores.shape
        keep = torch.empty((B, K), dtype=torch.bool, device=device)

        def launch(boxes=boxes, scores=scores, keep=keep, B=B, K=K, thr=thr):
            stream = torch.cuda.current_stream(device).cuda_stream
            if lib(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), B, K, thr, stream) != 0:
                raise RuntimeError("the one-block K5 failed to launch")

        launch()
        if not torch.equal(keep, smoke._nms_keep_plain(boxes, scores, thr)):
            raise AssertionError(f"the one-block K5 differs from the plain version on {name}")
        result[name] = smoke.device_times({name: (launch, "nms_keep_kernel")})[name][0]
    return result


LARGE_REPS = 50


def batch_us(smoke, fn, key: str, reps: int = LARGE_REPS) -> float:
    """Device microseconds a call of ``fn``: `chip_smoke.kernels_device_ms`
    of the kernels whose name holds ``key``, in the order a trace of one
    call shows them (the two checkouts may launch different kernels)."""
    _, records = smoke.card_trace(fn)
    names = tuple(e.name for e in sorted(records, key=lambda e: e.time_range.start) if key in e.name)
    return smoke.kernels_device_ms(fn, names, reps)[1] * 1e3


def large_times(smoke, device) -> dict:
    """`batch_us` of K1, K4 and K3's general instances and of K5's large
    instance (see the module's docstring)."""
    import numpy as np
    import torch

    out = {}
    for t, d in smoke.GENERAL_SHAPES + ((1024, 64),) + smoke.WIDE_SHAPES:
        x = smoke.large_kernel_inputs(device, t, d)
        cfg, table, dets = x["cfg"], x["table"], x["dets"]
        iou, rank = x["association"]
        calls = {"K1": (lambda: smoke.tracker_kernel.tracker_step(table, dets, cfg, cfg.min_hits), "tracker_"),
                 "K4": (lambda: smoke.association_kernel.greedy_associate(iou, rank, cfg.iou_threshold),
                        "associate_")}
        if (t, d) in smoke.LARGE_SHAPES:
            rules, state, (tdets, ttable, vrow) = x["rules"], x["state"], x["tag_frame"]
            calls["K3"] = (lambda: smoke.tagging_kernel.tagging_step(rules, state, tdets, ttable, vrow), "tagging_step")
        out[f"{t}x{d}"] = {}
        for name, (fn, key) in calls.items():
            fn()
            out[f"{t}x{d}"][name] = batch_us(smoke, fn, key)
    for b, k in ((64, 8400), (2, 33600)):
        boxes, scores = (torch.tensor(v, device=device) for v in smoke._pools(np.random.default_rng(b * k), b, k))
        fn = lambda boxes=boxes, scores=scores: smoke.nms_kernel.nms_keep(boxes, scores, 0.45)  # noqa: E731
        fn()
        out[f"{b}x{k}"] = {"K5": batch_us(smoke, fn, "nms_", reps=10)}
    return out


# By each block's key words (association.cuh `assoc_key_words`): 10,240 at
# (160, 80) to 39,040 at (1,025, 64).
ROUTE_SHAPES = ((64, 300), (160, 80), (256, 128), (384, 128), (512, 64), (768, 64), (512, 512), (1024, 64),
                (1025, 64))
ROUTE_FORCE = {"in_cluster": "return !keys_fit;", "staged": "return true;"}
ROUTE_RULE = re.compile(r"(bool staged_route\([^)]*\) \{\s*)return [^;]*;(\s*\})")


def route_forks(smoke) -> dict:
    """associate.cu built once a route of `ROUTE_FORCE`, in parallel, from
    a copy of the sources whose `staged_route` returns that route: each
    fork's launcher and scratch rule, typed for the wrapper."""
    import shutil

    from torch.utils import cpp_extension

    build = smoke.build
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    jobs = {}
    for route, body in ROUTE_FORCE.items():
        out = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
        shutil.copytree(build.CSRC, out / "csrc")
        src = out / "csrc" / "associate.cu"
        text, n = ROUTE_RULE.subn(lambda m, body=body: m.group(1) + body + m.group(2), src.read_text())
        if n != 1:
            raise AssertionError("associate.cu's staged_route was not found")
        src.write_text(text)
        lib = out / "libassociate_fork.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)]
        jobs[route] = (subprocess.Popen(cmd), cmd, lib)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    forks = {}
    for route, (proc, cmd, lib) in jobs.items():
        if proc.wait() != 0:
            raise subprocess.CalledProcessError(proc.returncode, cmd)
        dll = ctypes.CDLL(str(lib))
        dll.madpp_associate.argtypes, dll.madpp_associate.restype = [vp] * 3 + [ci, ci, cf, vp, vp], ci
        dll.madpp_associate_scratch.argtypes, dll.madpp_associate_scratch.restype = [ci, ci], ctypes.c_longlong
        forks[route] = {"associate": dll.madpp_associate, "associate_scratch": dll.madpp_associate_scratch}
    return forks


def route_times(smoke, device) -> dict:
    """K4 at `ROUTE_SHAPES` on `chip_smoke.large_kernel_inputs`' matrices
    through each fork of `route_forks`, called through the wrapper: each
    fork's matches against the plain version first, then `batch_us` in
    turns (in-cluster, staged, staged, in-cluster), with each fork's
    kernels and scratch words."""
    import torch

    forks = route_forks(smoke)
    order = ("in_cluster", "staged", "staged", "in_cluster")
    out = {}
    for t, d in ROUTE_SHAPES:
        x = smoke.large_kernel_inputs(device, t, d)
        iou, rank = x["association"]
        thr = x["cfg"].iou_threshold
        want = smoke._greedy_associate_plain(iou, rank, thr)
        fn = lambda: smoke.association_kernel.greedy_associate(iou, rank, thr)  # noqa: E731
        row = {"rounds": smoke.association_rounds(iou, rank, thr)}
        for route in order:
            smoke.association_kernel.scratch_words.cache_clear()
            with smoke.kernels_with(**forks[route]):
                if not torch.equal(fn(), want):
                    raise AssertionError(f"K4's {route} route differs from the plain version at ({t}, {d})")
                _, records = smoke.card_trace(fn)
                row.setdefault(route, {"kernels": sorted({re.search(r"associate_\w+(?:<\w+>)?", e.name).group(0)
                                                          for e in records if "associate_" in e.name}),
                                       "scratch_words": smoke.association_kernel.scratch_words(t, d), "us": []})
                row[route]["us"].append(batch_us(smoke, fn, "associate_"))
        smoke.association_kernel.scratch_words.cache_clear()
        out[f"{t}x{d}"] = row
    return out


def run_one(label: str, resources: bool, sass_dir: Path | None = None, large: bool = False) -> dict:
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
        usage, files, tool = kernel_resources(smoke)
        listings = kernel_sass(smoke, files, tool)
        if sass_dir is not None:
            sass_dir.mkdir(parents=True, exist_ok=True)
            for k, listing in listings.items():
                (sass_dir / f"{label}_{k}.sass").write_text("\n".join(listing) + "\n")
        sass = {k: {"instructions": len(v), "opcodes": opcode_counts(v)} for k, v in listings.items()}
        return {**result, "resources": usage, "sass": sass}
    if large:
        device = torch.device("cuda")
        result["large"] = large_times(smoke, device)
        return result
    device, inputs = torch.device("cuda"), smoke.synthetic_inputs()
    pools = smoke.nms_pools_from(smoke.yolo_chunk_candidates(device))
    result.update(split=smoke.measure_split(device, inputs, pools), kernels=smoke.measure_kernels(device, inputs),
                  nms=smoke.measure_nms_kernel(device, pools), paths=smoke.measure_paths(device, inputs))
    if label == "this":
        result["dense_fork"] = dense_fork(smoke, device, inputs)
        result["single_block_fork"] = single_block_fork(smoke, device, pools)
    return result


def run(label: str, checkout: Path, resources: bool, sass_dir: Path | None = None, large: bool = False) -> dict:
    cmd = [sys.executable, str(HERE / "split_compare.py"), "--run-one", label] + (["--resources"] if resources else [])
    cmd += ["--large"] if large else []
    cmd += ["--sass-dir", str(sass_dir)] if sass_dir is not None else []
    out = subprocess.run(cmd, cwd=checkout, check=True, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(checkout)})
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    args = list(argv)
    resources = "--resources" in args
    if resources:
        args.remove("--resources")
    large = "--large" in args
    if large:
        args.remove("--large")
    sass_dir = None
    if "--sass-dir" in args:
        i = args.index("--sass-dir")
        sass_dir = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    if "--routes" in args:
        args.remove("--routes")
        import torch

        smoke = load_smoke()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
        smoke.build.kernels()
        result = {"card": card, "routes": route_times(smoke, torch.device("cuda"))}
        print(json.dumps(result), flush=True)
        if "--out" in args:
            out_file = Path(args[args.index("--out") + 1])
            out_file.parent.mkdir(parents=True, exist_ok=True)
            out_file.write_text(json.dumps(result, indent=1))
        return 0
    if "--run-one" in args:
        print(json.dumps(run_one(args[args.index("--run-one") + 1], resources, sass_dir, large)))
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
        result = {"run": label, **run(label, checkout, resources, sass_dir, large)}
        print(json.dumps(result), flush=True)
        results.append(result)
    if out_file is not None:
        out_file.parent.mkdir(parents=True, exist_ok=True)
        out_file.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
