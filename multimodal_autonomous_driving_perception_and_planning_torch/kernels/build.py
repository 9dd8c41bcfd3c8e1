"""Build the hand-written CUDA kernels from the sources in csrc/ at first use.

With ninja present, `torch.utils.cpp_extension.load` compiles every ``.cu``
source and the small pybind11 binding file in one call (ninja runs the
compilers in parallel).  Without ninja, one ``nvcc -shared`` per source, all
started together, builds a library with a plain C interface each, and ctypes
binds them.  Either way the result exposes ``tracker_step`` (K1),
``kalman_step`` (K2), ``tagging_step`` (K3), ``associate`` (K4),
``nms_keep`` (K5, and ``nms_keep_large``, its instance beyond 1,024
candidates) and ``plan_step`` (K6), which take pointers and the stream as
integers and return the CUDA error code of the launch, and the plan queries of the
general instances, from the shape alone: ``tracker_scratch``,
``tracker_cluster``, ``tagging_cluster``, ``associate_scratch`` and
``associate_cluster`` (K1's and K4's key scratch in 32-bit words, and K1's,
K3's and K4's thread block clusters).

The output goes to ``kernels/build/`` inside the package (listed in
.gitignore).  Kernels are built for Hopper only (``sm_90a``).  No source
includes PyTorch's headers, which keeps the build to seconds.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from types import SimpleNamespace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CUDA_SOURCES = (
    "tracker_step.cu", "kalman_step.cu", "tagging_step.cu", "associate.cu", "nms_keep.cu", "plan_step.cu",
)
BINDINGS = "bindings.cpp"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")
_NAME = "madpp_torch_kernels"

_kernels = None


def kernels():
    """The built kernel library, building it on the first call."""
    global _kernels
    if _kernels is None:
        from torch.utils import cpp_extension

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        if cpp_extension.is_ninja_available():
            _kernels = cpp_extension.load(
                name=_NAME,
                sources=[str(CSRC / BINDINGS)] + [str(CSRC / s) for s in CUDA_SOURCES],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O2"],
                extra_cuda_cflags=list(NVCC_FLAGS),
                verbose=False,
            )
        else:
            _kernels = build_ctypes(cpp_extension.CUDA_HOME)
    return _kernels


def build_ctypes(cuda_home: str | None) -> SimpleNamespace:
    """Build each source into its own shared library with ``nvcc``, all in
    parallel, and bind their C launchers with ctypes."""
    nvcc = os.path.join(cuda_home, "bin", "nvcc") if cuda_home else "nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in CUDA_SOURCES:
        target = BUILD_DIR / f"lib{Path(src).stem}.so"
        # Build under a temporary name and rename, so that concurrent
        # processes never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(CSRC / src)]
        jobs.append((subprocess.Popen(cmd), cmd, tmp, target))
    for proc, cmd, tmp, target in jobs:
        if proc.wait() != 0:
            raise subprocess.CalledProcessError(proc.returncode, cmd)
        os.replace(tmp, target)

    vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    tracker = ctypes.CDLL(str(BUILD_DIR / "libtracker_step.so"))
    tracker.madpp_tracker_step.argtypes = [vp] * 19 + [ci, ci, ci, ci, cf, ci, ci, vp]
    tracker.madpp_tracker_step.restype = ci
    tracker.madpp_tracker_scratch.argtypes = [ci, ci, ci]
    tracker.madpp_tracker_scratch.restype = cl
    tracker.madpp_tracker_cluster.argtypes = [ci, ci, ci]
    tracker.madpp_tracker_cluster.restype = ci
    kalman = ctypes.CDLL(str(BUILD_DIR / "libkalman_step.so"))
    kalman.madpp_kalman_step.argtypes = [vp] * 10 + [ci, cf, cf, vp]
    kalman.madpp_kalman_step.restype = ci
    tagging = ctypes.CDLL(str(BUILD_DIR / "libtagging_step.so"))
    tagging.madpp_tagging_step.argtypes = [vp] * 23 + [ci] * 8 + [vp]
    tagging.madpp_tagging_step.restype = ci
    tagging.madpp_tagging_cluster.argtypes = [ci, ci]
    tagging.madpp_tagging_cluster.restype = ci
    associate = ctypes.CDLL(str(BUILD_DIR / "libassociate.so"))
    associate.madpp_associate.argtypes = [vp] * 3 + [ci, ci, cf, vp, vp]
    associate.madpp_associate.restype = ci
    associate.madpp_associate_scratch.argtypes = [ci, ci]
    associate.madpp_associate_scratch.restype = cl
    associate.madpp_associate_cluster.argtypes = [ci, ci]
    associate.madpp_associate_cluster.restype = ci
    nms = ctypes.CDLL(str(BUILD_DIR / "libnms_keep.so"))
    nms.madpp_nms_keep.argtypes = [vp] * 3 + [ci, ci, cf, vp]
    nms.madpp_nms_keep.restype = ci
    nms.madpp_nms_keep_large.argtypes = [vp] * 5 + [ci, ci, cf, vp]
    nms.madpp_nms_keep_large.restype = ci
    planner = ctypes.CDLL(str(BUILD_DIR / "libplan_step.so"))
    planner.madpp_plan_step.argtypes = [vp] * 12 + [ci] * 10 + [cf] * 6 + [vp]
    planner.madpp_plan_step.restype = ci
    return SimpleNamespace(
        tracker_step=tracker.madpp_tracker_step,
        kalman_step=kalman.madpp_kalman_step,
        tagging_step=tagging.madpp_tagging_step,
        associate=associate.madpp_associate,
        tracker_scratch=tracker.madpp_tracker_scratch,
        tracker_cluster=tracker.madpp_tracker_cluster,
        tagging_cluster=tagging.madpp_tagging_cluster,
        associate_scratch=associate.madpp_associate_scratch,
        associate_cluster=associate.madpp_associate_cluster,
        nms_keep=nms.madpp_nms_keep,
        nms_keep_large=nms.madpp_nms_keep_large,
        plan_step=planner.madpp_plan_step,
    )
