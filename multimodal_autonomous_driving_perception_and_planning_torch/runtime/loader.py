"""ctypes binding for the native frame-source runtime (frame_ring.cpp).

`build_runtime` compiles the port's own copy of the ring with the host C++
compiler at first use, into ``runtime/build/`` (a temporary file, then a
rename, so that two processes building at once never load a torn library).
`NativeFrameSource` is a producer-thread-backed frame stream whose batches
feed the device pipeline while the next batch is being produced: host
decode overlapped with device compute, unlike the reference's
decode-then-compute serial loop.  `NativeFrameSource.next_batch_into`
drains a batch straight into a caller's tensor (a pinned host buffer in
runtime/stream.py), with no numpy copy between.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "frame_ring.cpp"
_BUILD = _DIR / "build"
_LIB = _BUILD / "libmadpp_runtime.so"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lib = None


def build_runtime(force: bool = False) -> Path:
    """Compile the native library if it is missing or older than its
    source; returns the .so path."""
    if force or not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        _BUILD.mkdir(exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=_LIB.name + ".", suffix=".tmp", dir=_BUILD)
        os.close(fd)
        try:
            cmd = ["c++", *CXXFLAGS, str(_SRC), "-lpthread", "-o", tmp]
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"building the frame ring failed: {' '.join(cmd)}\n{done.stderr}")
            os.replace(tmp, _LIB)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return _LIB


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_runtime()))
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ring_start_synthetic.restype = None
    lib.ring_start_synthetic.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    lib.ring_start_rawfile.restype = ctypes.c_int
    lib.ring_start_rawfile.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.ring_next.restype = ctypes.c_int64
    lib.ring_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.ring_next_batch.restype = ctypes.c_int64
    lib.ring_next_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    lib.ring_produced.restype = ctypes.c_int64
    lib.ring_produced.argtypes = [ctypes.c_void_p]
    lib.ring_consumed.restype = ctypes.c_int64
    lib.ring_consumed.argtypes = [ctypes.c_void_p]
    lib.ring_destroy.restype = None
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeFrameSource:
    """Threaded native frame producer with a fixed-slot ring.

    Modes:
      * synthetic: procedural road frames rasterized in C++.
      * rawfile: contiguous (H, W, 3) uint8 frames read with readahead.
    """

    def __init__(
        self,
        width: int = 640,
        height: int = 480,
        slots: int = 16,
        num_frames: int = 300,
        raw_path: Optional[str] = None,
        threads: int = 0,
    ):
        """``threads`` producer threads fill disjoint ring slots
        (0 = automatic: half the cores, capped at 8).  Producers claim
        frame indices atomically, so output order is exact regardless of
        thread count."""
        self.width = width
        self.height = height
        self.num_frames = num_frames
        self._lib = _load()
        self._ring = self._lib.ring_create(width, height, slots)
        if not self._ring:  # native side validates (slots==0 would be UB)
            raise ValueError(
                f"invalid ring dimensions width={width} height={height} slots={slots} (all must be > 0)"
            )
        if raw_path is not None:
            rc = self._lib.ring_start_rawfile(self._ring, str(raw_path).encode(), num_frames, threads)
            if rc != 0:
                self.close()
                raise FileNotFoundError(f"cannot open raw frame file: {raw_path}")
        else:
            self._lib.ring_start_synthetic(self._ring, num_frames, threads)

    def next_frame(self, timeout_ms: int = 5000) -> Optional[np.ndarray]:
        """Next frame, or None at end-of-stream.  Raises TimeoutError on a
        producer stall (a stall must not look like exhaustion)."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        idx = self._lib.ring_next(self._ring, out.ctypes.data_as(ctypes.c_void_p), timeout_ms)
        if idx == -2:
            raise TimeoutError(
                f"frame producer stalled (> {timeout_ms} ms; produced={self.produced} consumed={self.consumed})"
            )
        if idx < 0:
            return None
        return out

    def _drain(self, ptr: int, n: int, timeout_ms: int) -> int:
        got = int(self._lib.ring_next_batch(self._ring, ctypes.c_void_p(ptr), n, timeout_ms))
        if got < 0:
            raise TimeoutError(
                f"frame producer stalled after {-got - 1} frames (> {timeout_ms} ms; "
                f"produced={self.produced} consumed={self.consumed})"
            )
        return got

    def next_batch(self, n: int, timeout_ms: int = 5000) -> np.ndarray:
        """Up to ``n`` frames; short only at end-of-stream.  Raises
        TimeoutError on a producer stall mid-batch: a silently truncated
        batch would make the chunked stream driver advance its carried state
        through padded frames (runtime/stream.py contract)."""
        out = np.empty((n, self.height, self.width, 3), np.uint8)
        return out[: self._drain(out.ctypes.data, n, timeout_ms)]

    def next_batch_into(self, out: torch.Tensor, timeout_ms: int = 5000) -> int:
        """Drain up to ``out.shape[0]`` frames into ``out``, a contiguous
        (n, H, W, 3) uint8 tensor on the host (pinned or not), in place.
        Returns the count written: short only at end-of-stream; a producer
        stall raises TimeoutError as in `next_batch`."""
        want = (self.height, self.width, 3)
        if out.device.type != "cpu" or out.dtype != torch.uint8 or tuple(out.shape[1:]) != want:
            raise ValueError(
                f"next_batch_into takes a (n, {self.height}, {self.width}, 3) uint8 host tensor, "
                f"not {out.dtype} {tuple(out.shape)} on {out.device}"
            )
        if not out.is_contiguous():
            raise ValueError("next_batch_into takes a contiguous tensor")
        return self._drain(out.data_ptr(), out.shape[0], timeout_ms)

    @property
    def produced(self) -> int:
        return int(self._lib.ring_produced(self._ring))

    @property
    def consumed(self) -> int:
        return int(self._lib.ring_consumed(self._ring))

    def close(self) -> None:
        if self._ring:
            self._lib.ring_destroy(self._ring)
            self._ring = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # Only the ring's own resources: close() joins the producer threads.
        if getattr(self, "_ring", None):
            self.close()
