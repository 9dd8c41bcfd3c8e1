"""Wrapper of kernel K1 (kernels/csrc/tracker_step.cu): one whole tracker
step, with the confirmed order, in one launch.

Replaces the Pallas TPU kernel of the JAX package's ops/tracker_pallas.py
(`_make_kernel`, launched by `tracker_update_pallas`).  The plain PyTorch
version is tracking/tracker.py `tracker_update` followed by
`confirmed_order`; the kernel is bit-identical to it.

Bound on an H100: at T=64, D=16, L=50 a step reads about 29.6 KB and writes
about 29.7 KB (the trajectory ring dominates), about 18 ns at 3.35 TB/s, and
its arithmetic is a few thousand operations.  Both are far below the launch
latency of a few microseconds, so the step is latency-bound; the kernel
answers with one launch per frame in one thread block, the table in shared
memory and no host synchronisation (`next_id` and the confirmed count stay
on the device).
"""

from __future__ import annotations

import torch

from ..config import TrackerConfig
from ..kernels import build
from ..types import Detections, TrackTable

MAX_TRACKS = 128
MAX_DETECTIONS = 64

# Launches of the kernel in this process; only `tracker_step` adds to it.
launches = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device):
    if t.device != device:
        raise ValueError(f"tracker_step: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"tracker_step: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"tracker_step: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"tracker_step: {name} is not contiguous")


def tracker_step(table: TrackTable, dets: Detections, cfg: TrackerConfig, min_hits: int):
    """Launch K1 on CUDA tensors.

    Returns (new_table, match, order, n_confirmed), the same as the plain
    `tracker_update` + `confirmed_order`.
    """
    global launches
    device = table.track_id.device
    if device.type != "cuda":
        raise ValueError(f"tracker_step launches a CUDA kernel; got a tensor on {device}")
    T = table.track_id.shape[0]
    D = dets.bbox.shape[0]
    L = table.trajectory.shape[1] // 2
    if not (1 <= T <= MAX_TRACKS and 1 <= D <= MAX_DETECTIONS and L >= 1):
        raise ValueError(
            f"tracker_step takes 1..{MAX_TRACKS} slots and 1..{MAX_DETECTIONS} "
            f"detections; got T={T}, D={D}, L={L}"
        )
    i32, f32 = torch.int32, torch.float32
    ins = (
        ("track_id", table.track_id, i32, (T,)),
        ("bbox", table.bbox, f32, (T, 4)),
        ("class_id", table.class_id, i32, (T,)),
        ("confidence", table.confidence, f32, (T,)),
        ("age", table.age, i32, (T,)),
        ("hits", table.hits, i32, (T,)),
        ("misses", table.misses, i32, (T,)),
        ("trajectory", table.trajectory, f32, (T, 2 * L)),
        ("traj_len", table.traj_len, i32, (T,)),
        ("velocity", table.velocity, f32, (T, 2)),
        ("vel_count", table.vel_count, i32, (T,)),
        ("next_id", table.next_id, i32, ()),
        ("det_bbox", dets.bbox, f32, (D, 4)),
        ("det_class_id", dets.class_id, i32, (D,)),
        ("det_confidence", dets.confidence, f32, (D,)),
        ("det_valid", dets.valid, torch.bool, (D,)),
    )
    for name, t, dtype, shape in ins:
        _check(name, t, dtype, shape, device)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    out = TrackTable(
        track_id=empty((T,), i32),
        bbox=empty((T, 4), f32),
        class_id=empty((T,), i32),
        confidence=empty((T,), f32),
        age=empty((T,), i32),
        hits=empty((T,), i32),
        misses=empty((T,), i32),
        trajectory=empty((T, 2 * L), f32),
        traj_len=empty((T,), i32),
        velocity=empty((T, 2), f32),
        vel_count=empty((T,), i32),
        next_id=empty((), i32),
    )
    match = empty((T,), i32)
    order = empty((T,), i32)
    n_confirmed = empty((), i32)
    out_ptrs = [
        out.track_id, out.bbox, out.class_id, out.confidence, out.age, out.hits,
        out.misses, out.trajectory, out.traj_len, out.velocity, out.vel_count,
        out.next_id, match, order, n_confirmed,
    ]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.kernels().tracker_step(
            *[t.data_ptr() for _, t, _, _ in ins],
            *[t.data_ptr() for t in out_ptrs],
            T, D, L, float(cfg.iou_threshold), int(cfg.max_age), int(min_hits), stream,
        )
    if err != 0:
        raise RuntimeError(f"tracker_step: kernel launch failed with CUDA error {err}")
    launches += 1
    return out, match, order, n_confirmed
