"""Wrapper of kernel K1 (kernels/csrc/tracker_step.cu): one whole tracker
step, with the confirmed order, in one launch.

Replaces the Pallas TPU kernel of the JAX package's ops/tracker_pallas.py
(`_make_kernel`, launched by `tracker_update_pallas`).  The plain PyTorch
version is tracking/tracker.py `tracker_update` followed by
`confirmed_order`; the kernel is bit-identical to it.

Bound on an H100: at T=64, D=16, L=50 a step reads about 29.6 KB and writes
about 29.7 KB (the trajectory ring dominates), about 18 ns at 3.35 TB/s, and
its arithmetic is a few thousand operations.  Both are far below the launch
latency, so the step is latency-bound: on the device by its chain of
dependent phases (tracker_step.cu says what the kernel does about it), and
on the host by this wrapper, whose time a call sets the rate of a path that
launches one step a frame.  So the wrapper does one thing per call: one
pass of checks, two allocations (the outputs are carved from one float32
and one int32 buffer, `unpack`), 19 pointers to the binding, and the
stream without re-entering the device context.  It reads nothing back from
the device and allocates nothing that depends on the data, so a CUDA graph
can capture it.  Larger tables, up to 4,096 slots and 4,096 detections,
take the kernel's general instance (a thread block cluster of up to 16
blocks a lane, tracker_step.cu); where its association's keys do not fit
in the cluster's shared memory (1,024 x 1,024 and beyond), the wrapper allocates them
a device scratch a lane, by shape alone (`scratch_words`).  Its times are
in PERF.md.

Lanes: a table and detections with a leading lane axis, (B, T, ...) and
(B, D, ...), go through one launch of B blocks, each running its lane's
step as an unbatched launch would; the outputs come back (B, ...).  An
unbatched call is the kernel's B = 1.  ``launches`` counts launches, not
lanes.
"""

from __future__ import annotations

import functools

import torch

from ..config import TrackerConfig
from ..kernels import build
from ..types import Detections, TrackTable
from . import launch

# The kernel has two instances: the one whose times PERF.md tracks, for
# tables of at most 128 slots and 64 detections, and a general one up to
# MAX_TRACKS and MAX_DETECTIONS; its launcher picks one by shape.
MAX_TRACKS = 4096
MAX_DETECTIONS = 4096

# The output fields, in the order the kernel carves its two buffers
# (tracker_step.cu `carve`).
FLOAT_FIELDS = ("trajectory", "bbox", "confidence", "velocity")
INT_FIELDS = (
    "track_id", "class_id", "age", "hits", "misses", "traj_len", "vel_count",
    "match", "order", "next_id", "n_confirmed",
)

# Launches of the kernel in this process; only `tracker_step` adds to it.
launches = 0


@functools.lru_cache(maxsize=None)
def scratch_words(T: int, D: int, L: int) -> int:
    """32-bit words of device scratch a lane of the launch at (T, D, L)
    takes for its association's keys: 0 where they fit in the cluster's
    shared memory (the launcher's own rule, asked of the built library)."""
    return int(build.kernels().tracker_scratch(T, D, L))


@functools.lru_cache(maxsize=None)
def cluster_size(T: int, D: int, L: int) -> int:
    """The blocks a lane of the launch at (T, D, L) takes: its thread block
    cluster (1: the small instance's single block)."""
    return int(build.kernels().tracker_cluster(T, D, L))


@functools.lru_cache(maxsize=None)
def output_shapes(T: int, L: int, lead: tuple = ()) -> tuple:
    """The shapes of FLOAT_FIELDS and of INT_FIELDS at T slots and a ring of
    L points, each behind the lane axis ``lead`` (``()`` or ``(B,)``)."""
    per_slot = {"trajectory": (T, 2 * L), "bbox": (T, 4), "velocity": (T, 2), "next_id": (), "n_confirmed": ()}
    return (
        tuple(lead + per_slot.get(k, (T,)) for k in FLOAT_FIELDS),
        tuple(lead + per_slot.get(k, (T,)) for k in INT_FIELDS),
    )


def output_fields(T: int, L: int, device, lead: tuple = ()) -> tuple:
    """The kernel's outputs carved from one float32 and one int32 buffer:
    ``(float buffer, int buffer, {field: tensor})``."""
    f_shapes, i_shapes = output_shapes(T, L, lead)
    fbuf, f = launch.carve(f_shapes, torch.float32, device)
    ibuf, i = launch.carve(i_shapes, torch.int32, device)
    return fbuf, ibuf, dict(zip(FLOAT_FIELDS + INT_FIELDS, f + i))


def tracker_step(table: TrackTable, dets: Detections, cfg: TrackerConfig, min_hits: int):
    """Launch K1 on CUDA tensors, with or without a leading lane axis.

    Returns (new_table, match, order, n_confirmed), the same as the plain
    `tracker_update` + `confirmed_order` (lane by lane).
    """
    fbuf, ibuf = tracker_buffers(table, dets, cfg.iou_threshold, cfg.max_age, min_hits)
    return unpack(fbuf, ibuf, table)


def tracker_buffers(table: TrackTable, dets: Detections, iou_threshold: float, max_age: int, min_hits: int):
    """Launch K1 and return its two output buffers, ``(float32, int32)``;
    `unpack` carves the fields from them.  The CUDA implementation of the
    ``madpp.tracker_step`` op (ops/library.py)."""
    global launches
    device = table.track_id.device
    if device.type != "cuda":
        raise ValueError(f"tracker_step launches a CUDA kernel; got a tensor on {device}")
    lead = tuple(table.track_id.shape[:-1])
    B = lead[0] if lead else 1
    T = table.track_id.shape[-1]
    D = dets.bbox.shape[-2]
    L = table.trajectory.shape[-1] // 2
    if not (len(lead) <= 1 and B >= 1 and 1 <= T <= MAX_TRACKS and 1 <= D <= MAX_DETECTIONS and L >= 1):
        raise ValueError(
            f"tracker_step takes at most one lane axis, 1..{MAX_TRACKS} slots and "
            f"1..{MAX_DETECTIONS} detections; got lanes {lead}, T={T}, D={D}, L={L}"
        )
    i32, f32 = torch.int32, torch.float32
    ins = (
        ("track_id", table.track_id, i32, lead + (T,)),
        ("bbox", table.bbox, f32, lead + (T, 4)),
        ("class_id", table.class_id, i32, lead + (T,)),
        ("confidence", table.confidence, f32, lead + (T,)),
        ("age", table.age, i32, lead + (T,)),
        ("hits", table.hits, i32, lead + (T,)),
        ("misses", table.misses, i32, lead + (T,)),
        ("trajectory", table.trajectory, f32, lead + (T, 2 * L)),
        ("traj_len", table.traj_len, i32, lead + (T,)),
        ("velocity", table.velocity, f32, lead + (T, 2)),
        ("vel_count", table.vel_count, i32, lead + (T,)),
        ("next_id", table.next_id, i32, lead),
        ("det_bbox", dets.bbox, f32, lead + (D, 4)),
        ("det_class_id", dets.class_id, i32, lead + (D,)),
        ("det_confidence", dets.confidence, f32, lead + (D,)),
        ("det_valid", dets.valid, torch.bool, lead + (D,)),
    )
    launch.check_inputs("tracker_step", device, ins)
    f_shapes, i_shapes = output_shapes(T, L, lead)
    fbuf = launch.buffer(f_shapes, f32, device)
    ibuf = launch.buffer(i_shapes, i32, device)
    words = scratch_words(T, D, L)
    scratch = torch.empty((B * words,), dtype=i32, device=device) if words else None
    ptrs = [t.data_ptr() for _, t, _, _ in ins]
    kernel = build.kernels().tracker_step
    args = (fbuf.data_ptr(), ibuf.data_ptr(), scratch.data_ptr() if words else 0, B, T, D, L,
            float(iou_threshold), int(max_age), int(min_hits))
    err = launch.launch(device, lambda stream: kernel(*ptrs, *args, stream))
    if err != 0:
        raise RuntimeError(f"tracker_step: kernel launch failed with CUDA error {err} (B={B}, T={T}, D={D}, L={L})")
    launches += 1
    return fbuf, ibuf


def unpack(fbuf: torch.Tensor, ibuf: torch.Tensor, table: TrackTable):
    """The fields of K1's two buffers for a step of ``table``, as views:
    (new_table, match, order, n_confirmed)."""
    lead = tuple(table.track_id.shape[:-1])
    f_shapes, i_shapes = output_shapes(table.track_id.shape[-1], table.trajectory.shape[-1] // 2, lead)
    out = dict(zip(FLOAT_FIELDS + INT_FIELDS, launch.split(fbuf, f_shapes) + launch.split(ibuf, i_shapes)))
    new_table = TrackTable(**{k: out[k] for k in TrackTable.__dataclass_fields__})
    return new_table, out["match"], out["order"], out["n_confirmed"]
