"""Wrapper of kernel K3 (kernels/csrc/tagging_step.cu): the whole tagging
stage (scene classifier, maneuver detector, interaction detector) in one
launch.

Replaces the Pallas TPU kernel of the JAX package's ops/tagging_pallas.py
(`_make_kernel`, launched by `make_fused_tagging_step`), in both of its
modes.  The plain PyTorch version is tagging/rules.py `tagging_step_plain`.
This module carries the layout of the kernel's two packed output rows,
which the plain version shares.

Bound on an H100: at T=64 a step reads about 17 KB and writes about 17 KB,
the two copies of the (T, 60) float32 center ring being most of it: about
1e-5 ms at 3.35 TB/s.  Its arithmetic is a few thousand operations.  Both
are far below the launch latency, so the step is latency-bound: on the
device by its chain of dependent phases (tagging_step.cu says what the
kernel does about it), and on the host by this wrapper, whose time a call
sets the rate of the tagging path.  So the wrapper does one pass of checks,
two allocations (the new state and the packed rows are carved from one
float32 and one int32 buffer, `unpack`), and takes the stream
without re-entering the device context.  It reads nothing back from the
device and allocates nothing that depends on the data, so a CUDA graph can
capture it; the state's counters and the frame's timestamp are written on
the device.

Lanes: a state, table and detections with a leading lane axis go through
one launch of B blocks, each running its lane's step as an unbatched
launch would; the state and rows come back (B, ...).  An unbatched call is
the kernel's B = 1.  ``launches`` counts launches, not lanes.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import build
from ..types import TaggingState
from . import launch

# One thread a track slot: the kernel's small instance takes at most 128
# slots in one block, its general instance MAX_TRACKS on a thread block
# cluster a lane (`cluster_size`); its launcher picks one by shape.
MAX_TRACKS = 4096


@functools.lru_cache(maxsize=None)
def cluster_size(T: int, D: int) -> int:
    """The blocks of the thread block cluster a launch at T slots and D
    detections takes a lane (1: the small instance's single block)."""
    return int(build.kernels().tagging_cluster(T, D))

# --- the packed output rows --------------------------------------------------
# The first 12 floats and 21 ints are the JAX package's SF and SI rows
# (ops/tagging_pallas.py); the rest are the tags it returns beside them.
# Each entry is (name, width): width 1 is a scalar tag, "T" one entry per
# track slot.  kernels/csrc/tagging_step.cu writes these offsets.
SF = (
    "road_type_confidence", "traffic_light_confidence",
    "stop_sign_confidence", "cond_day_confidence", "lateral_confidence",
    "longitudinal_confidence", "turning_confidence", "speed_kmh",
    "acceleration", "yaw_rate_deg", "closest_agent_distance", "min_ttc",
)
SI = (
    "road_type", "road_type_raw", "lane_count", "lateral", "longitudinal",
    "turning", "primary_interaction", "overall_risk", "agent_count",
    "pedestrian_count", "cyclist_count", "vehicle_count",
    "has_traffic_light", "has_stop_sign", "has_pedestrian_area",
    "cond_night", "cond_day", "cond_congested", "cond_clear", "cond_fog",
    "has_min_ttc",
)
NUM_INTERACTIONS = 13
FLOAT_TAGS = tuple((k, 1) for k in SF) + (
    ("timestamp", 1),
    ("interaction_confidence", NUM_INTERACTIONS),
    ("track_interaction_confidence", "T"),
    ("track_distance", "T"),
    ("track_relative_speed", "T"),
    ("track_ttc", "T"),
)
INT_TAGS = tuple((k, 1) for k in SI) + (
    ("interaction_present", NUM_INTERACTIONS),
    ("track_interaction_type", "T"),
    ("track_interaction_risk", "T"),
    ("track_has_ttc", "T"),
)
# Tags emitted as bool; the packed int row holds them as 0/1.
BOOL_TAGS = frozenset(SI[12:]) | {"interaction_present", "track_has_ttc"}

# The float32 constants of the rules, in the order of `TagParams` in
# tagging_step.cu.
PARAM_NAMES = (
    "frame_height", "inv_frame_height", "half_width", "quarter_width",
    "three_quarter_width", "inv_fps", "deg_per_rad",
    "inv_10", "inv_20", "inv_5", "inv_3", "inv_90", "inv_45", "inv_360",
    "lane_change_yaw_deg", "turn_yaw_rate_deg", "hard_brake", "brake",
    "accel", "stopped_speed", "near_miss_distance",
    "pedestrian_danger_distance", "cut_in_distance",
    "following_distance_min", "following_distance_max", "ttc_warning",
    "ttc_critical",
)


def row_width(layout, max_tracks: int) -> int:
    return sum(max_tracks if n == "T" else n for _, n in layout)


# Launches of the kernel in this process; only `tagging_step` adds to it.
launches = 0

# The new state's fields and the packed rows, in the order the kernel carves
# its two buffers (tagging_step.cu `carve`).
FLOAT_FIELDS = ("int_centers", "man_history", "tag_f")
INT_FIELDS = ("scene_votes", "int_len", "scene_count", "man_count", "frame_count", "tag_i")


@functools.lru_cache(maxsize=None)
def output_shapes(T: int, W: int, H: int, HI: int, lead: tuple = ()) -> tuple:
    """The shapes of FLOAT_FIELDS and of INT_FIELDS, each behind the lane
    axis ``lead`` (``()`` or ``(B,)``)."""
    f = ((T, 2 * HI), (H, 6), (row_width(FLOAT_TAGS, T),))
    i = ((W,), (T,), (), (), (), (row_width(INT_TAGS, T),))
    return tuple(lead + s for s in f), tuple(lead + s for s in i)


def output_fields(T: int, W: int, H: int, HI: int, device, lead: tuple = ()) -> tuple:
    """The kernel's outputs carved from one float32 and one int32 buffer:
    ``(float buffer, int buffer, {field: tensor})``."""
    f_shapes, i_shapes = output_shapes(T, W, H, HI, lead)
    fbuf, f = launch.carve(f_shapes, torch.float32, device)
    ibuf, i = launch.carve(i_shapes, torch.int32, device)
    return fbuf, ibuf, dict(zip(FLOAT_FIELDS + INT_FIELDS, f + i))


def tagging_step(rules, state: TaggingState, dets, table, vrow, lane_row=None, feat_row=None):
    """Launch K3 on CUDA tensors, with or without a leading lane axis.

    ``rules`` is a tagging.rules.TaggingRules; ``vrow`` the (11,) float32
    vehicle-state row in VehicleState field order.  ``lane_row`` (8,) and
    ``feat_row`` (6,) select frames mode: the left and right lane fits and
    the two found flags, and the six scene features, as float32.  With a
    lane axis each of these is (B, ...).

    Returns ``(new_state, tag_f, tag_i)``, as the plain version does.
    """
    fbuf, ibuf = tagging_buffers(rules, state, dets, table, vrow, lane_row, feat_row)
    return unpack(fbuf, ibuf, rules, table)


def tagging_buffers(rules, state: TaggingState, dets, table, vrow, lane_row=None, feat_row=None):
    """Launch K3 and return its two output buffers, ``(float32, int32)``;
    `unpack` carves the fields from them.  The CUDA implementation of the
    ``madpp.tagging_step`` op (ops/library.py)."""
    global launches
    device = table.track_id.device
    if device.type != "cuda":
        raise ValueError(f"tagging_step launches a CUDA kernel; got a tensor on {device}")
    lead = tuple(table.track_id.shape[:-1])
    T = table.track_id.shape[-1]
    D = dets.class_id.shape[-1]
    W, H, HI = rules.window, rules.history, rules.interaction_history
    if T != rules.max_tracks:
        raise ValueError(f"tagging_step: the table has {T} slots, the rules {rules.max_tracks}")
    if not (len(lead) <= 1 and (not lead or lead[0] >= 1) and 1 <= T <= MAX_TRACKS and D >= 1 and W >= 1
            and H >= 1 and HI >= 1):
        raise ValueError(
            f"tagging_step takes at most one lane axis, 1..{MAX_TRACKS} track slots, at least one "
            f"detection and non-empty rings; got lanes {lead}, T={T}, D={D}, W={W}, H={H}, HI={HI}"
        )
    frames_mode = lane_row is not None
    if frames_mode != (feat_row is not None):
        raise ValueError("tagging_step: lane_row and feat_row come together or not at all")
    i32, f32 = torch.int32, torch.float32
    ins = (
        ("det_class_id", dets.class_id, i32, lead + (D,)),
        ("det_confidence", dets.confidence, f32, lead + (D,)),
        ("det_valid", dets.valid, torch.bool, lead + (D,)),
        ("bbox", table.bbox, f32, lead + (T, 4)),
        ("class_id", table.class_id, i32, lead + (T,)),
        ("track_id", table.track_id, i32, lead + (T,)),
        ("hits", table.hits, i32, lead + (T,)),
        ("velocity", table.velocity, f32, lead + (T, 2)),
        ("vel_count", table.vel_count, i32, lead + (T,)),
        ("vehicle_row", vrow, f32, lead + (11,)),
        ("scene_votes", state.scene_votes, i32, lead + (W,)),
        ("scene_count", state.scene_count, i32, lead),
        ("man_history", state.man_history, f32, lead + (H, 6)),
        ("man_count", state.man_count, i32, lead),
        ("int_centers", state.int_centers, f32, lead + (T, 2 * HI)),
        ("int_len", state.int_len, i32, lead + (T,)),
        ("int_track_id", state.int_track_id, i32, lead + (T,)),
        ("frame_count", state.frame_count, i32, lead),
    )
    if frames_mode:
        ins += (("lane_row", lane_row, f32, lead + (8,)), ("feat_row", feat_row, f32, lead + (6,)))
    launch.check_inputs("tagging_step", device, ins)
    params = rules.params
    if params.dtype.name != "float32" or params.shape != (len(PARAM_NAMES),) or not params.flags.c_contiguous:
        raise ValueError(f"tagging_step: rules.params must be ({len(PARAM_NAMES)},) float32")

    f_shapes, i_shapes = output_shapes(T, W, H, HI, lead)
    fbuf = launch.buffer(f_shapes, f32, device)
    ibuf = launch.buffer(i_shapes, i32, device)
    ptrs = [t.data_ptr() for _, t, _, _ in ins]
    if not frames_mode:
        ptrs += [0, 0]
    kernel = build.kernels().tagging_step
    args = (fbuf.data_ptr(), ibuf.data_ptr(), params.ctypes.data, lead[0] if lead else 1, T, D, W, H, HI,
            int(rules.min_hits), int(frames_mode))
    err = launch.launch(device, lambda stream: kernel(*ptrs, *args, stream))
    if err != 0:
        raise RuntimeError(f"tagging_step: kernel launch failed with CUDA error {err}")
    launches += 1
    return fbuf, ibuf


def unpack(fbuf: torch.Tensor, ibuf: torch.Tensor, rules, table):
    """The fields of K3's two buffers for a step over ``table``, as views:
    ``(new_state, tag_f, tag_i)``; the new state's ``int_track_id`` is the
    table's ``track_id``."""
    lead = tuple(table.track_id.shape[:-1])
    f_shapes, i_shapes = output_shapes(
        table.track_id.shape[-1], rules.window, rules.history, rules.interaction_history, lead
    )
    out = dict(zip(FLOAT_FIELDS + INT_FIELDS, launch.split(fbuf, f_shapes) + launch.split(ibuf, i_shapes)))
    new_state = TaggingState(
        scene_votes=out["scene_votes"],
        scene_count=out["scene_count"],
        man_history=out["man_history"],
        man_count=out["man_count"],
        int_centers=out["int_centers"],
        int_len=out["int_len"],
        int_track_id=table.track_id,
        frame_count=out["frame_count"],
    )
    return new_state, out["tag_f"], out["tag_i"]
