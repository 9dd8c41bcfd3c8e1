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
are far below the launch latency, so the step is latency-bound; the kernel
answers with one launch a frame, one block, per-slot work on one thread a
slot, the aggregates on a few threads from shared memory, and no host
synchronisation: the state's counters and the frame's timestamp are
written on the device.
"""

from __future__ import annotations

import torch

from ..kernels import build
from ..types import TaggingState

MAX_TRACKS = 128  # one thread a track slot

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


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device):
    if t.device != device:
        raise ValueError(f"tagging_step: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"tagging_step: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"tagging_step: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"tagging_step: {name} is not contiguous")


def tagging_step(rules, state: TaggingState, dets, table, vrow, lane_row=None, feat_row=None):
    """Launch K3 on CUDA tensors.

    ``rules`` is a tagging.rules.TaggingRules; ``vrow`` the (11,) float32
    vehicle-state row in VehicleState field order.  ``lane_row`` (8,) and
    ``feat_row`` (6,) select frames mode: the left and right lane fits and
    the two found flags, and the six scene features, as float32.

    Returns ``(new_state, tag_f, tag_i)``, as the plain version does.
    """
    global launches
    device = table.track_id.device
    if device.type != "cuda":
        raise ValueError(f"tagging_step launches a CUDA kernel; got a tensor on {device}")
    T = table.track_id.shape[0]
    D = dets.class_id.shape[0]
    W, H, HI = rules.window, rules.history, rules.interaction_history
    if T != rules.max_tracks:
        raise ValueError(f"tagging_step: the table has {T} slots, the rules {rules.max_tracks}")
    if not (1 <= T <= MAX_TRACKS and D >= 1 and W >= 1 and H >= 1 and HI >= 1):
        raise ValueError(
            f"tagging_step takes 1..{MAX_TRACKS} track slots, at least one "
            f"detection and non-empty rings; got T={T}, D={D}, W={W}, H={H}, HI={HI}"
        )
    frames_mode = lane_row is not None
    if frames_mode != (feat_row is not None):
        raise ValueError("tagging_step: lane_row and feat_row come together or not at all")
    i32, f32 = torch.int32, torch.float32
    ins = (
        ("det_class_id", dets.class_id, i32, (D,)),
        ("det_confidence", dets.confidence, f32, (D,)),
        ("det_valid", dets.valid, torch.bool, (D,)),
        ("bbox", table.bbox, f32, (T, 4)),
        ("class_id", table.class_id, i32, (T,)),
        ("track_id", table.track_id, i32, (T,)),
        ("hits", table.hits, i32, (T,)),
        ("velocity", table.velocity, f32, (T, 2)),
        ("vel_count", table.vel_count, i32, (T,)),
        ("vehicle_row", vrow, f32, (11,)),
        ("scene_votes", state.scene_votes, i32, (W,)),
        ("scene_count", state.scene_count, i32, ()),
        ("man_history", state.man_history, f32, (H, 6)),
        ("man_count", state.man_count, i32, ()),
        ("int_centers", state.int_centers, f32, (T, 2 * HI)),
        ("int_len", state.int_len, i32, (T,)),
        ("int_track_id", state.int_track_id, i32, (T,)),
        ("frame_count", state.frame_count, i32, ()),
    )
    for name, t, dtype, shape in ins:
        _check(name, t, dtype, shape, device)
    if frames_mode:
        _check("lane_row", lane_row, f32, (8,), device)
        _check("feat_row", feat_row, f32, (6,), device)
    params = rules.params
    if params.dtype.name != "float32" or params.shape != (len(PARAM_NAMES),) or not params.flags.c_contiguous:
        raise ValueError(f"tagging_step: rules.params must be ({len(PARAM_NAMES)},) float32")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    votes = empty((W,), i32)
    mhist = empty((H, 6), f32)
    icent = empty((T, 2 * HI), f32)
    ilen = empty((T,), i32)
    counts = empty((3,), i32)  # scene_count, man_count, frame_count
    tag_f = empty((row_width(FLOAT_TAGS, T),), f32)
    tag_i = empty((row_width(INT_TAGS, T),), i32)
    rows = (lane_row.data_ptr(), feat_row.data_ptr()) if frames_mode else (0, 0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.kernels().tagging_step(
            *[t.data_ptr() for _, t, _, _ in ins],
            *rows,
            votes.data_ptr(), mhist.data_ptr(), icent.data_ptr(), ilen.data_ptr(),
            counts.data_ptr(), tag_f.data_ptr(), tag_i.data_ptr(),
            params.ctypes.data,
            T, D, W, H, HI, int(rules.min_hits), int(frames_mode), stream,
        )
    if err != 0:
        raise RuntimeError(f"tagging_step: kernel launch failed with CUDA error {err}")
    launches += 1
    new_state = TaggingState(
        scene_votes=votes,
        scene_count=counts[0],
        man_history=mhist,
        man_count=counts[1],
        int_centers=icent,
        int_len=ilen,
        int_track_id=table.track_id,
        frame_count=counts[2],
    )
    return new_state, tag_f, tag_i
