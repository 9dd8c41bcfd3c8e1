"""Kernels K1, K2 and K3 as ``torch.library`` custom ops, so that a traced
program (``torch.export``, utils/export.py) can hold them.

The ops, in the ``madpp`` namespace:

  ``madpp.tracker_step``  K1, ops/tracker_kernel.py `tracker_buffers`
  ``madpp.kalman_step``   K2, ops/kalman_kernel.py `kalman_buffer`
  ``madpp.tagging_step``  K3 in either mode, ops/tagging_kernel.py
                          `tagging_buffers`

Each takes the leaves of its tables (`types.tree_leaves` order) and its
scalars as ``float``/``int`` arguments.  Its CUDA implementation launches
the kernel through the wrapper and raises where the wrapper raises: it
never runs the plain version instead.  Its CPU implementation runs the
plain version.  Its fake implementation gives the outputs' shapes from the
same ``output_shapes`` the wrappers use.

An op returns the kernel's flat output buffers, one a dtype, and never the
fields: a custom op may not return outputs that alias each other, and the
wrappers carve every field from those buffers.  The callers below carve
them outside the op, with the wrappers' ``unpack`` (`launch.split`: a
`split_with_sizes` and a `view` a field, which the trace records).

`tracker_update_with_order`, `estimator_step_row` and
`make_packed_tagging_step` are the pipeline's entry points of the three
stages (tracking/tracker.py, estimation/ego.py, tagging/rules.py) through
the ops: the frame step of an exported program calls these
(`pipeline._make_frame_step` with ``ops=True``).  The eager runners call
the wrappers directly, as a custom op's dispatch costs host time a call.

K3's frames mode takes two more tensors, the lane row and the scene
feature row (tagging/rules.py `frames_rows`), as optional arguments of
``madpp.tagging_step``: given, the op runs frames mode, absent, detections
mode.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ..config import EstimatorConfig, TrackerConfig
from ..estimation import ego
from ..tagging.rules import TaggingRules, frames_from_rows, frames_rows, tagging_step_plain
from ..tracking import tracker
from ..types import Detections, KalmanState, TaggingState, TrackTable, map_lanes, tree_leaves
from . import kalman_kernel, launch, tagging_kernel, tracker_kernel
from .kalman import KalmanModel

_N_TABLE = len(dataclasses.fields(TrackTable))
_N_DETS = len(dataclasses.fields(Detections))


def _lead(t: Tensor, rank: int) -> tuple:
    """The lane axis of ``t``, a field of ``rank`` dimensions a lane."""
    return tuple(t.shape[: t.dim() - rank])


# --- K1 ----------------------------------------------------------------------


@torch.library.custom_op("madpp::tracker_step", mutates_args=(), device_types="cpu")
def tracker_step(
    track_id: Tensor, bbox: Tensor, class_id: Tensor, confidence: Tensor, age: Tensor, hits: Tensor,
    misses: Tensor, trajectory: Tensor, traj_len: Tensor, velocity: Tensor, vel_count: Tensor, next_id: Tensor,
    det_bbox: Tensor, det_class_id: Tensor, det_confidence: Tensor, det_valid: Tensor,
    iou_threshold: float, max_age: int, min_hits: int,
) -> Tuple[Tensor, Tensor]:
    """One tracker step of the table and detections: K1's float32 and int32
    output buffers.  On the CPU, the plain version."""
    table = TrackTable(track_id, bbox, class_id, confidence, age, hits, misses, trajectory, traj_len, velocity,
                       vel_count, next_id)
    dets = Detections(det_bbox, det_class_id, det_confidence, det_valid)
    cfg = dataclasses.replace(TrackerConfig(), iou_threshold=iou_threshold, max_age=max_age, min_hits=min_hits)
    new_table, match, order, n_confirmed = tracker.tracker_update_with_order(table, dets, cfg, min_hits)
    out = {**{f.name: getattr(new_table, f.name) for f in dataclasses.fields(TrackTable)},
           "match": match, "order": order, "n_confirmed": n_confirmed}
    f_shapes, i_shapes = tracker_kernel.output_shapes(track_id.shape[-1], trajectory.shape[-1] // 2, _lead(track_id, 1))
    return (
        launch.pack([out[k] for k in tracker_kernel.FLOAT_FIELDS], f_shapes, torch.float32, track_id.device),
        launch.pack([out[k] for k in tracker_kernel.INT_FIELDS], i_shapes, torch.int32, track_id.device),
    )


@tracker_step.register_kernel("cuda")
def _tracker_step_cuda(*args):
    table = TrackTable(*args[:_N_TABLE])
    dets = Detections(*args[_N_TABLE : _N_TABLE + _N_DETS])
    return tracker_kernel.tracker_buffers(table, dets, *args[_N_TABLE + _N_DETS :])


# The fake implementations call the shape functions uncached
# (``__wrapped__``): under dynamic shapes the sizes are symbolic, which a
# cache cannot hash.


def _fake_buffers(like: Tensor, f_shapes, i_shapes):
    return (
        like.new_empty(launch.buffer_length(f_shapes), dtype=torch.float32),
        like.new_empty(launch.buffer_length(i_shapes), dtype=torch.int32),
    )


@tracker_step.register_fake
def _tracker_step_fake(track_id, bbox, class_id, confidence, age, hits, misses, trajectory, *rest):
    shapes = tracker_kernel.output_shapes.__wrapped__(track_id.shape[-1], trajectory.shape[-1] // 2,
                                                       _lead(track_id, 1))
    return _fake_buffers(track_id, *shapes)


def tracker_update_with_order(table: TrackTable, dets: Detections, cfg: TrackerConfig, min_hits: int):
    """tracking/tracker.py `tracker_update_with_order` through the
    ``madpp.tracker_step`` op: (new_table, match, order, n_confirmed)."""
    fbuf, ibuf = torch.ops.madpp.tracker_step(
        *tree_leaves(table), *tree_leaves(dets), float(cfg.iou_threshold), int(cfg.max_age), int(min_hits)
    )
    return tracker_kernel.unpack(fbuf, ibuf, table)


# --- K2 ----------------------------------------------------------------------


@torch.library.custom_op("madpp::kalman_step", mutates_args=(), device_types="cpu")
def kalman_step(
    x: Tensor, P: Tensor, time: Tensor, prev_heading: Tensor, prev_speed: Tensor,
    measurement: Tensor, has_measurement: Tensor,
    F: Tensor, H: Tensor, Q: Tensor, R: Tensor,
    dt: float, speed_heading_hold: float,
) -> Tensor:
    """One ego-filter step: K2's float32 output buffer (x, P, the vehicle
    row, time, heading, speed).  On the CPU, the plain version."""
    cfg = dataclasses.replace(EstimatorConfig(), dt=dt, speed_heading_hold=speed_heading_hold)
    new_ks, vs = ego.estimator_step_row(
        KalmanState(x, P, time, prev_heading, prev_speed), KalmanModel(F, H, Q, R), measurement, has_measurement, cfg
    )
    return launch.pack(
        [new_ks.x, new_ks.P, vs, new_ks.time, new_ks.prev_heading, new_ks.prev_speed],
        kalman_kernel.output_shapes(_lead(x, 1)), torch.float32, x.device,
    )


@kalman_step.register_kernel("cuda")
def _kalman_step_cuda(x, P, time, prev_heading, prev_speed, measurement, has_measurement, F, H, Q, R, dt,
                      speed_heading_hold):
    return kalman_kernel.kalman_buffer(
        KalmanState(x, P, time, prev_heading, prev_speed), KalmanModel(F, H, Q, R), measurement, has_measurement,
        dt, speed_heading_hold,
    )


@kalman_step.register_fake
def _kalman_step_fake(x, *rest):
    return x.new_empty(launch.buffer_length(kalman_kernel.output_shapes.__wrapped__(_lead(x, 1))))


def estimator_step_row(ks: KalmanState, model: KalmanModel, measurement: Tensor, has_measurement: Tensor,
                       cfg: EstimatorConfig):
    """estimation/ego.py `estimator_step_row` through the
    ``madpp.kalman_step`` op: (new_state, vehicle row)."""
    buf = torch.ops.madpp.kalman_step(
        *tree_leaves(ks), measurement, has_measurement, *model, float(cfg.dt), float(cfg.speed_heading_hold)
    )
    return kalman_kernel.unpack(buf, _lead(ks.x, 1))


# --- K3 ----------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _rules(params: tuple, window: int, history: int, interaction_history: int, max_tracks: int,
           min_hits: int) -> TaggingRules:
    return TaggingRules(window, history, interaction_history, max_tracks, min_hits, np.asarray(params, np.float32))


def _tagging_rules(params, scene_votes, man_history, int_centers, min_hits) -> TaggingRules:
    """The rules of a step, their ring sizes read from the state."""
    return _rules(tuple(params), scene_votes.shape[-1], man_history.shape[-2], int_centers.shape[-1] // 2,
                  int_centers.shape[-2], min_hits)


@torch.library.custom_op("madpp::tagging_step", mutates_args=(), device_types="cpu")
def tagging_step(
    det_bbox: Tensor, det_class_id: Tensor, det_confidence: Tensor, det_valid: Tensor,
    track_id: Tensor, bbox: Tensor, class_id: Tensor, confidence: Tensor, age: Tensor, hits: Tensor,
    misses: Tensor, trajectory: Tensor, traj_len: Tensor, velocity: Tensor, vel_count: Tensor, next_id: Tensor,
    vehicle_row: Tensor,
    scene_votes: Tensor, scene_count: Tensor, man_history: Tensor, man_count: Tensor, int_centers: Tensor,
    int_len: Tensor, int_track_id: Tensor, frame_count: Tensor,
    params: List[float], min_hits: int, lane_row: Optional[Tensor] = None, feat_row: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """One tagging step: K3's float32 and int32 output buffers (the new
    state and the packed tag rows).  ``params`` are the rules' float32
    constants (`TaggingRules.params`).  ``lane_row`` (..., 8) and
    ``feat_row`` (..., 6) select frames mode.  On the CPU, the plain
    version."""
    rules = _tagging_rules(params, scene_votes, man_history, int_centers, min_hits)
    dets = Detections(det_bbox, det_class_id, det_confidence, det_valid)
    table = TrackTable(track_id, bbox, class_id, confidence, age, hits, misses, trajectory, traj_len, velocity,
                       vel_count, next_id)
    state = TaggingState(scene_votes, scene_count, man_history, man_count, int_centers, int_len, int_track_id,
                         frame_count)
    lead = _lead(track_id, 1)
    frames = () if lane_row is None else frames_from_rows(lane_row, feat_row)
    step = functools.partial(tagging_step_plain, rules)
    new_state, tag_f, tag_i = (map_lanes(step, lead[0], state, dets, table, vehicle_row, *frames) if lead
                               else step(state, dets, table, vehicle_row, *frames))
    out = {**{f.name: getattr(new_state, f.name) for f in dataclasses.fields(TaggingState)},
           "tag_f": tag_f, "tag_i": tag_i}
    f_shapes, i_shapes = tagging_kernel.output_shapes(
        rules.max_tracks, rules.window, rules.history, rules.interaction_history, lead
    )
    return (
        launch.pack([out[k] for k in tagging_kernel.FLOAT_FIELDS], f_shapes, torch.float32, track_id.device),
        launch.pack([out[k] for k in tagging_kernel.INT_FIELDS], i_shapes, torch.int32, track_id.device),
    )


_N_TAGGING_TENSORS = _N_DETS + _N_TABLE + 1 + len(dataclasses.fields(TaggingState))


def _tagging_args(args):
    """``(tensors, params, min_hits, lane_row, feat_row)`` of the op's
    arguments as the dispatcher passes them (positionally, the trailing
    optional rows left out when absent)."""
    n = _N_TAGGING_TENSORS
    lane_row, feat_row = (*args[n + 2 :], None, None)[:2]
    return args[:n], args[n], args[n + 1], lane_row, feat_row


@tagging_step.register_kernel("cuda")
def _tagging_step_cuda(*args):
    tensors, params, min_hits, lane_row, feat_row = _tagging_args(args)
    dets = Detections(*tensors[:_N_DETS])
    table = TrackTable(*tensors[_N_DETS : _N_DETS + _N_TABLE])
    vrow = tensors[_N_DETS + _N_TABLE]
    state = TaggingState(*tensors[_N_DETS + _N_TABLE + 1 :])
    rules = _tagging_rules(params, state.scene_votes, state.man_history, state.int_centers, min_hits)
    return tagging_kernel.tagging_buffers(rules, state, dets, table, vrow, lane_row, feat_row)


@tagging_step.register_fake
def _tagging_step_fake(*args):
    tensors = _tagging_args(args)[0]
    track_id = tensors[_N_DETS]
    scene_votes, _, man_history, _, int_centers = tensors[_N_DETS + _N_TABLE + 1 : _N_DETS + _N_TABLE + 6]
    shapes = tagging_kernel.output_shapes.__wrapped__(
        track_id.shape[-1], scene_votes.shape[-1], man_history.shape[-2], int_centers.shape[-1] // 2,
        _lead(track_id, 1),
    )
    return _fake_buffers(track_id, *shapes)


def make_packed_tagging_step(cfg):
    """tagging/rules.py `make_packed_tagging_step` through the
    ``madpp.tagging_step`` op, in either mode:
    ``step(state, dets, table, vrow, lane_obs=None, frame_feats=None) ->
    (state', tag_f, tag_i)``."""
    rules = TaggingRules.from_config(cfg)
    params = rules.params.tolist()

    def step(state, dets, table, vrow, lane_obs=None, frame_feats=None):
        if (lane_obs is None) != (frame_feats is None):
            raise ValueError("lane_obs and frame_feats come together (frames mode) or not at all (detections mode)")
        lane_row, feat_row = frames_rows(lane_obs, frame_feats)
        fbuf, ibuf = torch.ops.madpp.tagging_step(
            *tree_leaves(dets), *tree_leaves(table), vrow, *tree_leaves(state), params, int(rules.min_hits),
            lane_row, feat_row,
        )
        return tagging_kernel.unpack(fbuf, ibuf, rules, table)

    return step
