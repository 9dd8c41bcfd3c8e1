"""The per-frame pipeline and its sequence runner.

One frame is ``(state, inputs) -> (state', out)``: with ``use_frames`` and
a camera frame, find the lanes and the scene features (tensor ops,
perception/lanes.py); track (kernel K1 on the card), estimate the ego state
(kernel K2 on the card), plan (kernel K6 on the card), and, with
``enable_tagging``, tag (kernel K3 on the card, in frames mode when the
frame gave lanes and scene features).  The sequence runner loops that step
over a whole sequence and writes each frame's outputs into preallocated
``(F, ...)`` buffers, so that no frame waits for the host but for the
Canny hysteresis's convergence reads.  The tags travel as K3's two packed rows a
frame and the lane observation as two rows, unpacked once, after the loop.

Lanes: `make_batched_sequence_runner` runs B independent streams (the
server's sessions, the multi-camera runner's cameras) through the same
frame step with a leading lane axis on the state and the inputs: the
counterpart of ``jax.vmap(make_sequence_runner(...))``.  Kernels K1, K2, K3
and K6 take the lane axis, one launch a frame for all lanes.  The unbatched
runner and `make_pipeline_step` run that frame step with no lane axis,
which is B = 1 of the same kernels.

Entry points run on the card unless the caller asks for ``device="cpu"``,
where each kernel's plain version runs instead.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .config import PipelineConfig
from .estimation.ego import estimator_step_row
from .ops import library, tracker_kernel
from .ops.kalman import make_constant_accel_model
from .perception.lanes import make_lane_step
from .planning import planner
from .tagging.rules import make_packed_tagging_step, unpack_tags
from .tracking.tracker import tracker_update_with_order
from .types import (
    VEHICLE_STATE_FIELDS,
    Detections,
    KalmanState,
    LaneObservation,
    LaneState,
    PipelineState,
    TaggingState,
    TrackTable,
    VehicleState,
    map_lanes,
    tree_leaves,
    vehicle_state_from_row,
)
from .utils.convert import kalman_model_from_numpy
from .utils.device import resolve_device
from .utils.profiler import NO_SPAN, SPANS


def initial_state(cfg: PipelineConfig, device="cuda") -> PipelineState:
    dev = resolve_device(device)
    return PipelineState(
        tracks=TrackTable.empty(cfg.tracker.max_tracks, cfg.tracker.trajectory_length, dev),
        kalman=KalmanState.initial(cfg.estimator.initial_covariance, dev),
        lanes=LaneState.initial(dev),
        tagging=TaggingState.initial(
            cfg.tagging.scene_smoothing_window,
            cfg.tagging.maneuver_history,
            cfg.tracker.max_tracks,
            dev,
            interaction_history=cfg.tagging.interaction_history,
        ),
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
    )


def detections_from_arrays(arrs: Dict[str, Any], device="cuda") -> Detections:
    dev = resolve_device(device)
    return Detections(
        bbox=torch.as_tensor(arrs["bbox"], dtype=torch.float32, device=dev),
        class_id=torch.as_tensor(arrs["class_id"], dtype=torch.int32, device=dev),
        confidence=torch.as_tensor(arrs["confidence"], dtype=torch.float32, device=dev),
        valid=torch.as_tensor(arrs["valid"], dtype=torch.bool, device=dev),
    )


# The lane observation's fields in its two packed rows a frame.
_LANE_F = (("left_fit", 3), ("right_fit", 3), ("left_confidence", 1), ("right_confidence", 1), ("offset_px", 1))
_LANE_B = ("left_found", "right_found", "has_offset")


def _pack_lane_obs(obs: LaneObservation):
    """The observation as a (..., 9) float32 row and a (..., 3) bool row."""
    f = torch.cat([getattr(obs, k).reshape(*obs.offset_px.shape, n) for k, n in _LANE_F], dim=-1)
    return f, torch.stack([getattr(obs, k) for k in _LANE_B], dim=-1)


def _unpack_lane_obs(f: torch.Tensor, b: torch.Tensor) -> LaneObservation:
    """`_pack_lane_obs`'s rows, stacked over frames, back into fields."""
    fields, off = {}, 0
    for k, n in _LANE_F:
        piece = f[..., off : off + n]
        fields[k] = piece if n > 1 else piece[..., 0]
        off += n
    fields.update({k: b[..., i] for i, k in enumerate(_LANE_B)})
    return LaneObservation(**{k: v.contiguous() for k, v in fields.items()})


def check_card_limits(cfg: PipelineConfig, dev: torch.device) -> None:
    """Refuse, when a runner, server or facade is built for the card, a
    configuration whose tables kernels K1 and K3 do not take: more than
    4,096 track slots or detections a frame.  The CPU takes any size."""
    if dev.type != "cuda":
        return
    limits = (
        ("tracker.max_tracks", cfg.tracker.max_tracks, tracker_kernel.MAX_TRACKS, "track slots"),
        ("detector.max_detections", cfg.detector.max_detections, tracker_kernel.MAX_DETECTIONS, "detections"),
    )
    for field, value, limit, what in limits:
        if value > limit:
            raise ValueError(
                f"{field} = {value}: the card's kernels take at most {limit} {what}; "
                f"lower {field} or run on device='cpu'"
            )


def _make_frame_step(cfg: PipelineConfig, dev: torch.device, ops: bool = False):
    """The frame step: ``(state, inputs) -> (state', out, rows)``, with
    ``rows`` the packed rows of the frame: K3's ``tag_f``/``tag_i`` with
    tagging and the lane observation's ``lane_f``/``lane_b`` with lanes.
    ``out`` holds no "tags" and no "lane_obs", and the vehicle state as
    K2's (11,) row.  State, inputs and outputs carry the same leading lane
    axis, (B, ...), or none.

    With ``ops``, K1-K3 go through the ``madpp`` custom ops
    (ops/library.py), as in the program that utils/export.py traces, and
    the planner through its tensor ops (``torch.export`` traces no call
    of the kernel library); without, K1-K3 and K6 through their wrappers,
    or their plain versions on the CPU."""
    check_card_limits(cfg, dev)
    if ops:
        track, estimate = library.tracker_update_with_order, library.estimator_step_row
        make_tagging, plan_from_row = library.make_packed_tagging_step, planner.plan_from_row_plain
    else:
        track, estimate, make_tagging = tracker_update_with_order, estimator_step_row, make_packed_tagging_step
        plan_from_row = planner.plan_from_row
    model = kalman_model_from_numpy(
        *make_constant_accel_model(
            cfg.estimator.dt,
            cfg.estimator.process_noise,
            cfg.estimator.measurement_noise,
            cfg.estimator.accel_noise_scale,
        ),
        device=dev,
    )
    tagging_step = make_tagging(cfg) if cfg.enable_tagging else None
    lane_step = make_lane_step(cfg, dev) if cfg.use_frames else None
    # Per lane count: the default has-measurement flags.
    per_lanes: Dict[tuple, Any] = {}

    def step(state: PipelineState, inputs: Dict[str, Any]):
        dets = inputs["detections"]
        lead = tuple(state.frame_idx.shape)
        if lead not in per_lanes:
            per_lanes[lead] = torch.ones(lead, dtype=torch.bool, device=dev)
        measured = per_lanes[lead]
        rows = {}
        rec = SPANS.active()

        # Lanes and scene features, from the camera frame.  The lane step
        # reads the Canny hysteresis's flag on the host, so with a lane
        # axis it runs once a lane (K1-K3 still run once for all lanes);
        # batching it belongs with its CUDA graph (ROADMAP items 5a, 7b).
        if lane_step is not None and "frame" in inputs:
            with rec.span("lanes") if rec else NO_SPAN:
                if lead:
                    lanes, lane_obs, frame_feats = map_lanes(lane_step, lead[0], state.lanes, inputs["frame"])
                else:
                    lanes, lane_obs, frame_feats = lane_step(state.lanes, inputs["frame"])
                rows["lane_f"], rows["lane_b"] = _pack_lane_obs(lane_obs)
        else:
            lanes, lane_obs, frame_feats = state.lanes, None, None

        # Tracking: kernel K1 on the card, the confirmed order included.
        with rec.span("track") if rec else NO_SPAN:
            table, match, order, n_confirmed = track(state.tracks, dets, cfg.tracker, cfg.tracker.min_hits)

        # Ego estimation: kernel K2 on the card, the state as its one row.
        with rec.span("estimate") if rec else NO_SPAN:
            kalman, vrow = estimate(
                state.kalman,
                model,
                inputs["ego_measurement"],
                inputs.get("has_measurement", measured),
                cfg.estimator,
            )

        # Planning: kernel K6 on the card, from K2's row where it lies.
        with rec.span("plan") if rec else NO_SPAN:
            pr, best_positions, best_velocities = plan_from_row(
                vrow,
                cfg.planner,
                reference_positions=inputs.get("reference_positions"),
                reference_valid=inputs.get("reference_valid"),
                obstacles=inputs.get("obstacles"),
                obstacles_valid=inputs.get("obstacles_valid"),
            )

        # Tagging: kernel K3 on the card, in frames mode with lanes.
        if tagging_step is not None:
            with rec.span("tag") if rec else NO_SPAN:
                tagging_state, rows["tag_f"], rows["tag_i"] = tagging_step(
                    state.tagging, dets, table, vrow, lane_obs, frame_feats
                )
        else:
            tagging_state = state.tagging

        new_state = PipelineState(
            tracks=table,
            kalman=kalman,
            lanes=lanes,
            tagging=tagging_state,
            frame_idx=state.frame_idx + 1,
        )
        out = {
            "track_id": table.track_id,
            "track_bbox": table.bbox,
            "track_class_id": table.class_id,
            "track_confidence": table.confidence,
            "track_hits": table.hits,
            "track_misses": table.misses,
            "track_age": table.age,
            "track_velocity": table.velocity,
            "track_vel_count": table.vel_count,
            "confirmed_order": order,
            "num_confirmed": n_confirmed,
            "match": match,
            "vehicle_state": vrow,
            "plan_costs": pr.costs,
            "plan_best": pr.best,
            "plan_best_positions": best_positions,
            "plan_best_velocities": best_velocities,
        }
        if cfg.emit_trajectories:
            out["track_trajectory"] = table.trajectory
            out["track_traj_len"] = table.traj_len
        if cfg.emit_candidates:
            out["plan_order"] = pr.order
            out["plan_positions"] = pr.positions
            out["plan_velocities"] = pr.velocities
            out["plan_lateral_offsets"] = pr.lateral_offsets.expand(pr.costs.shape)  # the grid, a lane each
        return new_state, out, rows

    return step


def _unpack_rows(outs: Dict[str, Any], max_tracks: int) -> None:
    """Replace the packed rows in ``outs`` by "tags" (always) and
    "lane_obs" (with lanes)."""
    tag_f, tag_i = outs.pop("tag_f", None), outs.pop("tag_i", None)
    outs["tags"] = {} if tag_f is None else unpack_tags(tag_f, tag_i, max_tracks)
    if "lane_f" in outs:
        outs["lane_obs"] = _unpack_lane_obs(outs.pop("lane_f"), outs.pop("lane_b"))


def make_pipeline_step(cfg: PipelineConfig, device="cuda"):
    """Build the per-frame step function.

    Inputs per frame (all fixed-shape, on the step's device):
      detections: Detections table
      ego_measurement: (4,) [x, y, vx, vy]
      frame: optional (H, W, 3) BGR image, uint8 or int32: with
        ``use_frames``, lanes and scene features (and frames-mode tags)
      has_measurement, reference_positions, reference_valid, obstacles,
      obstacles_valid: optional, as in the JAX package.

    Outputs: a dict of per-frame results, the JAX package's keys; "tags"
    holds the 43 tags with ``enable_tagging``, else nothing; "lane_obs" the
    LaneObservation when the frame gave lanes.
    """
    frame_step = _make_frame_step(cfg, resolve_device(device))

    def step(state: PipelineState, inputs: Dict[str, Any]):
        new_state, out, rows = frame_step(state, inputs)
        out.update(rows)
        out["vehicle_state"] = vehicle_state_from_row(out["vehicle_state"])
        _unpack_rows(out, cfg.tracker.max_tracks)
        return new_state, out

    return step


_REQUIRED_INPUT_KEYS = frozenset({"bbox", "class_id", "confidence", "valid", "ego_measurement"})
_INPUT_DTYPES = {
    "bbox": torch.float32,
    "class_id": torch.int32,
    "confidence": torch.float32,
    "valid": torch.bool,
    "ego_measurement": torch.float32,
    "has_measurement": torch.bool,  # estimator measurement-skip branch
    "reference_positions": torch.float32,  # planner reference-path cost
    "reference_valid": torch.bool,
    "obstacles": torch.float32,  # planner obstacle penalties
    "obstacles_valid": torch.bool,
    "frame": None,  # (F, H, W, 3) uint8 or int32, kept in its dtype
}
_FRAME_DTYPES = (torch.uint8, torch.int32)


def make_sequence_runner(cfg: PipelineConfig, device="cuda"):
    """Build a runner that loops the pipeline step over a whole sequence.

    ``inputs`` is a dict of time-stacked arrays (numpy or tensors):
    detections (F, D, ...), ego_measurement (F, 4) and the optional
    per-frame inputs of `make_pipeline_step`, "frame" (F, H, W, 3) uint8
    or int32 among them (kept in its dtype: 300 uint8 frames at 640x480 are
    276 MB).  Contiguous tensors already on the runner's device in the
    input's dtype (the YOLO frontend's detection tables) go in uncopied.
    Returns ``(final_state, outs)``, ``outs`` holding the step's outputs
    with a leading time axis.
    """
    return _make_runner(cfg, resolve_device(device), lanes=False)


def make_batched_sequence_runner(cfg: PipelineConfig, device="cuda"):
    """Build a runner over B independent streams at once: the counterpart of
    ``jax.vmap(make_sequence_runner(cfg))``.

    The state carries a leading lane axis on every leaf (`types.stack_lanes`
    of B states), and every input a leading (B, F) pair of axes, as
    `make_sequence_runner`'s inputs with a lane axis in front.  Each frame
    launches K1, K2, K3 and K6 once for all B lanes.  Returns
    ``(final_state, outs)``, ``outs`` with leading (B, F) axes; lane b's
    outputs are those of `make_sequence_runner` on lane b's state and
    inputs: on the card bit for bit, on the CPU the planner's floats
    within rounding of its batched reductions.
    """
    return _make_runner(cfg, resolve_device(device), lanes=True)


def _make_runner(cfg: PipelineConfig, dev: torch.device, lanes: bool, step=None):
    """The sequence runner over ``step``, the frame step of
    `_make_frame_step` (built here when None) or another with its contract
    (utils/export.py's loaded program)."""
    if step is None:
        step = _make_frame_step(cfg, dev)

    def as_input(k, v):
        v = torch.as_tensor(v) if k == "frame" else torch.as_tensor(v, dtype=_INPUT_DTYPES[k])
        if k == "frame" and v.dtype not in _FRAME_DTYPES:
            raise TypeError(f"frames are uint8 or int32, not {v.dtype}")
        v = v.to(dev)
        # Frame-major on the device, so that each frame's slice is contiguous.
        return (v.transpose(0, 1) if lanes else v).contiguous()

    def run(state: PipelineState, inputs: Dict[str, Any]):
        rec = SPANS.active()
        if rec is None:
            return run_loop(state, inputs, None)
        with rec.span("frames") as sp:
            return run_loop(state, inputs, rec, sp.counts)

    def run_loop(state: PipelineState, inputs: Dict[str, Any], rec, counts=None):
        unknown = set(inputs) - set(_INPUT_DTYPES)
        if unknown:
            raise ValueError(
                f"unknown sequence inputs {sorted(unknown)}; supported: {sorted(_INPUT_DTYPES)}"
            )
        missing = _REQUIRED_INPUT_KEYS - set(inputs)
        if missing:
            raise KeyError(f"missing sequence inputs {sorted(missing)}")
        if state.tracks.track_id.device != dev:
            raise ValueError(
                f"the state is on {state.tracks.track_id.device}, the runner on {dev}"
            )
        lead = tuple(state.frame_idx.shape)
        if lanes:
            shapes = {tuple(torch.as_tensor(leaf).shape[:1]) for leaf in tree_leaves(state)}
            if len(lead) != 1 or shapes != {lead}:
                raise ValueError("the batched runner takes a state with one leading lane axis on every leaf")
            bad = {k: tuple(v.shape[:1]) for k, v in inputs.items() if tuple(v.shape[:1]) != lead}
            if bad:
                raise ValueError(f"inputs need a leading lane axis of {lead[0]}; got {bad}")
        elif lead:
            raise ValueError("make_sequence_runner takes an unbatched state; use make_batched_sequence_runner")
        with rec.span("inputs") if rec else NO_SPAN:
            xs = {k: as_input(k, v) for k, v in inputs.items()}
        num_frames = xs["bbox"].shape[0]
        if rec:
            counts.update(frames=num_frames, lanes=lead[0] if lead else 1)

        bufs: Dict[str, torch.Tensor] = {}
        for f in range(num_frames):
            with rec.span("step", frame=f) if rec else NO_SPAN:
                frame = {k: v[f] for k, v in xs.items()}
                frame["detections"] = Detections(
                    bbox=frame.pop("bbox"),
                    class_id=frame.pop("class_id"),
                    confidence=frame.pop("confidence"),
                    valid=frame.pop("valid"),
                )
                state, out, rows = step(state, frame)
                out.update(rows)
                with rec.span("write") if rec else NO_SPAN:
                    if not bufs:
                        bufs = {
                            k: torch.empty((*lead, num_frames, *v.shape[len(lead):]), dtype=v.dtype, device=dev)
                            for k, v in out.items()
                        }
                    for k, v in out.items():
                        (bufs[k][:, f] if lanes else bufs[k][f]).copy_(v)

        with rec.span("unpack") if rec else NO_SPAN:
            outs: Dict[str, Any] = dict(bufs)
            vs = outs.pop("vehicle_state", None)
            if vs is not None:
                outs["vehicle_state"] = VehicleState(
                    *(vs[..., i].contiguous() for i in range(len(VEHICLE_STATE_FIELDS)))
                )
            _unpack_rows(outs, cfg.tracker.max_tracks)
        return state, outs

    return run
