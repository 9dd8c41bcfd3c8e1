"""The per-frame pipeline and its sequence runner, detections mode.

One frame is ``(state, inputs) -> (state', out)``: track (kernel K1 on the
card), estimate the ego state (kernel K2 on the card), plan (tensor ops),
and, with ``enable_tagging``, tag (kernel K3 on the card).  The sequence
runner loops that step over a whole sequence and writes each frame's
outputs into preallocated ``(F, ...)`` buffers, so that no frame waits for
the host.  The tags travel as K3's two packed rows a frame and are
unpacked into the 43-key dict once, after the loop.

This slice runs with ``use_frames=False``; ``use_frames=True`` raises
`NotImplementedError`.  Entry points run on the card unless the caller
asks for ``device="cpu"``, where each kernel's plain version runs instead.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .config import PipelineConfig
from .estimation.ego import estimator_step_row
from .ops.kalman import make_constant_accel_model
from .planning.planner import plan
from .tagging.rules import make_packed_tagging_step, unpack_tags
from .tracking.tracker import tracker_update_with_order
from .types import (
    VEHICLE_STATE_FIELDS,
    Detections,
    KalmanState,
    LaneState,
    PipelineState,
    TaggingState,
    TrackTable,
    VehicleState,
    vehicle_state_from_row,
)
from .utils.convert import kalman_model_from_numpy


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "kernels' plain versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _check_slice(cfg: PipelineConfig) -> None:
    if cfg.use_frames:
        raise NotImplementedError(
            "use_frames=True (lanes and scene features from camera frames) is "
            "not ported yet: ROADMAP.md queue 1, item 7 (frames path)"
        )


def initial_state(cfg: PipelineConfig, device="cuda") -> PipelineState:
    dev = _resolve_device(device)
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
    dev = _resolve_device(device)
    return Detections(
        bbox=torch.as_tensor(arrs["bbox"], dtype=torch.float32, device=dev),
        class_id=torch.as_tensor(arrs["class_id"], dtype=torch.int32, device=dev),
        confidence=torch.as_tensor(arrs["confidence"], dtype=torch.float32, device=dev),
        valid=torch.as_tensor(arrs["valid"], dtype=torch.bool, device=dev),
    )


def _make_frame_step(cfg: PipelineConfig, dev: torch.device):
    """The frame step: ``(state, inputs) -> (state', out, tag_rows)``, with
    ``tag_rows`` K3's packed ``(tag_f, tag_i)``, or None without tagging,
    ``out`` holding no "tags" and the vehicle state as K2's (11,) row."""
    model = kalman_model_from_numpy(
        *make_constant_accel_model(
            cfg.estimator.dt,
            cfg.estimator.process_noise,
            cfg.estimator.measurement_noise,
            cfg.estimator.accel_noise_scale,
        ),
        device=dev,
    )
    measured = torch.ones((), dtype=torch.bool, device=dev)
    tagging_step = make_packed_tagging_step(cfg) if cfg.enable_tagging else None

    def step(state: PipelineState, inputs: Dict[str, Any]):
        dets = inputs["detections"]

        # Tracking: kernel K1 on the card, the confirmed order included.
        table, match, order, n_confirmed = tracker_update_with_order(
            state.tracks, dets, cfg.tracker, cfg.tracker.min_hits
        )

        # Ego estimation: kernel K2 on the card, the state as its one row.
        kalman, vrow = estimator_step_row(
            state.kalman,
            model,
            inputs["ego_measurement"],
            inputs.get("has_measurement", measured),
            cfg.estimator,
        )
        vstate = vehicle_state_from_row(vrow)

        # Planning.
        current = torch.stack([vstate.x, vstate.y, vstate.heading, vstate.speed])
        pr = plan(
            current,
            cfg.planner,
            reference_positions=inputs.get("reference_positions"),
            reference_valid=inputs.get("reference_valid"),
            obstacles=inputs.get("obstacles"),
            obstacles_valid=inputs.get("obstacles_valid"),
        )
        best = pr.best.view(1)

        # Tagging: kernel K3 on the card.
        if tagging_step is not None:
            tagging_state, tag_f, tag_i = tagging_step(state.tagging, dets, table, vrow)
            tag_rows = (tag_f, tag_i)
        else:
            tagging_state, tag_rows = state.tagging, None

        new_state = PipelineState(
            tracks=table,
            kalman=kalman,
            lanes=state.lanes,
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
            "plan_best_positions": pr.positions.index_select(0, best)[0],
            "plan_best_velocities": pr.velocities.index_select(0, best)[0],
        }
        if cfg.emit_trajectories:
            out["track_trajectory"] = table.trajectory
            out["track_traj_len"] = table.traj_len
        if cfg.emit_candidates:
            out["plan_order"] = pr.order
            out["plan_positions"] = pr.positions
            out["plan_velocities"] = pr.velocities
            out["plan_lateral_offsets"] = pr.lateral_offsets
        return new_state, out, tag_rows

    return step


def make_pipeline_step(cfg: PipelineConfig, device="cuda"):
    """Build the per-frame step function.

    Inputs per frame (all fixed-shape, on the step's device):
      detections: Detections table
      ego_measurement: (4,) [x, y, vx, vy]
      has_measurement, reference_positions, reference_valid, obstacles,
      obstacles_valid: optional, as in the JAX package.

    Outputs: a dict of per-frame results, the JAX package's keys; "tags"
    holds the 43 tags with ``enable_tagging``, else nothing.
    """
    _check_slice(cfg)
    frame_step = _make_frame_step(cfg, _resolve_device(device))

    def step(state: PipelineState, inputs: Dict[str, Any]):
        new_state, out, tag_rows = frame_step(state, inputs)
        out["vehicle_state"] = vehicle_state_from_row(out["vehicle_state"])
        out["tags"] = {} if tag_rows is None else unpack_tags(*tag_rows, cfg.tracker.max_tracks)
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
}


def make_sequence_runner(cfg: PipelineConfig, device="cuda"):
    """Build a runner that loops the pipeline step over a whole sequence.

    ``inputs`` is a dict of time-stacked arrays (numpy or tensors):
    detections (F, D, ...), ego_measurement (F, 4) and the optional
    per-frame inputs of `make_pipeline_step`.  Contiguous tensors already
    on the runner's device in the input's dtype (the YOLO frontend's
    detection tables) go in uncopied.  Returns ``(final_state, outs)``,
    ``outs`` holding the step's outputs with a leading time axis.
    """
    _check_slice(cfg)
    dev = _resolve_device(device)
    step = _make_frame_step(cfg, dev)

    def run(state: PipelineState, inputs: Dict[str, Any]):
        if "frame" in inputs:
            raise NotImplementedError(
                "camera frames are not ported yet: ROADMAP.md queue 1, item 7"
            )
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
        xs = {
            k: torch.as_tensor(v, dtype=_INPUT_DTYPES[k]).to(dev).contiguous()
            for k, v in inputs.items()
        }
        num_frames = xs["bbox"].shape[0]

        bufs: Dict[str, torch.Tensor] = {}
        for f in range(num_frames):
            frame = {k: v[f] for k, v in xs.items()}
            frame["detections"] = Detections(
                bbox=frame.pop("bbox"),
                class_id=frame.pop("class_id"),
                confidence=frame.pop("confidence"),
                valid=frame.pop("valid"),
            )
            state, out, tag_rows = step(state, frame)
            if tag_rows is not None:
                out["tag_f"], out["tag_i"] = tag_rows
            if not bufs:
                bufs = {
                    k: torch.empty((num_frames, *v.shape), dtype=v.dtype, device=dev)
                    for k, v in out.items()
                }
            for k, v in out.items():
                bufs[k][f].copy_(v)

        outs: Dict[str, Any] = dict(bufs)
        vs = outs.pop("vehicle_state", None)
        if vs is not None:
            outs["vehicle_state"] = VehicleState(
                *(vs[:, i].contiguous() for i in range(len(VEHICLE_STATE_FIELDS)))
            )
        tag_f, tag_i = outs.pop("tag_f", None), outs.pop("tag_i", None)
        outs["tags"] = {} if tag_f is None else unpack_tags(tag_f, tag_i, cfg.tracker.max_tracks)
        return state, outs

    return run
