"""Reference-named per-frame class facades (migration surface).

A user of the reference drives OOP classes one frame at a time
(`demo.py:97-177`).  The port's production path is the sequence runner
(`pipeline.make_sequence_runner`, one launch of each kernel a frame for a
whole sequence); these thin classes call the same step functions behind
the reference's exact class/method surface, so that existing call sites
port line for line:

    from multimodal_autonomous_driving_perception_and_planning_torch.compat import (
        LaneDetector, MultiObjectTracker, VehicleStateEstimator,
        MotionPlanner, SimulatedVehicleMotion)

Each facade runs on the card unless built with ``device="cpu"``:
`MultiObjectTracker.update` launches kernel K1, `VehicleStateEstimator.step`
kernel K2, `AutoTagger.tag_frame` kernel K3, `LaneDetector.detect` the lane
step's tensor ops, `MotionPlanner.plan` the planner's.  Every call reads
its results back to the host, so per-frame latency is set by the launches
and the reads: use the sequence runner for throughput.  Outputs are the
host records from `host.py` (the reference dataclasses' field names).

`AutoTagger` here extends tagging/auto_tagger.AutoTagger with the
reference's per-frame `tag_frame`.  Classes reference-named elsewhere:
`ObjectDetector` (perception/detector.py), `VLMTagger` (tagging/vlm.py),
`TagDatabase` (database/tag_db.py), `SyntheticRoadGenerator`
(data/frames.py, the reference's SyntheticDataGenerator).  A port of the
JAX package's compat.py, which the port cannot import.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import DEFAULT_CONFIG, EstimatorConfig, PlannerConfig, TrackerConfig
from .estimation.ego import estimator_step
from .host import (
    CLASS_NAMES,
    EgoStateHistory,
    HostTrack,
    HostTrajectory,
    HostVehicleState,
    _unroll_ring,
    lane_points,
    to_numpy,
    trajectory_type_of,
)
from .ops.image import bgr_to_gray_u8
from .ops.kalman import make_constant_accel_model
from .perception.lanes import make_lane_step, make_scene_features
from .pipeline import check_card_limits
from .planning.planner import plan
from .tagging.auto_tagger import AutoTagger as _BaseAutoTagger
from .tagging.rules import make_tagging_step
from .tracking.tracker import confirmed_order, tracker_update_with_order
from .types import (
    VEHICLE_STATE_FIELDS,
    Detections,
    KalmanState,
    LaneObservation,
    LaneState,
    TaggingState,
    TrackTable,
    VehicleState,
)
from .utils.convert import kalman_model_from_numpy
from .utils.device import resolve_device


def _frame_tensor(frame, dev: torch.device) -> torch.Tensor:
    """An (H, W, 3) BGR frame on ``dev``, uint8 or int32 as the lane step
    takes it (other integer types as int32)."""
    t = torch.as_tensor(np.asarray(frame))
    if t.dtype not in (torch.uint8, torch.int32):
        t = t.to(torch.int32)
    return t.to(dev)


def _detections(detections: Sequence, capacity: int, dev: torch.device) -> Detections:
    """Objects with .bbox/.class_id/.confidence as a fixed-capacity table."""
    bbox = np.zeros((capacity, 4), np.float32)
    cid = np.zeros((capacity,), np.int32)
    conf = np.zeros((capacity,), np.float32)
    valid = np.zeros((capacity,), bool)
    for j, det in enumerate(detections):
        bbox[j] = det.bbox
        cid[j] = det.class_id
        conf[j] = det.confidence
        valid[j] = True
    return Detections(
        bbox=torch.from_numpy(bbox).to(dev),
        class_id=torch.from_numpy(cid).to(dev),
        confidence=torch.from_numpy(conf).to(dev),
        valid=torch.from_numpy(valid).to(dev),
    )


@dataclasses.dataclass
class LaneLine:
    """Reference LaneLine (lane_detector.py:13-19)."""

    points: np.ndarray  # (50, 2) int32 raster
    side: str
    confidence: float
    polynomial: np.ndarray  # (3,) [a, b, c] for x = a y^2 + b y + c


class LaneDetector:
    """Per-frame facade over perception/lanes.py (lane_detector.py:178-218)."""

    def __init__(self, cfg=None, device="cuda"):
        self.cfg = cfg or DEFAULT_CONFIG
        self.device = resolve_device(device)
        self._step = make_lane_step(self.cfg, self.device)
        self._state = LaneState.initial(self.device)

    def detect(self, frame: np.ndarray) -> Tuple[Optional[LaneLine], Optional[LaneLine]]:
        self._state, obs, _ = self._step(self._state, _frame_tensor(frame, self.device))
        h = self.cfg.frame_height

        def build(found, fit, conf, side):
            if not bool(found):
                return None
            fit = to_numpy(fit)
            return LaneLine(
                points=lane_points(fit, h, self.cfg.lanes.num_lane_points),
                side=side,
                confidence=float(conf),
                polynomial=fit,
            )

        left = build(obs.left_found, obs.left_fit, obs.left_confidence, "left")
        right = build(obs.right_found, obs.right_fit, obs.right_confidence, "right")
        return left, right

    def get_lane_center_offset(
        self,
        frame_width: int,
        left_lane: Optional[LaneLine],
        right_lane: Optional[LaneLine],
    ) -> Optional[float]:
        """lane_detector.py:253-272; argument order matches the reference
        (frame_width first), as called positionally at reference demo.py:128
        and app.py:173."""
        if left_lane is None or right_lane is None:
            return None
        lane_center = (float(left_lane.points[-1, 0]) + float(right_lane.points[-1, 0])) / 2
        return frame_width / 2 - lane_center

    def reset(self) -> None:
        self._state = LaneState.initial(self.device)


def _host_tracks(table: TrackTable, order, n) -> List[HostTrack]:
    """The confirmed tracks of ``table`` in ``order`` as host records."""
    t = {f.name: to_numpy(getattr(table, f.name)) for f in dataclasses.fields(table)}
    out = []
    for s in to_numpy(order)[: int(n)]:
        c = int(t["class_id"][s])
        out.append(
            HostTrack(
                track_id=int(t["track_id"][s]),
                bbox=tuple(t["bbox"][s].tolist()),
                class_id=c,
                class_name=CLASS_NAMES[c],
                confidence=float(t["confidence"][s]),
                age=int(t["age"][s]),
                hits=int(t["hits"][s]),
                misses=int(t["misses"][s]),
                trajectory=_unroll_ring(t["trajectory"][s].reshape(-1, 2), int(t["traj_len"][s])),
                velocity=tuple(t["velocity"][s].tolist()) if int(t["vel_count"][s]) > 0 else None,
            )
        )
    return out


class MultiObjectTracker:
    """Per-frame facade over tracking/tracker.py
    (multi_object_tracker.py:61-241), one launch of kernel K1 a frame on
    the card.

    Unlike the reference (which accepts unbounded detection lists), the
    table is fixed-shape: ``max_detections`` caps how many detections one
    ``update`` call may carry.  The default (32) matches the YOLO
    detector's ``max_det`` (models/yolov8.py), so that a reference-ported
    YOLO pipeline never trips the capacity check; raise it at construction
    for denser scenes (the card takes up to 4,096 slots and detections).
    """

    def __init__(
        self,
        iou_threshold: float = 0.3,
        max_age: int = 30,
        min_hits: int = 3,
        trajectory_length: int = 50,
        max_tracks: int = 64,
        max_detections: int = 32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = TrackerConfig(
            iou_threshold=iou_threshold,
            max_age=max_age,
            min_hits=min_hits,
            trajectory_length=trajectory_length,
            max_tracks=max_tracks,
        )
        check_card_limits(
            DEFAULT_CONFIG.replace(
                tracker=self.cfg, detector=dataclasses.replace(DEFAULT_CONFIG.detector, max_detections=max_detections)
            ),
            self.device,
        )
        self._d_cap = max_detections
        self._table = self._empty()

    def _empty(self) -> TrackTable:
        return TrackTable.empty(self.cfg.max_tracks, self.cfg.trajectory_length, self.device)

    def update(self, detections: Sequence) -> List[HostTrack]:
        """detections: objects with .bbox/.class_id/.confidence (the
        reference Detection or host.HostDetection)."""
        d = self._d_cap
        if len(detections) > d:
            raise ValueError(f"{len(detections)} detections > capacity {d}; raise max_detections at construction")
        dets = _detections(detections, d, self.device)
        self._table, _, order, n = tracker_update_with_order(self._table, dets, self.cfg)
        return _host_tracks(self._table, order, n)

    def get_all_trajectories(self) -> Dict[int, List[Tuple[float, float]]]:
        """multi_object_tracker.py:243-249 (confirmed tracks only)."""
        order, n = confirmed_order(self._table, self.cfg.min_hits)
        return {t.track_id: t.trajectory for t in _host_tracks(self._table, order, n)}

    def reset(self) -> None:
        self._table = self._empty()


class VehicleStateEstimator:
    """Per-frame facade over estimation/ego.py (vehicle_state.py:33-257),
    one launch of kernel K2 a step on the card."""

    def __init__(
        self,
        dt: float = 0.033,
        process_noise: float = 0.1,
        measurement_noise: float = 1.0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = EstimatorConfig(dt=dt, process_noise=process_noise, measurement_noise=measurement_noise)
        self._model = kalman_model_from_numpy(
            *make_constant_accel_model(dt, process_noise, measurement_noise, self.cfg.accel_noise_scale),
            device=self.device,
        )
        self._ks = self._initial()
        self._history = EgoStateHistory()

    def _initial(self) -> KalmanState:
        return KalmanState.initial(self.cfg.initial_covariance, self.device)

    def _run(self, measurement, has: bool) -> HostVehicleState:
        z = torch.as_tensor(
            np.zeros(4, np.float32) if measurement is None else np.asarray(measurement, np.float32)
        ).to(self.device)
        has_t = torch.tensor(has, device=self.device)
        self._ks, vs = estimator_step(self._ks, self._model, z, has_t, self.cfg)
        host = HostVehicleState(**{k: float(to_numpy(getattr(vs, k))) for k in VEHICLE_STATE_FIELDS})
        self._history.append(host)
        return host

    def step(self, measurement=None) -> HostVehicleState:
        """predict + optional update (vehicle_state.py:139-156)."""
        return self._run(measurement, measurement is not None)

    def predict(self) -> HostVehicleState:
        return self._run(None, False)

    # History getters (vehicle_state.py:200-240).
    def get_state_history(self, n: Optional[int] = None):
        return self._history.get_state_history(n)

    def get_trajectory(self) -> np.ndarray:
        return self._history.get_trajectory()

    def get_velocity_history(self) -> np.ndarray:
        return self._history.get_velocity_history()

    def get_speed_history(self):
        return self._history.get_speed_history()

    def get_heading_history(self):
        return self._history.get_heading_history()

    def set_initial_state(self, x=0.0, y=0.0, vx=0.0, vy=0.0) -> None:
        """vehicle_state.py:242-248."""
        ks = self._initial()
        self._ks = dataclasses.replace(
            ks, x=torch.tensor([x, y, vx, vy, 0.0, 0.0], dtype=torch.float32, device=self.device)
        )

    def reset(self) -> None:
        self._ks = self._initial()
        self._history.reset()


class MotionPlanner:
    """Per-frame facade over planning/planner.py (motion_planner.py:56-303)."""

    def __init__(
        self,
        planning_horizon: float = 5.0,
        dt: float = 0.1,
        num_samples: int = 7,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = PlannerConfig(planning_horizon=planning_horizon, dt=dt, num_samples=num_samples)
        self._O = self.cfg.max_obstacles

    def plan(
        self,
        current_state,
        obstacles: Optional[Sequence[Tuple[float, float, float]]] = None,
    ) -> Tuple[HostTrajectory, List[HostTrajectory]]:
        """current_state: anything with .x/.y/.heading/.speed
        (HostVehicleState or the reference VehicleState).  obstacles:
        (x, y, radius) tuples (motion_planner.py:264-303)."""
        cur = torch.tensor(
            [current_state.x, current_state.y, current_state.heading, current_state.speed],
            dtype=torch.float32,
            device=self.device,
        )
        obstacles = list(obstacles or [])
        if len(obstacles) > self._O:
            # Fail loudly like MultiObjectTracker.update's capacity check:
            # silently dropping obstacles could plan through one.
            raise ValueError(
                f"{len(obstacles)} obstacles > capacity {self._O}; raise "
                "PlannerConfig.max_obstacles at construction"
            )
        obs = np.zeros((self._O, 3), np.float32)
        val = np.zeros((self._O,), bool)
        for j, (x, y, r) in enumerate(obstacles):
            obs[j] = (x, y, r)
            val[j] = True
        pr = plan(
            cur,
            self.cfg,
            obstacles=torch.from_numpy(obs).to(self.device),
            obstacles_valid=torch.from_numpy(val).to(self.device),
        )
        costs, positions, velocities, lat, order = (
            to_numpy(a) for a in (pr.costs, pr.positions, pr.velocities, pr.lateral_offsets, pr.order)
        )
        candidates = [
            HostTrajectory(
                positions=positions[c],
                velocities=velocities[c],
                cost=float(costs[c]),
                trajectory_type=trajectory_type_of(float(lat[c])),
            )
            for c in order
        ]
        return candidates[0], candidates

    def reset(self) -> None:  # motion_planner.py:372-374 (stateless)
        pass


class AutoTagger(_BaseAutoTagger):
    """Per-frame `tag_frame` facade over the rule engines
    (auto_tagger.py:112-208), one launch of kernel K3 a frame on the card,
    on top of the aggregation/search/export surface the base class already
    provides.

    ``tag_frame(frame, detections, tracks, lanes, vehicle_state)`` runs
    the scene/maneuver/interaction classifiers for one frame, appends a
    FrameTags record, and returns it: the reference signature exactly.
    ``frame`` may be None (no visual features, like the sequence runner's
    detections mode); ``lanes`` is the (left, right) LaneLine pair from
    `LaneDetector.detect` or None.
    """

    def __init__(self, video_path: str = "unknown", fps: float = 30.0, cfg=None, device="cuda"):
        super().__init__(video_path=video_path, fps=fps)
        self.cfg = cfg or DEFAULT_CONFIG
        self.device = resolve_device(device)
        check_card_limits(self.cfg, self.device)
        self._t_cap = self.cfg.tracker.max_tracks
        self._state = self._initial()
        self._slots: Dict[int, int] = {}  # track_id -> stable slot
        self._step = make_tagging_step(self.cfg)
        self._feat_fn = None

    def _initial(self) -> TaggingState:
        tg = self.cfg.tagging
        return TaggingState.initial(
            tg.scene_smoothing_window, tg.maneuver_history, self._t_cap, self.device,
            interaction_history=tg.interaction_history,
        )

    def _frame_features(self, frame):
        if self._feat_fn is None:
            self._feat_fn = make_scene_features(self.cfg)
        f = _frame_tensor(frame, self.device)
        return self._feat_fn(f, bgr_to_gray_u8(f))

    def _build_tables(self, detections, tracks):
        dets = _detections(detections[: self.cfg.detector.max_detections], self.cfg.detector.max_detections,
                           self.device)

        # Stable slot assignment so that the interaction history rings
        # (TaggingState.int_centers, keyed by slot and track id) persist.
        T = self._t_cap
        live_ids = {t.track_id for t in tracks}
        self._slots = {i: s for i, s in self._slots.items() if i in live_ids}
        used = set(self._slots.values())
        for t in tracks:
            if t.track_id not in self._slots:
                s = next((i for i in range(T) if i not in used), None)
                if s is None:
                    raise ValueError(
                        f"{len(tracks)} live tracks exceed the tagging slot "
                        f"capacity {T} (cfg.tracker.max_tracks); construct "
                        "AutoTagger with a cfg whose tracker.max_tracks "
                        "matches the paired MultiObjectTracker"
                    )
                self._slots[t.track_id] = s
                used.add(s)

        tid = np.zeros((T,), np.int32)
        tb = np.zeros((T, 4), np.float32)
        tc = np.zeros((T,), np.int32)
        tcf = np.zeros((T,), np.float32)
        age = np.zeros((T,), np.int32)
        hits = np.zeros((T,), np.int32)
        miss = np.zeros((T,), np.int32)
        vel = np.zeros((T, 2), np.float32)
        vcnt = np.zeros((T,), np.int32)
        for t in tracks:
            s = self._slots[t.track_id]
            tid[s] = t.track_id
            tb[s] = t.bbox
            tc[s] = t.class_id
            tcf[s] = t.confidence
            age[s] = t.age
            hits[s] = max(t.hits, self.cfg.tracker.min_hits)
            miss[s] = t.misses
            if t.velocity is not None:
                vel[s] = t.velocity
                vcnt[s] = 1
        empty = TrackTable.empty(T, self.cfg.tracker.trajectory_length, self.device)
        fields = dict(track_id=tid, bbox=tb, class_id=tc, confidence=tcf, age=age, hits=hits, misses=miss,
                      velocity=vel, vel_count=vcnt,
                      next_id=np.int32(max([t.track_id for t in tracks], default=0) + 1))
        table = dataclasses.replace(empty, **{k: torch.as_tensor(v).to(self.device) for k, v in fields.items()})
        order = np.argsort(np.where(tid > 0, tid, np.iinfo(np.int32).max)).astype(np.int32)
        return dets, table, torch.from_numpy(order).to(self.device), torch.tensor(len(tracks), dtype=torch.int32)

    def tag_frame(self, frame, detections, tracks, lanes, vehicle_state):
        dets, table, order, n = self._build_tables(detections or [], tracks or [])
        vs = VehicleState(
            **{k: torch.tensor(getattr(vehicle_state, k), dtype=torch.float32, device=self.device)
               for k in VEHICLE_STATE_FIELDS}
        )

        lane_obs = None
        if lanes is not None and any(lane is not None for lane in lanes):
            left, right = lanes
            z = np.zeros((3,), np.float32)
            lf = np.asarray(left.polynomial, np.float32) if left is not None else z
            rf = np.asarray(right.polynomial, np.float32) if right is not None else z
            both = left is not None and right is not None
            h = float(self.cfg.frame_height)
            if both:
                lane_center = (float(np.trunc(np.polyval(lf, h))) + float(np.trunc(np.polyval(rf, h)))) / 2.0
                offset = self.cfg.frame_width / 2.0 - lane_center
            else:
                offset = 0.0

            def on(v, dtype=torch.float32):
                return torch.tensor(v, dtype=dtype, device=self.device)

            lane_obs = LaneObservation(
                left_fit=on(lf),
                right_fit=on(rf),
                left_found=on(left is not None, torch.bool),
                right_found=on(right is not None, torch.bool),
                left_confidence=on(left.confidence if left is not None else 0.0),
                right_confidence=on(right.confidence if right is not None else 0.0),
                offset_px=on(offset),
                has_offset=on(both, torch.bool),
            )

        feats = self._frame_features(frame) if frame is not None else None
        self._state, tags = self._step(
            self._state, dets=dets, table=table, confirmed=order, n_confirmed=n, vstate=vs,
            lane_obs=lane_obs, frame_feats=feats,
        )
        self.ingest_device_tags({k: v[None] for k, v in tags.items()}, 1)
        return self.frame_tags[-1]

    def reset(self) -> None:
        super().reset()
        self._state = self._initial()
        self._slots = {}


class SimulatedVehicleMotion:
    """Ground-truth + noisy-measurement ego simulator
    (vehicle_state.py:260-330).  With a seed it draws from its own
    generator, whose stream is the one ``np.random.seed(seed)`` starts (the
    reference's); ``seed=None`` draws from numpy's global generator."""

    def __init__(self, dt: float = 0.033, seed: Optional[int] = 0):
        self.dt = dt
        self._rs = np.random.RandomState(seed) if seed is not None else np.random.mtrand._rand
        self._x = 0.0
        self._y = 0.0
        self._time = 0.0
        # Reference initial state (vehicle_state.py:271-277): speed 10 m/s,
        # heading 0; get_ground_truth recomputes velocity from these, so a
        # fresh or reset simulator reports (0, 0, 10, 0), not zeros.
        self._speed = 10.0
        self._heading = 0.0

    def step(self) -> np.ndarray:
        """Advance one tick; returns the noisy (x, y, vx, vy) measurement."""
        self._time += self.dt
        self._speed = 10 + 3 * np.sin(self._time * 0.2)
        self._heading = 0.1 * np.sin(self._time * 0.3) + 0.05 * np.sin(self._time * 0.7)
        vx = self._speed * np.cos(self._heading)
        vy = self._speed * np.sin(self._heading)
        self._x += vx * self.dt
        self._y += vy * self.dt
        return np.asarray(
            [
                self._x + self._rs.normal(0, 0.5),
                self._y + self._rs.normal(0, 0.5),
                vx + self._rs.normal(0, 0.2),
                vy + self._rs.normal(0, 0.2),
            ]
        )

    def get_ground_truth(self) -> np.ndarray:
        # Recomputed from the current speed and heading like the reference
        # (vehicle_state.py:317-321): (0, 0, 10, 0) before the first step.
        vx = self._speed * np.cos(self._heading)
        vy = self._speed * np.sin(self._heading)
        return np.asarray([self._x, self._y, vx, vy])

    def reset(self) -> None:
        self._x = self._y = self._time = 0.0
        self._speed = 10.0
        self._heading = 0.0
