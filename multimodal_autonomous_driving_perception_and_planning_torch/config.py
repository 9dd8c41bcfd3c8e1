"""Configuration tree for the PyTorch/CUDA AV pipeline.

One frozen dataclass per subsystem, a copy of the JAX package's config.py so
that this package imports nothing of it.  Static (shape-determining) fields
are plain Python ints; numeric tuning knobs are floats.  Each field cites
the reference knob it mirrors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Object detector knobs (reference: src/perception/detector.py:62-75)."""

    mode: str = "simulated"  # "simulated" | "yolo"
    model_path: str = "yolov8n.pt"
    # Static capacity of the per-frame detection table (reference emits 3-7
    # simulated boxes, detector.py:137; YOLO can emit more).
    max_detections: int = 16
    num_classes: int = 8  # detector.py:39-48 taxonomy


@dataclasses.dataclass(frozen=True)
class LaneConfig:
    """Lane detector knobs (reference: src/perception/lane_detector.py)."""

    smoothing_factor: float = 0.7  # lane_detector.py:45
    min_abs_slope: float = 0.3  # lane_detector.py:122
    hough_threshold: int = 50  # lane_detector.py:98
    hough_min_line_length: float = 50.0  # lane_detector.py:99
    hough_max_line_gap: float = 150.0  # lane_detector.py:100
    num_lane_points: int = 50  # lane_detector.py:164
    # ROI trapezoid fractions (lane_detector.py:55-60)
    roi_bottom_frac: float = 0.1
    roi_top_frac: float = 0.4
    roi_top_y_frac: float = 0.6
    # Static cap on Hough line segments kept per frame.
    max_lines: int = 64
    # Number of theta bins for the deterministic Hough transform.
    num_thetas: int = 180
    # Static caps on the edge-pixel voting sets (Hough cost scales
    # ~linearly with these; overflow is flagged, not silent).  The lane
    # pass sees only the ROI trapezoid (~1/4 of the frame) so it needs a
    # smaller pool than the full-frame scene-classifier pass.
    lane_edge_capacity: int = 2048
    scene_edge_capacity: int = 4096
    # Reduced scene-feature pass (the scene classifier consumes three
    # thresholded statistics, not geometry — scene_classifier.py:145-162):
    # run its Canny+Hough at 1/scene_downsample resolution with
    # proportionally scaled thresholds, skip the TLS segment refinement
    # (feature-only Hough), and cap its line pool separately.  Set
    # scene_downsample=1, scene_refine=True for the full-resolution pass
    # (reference-style geometry).  Tag equivalence of the default reduced
    # pass is proven on the reference-diff stream
    # (tests/test_reference_diff.py, tests/test_lanes.py).
    scene_downsample: int = 2
    scene_refine: bool = False
    scene_max_lines: int = 32


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """IoU tracker knobs (reference: src/tracking/multi_object_tracker.py:61-78)."""

    iou_threshold: float = 0.3
    max_age: int = 30
    min_hits: int = 3
    trajectory_length: int = 50
    # Static capacity of the track table (replaces the reference's unbounded
    # Dict[int, Track], multi_object_tracker.py:80).
    max_tracks: int = 64


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Ego Kalman filter knobs (reference: src/state_estimation/vehicle_state.py:49-66)."""

    dt: float = 0.033
    process_noise: float = 0.1
    measurement_noise: float = 1.0
    accel_noise_scale: float = 10.0  # vehicle_state.py:97-98
    initial_covariance: float = 10.0  # vehicle_state.py:101
    speed_heading_hold: float = 0.1  # vehicle_state.py:164


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Motion planner knobs (reference: src/planning/motion_planner.py:68-91)."""

    planning_horizon: float = 5.0
    dt: float = 0.1
    num_samples: int = 7  # lateral offsets
    lateral_range: float = 3.5  # motion_planner.py:279 (linspace(-3.5, 3.5))
    target_velocities: Tuple[float, ...] = (8.0, 10.0, 12.0)  # motion_planner.py:280
    cruise_velocity: float = 10.0  # motion_planner.py:234
    w_lateral: float = 1.0
    w_velocity: float = 0.5
    w_acceleration: float = 0.3
    w_jerk: float = 0.2  # declared but unused by the reference cost; kept for parity
    w_curvature: float = 0.4
    # Static capacity for obstacle inputs (x, y, radius) triples.
    max_obstacles: int = 16
    # Static capacity for reference-path waypoints.
    max_reference_points: int = 64

    @property
    def num_waypoints(self) -> int:
        """51 waypoints at horizon 5.0s / dt 0.1 (motion_planner.py:143-144)."""
        return int(self.planning_horizon / self.dt) + 1

    @property
    def num_candidates(self) -> int:
        """7 lateral offsets x 3 target speeds = 21 (motion_planner.py:279-297)."""
        return self.num_samples * len(self.target_velocities)


@dataclasses.dataclass(frozen=True)
class TaggingConfig:
    """Rule-based tagging thresholds.

    Reference: src/tagging/maneuver_detector.py:91-103,
    src/tagging/interaction_detector.py:117-130,
    src/tagging/scene_classifier.py:87-89.
    """

    # Maneuver detector
    maneuver_history: int = 30
    lane_change_yaw_deg: float = 5.0
    lane_change_lateral_m: float = 0.5
    turn_yaw_rate_deg: float = 15.0
    hard_brake: float = -3.0
    brake: float = -1.0
    accel: float = 1.0
    stopped_speed: float = 0.5
    # Interaction detector
    interaction_history: int = 30
    following_distance_max: float = 30.0
    following_distance_min: float = 5.0
    near_miss_distance: float = 3.0
    pedestrian_danger_distance: float = 10.0
    cut_in_distance: float = 15.0
    ttc_critical: float = 1.5
    ttc_warning: float = 3.0
    # Scene classifier
    scene_smoothing_window: int = 5
    fps: float = 30.0


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Vision-language tagger knobs (reference: src/tagging/vlm_tagger.py:88-117)."""

    model_name: str = "Salesforce/blip-image-captioning-base"
    device: str = ""  # "" = the card (utils.device.resolve_device("cuda")); "cpu" for tests
    # Replicated reference dead knob: vlm_tagger.py:102 stores this and
    # never reads it ("use smaller model for speed" was never implemented
    # upstream).  Kept stored-but-unread deliberately so the config surface
    # matches the reference knob-for-knob; wiring it to a shorter
    # generation would silently diverge caption outputs from the BLIP
    # parity contract (tests/test_converter_numerics.py beam-3 decode).
    use_fast_mode: bool = True
    cache_interval: int = 10  # vlm_tagger.py:113
    max_new_tokens: int = 75
    num_beams: int = 3


@dataclasses.dataclass(frozen=True)
class BEVConfig:
    """Bird's-eye-view renderer geometry (reference: src/visualization/bev_renderer.py:29-67)."""

    width: int = 600
    height: int = 600
    scale: float = 10.0  # pixels per meter
    x_range: Tuple[float, float] = (-30.0, 30.0)
    y_range: Tuple[float, float] = (-10.0, 50.0)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Multi-chip execution layout (new in the TPU build; SURVEY.md section 2.2)."""

    # Number of devices along the camera/data axis; 0 = use all local devices.
    data_axis: int = 0
    axis_name: str = "camera"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level configuration for the fused per-frame pipeline."""

    frame_height: int = 480
    frame_width: int = 640
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    lanes: LaneConfig = dataclasses.field(default_factory=LaneConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    estimator: EstimatorConfig = dataclasses.field(default_factory=EstimatorConfig)
    planner: PlannerConfig = dataclasses.field(default_factory=PlannerConfig)
    tagging: TaggingConfig = dataclasses.field(default_factory=TaggingConfig)
    vlm: VLMConfig = dataclasses.field(default_factory=VLMConfig)
    bev: BEVConfig = dataclasses.field(default_factory=BEVConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # Whether the per-frame step consumes camera frames (enables lane
    # detection and scene-classifier visual features on device).
    use_frames: bool = True
    # Whether the rule-based tagging stage runs on device.
    enable_tagging: bool = True
    # Compute dtype for image kernels; state math stays float32.
    image_dtype: str = "float32"
    # Per-frame output volume knobs.  Each array the scan stacks costs one
    # dynamic-update-slice per frame, and the candidate/trajectory tensors
    # dominate that traffic ((C, W, 2) x2 plans + the (T, 2L) ring =
    # ~60 KB/frame).  Visualization consumers (demo, webview, dashboard)
    # need them and leave these on; the serving tier (apps/serve.py
    # _OUTPUT_KEYS) and the throughput benchmarks ship only best-plan +
    # track summaries, mirroring what the reference demo actually consumes
    # per frame (it renders the optimal trajectory + top-10 candidates,
    # demo.py:142-143, but serves nothing else downstream).
    emit_candidates: bool = True  # plan_positions/velocities/order/lateral
    emit_trajectories: bool = True  # track_trajectory ring + traj_len

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = PipelineConfig()
