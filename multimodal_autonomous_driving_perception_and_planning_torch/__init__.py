"""PyTorch/CUDA port of the multimodal autonomous-driving perception and
planning pipeline.

A second package beside the JAX one, which stays the reference.  Plain
tensor code is PyTorch; each TPU kernel of the JAX package becomes a kernel
written by hand for Hopper (CUDA C++ for ``sm_90a`` under ``kernels/csrc``),
with a plain PyTorch version beside it that runs for CPU tensors.  The port
covers the JAX package's default configuration, the frames path (camera
frames -> lanes and scene features -> track -> estimate -> plan -> tag,
`DEFAULT_CONFIG`), the detections-mode path (track -> estimate -> plan ->
tag, ``use_frames=False``), and the YOLO path in front of either (camera
frames -> YOLOv8 -> NMS: `perception.detector.make_yolo_sequence_runner`).
The serving tier runs B streams at once with a lane axis through the
kernels: the micro-batched session server (`apps.serve`), the one-card
multi-camera runner (`parallel.mesh`), the per-agent Kalman bank
(`tracking.kalman_bank`) and checkpoint/resume (`utils.checkpoint`).
"""

__version__ = "0.1.0"

from .config import (
    DEFAULT_CONFIG,
    BEVConfig,
    DetectorConfig,
    EstimatorConfig,
    LaneConfig,
    MeshConfig,
    PipelineConfig,
    PlannerConfig,
    TaggingConfig,
    TrackerConfig,
)
from .tagging import (
    CONDITIONS,
    INTERACTIONS,
    LATERAL,
    LONGITUDINAL,
    RISKS,
    ROAD_TYPES,
    TURNING,
    make_tagging_step,
)
from .pipeline import (
    detections_from_arrays,
    initial_state,
    make_batched_sequence_runner,
    make_pipeline_step,
    make_sequence_runner,
)
from .types import (
    Detections,
    KalmanState,
    LaneObservation,
    LaneState,
    PipelineState,
    PlanResult,
    TaggingState,
    TrackTable,
    VehicleState,
)

__all__ = [
    "DEFAULT_CONFIG",
    "PipelineConfig",
    "DetectorConfig",
    "LaneConfig",
    "TrackerConfig",
    "EstimatorConfig",
    "PlannerConfig",
    "TaggingConfig",
    "BEVConfig",
    "MeshConfig",
    "Detections",
    "TrackTable",
    "KalmanState",
    "VehicleState",
    "PlanResult",
    "LaneState",
    "LaneObservation",
    "TaggingState",
    "PipelineState",
    "initial_state",
    "make_pipeline_step",
    "make_sequence_runner",
    "make_batched_sequence_runner",
    "detections_from_arrays",
    "make_tagging_step",
    "ROAD_TYPES",
    "LATERAL",
    "LONGITUDINAL",
    "TURNING",
    "INTERACTIONS",
    "RISKS",
    "CONDITIONS",
]
