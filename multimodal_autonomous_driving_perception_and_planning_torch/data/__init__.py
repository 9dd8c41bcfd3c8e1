"""Synthetic inputs, in numpy only: detection and ego streams
(`synthetic`) and road-scene camera frames (`frames`, drawn without cv2)."""

from .frames import SyntheticRoadGenerator
from .synthetic import ego_motion_stream, simulated_detection_stream

__all__ = ["SyntheticRoadGenerator", "ego_motion_stream", "simulated_detection_stream"]
