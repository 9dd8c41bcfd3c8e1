"""Synthetic inputs: detection, ego and vehicle-motion streams and agent
trajectories in numpy, detections made on the device (`synthetic`), and
road-scene camera frames (`frames`, drawn without cv2); the video loader
(`video`, cv2 on the host) is imported from its module.  The JAX package's
exports."""

from .frames import SyntheticRoadGenerator
from .synthetic import (
    device_detection_stream,
    ego_motion_stream,
    generate_agent_trajectories,
    simulated_detection_stream,
    simulated_vehicle_motion_stream,
)

__all__ = [
    "SyntheticRoadGenerator",
    "simulated_detection_stream",
    "ego_motion_stream",
    "simulated_vehicle_motion_stream",
    "device_detection_stream",
    "generate_agent_trajectories",
]
