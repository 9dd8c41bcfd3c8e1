"""Synthetic inputs, in numpy only: detection, ego and vehicle-motion
streams and agent trajectories (`synthetic`), and road-scene camera frames
(`frames`, drawn without cv2).  The JAX package's exports, but for
`device_detection_stream`, which draws from `jax.random` and comes with the
stream runtime that calls it (ROADMAP item 13b)."""

from .frames import SyntheticRoadGenerator
from .synthetic import (
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
    "generate_agent_trajectories",
]
