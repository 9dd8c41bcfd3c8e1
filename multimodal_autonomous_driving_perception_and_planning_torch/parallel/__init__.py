"""Scale-out over ranks: the camera mesh, tensor-parallel detection and
captioning, and the ranks they run on (parallel/distributed.py)."""

from .distributed import init_ranks, spawn
from .mesh import gather_cameras, make_camera_mesh, make_multicamera_runner, stack_states
from .tp import make_sharded_yolo_detector, make_tp_mesh, shard_blip_variables, shard_yolo_variables

__all__ = [
    "make_camera_mesh",
    "make_multicamera_runner",
    "stack_states",
    "make_tp_mesh",
    "make_sharded_yolo_detector",
    "shard_yolo_variables",
    "shard_blip_variables",
    "gather_cameras",
    "init_ranks",
    "spawn",
]
