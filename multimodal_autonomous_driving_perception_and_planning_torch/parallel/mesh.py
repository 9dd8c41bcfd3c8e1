"""Multi-camera runs over a mesh of ranks.

The JAX package shards N camera feeds over a device mesh with
``shard_map``: each device runs the pipeline's scan over its cameras under
``vmap``, and the fleet's confirmed-track count rides a ``psum`` over the
camera axis.  The port runs one process a device (parallel/distributed.py):
the camera mesh is a one-axis ``DeviceMesh`` over the ranks of the process
group, each rank runs its C / n cameras as the lane axis of
`pipeline.make_batched_sequence_runner` on its device (K1, K2 and K3 one
launch a frame for its cameras), and the ``psum`` is an ``all_reduce``
over the camera group.  The outputs come back as ``DTensor``s placed
``Shard(0)`` on the camera mesh, the counterpart of a
``NamedSharding(P("camera"))`` array; `gather_cameras` (``full_tensor``)
gives the JAX package's ``(C, T, ...)`` arrays.

A mesh of one device needs no process group: the cameras are the lanes of
one runner on one card (or the CPU), and the sum is a local one.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..pipeline import initial_state, make_batched_sequence_runner
from ..types import PipelineState, stack_lanes, tree_map
from ..utils.device import resolve_device
from .distributed import rank_mesh


class CameraMesh(NamedTuple):
    """This rank's device, the camera axis's name and the ``DeviceMesh``
    over the ranks (None for one device without a process group)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    device_mesh: Any = None

    @property
    def size(self) -> int:
        return 1 if self.device_mesh is None else self.device_mesh.size()


def make_camera_mesh(n_devices: Optional[int] = None, axis_name: str = "camera", device="cuda") -> CameraMesh:
    """A camera mesh of ``n_devices`` ranks (the process group's size when
    None, one device without a group).  More than one needs an initialized
    process group of that many ranks, each calling this with its own
    device; ``device`` is this rank's (the card unless the caller asks for
    the CPU)."""
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    mesh = rank_mesh((n_devices,), (axis_name,), dev, what="make_camera_mesh")
    return CameraMesh(devices=(dev,), axis_names=(axis_name,), device_mesh=mesh)


def stack_states(cfg: PipelineConfig, n_cameras: int, device="cuda") -> PipelineState:
    """Per-camera initial states stacked on a leading camera axis."""
    one = initial_state(cfg, device)
    return stack_lanes([one] * n_cameras)


def gather_cameras(tree):
    """Every ``DTensor`` of the runner's results as the whole ``(C, ...)``
    tensor on each rank (a collective: every rank calls it on the same
    tree); plain tensors pass through."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def make_multicamera_runner(cfg: PipelineConfig, mesh: CameraMesh):
    """Build the multi-camera sequence runner.

    Inputs: a dict of (C, T, ...) arrays, camera-major then time: bbox
    (C, T, D, 4), class_id, confidence, valid, ego_measurement (C, T, 4)
    and, with ``use_frames``, frame (C, T, H, W, 3).  State: a
    `PipelineState` stacked on the camera axis (`stack_states`).  Every
    rank calls the runner with the whole inputs and states, as the JAX
    package's caller does; C must divide over the mesh.

    Returns ``(final_states, outputs, fleet_summary)``: outputs with leading
    (C, T) axes, and ``fleet_summary["fleet_confirmed_per_frame"]`` (T,)
    int32, the sum of ``num_confirmed`` over all cameras, on every rank.
    Over a mesh of ranks the states and outputs are ``DTensor``s, this
    rank's cameras placed ``Shard(0)`` (`gather_cameras` gathers them).
    """
    dev = mesh.devices[0]
    run = make_batched_sequence_runner(cfg, dev)
    dmesh = mesh.device_mesh

    if dmesh is None:

        def runner(states: PipelineState, inputs):
            final, outs = run(states, inputs)
            fleet = outs["num_confirmed"].sum(dim=0, dtype=torch.int32)
            return final, outs, {"fleet_confirmed_per_frame": fleet}

        return runner

    from torch.distributed.tensor import DTensor, Shard

    n, rank = dmesh.size(), dmesh.get_local_rank()
    group = dmesh.get_group()

    def runner(states: PipelineState, inputs):
        cams = int(states.frame_idx.shape[0])
        if cams % n:
            raise ValueError(f"{cams} cameras do not split over a camera mesh of {n} ranks")
        lo, hi = rank * cams // n, (rank + 1) * cams // n

        def mine(x):
            return torch.as_tensor(x)[lo:hi].to(dev)

        final, outs = run(tree_map(mine, states), {k: mine(v) for k, v in inputs.items()})
        fleet = outs["num_confirmed"].sum(dim=0, dtype=torch.int32)
        dist.all_reduce(fleet, op=dist.ReduceOp.SUM, group=group)
        shard = lambda t: DTensor.from_local(t, dmesh, [Shard(0)], run_check=False)  # noqa: E731
        return tree_map(shard, final), tree_map(shard, outs), {"fleet_confirmed_per_frame": fleet}

    return runner
