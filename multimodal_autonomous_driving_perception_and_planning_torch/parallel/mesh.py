"""Multi-camera runs on one card.

The JAX package shards N camera feeds over a device mesh with
``shard_map``: each device runs the pipeline's scan over its cameras under
``vmap``, and the fleet's confirmed-track count rides a ``psum`` over the
camera axis.  On one card the camera axis is the lane axis of
`pipeline.make_batched_sequence_runner`: C cameras advance in one launch of
each of kernels K1, K2 and K3 a frame, and the ``psum`` is a sum over the
lanes.  A mesh of more than one card (``torch.distributed`` across cards)
is ROADMAP item 10b, and asking for one raises rather than running on one
card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import PipelineConfig
from ..pipeline import initial_state, make_batched_sequence_runner
from ..types import PipelineState, stack_lanes
from ..utils.device import resolve_device


class CameraMesh(NamedTuple):
    """The devices the cameras run on and the camera axis's name."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]


def make_camera_mesh(n_devices: Optional[int] = None, axis_name: str = "camera", device="cuda") -> CameraMesh:
    """A mesh of ``n_devices`` devices (all the cards visible when None).
    One card, or the CPU, is all this slice runs on."""
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_devices != 1:
        raise NotImplementedError(
            f"a camera mesh of {n_devices} devices needs torch.distributed across cards "
            "(ROADMAP item 10b); this runner drives one card"
        )
    return CameraMesh(devices=(dev,), axis_names=(axis_name,))


def stack_states(cfg: PipelineConfig, n_cameras: int, device="cuda") -> PipelineState:
    """Per-camera initial states stacked on a leading camera axis."""
    one = initial_state(cfg, device)
    return stack_lanes([one] * n_cameras)


def make_multicamera_runner(cfg: PipelineConfig, mesh: CameraMesh):
    """Build the multi-camera sequence runner.

    Inputs: a dict of (C, T, ...) arrays, camera-major then time: bbox
    (C, T, D, 4), class_id, confidence, valid, ego_measurement (C, T, 4)
    and, with ``use_frames``, frame (C, T, H, W, 3).  State: a
    `PipelineState` stacked on the camera axis (`stack_states`).

    Returns ``(final_states, outputs, fleet_summary)``: outputs with leading
    (C, T) axes, and ``fleet_summary["fleet_confirmed_per_frame"]`` (T,) the
    sum of ``num_confirmed`` over cameras.
    """
    run = make_batched_sequence_runner(cfg, mesh.devices[0])

    def runner(states: PipelineState, inputs):
        final, outs = run(states, inputs)
        fleet = outs["num_confirmed"].sum(dim=0, dtype=torch.int32)
        return final, outs, {"fleet_confirmed_per_frame": fleet}

    return runner
