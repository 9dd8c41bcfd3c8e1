"""Shapes and dtypes of the sequence runner's inputs.

The JAX package serializes its compiled runner (``jax.export``) and serves
that artifact.  The port has no such artifact yet: it needs the kernels
registered as ``torch.library`` custom ops and the frame step captured in a
CUDA graph (ROADMAP items 5a and 11).  What the server needs from this
module now is the input contract a chunk is checked against.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..config import PipelineConfig


class TensorSpec(NamedTuple):
    """The shape and dtype of one input."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def example_sequence_inputs(cfg: PipelineConfig, num_frames: int) -> Dict[str, TensorSpec]:
    """The time-stacked inputs of a ``num_frames``-frame chunk, as specs
    (the JAX package's `example_sequence_inputs` without the zeros)."""
    d = cfg.detector.max_detections
    inputs = {
        "bbox": TensorSpec((num_frames, d, 4), torch.float32),
        "class_id": TensorSpec((num_frames, d), torch.int32),
        "confidence": TensorSpec((num_frames, d), torch.float32),
        "valid": TensorSpec((num_frames, d), torch.bool),
        "ego_measurement": TensorSpec((num_frames, 4), torch.float32),
    }
    if cfg.use_frames:
        inputs["frame"] = TensorSpec((num_frames, cfg.frame_height, cfg.frame_width, 3), torch.int32)
    return inputs
