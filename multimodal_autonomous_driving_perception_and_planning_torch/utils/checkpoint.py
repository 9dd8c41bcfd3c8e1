"""Checkpoint and resume of the pipeline's carry.

The whole cross-frame state (track table, Kalman state, lane memory,
tagging histories, frame counter) is one `PipelineState`, so a long run can
stop, save it, and resume exactly where it stopped: 20 frames, a save and a
restore, then 20 more give what 40 frames straight give.

The file holds the state's leaves in the JAX package's order
(`types.tree_leaves`) as ``leaf0 .. leafN`` CPU tensors, written by
``torch.save`` and read back with ``weights_only=True``.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import torch

from ..types import tree_leaves
from .convert import state_from_leaves


def save_pipeline_state(path: str, state) -> None:
    """Save a `PipelineState` (any table of tensors) to the file ``path``
    atomically: a temporary file beside it, then ``os.replace``."""
    p = Path(path).resolve()
    p.parent.mkdir(parents=True, exist_ok=True)
    leaves = {f"leaf{i}": leaf.detach().cpu() for i, leaf in enumerate(tree_leaves(state))}
    fd, tmp = tempfile.mkstemp(prefix=p.name + ".", suffix=".tmp", dir=p.parent)
    os.close(fd)
    try:
        torch.save(leaves, tmp)
        os.replace(tmp, p)
    except BaseException:
        os.unlink(tmp)
        raise


def restore_pipeline_state(path: str, template):
    """The state saved at ``path``, in the shapes, dtypes and device of
    ``template`` (for example ``initial_state(cfg)``)."""
    data = torch.load(Path(path).resolve(), map_location="cpu", weights_only=True)
    n = len(tree_leaves(template))
    if sorted(data) != sorted(f"leaf{i}" for i in range(n)):
        raise ValueError(f"{path}: expected {n} state leaves named leaf0..leaf{n - 1}")
    return state_from_leaves([data[f"leaf{i}"] for i in range(n)], template)
