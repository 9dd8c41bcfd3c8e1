"""Carry pipeline state and the Kalman model between numpy and tensors.

This path has no learned weights: its parameters are the carried state and
the Kalman model.  `state_from_numpy` takes any tree with the
`PipelineState` field names, as attributes (the JAX package's state with
numpy leaves) or as dict keys (what `state_to_numpy` returns), so a run can
be started in one package and resumed in the other.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from ..ops.kalman import KalmanModel
from ..types import KalmanState, LaneState, PipelineState, TaggingState, TrackTable

_NESTED = {
    "tracks": TrackTable,
    "kalman": KalmanState,
    "lanes": LaneState,
    "tagging": TaggingState,
}


def _field(tree: Any, name: str) -> Any:
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _from_numpy(cls, tree: Any, device) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = _field(tree, f.name)
        if f.name in _NESTED and cls is PipelineState:
            kwargs[f.name] = _from_numpy(_NESTED[f.name], value, device)
        else:
            kwargs[f.name] = torch.tensor(np.asarray(value), device=device)
    return cls(**kwargs)


def state_from_numpy(tree: Any, device) -> PipelineState:
    """A `PipelineState` on ``device`` from a tree of numpy arrays."""
    return _from_numpy(PipelineState, tree, torch.device(device))


def state_to_numpy(state: Any) -> Dict[str, Any]:
    """A nested dict of numpy arrays from a `PipelineState` (or any of its
    tables)."""
    return {
        f.name: (
            state_to_numpy(getattr(state, f.name))
            if dataclasses.is_dataclass(getattr(state, f.name))
            else getattr(state, f.name).detach().cpu().numpy()
        )
        for f in dataclasses.fields(state)
    }


def kalman_model_from_numpy(F, H, Q, R, device) -> KalmanModel:
    """The Kalman model's matrices as float32 tensors on ``device``."""
    return KalmanModel(
        *(torch.tensor(np.asarray(m, np.float32), device=device) for m in (F, H, Q, R))
    )
