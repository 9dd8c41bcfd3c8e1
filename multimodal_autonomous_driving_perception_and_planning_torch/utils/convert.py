"""Carry pipeline state, the Kalman model and the YOLO and BLIP weights
between numpy and tensors.

`yolo_state_from_flax` carries the Flax YOLOv8's variables into the port's
`YOLOv8`, `blip_state_from_flax` the Flax BLIP's into `BlipForCaptioning`.  `state_from_numpy` takes any tree with the
`PipelineState` field names, as attributes (the JAX package's state with
numpy leaves) or as dict keys (what `state_to_numpy` returns), so a run can
be started in one package and resumed in the other.  `state_from_leaves`
takes a state's leaves in the JAX package's order (``jax.tree_util.
tree_leaves``, `types.tree_leaves` here), the form in which the servers
export a session and the checkpoints hold a state.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from ..ops.kalman import KalmanModel
from ..types import KalmanState, LaneState, PipelineState, TaggingState, TrackTable, tree_leaves, tree_unflatten

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


def state_from_leaves(leaves, template):
    """A state shaped like ``template`` (on its device, in its dtypes) from
    its leaves in `types.tree_leaves` order, numpy arrays or tensors.
    Raises ValueError when the count or a shape differs from the
    template's."""
    t_leaves = tree_leaves(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(f"expected {len(t_leaves)} state leaves, got {len(leaves)}")
    out = []
    for i, (a, t) in enumerate(zip(leaves, t_leaves)):
        a = a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"leaf{i}: expected shape {tuple(t.shape)}, got {tuple(a.shape)}")
        out.append(a.to(device=t.device, dtype=t.dtype))
    return tree_unflatten(template, out)


def kalman_model_from_numpy(F, H, Q, R, device) -> KalmanModel:
    """The Kalman model's matrices as float32 tensors on ``device``."""
    return KalmanModel(
        *(torch.tensor(np.asarray(m, np.float32), device=device) for m in (F, H, Q, R))
    )


# Flax leaf name -> the port's, by collection.
_FLAX_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def yolo_state_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The state dict of the port's `YOLOv8` from the Flax model's
    variables (``params`` and ``batch_stats``, nested dicts of numpy
    arrays): module paths joined with dots, conv kernels HWIO -> OIHW,
    BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
    running_var.  The port's model loads it with ``strict=True``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(collection, tree, path):
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(collection, value, path + [name])
                continue
            leaf = np.asarray(value, np.float32)
            if name == "kernel":
                leaf = leaf.transpose(3, 2, 0, 1)
            out[".".join(path + [_FLAX_LEAVES[collection, name]])] = torch.tensor(leaf)

    for collection in ("params", "batch_stats"):
        walk(collection, variables[collection], [])
    return out


def blip_state_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The state dict of the port's `BlipForCaptioning` from the Flax BLIP's
    variables (``params``, nested dicts of numpy arrays): module paths
    joined with dots; Dense kernels (in, out) -> Linear weights (out, in),
    the patch conv HWIO -> OIHW; LayerNorm scale -> weight, Embed embedding
    -> weight; the class token and the position embeddings keep their
    shapes.  The port's model loads it with ``strict=True``."""
    out: Dict[str, torch.Tensor] = {}
    renamed = {"scale": "weight", "embedding": "weight"}

    def walk(tree, path):
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + [name])
                continue
            leaf = np.asarray(value, np.float32)
            if name == "kernel":
                leaf = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf.T
                name = "weight"
            out[".".join(path + [renamed.get(name, name)])] = torch.tensor(np.ascontiguousarray(leaf))

    walk(variables["params"], [])
    return out
