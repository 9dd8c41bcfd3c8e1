"""Portable ``.npz`` checkpoint archives: a copy of the JAX package's
utils/weights.py.

tools/export_weights.py runs where the native checkpoints and their tooling
live (ultralytics / transformers) and writes a plain numpy archive of the
torch ``state_dict``; `load_npz_state_dict` reads it back into the dict the
port's converters consume (models/blip.py `load_torch_state_dict`), with
numpy alone.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

_META_PREFIX = "__meta_"


def load_npz_state_dict(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Read an export_weights.py archive.

    Returns (state_dict, meta) where state_dict maps the original torch
    key names to numpy arrays and meta holds the ``__meta_*`` markers
    (``format``, optionally ``variant``).
    """
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, str] = {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            if k.startswith(_META_PREFIX):
                meta[k[len(_META_PREFIX) : ].rstrip("_")] = str(z[k])
            else:
                arrays[k] = z[k]
    return arrays, meta


def save_npz_state_dict(path: str, state_dict: Dict[str, Any], **meta: str) -> None:
    """Inverse of `load_npz_state_dict` (tests and chip_smoke.py write
    their archives with it; checkpoints come from tools/export_weights.py)."""
    arrays = {k: np.asarray(v) for k, v in state_dict.items()}
    for k, v in meta.items():
        arrays[f"{_META_PREFIX}{k}__"] = np.asarray(v)
    np.savez(path, **arrays)
