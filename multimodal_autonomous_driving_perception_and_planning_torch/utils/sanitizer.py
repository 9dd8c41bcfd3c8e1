"""Numeric sanitizer: NaN/Inf detection hooks (SURVEY.md §5).

The reference has no sanitizers at all; crashes from bad numerics surface
as downstream cv2 draw errors.  The JAX package flips ``jax_debug_nans``;
PyTorch has no such flag, so the port checks where it can see:

- ``nan_debug()``: a context manager (or env var ``MADPP_DEBUG_NANS=1`` at
  import, see ``enable_from_env``) in which every floating output of every
  aten op is checked, and the first NaN raises ``FloatingPointError``
  naming the op that produced it, as ``jax_debug_nans`` raises at the
  producing op.  The hand-written kernels K1-K5 are not aten ops: their
  outputs are checked with ``validate_outputs`` on the frame step's or the
  runner's results.  Each check reads the card, so the scope is for
  debugging.
- ``validate_outputs(tree)``: host-side post-hoc scan of a pipeline output
  tree (dicts, tuples and lists, the port's dataclasses, tensors on any
  device, arrays); raises ``ValueError`` naming every leaf path that
  contains NaN/Inf.  Cheap enough to run after every sequence run when
  ``MADPP_VALIDATE_OUTPUTS=1``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ENV_DEBUG_NANS = "MADPP_DEBUG_NANS"
ENV_VALIDATE = "MADPP_VALIDATE_OUTPUTS"


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


class NanCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first aten op whose floating
    output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


_env_mode = None


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    """Scope in which every aten op raises on the first NaN it produces."""
    if not enable:
        yield
        return
    with NanCheck():
        yield


def enable_from_env() -> bool:
    """Enter the NaN check for the rest of the process when
    MADPP_DEBUG_NANS=1; returns whether it is on."""
    global _env_mode
    if os.environ.get(ENV_DEBUG_NANS, "") != "1":
        return _env_mode is not None
    if _env_mode is None:
        _env_mode = NanCheck()
        _env_mode.__enter__()
    return True


def _leaves(tree, path=""):
    """(path, leaf) of every tensor or array of ``tree``, the path written
    as ``jax.tree_util.keystr`` writes it: ``['key']``, ``[index]``,
    ``.field``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def validate_outputs(tree, name: str = "outputs") -> None:
    """Raise ValueError listing every float leaf of ``tree`` holding a
    NaN or Inf; no-op on clean trees."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            finite = torch.isfinite(leaf)
            n_bad, size = int((~finite).sum()), leaf.numel()
        else:
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            n_bad, size = int((~np.isfinite(arr)).sum()), arr.size
        if n_bad:
            bad.append(f"{path}: {n_bad}/{size} non-finite")
    if bad:
        raise ValueError(f"non-finite values in {name}:\n  " + "\n  ".join(bad))


def validate_if_enabled(tree, name: str = "outputs") -> None:
    """`validate_outputs` gated on MADPP_VALIDATE_OUTPUTS=1."""
    if os.environ.get(ENV_VALIDATE, "") == "1":
        validate_outputs(tree, name)
