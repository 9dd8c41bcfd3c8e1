"""What the hand-written kernels' wrappers share on the host: one pass of
input checks, outputs carved from one buffer a dtype, and the launch
stream.

A wrapper's host time is the call's floor when the kernel runs for a few
microseconds, so each step here does one thing per call: one loop of
checks whose messages are built only on a failure, one allocation per
output dtype split into fields by one `split_with_sizes`, and the raw
stream handle without re-entering the device context when the tensors'
device is already the current one.
"""

from __future__ import annotations

import functools
import math

import torch


def check_inputs(kernel: str, device: torch.device, specs) -> None:
    """Raise unless every ``(name, tensor, dtype, shape)`` of ``specs`` lies
    on ``device`` with that dtype and shape, contiguous."""
    for name, t, dtype, shape in specs:
        if t.dtype is not dtype or t.shape != shape or not t.is_contiguous() or t.device != device:
            _refuse(kernel, name, t, dtype, shape, device)


def _refuse(kernel, name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    raise ValueError(f"{kernel}: {name} is not contiguous")


def _round4(n: int) -> int:
    return (n + 3) & ~3


@functools.lru_cache(maxsize=None)
def buffer_plan(shapes: tuple) -> tuple:
    """The split of one buffer into fields of the given shapes, in order,
    each starting at a multiple of 4 elements (16 bytes for 4-byte types):
    ``(total elements, split sizes, ((piece index, shape), ...))``.  The
    kernels carve their output pointers the same way."""
    sizes, pieces = [], []
    for shape in shapes:
        n = math.prod(shape)
        pieces.append((len(sizes), shape))
        sizes.append(n)
        if _round4(n) > n:
            sizes.append(_round4(n) - n)
    return sum(sizes), tuple(sizes), tuple(pieces)


def buffer_length(shapes) -> int:
    """`buffer_plan`'s total, uncached, so that it takes symbolic sizes (a
    fake implementation's under dynamic shapes)."""
    return sum((math.prod(shape) + 3) // 4 * 4 for shape in shapes)


def split(buf: torch.Tensor, shapes: tuple) -> list:
    """The fields of ``shapes`` in ``buf``, laid out by `buffer_plan`, as
    contiguous views (one `split_with_sizes` and a `view` a field, which
    ``torch.export`` traces)."""
    _, sizes, pieces = buffer_plan(shapes)
    parts = torch.split_with_sizes(buf, sizes)
    return [parts[k] if len(shape) == 1 else parts[k].view(shape) for k, shape in pieces]


def buffer(shapes: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """One uninitialised buffer of ``dtype`` on ``device`` for the fields
    of ``shapes``, laid out by `buffer_plan`."""
    return torch.empty(buffer_plan(shapes)[0], dtype=dtype, device=device)


def carve(shapes: tuple, dtype: torch.dtype, device) -> tuple:
    """One buffer of ``dtype`` on ``device`` and its fields as contiguous
    tensors of ``shapes``, laid out by `buffer_plan`: ``(buffer, fields)``."""
    buf = buffer(shapes, dtype, device)
    return buf, split(buf, shapes)


def pack(values, shapes: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` (tensors of ``shapes``) copied into one zeroed buffer laid
    out by `buffer_plan`: the buffer a kernel would have written."""
    buf = torch.zeros(buffer_plan(shapes)[0], dtype=dtype, device=device)
    for field, value in zip(split(buf, shapes), values):
        field.copy_(value)
    return buf


def launch(device: torch.device, call):
    """Run ``call(stream)`` with the raw handle of the current stream of
    ``device``, entering its device context only when it is not the current
    device; returns what ``call`` returns."""
    if device.index == torch.cuda.current_device():
        return call(torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return call(torch.cuda.current_stream(device).cuda_stream)
