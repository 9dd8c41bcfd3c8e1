"""Where the port's entry points run: the card unless the caller asks for
the CPU; and the float32 arithmetic of their parity math there."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``: ``cuda`` (the current card when no
    index is given) or ``cpu``.  Refuses ``cuda`` on a machine without a
    card, and any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "kernels' plain versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def float32_matmuls():
    """Full float32 matrix products and convolutions for the block: TF32 off
    for cuBLAS and cuDNN (torch's default lets cuDNN's float32 convolutions
    run in TF32), the caller's two flags restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
