"""Wrapper of kernel K4 (kernels/csrc/associate.cu): the greedy IoU
association fixpoint over one (T, D) matrix in one launch.

Replaces the Pallas TPU kernel of the JAX package's
ops/association_pallas.py (`_associate_kernel`, launched by
`greedy_associate_pallas`).  The plain PyTorch version is
ops/association.py `_greedy_associate_plain`, which the kernel equals on
every input, tied row ranks included.

Bound on an H100: at (64, 16) a call moves about 4.6 KB, about 1.4 ns at
3.35 TB/s, and a few thousand comparisons: it is latency-bound.  The
kernel runs every round of the fixpoint inside one launch, on one warp
(at most 32 eligible pairs) or a warp a 32 rows, from keys in shared
memory, where the plain version synchronises with the host once a
round.  The wrapper does one pass of checks (ops/launch.py),
one allocation and the launch on the current stream without re-entering
the device context.  Tables beyond 128 rows or 64 columns take the
kernel's general instance, a thread block cluster of up to 16 blocks.
Up to 1,024 rows and columns, where its key lines fit in the cluster's
shared memory, each block computes its lines' keys from the matrix
itself.  Where they do not fit (1,024 x 1,024: 8 MB of keys; 4,096 x
4,096: 128 MB) and beyond 1,024 lines, a stage kernel over the whole card
computes each key once into a device scratch, with each line's best in
each chunk of 32 entries, and the cluster kernel, started while it
finishes, takes its first bests and chunk masks from those and runs
rounds that skip the chunks with no eligible key.  The wrapper allocates
that scratch by shape alone (`scratch_words`).
"""

from __future__ import annotations

import functools

import torch

from ..kernels import build
from . import launch

# The kernel's small instance takes at most 128 rows and 64 columns; its
# general instance (a thread block cluster a matrix) MAX_ROWS and
# MAX_COLS.  Its launcher picks one by shape.
MAX_ROWS = 4096
MAX_COLS = 4096


@functools.lru_cache(maxsize=None)
def scratch_words(T: int, D: int) -> int:
    """32-bit words of device scratch the launch at (T, D) takes for the
    stage kernel's keys and chunk bests: 0 where the cluster stages its
    keys itself, or the small instance runs (the launcher's own rule,
    asked of the built library)."""
    return int(build.kernels().associate_scratch(T, D))


@functools.lru_cache(maxsize=None)
def cluster_size(T: int, D: int) -> int:
    """The blocks of the thread block cluster the launch at (T, D) takes (1:
    the small instance's single block)."""
    return int(build.kernels().associate_cluster(T, D))


# Launches of the kernel in this process; only `greedy_associate` adds to it.
launches = 0


def greedy_associate(iou: torch.Tensor, row_rank: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Launch K4 on CUDA tensors: iou (T, D) float32, row_rank (T,) int32,
    T <= 4,096 and D <= 4,096.  Returns match (T,) int32."""
    global launches
    device = iou.device
    if device.type != "cuda":
        raise ValueError(f"greedy_associate launches a CUDA kernel; got a tensor on {device}")
    if iou.dim() != 2:
        raise ValueError(f"greedy_associate: iou must be (T, D), got shape {tuple(iou.shape)}")
    T, D = iou.shape
    if not (1 <= T <= MAX_ROWS and 1 <= D <= MAX_COLS):
        raise ValueError(
            f"greedy_associate takes 1..{MAX_ROWS} rows and 1..{MAX_COLS} columns; got ({T}, {D})"
        )
    launch.check_inputs(
        "greedy_associate", device, (("iou", iou, torch.float32, (T, D)), ("row_rank", row_rank, torch.int32, (T,)))
    )
    match = torch.empty((T,), dtype=torch.int32, device=device)
    kernel = build.kernels().associate
    words = scratch_words(T, D)
    scratch = torch.empty((words,), dtype=torch.int32, device=device) if words else None
    args = (iou.data_ptr(), row_rank.data_ptr(), match.data_ptr(), T, D, float(iou_threshold),
            scratch.data_ptr() if words else 0)
    err = launch.launch(device, lambda stream: kernel(*args, stream))
    if err != 0:
        raise RuntimeError(f"greedy_associate: kernel launch failed with CUDA error {err}")
    launches += 1
    return match
