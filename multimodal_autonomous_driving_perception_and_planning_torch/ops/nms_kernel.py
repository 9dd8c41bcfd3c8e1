"""Wrapper of kernel K5 (kernels/csrc/nms_keep.cu): the greedy-NMS keep
mask of B images in one launch, a thread block cluster of 1 to 8 blocks an
image.

Replaces the Pallas TPU kernel of the JAX package's ops/nms_pallas.py
(`_nms_keep_kernel`, launched by `nms_keep_pallas`).  The plain PyTorch
version is ops/nms.py `_nms_keep_plain`, which the kernel equals on every
input, ties and dead entries included.

Bound on an H100: at the detector's (B, K) = (64, 256) a call reads 344 KB
and writes 16 KB, about 0.1 us at 3.35 TB/s, and at most 64 * 32,640 IoU
pairs, about 0.5 us at 67 TFLOP/s float32, both under the launch floor.
The cluster builds only the suppression words the scan can read, spread
over all its warps, into rank 0's shared memory; one warp then scans the
greedy a 32-candidate word at a time (nms_keep.cu says more).  The wrapper
does one pass of checks (ops/launch.py), one allocation and the launch on
the current stream without re-entering the device context.
"""

from __future__ import annotations

import torch

from ..kernels import build
from . import launch

MAX_K = 1024

# Launches of the kernel in this process; only `nms_keep` adds to it.
launches = 0


def nms_keep(iou_boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Launch K5 on CUDA tensors: iou_boxes (B, K, 4) float32, scores (B, K)
    float32, score-descending, 1 <= K <= 1024.  Returns keep (B, K) bool."""
    global launches
    device = iou_boxes.device
    if device.type != "cuda":
        raise ValueError(f"nms_keep launches a CUDA kernel; got a tensor on {device}")
    if iou_boxes.dim() != 3 or iou_boxes.shape[-1] != 4:
        raise ValueError(f"nms_keep: iou_boxes must be (B, K, 4), got shape {tuple(iou_boxes.shape)}")
    B, K, _ = iou_boxes.shape
    if not (B >= 1 and 1 <= K <= MAX_K):
        raise ValueError(f"nms_keep takes B >= 1 images of 1..{MAX_K} candidates; got ({B}, {K})")
    launch.check_inputs(
        "nms_keep", device,
        (("iou_boxes", iou_boxes, torch.float32, (B, K, 4)), ("scores", scores, torch.float32, (B, K))),
    )
    keep = torch.empty((B, K), dtype=torch.bool, device=device)
    kernel = build.kernels().nms_keep
    args = (iou_boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), B, K, float(iou_threshold))
    err = launch.launch(device, lambda stream: kernel(*args, stream))
    if err != 0:
        raise RuntimeError(f"nms_keep: kernel launch failed with CUDA error {err}")
    launches += 1
    return keep
