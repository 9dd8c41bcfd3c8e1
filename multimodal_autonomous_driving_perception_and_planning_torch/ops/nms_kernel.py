"""Wrapper of kernel K5 (kernels/csrc/nms_keep.cu): the greedy-NMS keep
mask of B images in one launch, one thread block an image.

Replaces the Pallas TPU kernel of the JAX package's ops/nms_pallas.py
(`_nms_keep_kernel`, launched by `nms_keep_pallas`).  The plain PyTorch
version is ops/nms.py `_nms_keep_plain`, which the kernel equals on every
input, ties and dead entries included.

Bound on an H100: at the detector's (B, K) = (64, 256) a call reads 344 KB
and writes 16 KB, about 0.1 us at 3.35 TB/s, and at most 64 * 32,640 IoU
pairs, about 0.5 us at 67 TFLOP/s float32.  The greedy scan itself is
serial in score order; the design keeps the K x K suppression bits in
shared memory and runs the scan on one warp.
"""

from __future__ import annotations

import torch

from ..kernels import build

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
    for name, t, shape in (("iou_boxes", iou_boxes, (B, K, 4)), ("scores", scores, (B, K))):
        if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"nms_keep: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; "
                f"expected torch.float32 {shape} on {device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"nms_keep: {name} is not contiguous")
    keep = torch.empty((B, K), dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.kernels().nms_keep(
            iou_boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), B, K, float(iou_threshold), stream
        )
    if err != 0:
        raise RuntimeError(f"nms_keep: kernel launch failed with CUDA error {err}")
    launches += 1
    return keep
