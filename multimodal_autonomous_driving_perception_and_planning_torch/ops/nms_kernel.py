"""Wrapper of kernel K5 (kernels/csrc/nms_keep.cu): the greedy-NMS keep
mask of B images in one launch, a thread block cluster of 1 to 8 blocks an
image (two launches, a mask and a scan, beyond 1,024 candidates).

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

Pools beyond 1,024 candidates, up to MAX_K (every anchor of yolov8 at
1,280), take the kernel's large instance: the suppression mask in a device
workspace, built by one kernel and scanned by another, a block an image
(nms_keep.cu `madpp_nms_keep_large`).  The workspace, B K ceil(K / 32)
32-bit words and B ceil(K / 32) more (565 MB at (64, 8,400)), is allocated
at the first call that needs it and kept for the next; a pool it cannot
hold raises ValueError.
"""

from __future__ import annotations

import torch

from ..kernels import build
from . import launch

FAST_MAX_K = 1024  # the cluster instance; beyond, the large instance
MAX_K = 33_600  # every anchor of yolov8 at 1,280: 160^2 + 80^2 + 40^2

# Launches of the kernel in this process; only `nms_keep` adds to it.
launches = 0

# The large instance's workspace, one a device: (mask words, nz words).
_workspaces: dict = {}


def workspace_words(B: int, K: int) -> tuple[int, int]:
    """The large instance's workspace at (B, K), in 32-bit words: the mask,
    B K ceil(K / 32), and the rows with later bits, B ceil(K / 32)."""
    W = -(-K // 32)
    return B * K * W, B * W


def _workspace(device: torch.device, B: int, K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The mask and nz words of the launch at (B, K) on ``device``, from the
    device's cached workspace, grown when it is too small."""
    mask_words, nz_words = workspace_words(B, K)
    key = device.index if device.index is not None else torch.cuda.current_device()
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < mask_words + nz_words:
        _workspaces.pop(key, None)
        del ws  # the old workspace is freed before the larger one is allocated
        try:
            ws = torch.empty((mask_words + nz_words,), dtype=torch.int32, device=device)
        except torch.cuda.OutOfMemoryError as err:
            raise ValueError(
                f"nms_keep: {B} images of {K} candidates need a {4 * (mask_words + nz_words):,}-byte mask "
                f"workspace, more than the card holds free; launch fewer images at a time"
            ) from err
        _workspaces[key] = ws
    return ws[:mask_words], ws[mask_words:mask_words + nz_words]


def nms_keep(iou_boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Launch K5 on CUDA tensors: iou_boxes (B, K, 4) float32, scores (B, K)
    float32, score-descending, 1 <= K <= MAX_K.  Returns keep (B, K) bool."""
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
    lib = build.kernels()
    if K <= FAST_MAX_K:
        kernel = lib.nms_keep
        args = (iou_boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), B, K, float(iou_threshold))
    else:
        kernel = lib.nms_keep_large
        mask, nz = _workspace(device, B, K)
        args = (iou_boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), mask.data_ptr(), nz.data_ptr(), B, K,
                float(iou_threshold))
    err = launch.launch(device, lambda stream: kernel(*args, stream))
    if err != 0:
        raise RuntimeError(f"nms_keep: kernel launch failed with CUDA error {err} (B={B}, K={K})")
    launches += 1
    return keep
