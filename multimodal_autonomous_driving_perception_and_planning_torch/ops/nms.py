"""Fixed-capacity non-maximum suppression, batched over leading dims.

Port of the JAX package's ops/nms.py: score-descending greedy suppression
with IoU, class-aware through the coordinate-offset trick (ultralytics'
``c = cls * max_wh``), the semantics of the torchvision/ultralytics NMS the
reference runs.  Pipeline: score filter -> top-K prefilter -> greedy keep
mask -> top ``max_det`` survivors, all fixed capacity.

Both top-K selections are stable descending sorts: ``jax.lax.top_k`` puts
equal values in index order and ``torch.topk`` promises no order among
ties, and positive scores do tie.

`nms_keep` is the greedy keep mask: for CUDA tensors it launches kernel K5
(ops.nms_kernel), a cluster an image up to K = 1024 and a mask and a scan
beyond, every K up to `nms_kernel.MAX_K` (33,600); for CPU tensors it
runs the plain version, `_nms_keep_plain`, the suppression fixpoint of the
JAX package's ``nms_keep_xla``, which K5 equals bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import nms_kernel
from .geometry import pairwise_iou


class NMSResult(NamedTuple):
    boxes: torch.Tensor  # (..., max_det, 4) xyxy
    scores: torch.Tensor  # (..., max_det)
    classes: torch.Tensor  # (..., max_det) int32
    valid: torch.Tensor  # (..., max_det) bool


def nms_keep(iou_boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy keep mask over score-descending candidates.

    Args:
      iou_boxes: (..., K, 4) float32 xyxy, already class-offset when
        class-aware.
      scores: (..., K) float32, descending; entries <= 0 are dead (never
        kept, never suppress).
      iou_threshold: suppression threshold (strict ``>``).

    Returns:
      keep: (..., K) bool.
    """
    if iou_boxes.device.type == "cuda":
        k = scores.shape[-1]
        flat = nms_kernel.nms_keep(
            iou_boxes.reshape(-1, k, 4).contiguous(), scores.reshape(-1, k).contiguous(), iou_threshold
        )
        return flat.reshape(scores.shape)
    if iou_boxes.device.type != "cpu":
        raise ValueError(f"nms_keep: unsupported device {iou_boxes.device}")
    return _nms_keep_plain(iou_boxes, scores, iou_threshold)


# IoU pairs a block of the suppression matrix at most: its temporaries stay
# near 100 MB each, where at (64, 8,400) the whole matrix's would take tens
# of GB.
_BLOCK_PAIRS = 1 << 22


def _suppression(iou_boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """``S_ij = (i < j) & (iou_ij > thr)`` over (..., K, 4) boxes, as a
    (..., K, K) bool, built in blocks of rows.  `pairwise_iou` is computed
    only for the pairs whose boxes intersect (its ``iw > 0 and ih > 0``,
    by the same ops): every other pair's IoU is 0, so its entry is ``0 >
    thr``.  Each pair's IoU is the same however the pairs are gathered."""
    *lead, k, _ = iou_boxes.shape
    flat = iou_boxes.reshape(-1, k, 4)
    n = flat.shape[0]
    S = torch.full((n, k, k), 0.0 > iou_threshold, dtype=torch.bool, device=iou_boxes.device)
    rows = max(1, _BLOCK_PAIRS // max(1, k * n))
    for r0 in range(0, k, rows):
        a, b = flat[:, r0:r0 + rows, None, :], flat[:, None, :, :]
        iw = torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])
        ih = torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])
        img, row, col = ((iw > 0) & (ih > 0)).nonzero(as_tuple=True)
        if img.numel():
            row = row + r0
            iou = pairwise_iou(flat[img, row][:, None, :], flat[img, col][:, None, :])[:, 0, 0]
            S[img, row, col] = iou > iou_threshold
    idx = torch.arange(k, device=iou_boxes.device)
    return (S & (idx[:, None] < idx[None, :])).reshape(*lead, k, k)


def _nms_keep_plain(iou_boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The suppression fixpoint (kernel K5's reference), with the contract
    of `nms_keep`: iterate ``keep = alive & not any_i(keep_i & S_ij)`` from
    ``keep = alive``, with ``S_ij = (i < j) & (iou_ij > thr)``, until it
    stops changing (at most K rounds), as ``nms_keep_xla`` does."""
    k = scores.shape[-1]
    alive = scores > 0
    S = _suppression(iou_boxes, iou_threshold)

    def f(keep):
        return alive & ~(S & keep[..., :, None]).any(dim=-2)

    keep, nxt, it = alive, f(alive), 0
    while bool((keep != nxt).any()) and it < k:
        keep, nxt, it = nxt, f(nxt), it + 1
    return nxt


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per leading index."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def nms_prefilter(boxes, scores, classes, score_threshold: float, pre_topk: int,
                  class_aware: bool = True, max_wh: float = 7680.0):
    """Score filter and top-K prefilter: the candidates' scores, boxes and
    classes in descending score order, K = min(pre_topk, N), and the boxes
    the IoU sees (class-offset when ``class_aware``), which with the scores
    are the keep mask's input."""
    scores = torch.where(scores > score_threshold, scores, 0.0)
    k = min(pre_topk, boxes.shape[-2])
    top_scores, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[..., :k].contiguous(), idx[..., :k]
    top_boxes = _gather_rows(boxes, idx)
    top_classes = torch.gather(classes, -1, idx)
    if class_aware:
        # In float32 and in this order, as the JAX package computes it: at
        # class 79 the coordinates reach 606,720, where a float32 step is
        # 0.0625, and the keep mask must see exactly these floats.
        iou_boxes = top_boxes + top_classes.to(torch.float32)[..., None] * max_wh
    else:
        iou_boxes = top_boxes
    return top_scores, top_boxes, top_classes, iou_boxes.contiguous()


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.25,
    max_det: int = 300,
    pre_topk: int = 1024,
    class_aware: bool = True,
    max_wh: float = 7680.0,
) -> NMSResult:
    """Greedy NMS over (..., N, 4) candidate sets.

    Args:
      boxes: (..., N, 4) xyxy.
      scores: (..., N) confidence.
      classes: (..., N) integer class ids.
      class_aware: offset boxes per class so suppression never crosses
        classes.
    """
    boxes = boxes.to(torch.float32)
    scores = scores.to(torch.float32)
    classes = classes.to(torch.int32)
    top_scores, top_boxes, top_classes, iou_boxes = nms_prefilter(
        boxes, scores, classes, score_threshold, pre_topk, class_aware, max_wh
    )
    k = top_scores.shape[-1]
    keep = nms_keep(iou_boxes, top_scores, iou_threshold)

    # Compact the survivors (score order preserved) into max_det slots.
    kept_scores = torch.where(keep, top_scores, -1.0)
    m = min(max_det, k)
    sel_scores, sel = torch.sort(kept_scores, dim=-1, descending=True, stable=True)
    sel_scores, sel = sel_scores[..., :m], sel[..., :m]
    valid = sel_scores > 0
    out_boxes = torch.where(valid[..., None], _gather_rows(top_boxes, sel), 0.0)
    out_classes = torch.where(valid, torch.gather(top_classes, -1, sel), 0)
    out_scores = torch.where(valid, sel_scores, 0.0)

    if max_det > k:  # pad up to max_det
        pad = max_det - k
        lead = out_scores.shape[:-1]
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros((*lead, pad, 4))], dim=-2)
        out_scores = torch.cat([out_scores, out_scores.new_zeros((*lead, pad))], dim=-1)
        out_classes = torch.cat([out_classes, out_classes.new_zeros((*lead, pad))], dim=-1)
        valid = torch.cat([valid, valid.new_zeros((*lead, pad))], dim=-1)

    return NMSResult(boxes=out_boxes, scores=out_scores, classes=out_classes, valid=valid)
