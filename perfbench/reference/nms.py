"""Plain detection tables from head logits: decode, class-aware greedy
NMS, the driving taxonomy and frame coordinates.

Greedy NMS keeps candidates in descending score order and drops every one
whose IoU with a kept candidate of the same class exceeds the threshold
(torchvision's and Ultralytics' semantics; classes kept apart by the
coordinate offset ``class * 7680``).  Here it is the suppression fixpoint:
``keep = alive & not any_i(keep_i & S_ij)`` with ``S_ij = (i < j) & (iou_ij
> thr)``, iterated from ``keep = alive`` until it stops changing, which is
the greedy result.  Both sorts are stable, so tied scores keep anchor
order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .geometry import pairwise_iou
from .yolov8 import decode

MAX_WH = 7680.0
# COCO class -> driving taxonomy (car, truck, pedestrian, cyclist,
# motorcycle, bus, traffic light, stop sign); other classes are dropped.
COCO_TO_TAXONOMY = {0: 2, 1: 3, 2: 0, 3: 4, 5: 5, 7: 1, 9: 6, 11: 7}
_BLOCK_PAIRS = 1 << 22


def taxonomy(num_classes: int = 80) -> np.ndarray:
    out = np.full((num_classes,), -1, np.int32)
    for coco, tax in COCO_TO_TAXONOMY.items():
        out[coco] = tax
    return out


def suppression(iou_boxes: torch.Tensor, thr: float) -> torch.Tensor:
    """(B, K, K) bool ``S_ij = (i < j) & (iou_ij > thr)``, built a block
    of rows at a time; pairs whose boxes do not intersect have IoU 0."""
    n, k, _ = iou_boxes.shape
    S = torch.full((n, k, k), 0.0 > thr, dtype=torch.bool, device=iou_boxes.device)
    rows = max(1, _BLOCK_PAIRS // max(1, k * n))
    for r0 in range(0, k, rows):
        a, b = iou_boxes[:, r0 : r0 + rows, None, :], iou_boxes[:, None, :, :]
        iw = torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])
        ih = torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])
        img, row, col = ((iw > 0) & (ih > 0)).nonzero(as_tuple=True)
        if img.numel():
            row = row + r0
            iou = pairwise_iou(iou_boxes[img, row][:, None, :], iou_boxes[img, col][:, None, :])[:, 0, 0]
            S[img, row, col] = iou > thr
    idx = torch.arange(k, device=iou_boxes.device)
    return S & (idx[:, None] < idx[None, :])


def keep_mask(iou_boxes: torch.Tensor, scores: torch.Tensor, thr: float) -> torch.Tensor:
    """Greedy keep mask over (B, K) score-descending candidates; scores
    that are not positive are dead."""
    alive = scores > 0
    S = suppression(iou_boxes, thr)

    def step(keep):
        return alive & ~(S & keep[..., :, None]).any(dim=-2)

    keep, nxt, it = alive, step(alive), 0
    while bool((keep != nxt).any()) and it < scores.shape[-1]:
        keep, nxt, it = nxt, step(nxt), it + 1
    return nxt


def _rows(x, idx):
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def tables(outputs, traffic: Dict, letterbox_scale: float, letterbox_pad,
           dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Head logits -> the (B, max_detections) detection tables in frame
    pixels: ``bbox``, ``class_id`` (taxonomy), ``confidence``, ``valid``.
    ``dtype`` is the decode's and the IoU's float type (float32 for the
    reference, bfloat16 for the control); the IoU and the tables are
    float32."""
    boxes, logits = decode(outputs, dtype)
    scores = torch.sigmoid(logits.amax(dim=-1))
    classes = logits.argmax(dim=-1).to(torch.int32)
    thr, pre_topk, max_det = traffic["score_threshold"], traffic["pre_topk"], traffic["max_detections"]
    scores = torch.where(scores > thr, scores, 0.0)
    k = min(pre_topk, boxes.shape[-2])
    top_scores, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[..., :k].contiguous(), idx[..., :k]
    top_boxes = _rows(boxes, idx)
    top_classes = torch.gather(classes, -1, idx)
    # The class offset in float32, in this order: at class 79 the
    # coordinates reach 606,720, where a float32 step is 0.0625.
    iou_boxes = top_boxes.float() + top_classes.float()[..., None] * MAX_WH
    keep = keep_mask(iou_boxes.contiguous(), top_scores.float(), traffic["iou_threshold"])

    kept = torch.where(keep, top_scores, -1.0)
    m = min(max_det, k)
    sel_scores, sel = torch.sort(kept, dim=-1, descending=True, stable=True)
    sel_scores, sel = sel_scores[..., :m], sel[..., :m]
    valid = sel_scores > 0
    out_boxes = torch.where(valid[..., None], _rows(top_boxes, sel), 0.0).float()
    out_classes = torch.where(valid, torch.gather(top_classes, -1, sel), 0)
    out_scores = torch.where(valid, sel_scores, 0.0).float()
    if max_det > k:
        pad = max_det - k
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros((out_boxes.shape[0], pad, 4))], dim=1)
        out_scores = torch.cat([out_scores, out_scores.new_zeros((out_scores.shape[0], pad))], dim=1)
        out_classes = torch.cat([out_classes, out_classes.new_zeros((out_classes.shape[0], pad))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((valid.shape[0], pad))], dim=1)

    dev = out_boxes.device
    px, py = letterbox_pad
    offset = torch.tensor([px, py, px, py], dtype=torch.float32, device=dev)
    frame_boxes = (out_boxes - offset) / torch.tensor(letterbox_scale, dtype=torch.float32, device=dev)
    mapped = torch.as_tensor(taxonomy(logits.shape[-1]), device=dev)[out_classes.long()]
    valid = valid & (mapped >= 0)
    return {
        "bbox": torch.where(valid[..., None], frame_boxes, 0.0),
        "class_id": torch.where(valid, mapped.clamp_min(0), 0).to(torch.int32),
        "confidence": torch.where(valid, out_scores, 0.0),
        "valid": valid,
    }
