"""Batched box geometry ops."""

from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on float32 tensors with one rounding, as a fused
    multiply-add gives it.  The product of two float32 is exact in float64;
    the float64 sum is rounded to odd (TwoSum's error nudges an even last
    bit one ulp toward it), after which rounding to float32 is correct."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    nudge = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU between every pair of xyxy boxes, as the jitted JAX package
    computes ``pairwise_iou`` (reference multi_object_tracker.py:84-105):
    zero-area intersection when edges touch and 0 when the union is
    non-positive.  Compiled XLA contracts the union's multiply-add, so the
    union is fma(w_b, h_b, area_a) - inter, one rounding for the fma.

    Args:
      boxes_a: (..., A, 4) float tensor of (x1, y1, x2, y2).
      boxes_b: (..., B, 4) float tensor, the same leading dims.

    Returns:
      (..., A, B) IoU matrix.
    """
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]

    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])

    iw = x2 - x1
    ih = y2 - y1
    intersects = (iw > 0) & (ih > 0)
    inter = torch.where(intersects, iw * ih, 0.0)

    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    w_b, h_b = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
    union = fma32(*torch.broadcast_tensors(w_b, h_b, area_a)) - inter
    positive = union > 0
    return torch.where(positive, inter / torch.where(positive, union, 1.0), 0.0)
