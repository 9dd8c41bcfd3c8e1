"""Batched box geometry ops."""

from __future__ import annotations

import torch


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU between every pair of xyxy boxes, op for op like the JAX
    package's ``pairwise_iou`` (reference multi_object_tracker.py:84-105):
    zero-area intersection when edges touch and 0 when the union is
    non-positive.

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
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    positive = union > 0
    return torch.where(positive, inter / torch.where(positive, union, 1.0), 0.0)
