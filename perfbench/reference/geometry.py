"""Box geometry of the plain reference."""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one rounding to the inputs' dtype, as a fused
    multiply-add gives it.  The product is exact in float64 for float32 and
    narrower inputs; the float64 sum is rounded to odd (TwoSum's error
    nudges an even last bit one ulp toward it), after which rounding to the
    narrower type is correct."""
    dtype = a.dtype
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    nudge = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(nudge, torch.nextafter(s, toward), s).to(dtype)


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU of every pair of xyxy boxes, (..., A, 4) x (..., B, 4) ->
    (..., A, B): a zero intersection where edges only touch, 0 where the
    union is not positive, and the union as ``fma(w_b, h_b, area_a) -
    inter`` (the multiply-add contracted, one rounding)."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    iw = torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])
    ih = torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])
    inter = torch.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    w_b, h_b = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
    union = fma(*torch.broadcast_tensors(w_b, h_b, area_a)) - inter
    positive = union > 0
    return torch.where(positive, inter / torch.where(positive, union, 1.0), 0.0)


def centers(bbox: torch.Tensor) -> torch.Tensor:
    """Box centres, (..., 2)."""
    return torch.stack([(bbox[..., 0] + bbox[..., 2]) * 0.5, (bbox[..., 1] + bbox[..., 3]) * 0.5], dim=-1)
