"""Greedy IoU association via rounds of mutual-maximum acceptance.

The reference's greedy matcher (src/tracking/multi_object_tracker.py:137-159)
repeatedly takes the first maximum of the IoU matrix in row-major order,
rows in ascending track id.  That is a strict total order on pairs: IoU
descending, then ``row_rank * D + det`` ascending.  A pair that is the best
remaining in both its row and its column is picked by greedy, and distinct
such pairs share no row or column, so accepting all of them in each round
gives the exact greedy matching in a data-dependent number of rounds (worst
case min(T, D)).

`greedy_associate` is the entry point: for CUDA tensors it launches kernel
K4 (ops.association_kernel), which runs every round inside one launch; for
CPU tensors it runs the plain version, `_greedy_associate_plain`, which
asks the host after each round whether it accepted a pair.
"""

from __future__ import annotations

import torch

from . import association_kernel

_I32_MAX = torch.iinfo(torch.int32).max


def greedy_associate(
    iou: torch.Tensor, row_rank: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Greedy max-IoU matching.

    Args:
      iou: (T, D) matrix; entries of invalid rows or columns must already
        be -1.
      row_rank: (T,) int32 rank of each row in reference iteration order,
        a permutation of 0..T-1 where it comes from the tracker.  Rows of
        equal rank tie on every pair of one column: all of them that share
        the column's best IoU and are at their own row's best take that
        column, on the card and on the CPU alike, as in the JAX package.
      iou_threshold: pairs with IoU below it are never matched (the
        reference's strict ``<`` stop, multi_object_tracker.py:146-148).

    Returns:
      match: (T,) int32, matched detection index per row, -1 if unmatched.
    """
    if iou.device.type == "cuda":
        return association_kernel.greedy_associate(iou, row_rank, iou_threshold)
    if iou.device.type != "cpu":
        raise ValueError(f"greedy_associate: unsupported device {iou.device}")
    return _greedy_associate_plain(iou, row_rank, iou_threshold)


def _greedy_associate_plain(
    iou: torch.Tensor, row_rank: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """The plain mutual-max fixpoint (kernel K4's reference), with the
    contract of `greedy_associate`."""
    T, D = iou.shape
    det_idx = torch.arange(D, dtype=torch.int32, device=iou.device)[None, :].expand(T, D)
    key = row_rank[:, None] * D + det_idx  # (T, D) tie-break, asc = earlier
    big = torch.full((), _I32_MAX, dtype=torch.int32, device=iou.device)

    live = (iou >= iou_threshold) & (iou >= 0.0)
    match = torch.full((T,), -1, dtype=torch.int32, device=iou.device)
    while True:
        m = torch.where(live, iou, -1.0)
        row_max = m.amax(dim=1, keepdim=True)
        at_row_max = live & (m == row_max)
        row_best_key = torch.where(at_row_max, key, big).amin(dim=1, keepdim=True)
        col_max = m.amax(dim=0, keepdim=True)
        at_col_max = live & (m == col_max)
        col_best_key = torch.where(at_col_max, key, big).amin(dim=0, keepdim=True)

        accept = at_row_max & at_col_max & (key == row_best_key) & (key == col_best_key)
        if not bool(accept.any()):
            return match
        row_hit = accept.any(dim=1)
        col_hit = accept.any(dim=0)
        picked = torch.where(accept, det_idx, big).amin(dim=1)
        match = torch.where(row_hit, picked, match)
        live = live & ~row_hit[:, None] & ~col_hit[None, :]
