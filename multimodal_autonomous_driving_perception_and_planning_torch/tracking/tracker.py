"""IoU-greedy multi-object tracker over a fixed slot table.

The reference (src/tracking/multi_object_tracker.py:166-241) mutates a
Dict[int, Track]; here the whole lifecycle -- associate, matched update,
miss increment, birth, death, confirm -- is one function over a
`TrackTable`.

Parity notes (each maps to a reference behavior):
  * Greedy matching takes the max-IoU pair repeatedly with numpy's
    row-major first-max tie-break (:137-159), see ops.association.
  * Matched tracks keep their class_id; only bbox/confidence are
    refreshed (:192-196).
  * Velocity is the frame-diff of box centers taken *before* the bbox
    overwrite (:186-189).
  * Births take unmatched detections in detection order with sequential
    ids (:214-225); slots are allocated lowest-free-first, and `id_rank`
    recovers the reference's iteration order.
  * Death strictly after the miss increment: ``misses > max_age``
    (:228-233).
  * Confirmed = ``hits >= min_hits`` (:236-241), missed tracks included.

`tracker_update_with_order` is the entry point the pipeline calls: for
CUDA tensors it launches kernel K1 (ops.tracker_kernel), for CPU tensors it
runs the plain version below.  A table and detections with a leading lane
axis are B trackers stepped at once: one launch on the card, the plain
version lane by lane on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import TrackerConfig
from ..ops import tracker_kernel
from ..ops.association import _greedy_associate_plain
from ..ops.geometry import pairwise_iou
from ..types import Detections, TrackTable, map_lanes

_I32_MAX = torch.iinfo(torch.int32).max


def _rank_by_count(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending rank of each element (``argsort(argsort(key))``
    with ties broken by index)."""
    n = key.shape[0]
    idx = torch.arange(n, device=key.device)
    lt = key[:, None] < key[None, :]  # [j, i]: key_j < key_i
    tie_before = (key[:, None] == key[None, :]) & (idx[:, None] < idx[None, :])
    return (lt | tie_before).sum(dim=0).to(torch.int32)


def _invert_permutation(rank: torch.Tensor) -> torch.Tensor:
    """order[r] = i such that rank[i] == r."""
    order = torch.empty_like(rank)
    order[rank.long()] = torch.arange(rank.shape[0], dtype=rank.dtype, device=rank.device)
    return order


def id_rank(table: TrackTable) -> torch.Tensor:
    """Rank of each slot in the reference's iteration order (ascending
    track id, dict-insertion order); dead slots rank last."""
    key = torch.where(table.alive, table.track_id, _I32_MAX)
    return _rank_by_count(key)


def confirmed_mask(table: TrackTable, min_hits: int) -> torch.Tensor:
    return table.alive & (table.hits >= min_hits)


def confirmed_order(table: TrackTable, min_hits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slots of confirmed tracks sorted ascending by id (then by slot),
    unconfirmed slots after them in slot order, plus the count."""
    mask = confirmed_mask(table, min_hits)
    key = torch.where(mask, table.track_id, _I32_MAX)
    order = _invert_permutation(_rank_by_count(key))
    return order, mask.sum().to(torch.int32)


def tracker_update_with_order(
    table: TrackTable, dets: Detections, cfg: TrackerConfig, min_hits: int | None = None
):
    """`tracker_update` + `confirmed_order` in one call.

    Returns (new_table, match, order, n_confirmed).  CUDA tensors go through
    kernel K1; CPU tensors through the plain version.
    """
    if min_hits is None:
        min_hits = cfg.min_hits
    device = table.track_id.device
    if device.type == "cuda":
        return tracker_kernel.tracker_step(table, dets, cfg, min_hits)
    if device.type != "cpu":
        raise ValueError(f"tracker_update_with_order: unsupported device {device}")
    if table.track_id.dim() > 1:
        return map_lanes(
            lambda t, d: tracker_update_with_order(t, d, cfg, min_hits), table.track_id.shape[0], table, dets
        )
    new_table, match = tracker_update(table, dets, cfg)
    order, n_confirmed = confirmed_order(new_table, min_hits)
    return new_table, match, order, n_confirmed


def tracker_update(
    table: TrackTable, dets: Detections, cfg: TrackerConfig
) -> Tuple[TrackTable, torch.Tensor]:
    """One tracker step, the plain version (kernel K1's reference).

    Returns the new table and the per-slot matched-detection index (-1
    where unmatched).
    """
    t_cap = table.track_id.shape[0]
    d_cap = dets.bbox.shape[0]
    traj_cap = table.trajectory.shape[1] // 2
    device = table.track_id.device

    # --- associate -------------------------------------------------------
    iou = pairwise_iou(table.bbox, dets.bbox)
    valid_pair = table.alive[:, None] & dets.valid[None, :]
    iou = torch.where(valid_pair, iou, -1.0)
    # The plain association, so that K1's plain version stays plain on the card.
    match = _greedy_associate_plain(iou, id_rank(table), cfg.iou_threshold)
    matched = match >= 0
    matched_i = matched.to(torch.int32)
    safe = torch.where(matched, match, 0).long()

    # --- matched updates -------------------------------------------------
    det_center = dets.center
    new_center = det_center[safe]
    vel = new_center - table.center  # before the bbox overwrite

    alive_i = table.alive.to(torch.int32)
    bbox = torch.where(matched[:, None], dets.bbox[safe], table.bbox)
    conf = torch.where(matched, dets.confidence[safe], table.confidence)
    age = table.age + alive_i
    hits = table.hits + matched_i
    misses = torch.where(matched, 0, table.misses + alive_i)
    velocity = torch.where(matched[:, None], vel, table.velocity)
    vel_count = table.vel_count + matched_i

    # Trajectory ring append for matched slots at column pair traj_len % L.
    trajectory = table.trajectory.clone()
    widx = (table.traj_len % traj_cap).long()
    rows = torch.nonzero(matched).squeeze(1)
    trajectory[rows, 2 * widx[rows]] = new_center[rows, 0]
    trajectory[rows, 2 * widx[rows] + 1] = new_center[rows, 1]
    traj_len = table.traj_len + matched_i

    # --- births: unmatched valid detections, in detection order ----------
    # The k-th unmatched detection takes the k-th lowest free slot and id
    # next_id + k, for k < min(#wanted, #free).
    det_matched = torch.zeros(d_cap, dtype=torch.bool, device=device)
    det_matched[match[matched].long()] = True
    want = dets.valid & ~det_matched
    free = table.track_id == 0
    src = torch.nonzero(want).squeeze(1)
    tgt = torch.nonzero(free).squeeze(1)
    n_birth = min(src.shape[0], tgt.shape[0])
    src, tgt = src[:n_birth], tgt[:n_birth]

    track_id = table.track_id.clone()
    class_id = table.class_id.clone()
    track_id[tgt] = table.next_id + torch.arange(n_birth, dtype=torch.int32, device=device)
    bbox[tgt] = dets.bbox[src]
    class_id[tgt] = dets.class_id[src]
    conf[tgt] = dets.confidence[src]
    age[tgt] = 0
    hits[tgt] = 1
    misses[tgt] = 0
    trajectory[tgt] = 0.0
    trajectory[tgt, 0:2] = det_center[src]
    traj_len[tgt] = 1
    velocity[tgt] = 0.0
    vel_count[tgt] = 0
    next_id = table.next_id + n_birth

    # --- deaths ----------------------------------------------------------
    dead = (track_id > 0) & (misses > cfg.max_age)
    new_table = TrackTable(
        track_id=torch.where(dead, 0, track_id),
        bbox=bbox,
        class_id=class_id,
        confidence=conf,
        age=age,
        hits=torch.where(dead, 0, hits),
        misses=misses,
        trajectory=trajectory,
        traj_len=torch.where(dead, 0, traj_len),
        velocity=velocity,
        vel_count=torch.where(dead, 0, vel_count),
        next_id=next_id,
    )
    return new_table, match
