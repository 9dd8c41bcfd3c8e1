"""Plain IoU-greedy multi-object tracker over a fixed slot table.

A table is a dict of tensors: ``track_id`` (T,) int32 (0 = free slot),
``bbox`` (T, 4), ``class_id``, ``confidence``, ``age``, ``hits``,
``misses``, ``trajectory`` (T, 2L) interleaved centre ring, ``traj_len``,
``velocity`` (T, 2), ``vel_count`` and ``next_id`` ().  One step:

* associate: greedy maximum IoU over live slots and valid detections, rows
  in ascending track id (free slots last), first maximum in row-major
  order, pairs below the IoU threshold never matched;
* matched slots take the detection's box and confidence (not its class),
  their velocity is the centre difference taken before the box is
  replaced, and their centre is appended to the ring;
* unmatched valid detections are born in detection order into the lowest
  free slots with consecutive ids;
* a slot dies when its misses exceed ``max_age``;
* the confirmed order lists confirmed slots (``hits >= min_hits``) by
  ascending id, then the rest in slot order.

Greedy matching is computed as rounds of mutual maxima (a pair best in
both its row and its column under the order IoU descending, then row rank
and column ascending is the pair greedy takes), which gives the same
matching.  Float fields are computed in ``dtype``.
"""

from __future__ import annotations

from typing import Dict

import torch

from .geometry import centers, pairwise_iou

I32_MAX = torch.iinfo(torch.int32).max
FLOAT_FIELDS = ("bbox", "confidence", "trajectory", "velocity")


def _rank(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending rank of each entry (ties by index)."""
    n = key.shape[0]
    idx = torch.arange(n, device=key.device)
    lt = key[:, None] < key[None, :]
    tie = (key[:, None] == key[None, :]) & (idx[:, None] < idx[None, :])
    return (lt | tie).sum(dim=0).to(torch.int32)


def greedy_match(iou: torch.Tensor, row_rank: torch.Tensor, thr: float) -> torch.Tensor:
    """(T,) matched column of each row, -1 where none."""
    T, D = iou.shape
    col = torch.arange(D, dtype=torch.int32, device=iou.device)[None, :].expand(T, D)
    key = row_rank[:, None] * D + col
    big = torch.full((), I32_MAX, dtype=torch.int32, device=iou.device)
    live = (iou >= thr) & (iou >= 0.0)
    match = torch.full((T,), -1, dtype=torch.int32, device=iou.device)
    while True:
        m = torch.where(live, iou, -1.0)
        at_row = live & (m == m.amax(dim=1, keepdim=True))
        at_col = live & (m == m.amax(dim=0, keepdim=True))
        row_key = torch.where(at_row, key, big).amin(dim=1, keepdim=True)
        col_key = torch.where(at_col, key, big).amin(dim=0, keepdim=True)
        accept = at_row & at_col & (key == row_key) & (key == col_key)
        if not bool(accept.any()):
            return match
        row_hit, col_hit = accept.any(dim=1), accept.any(dim=0)
        match = torch.where(row_hit, torch.where(accept, col, big).amin(dim=1), match)
        live = live & ~row_hit[:, None] & ~col_hit[None, :]


def step(table: Dict[str, torch.Tensor], dets: Dict[str, torch.Tensor], cfg: Dict, dtype=torch.float32):
    """One frame.  ``dets``: ``bbox`` (D, 4), ``class_id``, ``confidence``,
    ``valid``; ``cfg``: ``iou_threshold``, ``max_age``, ``min_hits``.
    Returns (table', match (T,), confirmed order (T,), confirmed count ())."""
    table = {k: (v.to(dtype) if k in FLOAT_FIELDS else v) for k, v in table.items()}
    det_box, det_conf = dets["bbox"].to(dtype), dets["confidence"].to(dtype)
    valid = dets["valid"]
    T, D = table["track_id"].shape[0], det_box.shape[0]
    L = table["trajectory"].shape[1] // 2
    dev = det_box.device
    alive = table["track_id"] > 0

    iou = torch.where(alive[:, None] & valid[None, :], pairwise_iou(table["bbox"], det_box), -1.0)
    match = greedy_match(iou, _rank(torch.where(alive, table["track_id"], I32_MAX)), cfg["iou_threshold"])
    matched = match >= 0
    mi = matched.to(torch.int32)
    safe = torch.where(matched, match, 0).long()

    det_c = centers(det_box)
    new_c = det_c[safe]
    ai = alive.to(torch.int32)
    bbox = torch.where(matched[:, None], det_box[safe], table["bbox"])
    conf = torch.where(matched, det_conf[safe], table["confidence"])
    age = table["age"] + ai
    hits = table["hits"] + mi
    misses = torch.where(matched, 0, table["misses"] + ai)
    velocity = torch.where(matched[:, None], new_c - centers(table["bbox"]), table["velocity"])
    vel_count = table["vel_count"] + mi
    traj = table["trajectory"].clone()
    w = (table["traj_len"] % L).long()
    rows = torch.nonzero(matched).squeeze(1)
    traj[rows, 2 * w[rows]] = new_c[rows, 0]
    traj[rows, 2 * w[rows] + 1] = new_c[rows, 1]
    traj_len = table["traj_len"] + mi

    taken = torch.zeros(D, dtype=torch.bool, device=dev)
    taken[match[matched].long()] = True
    src = torch.nonzero(valid & ~taken).squeeze(1)
    tgt = torch.nonzero(table["track_id"] == 0).squeeze(1)
    n = min(src.shape[0], tgt.shape[0])
    src, tgt = src[:n], tgt[:n]
    track_id, class_id = table["track_id"].clone(), table["class_id"].clone()
    track_id[tgt] = table["next_id"] + torch.arange(n, dtype=torch.int32, device=dev)
    bbox[tgt] = det_box[src]
    class_id[tgt] = dets["class_id"][src]
    conf[tgt] = det_conf[src]
    age[tgt], hits[tgt], misses[tgt] = 0, 1, 0
    traj[tgt] = 0.0
    traj[tgt, 0:2] = det_c[src]
    traj_len[tgt] = 1
    velocity[tgt] = 0.0
    vel_count[tgt] = 0

    dead = (track_id > 0) & (misses > cfg["max_age"])
    new = {
        "track_id": torch.where(dead, 0, track_id), "bbox": bbox, "class_id": class_id, "confidence": conf,
        "age": age, "hits": torch.where(dead, 0, hits), "misses": misses, "trajectory": traj,
        "traj_len": torch.where(dead, 0, traj_len), "velocity": velocity,
        "vel_count": torch.where(dead, 0, vel_count), "next_id": table["next_id"] + n,
    }
    confirmed = (new["track_id"] > 0) & (new["hits"] >= cfg["min_hits"])
    rank = _rank(torch.where(confirmed, new["track_id"], I32_MAX))
    order = torch.empty_like(rank)
    order[rank.long()] = torch.arange(T, dtype=torch.int32, device=dev)
    return new, match, order, confirmed.sum().to(torch.int32)
