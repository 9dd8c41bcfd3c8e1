"""The yardstick's arithmetic: the card's peaks, the YOLOv8 FLOP count from
the published layer shapes, and the bytes and operations that one launch
of each hand-written kernel needs on its inputs.

Bytes count each input byte read once and each output byte written once;
operations are counted from the kernels' loops on the data at hand, so a
bound is the least time the work could take: the larger of bytes over the
memory bandwidth and operations over the arithmetic peak.
"""

from __future__ import annotations

from typing import Dict

import torch

from .reference import yolov8

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and dense rates without
# sparsity (float32 and float64 outside the tensor cores, bf16 on them).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
PEAK_BF16_PER_S = 989e12


def tower_flops(config: Dict) -> int:
    """FLOPs of one frame through the YOLOv8 the configuration states: 2 per multiply-add
    of every convolution (a bias adds one multiply-add an output), and the
    DFL expectation (16 bins of 4 sides an anchor).  SiLU, BatchNorm,
    pooling, resizing and concatenation are not counted, as Ultralytics'
    published GFLOPs do not count them."""
    img_size = config["img_size"]
    model = yolov8.from_config(config)
    with torch.device("meta"):
        x = torch.empty(1, 3, img_size, img_size)
    macs = [0]

    def count(mod, _inp, out):
        macs[0] += out.numel() * (mod.weight[0].numel() + (mod.bias is not None))

    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, yolov8.Conv)]
    with torch.device("meta"):
        model(x)
    for h in hooks:
        h.remove()
    anchors = sum((img_size // s) ** 2 for s in yolov8.STRIDES)
    return 2 * (macs[0] + 4 * yolov8.REG_MAX * anchors)


def bound_s(nbytes: float, ops: float, peak_ops_per_s: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / peak_ops_per_s)


# --- K1, the tracker step ----------------------------------------------------


def tracker_table_bytes(T: int, L: int) -> int:
    """A track table of T slots and an L-point centre ring: id, box, class,
    confidence, age, hits, misses, ring, ring length, velocity, velocity
    count a slot, and the next id."""
    return T * (4 + 16 + 4 + 4 + 12 + 8 * L + 4 + 8 + 4) + 4


def tracker_bytes(T: int, D: int, L: int) -> int:
    """K1 at (T, D): the table and the detections (box, class, confidence,
    valid flag) in, the new table, the match and the confirmed order and
    count out."""
    return 2 * tracker_table_bytes(T, L) + D * (16 + 4 + 4 + 1) + 8 * T + 4


def tracker_ops(T: int, D: int, matches: int) -> int:
    """16 operations an IoU pair, a row and a column scan of the matrix a
    round of the association (matches + 1 rounds: each but the last accepts
    a pair), and two stable ranks over the slots."""
    return T * D * (16 + 2 * (matches + 1)) + 2 * T * T


# --- K2, the ego Kalman step ---------------------------------------------------


def kalman_bytes() -> int:
    """K2 on one filter: x (6), P (6x6), the clock, the previous heading,
    the measurement (4) and its flag, F, Q (6x6) and R (4x4) in, in
    float32; the new state (x, P, clock, previous heading and speed) and
    the 11-float row out."""
    read = 4 * (6 + 36 + 1 + 1 + 4) + 1 + 4 * (36 + 36 + 16)
    written = 4 * (6 + 36 + 3) + 4 * 11
    return read + written


# Float64 operations of a measured step, counted from the kernel's loops:
# predict 573, first extraction 4, innovation covariance and Cholesky 46,
# gain 192, state update 58, Joseph form 1416, reported extraction 14.
KALMAN_OPS = 573 + 4 + 46 + 192 + 58 + 1416 + 14


# --- K3, the tagging step --------------------------------------------------------


def tag_row_widths(T: int) -> tuple:
    """Widths of the packed float and int tag rows: 12 scalar float tags,
    the timestamp, 13 interaction confidences and 4 a slot; 21 scalar int
    tags, 13 presence flags and 3 a slot."""
    return 12 + 1 + 13 + 4 * T, 21 + 13 + 3 * T


def tagging_bytes(T: int, D: int, W: int, H: int, HI: int, n_valid: int, n_signs: int, alive: int,
                  with_velocity: int, kept: int, confirmed: int) -> int:
    """Bytes one K3 step moves on this frame's data, counted from the
    kernel's reads: the valid flags, the class of each valid detection and
    the confidence of each valid traffic light or stop sign; the table's
    boxes, classes, ids, velocity counts and previous ids, the hits of live
    slots, the forward velocity of slots with a velocity and the ring
    lengths of slots that keep their id; six of the vehicle row's eleven
    floats; the state's counters, and its rings but for the entries this
    frame replaces.  Written: the new rings, lengths, counters and the two
    packed rows."""
    read = (
        D + 4 * n_valid + 4 * n_signs
        + T * (16 + 4 + 4 + 4 + 4) + 4 * alive + 4 * with_velocity + 4 * kept
        + 4 * 6 + 4 * 3
        + 4 * (W - 1) + 4 * 6 * (H - 1)
        + 4 * (T * 2 * HI - 2 * confirmed)
    )
    fw, iw = tag_row_widths(T)
    written = 4 * W + 4 * H * 6 + 4 * T * 2 * HI + 4 * T + 4 * (fw + iw) + 4 * 3
    return read + written


def tagging_ops(T: int, D: int, W: int, H: int, HI: int) -> int:
    """Operations of one K3 step, counted from the kernel's loops: per slot
    24 arithmetic operations and 15 comparisons (distance, TTC, centres,
    drift, cascade); one select an entry of the centre ring (2 HI a slot)
    and of the maneuver history (6 H); 3 comparisons a slot on each of the
    13 per-type threads and 10 on the count thread; the scene classifier's
    6 a detection, 168 for the scores and total, 12 for the normalised
    argmax, 5 a vote slot and about 60 more; the maneuver detector's
    about 90."""
    return T * (24 + 15 + 13 * 3 + 10 + 2 * HI) + 6 * H + 6 * D + 168 + 12 + 5 * W + 60 + 90


# --- K5, the greedy-NMS keep mask -------------------------------------------------


def nms_bytes(B: int, K: int) -> int:
    """K5 on B pools of K: boxes (B, K, 4) and scores (B, K) in float32
    in, the (B, K) keep mask out."""
    return B * K * (16 + 4 + 1)


def nms_ops(live: torch.Tensor) -> int:
    """16 operations an IoU pair of live candidates, over each pool's live
    count.  The OR of a kept candidate's mask row (a word each 32
    candidates) is left out, so the bound is a little low."""
    live = live.long()
    return int((16 * (live * (live - 1) // 2)).sum())


