#!/usr/bin/env python3
"""Drive the PyTorch port's paths on a CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the device: name, count, and ``nvidia-smi``'s name and power limit;
  2. the kernels build from the sources in the checkout (kernels/build.py);
  3. kernel K1 (tracker step) against its plain version on the card,
     exact on every output, over random, tie-quantized and saturated
     streams at (T, D) = (64, 16) and (128, 64) (the latter at full
     occupancy), the staircase and all-equal ladders at (64, 16) and the
     staircase at (128, 64), whose association accepts one pair a round,
     IoUs exactly at the threshold and +0 IoUs all tied under a threshold
     of 0, exactly 32 and 33 eligible pairs (either side of the
     association's sparse limit), (128, 64) IoUs within 2 ulps of the
     threshold (where the union's contracted rounding decides), and the
     synthetic stream;
  4. kernel K2 (ego Kalman step) against its plain version on the card,
     step by step over a 300-frame chain with unmeasured frames, then on
     single steps from crafted states (speed either side of the heading
     hold, a heading wrapping across +-pi, unmeasured, P at 1e4, and an
     ill-conditioned innovation covariance, held to the plain version
     evaluated in float64);
  5. kernel K3 (tagging step) against its plain version on the card, the
     state threaded through each side on its own, over random streams in
     detections mode (120 frames), frames mode (60) and at T = 128 (60),
     and over a crafted stream (40 frames, detections mode at T = 64 and
     frames mode at T = 128) that reaches every corner of the aggregates:
     all interaction types at once, ties on (risk, confidence) decided by
     id, equal minimum TTC in several slots, center rings past their wrap;
  6. kernel K4 (standalone association) against its plain version on the
     card, exact, over tie-quantized matrices, the empty and full ones, the
     ladders (the staircase at (128, 64) too), (128, 64) matrices with
     nothing dead, and the key-order corners (-0 and +0, IoU at the
     threshold, NaN, ranks at int32's ends in tied groups), dense, with
     few eligible pairs, and with exactly 32 and 33;
  7. kernel K5 (greedy-NMS keep mask) against its plain version on the
     card, exact, over tie-quantized pools at K = 16 ... 1024, a
     suppression chain, all dead, all kept, and `nms_cases`: K either side of a 32-bit word at B = 1 and 3, chains
     across words, IoUs at and within 2 ulps of the threshold, thresholds
     of 0, below 0 and from 1 up, class-offset, degenerate, NaN and inf
     boxes, dead entries between live ones, subnormal IoUs, and batches of
     1 to 200 images; and boxes off 16-byte alignment;
  7a. kernel K6 (the planner) against its plain version on the card
     (`check_planner_kernel`, within `hold_plan`'s bars): the default grid
     from headings near +-pi, rest, backing up and far-off starts (also
     from K2's vehicle row, bit for bit), a NaN start, a reference path
     with none, some and all points valid, obstacles in the hard and soft
     bands, ties (all costs equal, two equal minima), a 55 x 81 grid, and
     1, 8 and 64 random lanes, each lane bit for bit its B = 1 launch;
  8. the main path: `make_sequence_runner` on the card over the 300-frame
     synthetic stream in bench.py's configuration, against the same runner
     on the CPU, with each kernel's launches counted in that run;
  9. the tagging path: the same with tagging on (apps/serve.py's default);
 10. the association path: the public `ops.greedy_associate` on each frame
     of the tagging path's run, against the association inside K1;
 11. the frames path, the JAX package's default configuration
     (DEFAULT_CONFIG with the serving outputs: camera frames -> lanes and
     scene features -> track -> estimate -> plan -> tag, K3 in frames
     mode): `make_sequence_runner` on the card over 300 road frames from
     the port's generator (the adjacent lane's dashes scrolling) with the
     synthetic detections and ego stream, against the same runner on the
     CPU: discrete outputs and tags exact, floats within the budget, the
     lane fits by their x at three rows; K1, K2 and K3 counted;
 12. the YOLO path in float32: `make_yolo_sequence_runner` (yolov8n at 640,
     seeded weights) over 300 seeded 480x640 frames; the first chunk's
     conv tower against the CPU's, the card's detection tables against the
     plain `nms` on the card's own candidates, and the pipeline against
     the CPU's on those tables;
 13. the YOLO path in the serving configuration (bf16, the JAX defaults):
     its head logits against the float32 run's, its tables against the
     plain `nms` on its own candidates;
 14. the YOLO path with frames: one 64-frame chunk of the road frames with
     ``use_frames=True`` in bf16, against the frames runner on its own
     tables, and its lanes and frame-decided tags against the frames
     path's;
 14a. the float32 tower under torch's default TF32 flags
     (`yolo_default_flags`): a fresh process (this script with
     ``--yolo-default-flags``), which leaves the flags as torch sets them,
     runs yolov8n's float32 tower on 4 frames on the card against the
     CPU, head logits within 1e-4 of each output's scale, and finds the
     flags unchanged after the forward;
 15. the lane axis: K1, K2 and K3 at B = 1, 8 and 64 lanes a launch, each
     lane on its own random stream, against each lane's B = 1 launch (bit
     for bit) and plain version (`lane_kernels`; at B = 8 also rings of 63
     slots, off 16-byte alignment, and K3 in frames mode at (128, 64));
 16. the batched path: the tagging path over 8 distinct streams in one
     `make_batched_sequence_runner`, each lane against its own unbatched
     card run, one launch of K1, K2 and K3 a frame for all lanes;
 17. the multi-camera path: `parallel.mesh.make_multicamera_runner` over 8
     cameras in the main path's configuration, each camera against its
     own card run, the fleet count against the sum over cameras;
 18. the serve path: the port's server (`apps.serve`, --batch 8, 64-frame
     chunks, serving from the artifact it exports at startup, /info's
     ``artifact_bytes`` > 0) on the card under ``tools/serve_loadgen.py
     --sessions 8 --chunks 4`` in a subprocess, whose JSON line it prints:
     no error, one launch of K1-K3 a frame of each batched run; then one
     served chunk against the runner;
 19. the per-agent Kalman bank over 300 frames x 64 agents against the CPU;
 19a. tables beyond the fast instances (`large_tables`): K1 and K4's
     general instances (a thread block cluster a lane) at (T, D) = (64,
     300), (160, 80), (256, 128) and (1,024, 1,024) against their plain
     versions, exact (churn, saturated tables, random, tied-rank and full
     matrices, the key-order corners with ranks whose tie-break keys wrap
     at these D, IoUs within 2 ulps of the threshold, and the staircase,
     1,025 rounds at 1,024), and at every (T, D) of 65, 129, 300 and 1,024
     (the edges of the cluster partition); K3's in both modes at T = 160,
     256 and 1,024 and on the crafted stream at 256, and at T = 129, 255,
     256, 257, 511, 513, 993 and 1,024 (the edges of its warps and of its
     cluster), every tag and the state bit for bit, with rings of 29
     centers (at 1 and 3 lanes) and of 500; K1 at 8 lanes at (256, 128),
     (64, 300) and (1,024, 1,024), K3 at (256, 128);
 19a'. tables and pools beyond 1,024 (`wide_tables`): K1 and K4 at (1,025,
     64), (2,048, 300), (4,096, 1,024) and (4,096, 4,096) (churn,
     saturated tables, IoUs at the threshold and +0 IoUs all tied, IoUs
     within 2 ulps of the threshold, random, tied-rank and full matrices,
     the key-order corners with ranks whose keys wrap in int32 at these D,
     and the staircase and all-equal ladders, 4,097 rounds at 4,096 x
     4,096); K3 at 1,025, 2,048 and 4,096 slots in both modes and on the
     crafted stream at 4,096; K5's large instance (a mask kernel into a
     device workspace and a scan kernel by tiles of words) at (64, 1,025),
     (64, 8,400) and (2, 33,600) on
     `nms_cases` tiled past 1,024 and a chain across every word, and off
     16-byte alignment; K1 at 8 lanes at (2,048, 300); each bit for bit
     its plain version;
 19a''. the wide paths (`wide_paths`): (a) `yolo_all_anchors`, yolov8n at
     640 in float32 at score 0.05 with every anchor in the NMS pool
     (pre_topk 8,400) and 300 detections, one 64-frame chunk (K5 at (64,
     8,400), K1 at (64, 300)); (b) `tagging_4096`, the tagging path at
     4,096 slots and 1,024 random detections a frame at 60% valid over 64
     frames (K1 at (4,096, 1,024), K3 at 4,096 slots, more than 1,024
     live); (c) `frames_360`, the frames path on a Hough grid of 360
     thetas over 64 road frames; each counted, against its CPU run over
     the frames the CPU finishes in 20 s (at least 8) and its card run
     with the plain versions over all of them; and the computed
     Hough tables at 90 and 180 thetas against the carried ones on this
     host;
 19b. the host stack (`host_stack`): the tagging path over 40 frames on the
     card, then `extract_frame` on every frame, the AutoTagger and a
     TagDatabase round trip against the same chain on the CPU run; the
     per-frame facades (MultiObjectTracker, VehicleStateEstimator,
     MotionPlanner, AutoTagger.tag_frame, LaneDetector) on the card against
     the card's sequence runner, and ObjectDetector(mode="yolo")'s
     `detect_stream` against `make_yolo_frontend`, with the facades' own
     launches of K1, K2, K3 and K5 counted;
 19c. the device detection stream (`device_detections`):
     `device_detection_stream` of 300 frames at capacity 16 made on the card,
     its deterministic part against the CPU's on the card's draws over
     counters 1 to 1,000,000 (the float64 sine's x_base too), a chunk
     from counter 101 against the slice of the whole stream, and the
     tagging path's runner on the card's tables against the same runner on
     their host copies, every output exact;
 19d. the stream runtime (`stream_path`): `NativeFrameSource` (synthetic,
     640x480, 300 frames, 128 slots) into `run_stream` (64-frame chunks,
     the last padded to 320; pinned double buffers copied on a side
     stream) over the frames path with the serving outputs, against the
     card's monolithic runner on the same frames (discrete outputs exact,
     floats within the budget), and again with 16 slots and 4 producer
     threads; then the overlapped stream and the serial loop of
     benchmarks/suite.py:888-905 in turns: frames/s and ``decode_s``;
 19e. the demo (`demo_path`): `apps.demo.run_demo` over 300 synthetic
     frames in DEFAULT_CONFIG with the Kalman bank, its host records
     against `extract_frame` of the card's runner, ``--yolo`` on 2 frames
     with seeded weights from an ``.npz`` (K5 once), the multi-camera demo
     over 4 cameras x 30 frames; with renders and videos where cv2 imports
     (decided by an import check before the phase), else the demo's device
     half (`run_device`); device and render-loop frames/s;
 19f. the web dashboard (`webview_path`): `build_dashboard_data(120)` in
     30-frame chunks against one 120-frame chunk, tags and states equal,
     each chunk's run and render seconds;
 19g. the serialized runner (`export_path`): the madpp ops against their
     wrappers on the path's inputs (K3's also at 160 slots, its general
     instance) and each one's host microseconds a call
     beside its wrapper's, in turns; then `export_sequence_runner` on the
     card for the server's configuration at batch 1 and 8 and the main
     path's at batch 1 (64-frame chunks), each program holding its madpp
     ops, saved to a file; a fresh process (this script with
     ``--run-artifacts DIR``) loads each, runs 300 frames of the synthetic
     stream (8 streams at batch 8) in 64-frame chunks, the last padded to
     320, the state carried across chunks, against the eager runner on
     the same chunks: every output and the final state bit for bit, one
     launch of K1, K2 (and K3) a frame, a 63-frame chunk refused; the
     artifact's bytes, export and load seconds, both runners' frames/s
     in turns, and each one's host time for a chunk by function
     (cProfile); then the frames mode (DEFAULT_CONFIG at 640x480, tagging
     on) exported on the card at batch 1, loaded in the same fresh
     process and held bit for bit to the eager frames runner over 128
     road frames, one launch of K1-K3 a frame, with both runners' Canny
     hysteresis rounds and host reads a frame (the reads counted by
     ``torch.cuda.set_sync_debug_mode``); and the tagging configuration
     exported for ``("cuda", "cpu")`` by this script with
     ``--export-cpu DIR`` in a process that sees no card, loaded on the
     card there and held to the card-exported artifact (discrete outputs
     bit for bit, floats within 1e-4, whether bit for bit said), K1-K3
     launched;
 19h. across ranks (`cross_card`): two ranks (parallel/distributed.py
     `spawn`) share the one card over gloo with CUDA tensors: the camera
     mesh (4 cameras, 2 a rank, 300 frames, tagging off and on) each
     rank's cameras against their lanes of the one-card batched runner,
     the fleet count the sum; the dp server (dp=2, --batch 4) against the
     batch-4 server on two sessions of two chained chunks; the
     tensor-parallel yolov8n (data=1, model=2) at 640 in float32 against
     the unsharded detector, K5 launched; the full-width BLIP sharded over
     model=2, its greedy 8 tokens against the unsharded model's; then the
     camera mesh once more on one rank over NCCL, its outputs gathered
     (``full_tensor``).  Each case's seconds and launches;
 20. the BLIP captioner (`blip_model`): the full-width BlipConfig() with
     seeded weights on a 480x640 road frame, the card against the CPU:
     `preprocess_bgr`, the vision states, the cross K/V and the
     teacher-forced logits over one fixed buffer within a fraction of
     their scale, the greedy and beam-3 decodes of the scene prompt at 8
     new tokens (a token may differ only after a decision within the
     measured gap);
 21. the VLM path (`vlm_path`): the frames path on the card over 30 road
     frames, then `VLMTagger(backend="torch")` on the card over them with
     the runner's ego state and confirmed tracks, from an HF-named ``.npz``
     of the seeded weights and a synthetic ``vocab.txt``, at the default
     budgets (75 and 50) with num_beams=3: the backend loads and makes all
     6 captions (3 captioned frames x 2 prompts), 27 cache hits, no stub
     caption;
 22. times: each kernel and its plain version by CUDA events at its path's
     shapes, beside the kernel's bound; the launch floor (`floor_ms`, a
     one-element add's device time) and where K1's to K5's time goes
     (`split`: each wrapper's host split, each kernel on inputs that take
     one part of its work away, K5 with the cluster size each launch
     takes); the frames/s of the main, tagging and frames paths, timed in
     turns; the lane step's device time by stage (`lane_split`); the YOLO
     detection chunk by stage and the YOLO path's frames/s in both dtypes;
     the BLIP vision forward and a greedy and a beam-3 caption of each VLM
     prompt at its budget, beside their FLOPs and float32 bounds, with the
     card's busy share over one beam-3 caption (`blip_times`); then
     (`lane_times`) K1-K3 at B = 1, 8 and 64 beside their bounds, and the
     tagging path's lane-frames/s at B = 1, 8 and 64, in turns; then
     (`large_times`) K1 and K4's general instances at (64, 300), (160, 80),
     (256, 128), (1,024, 1,024), (1,024, 64) (K1 ranked by one block's
     sort, beside (1,025, 64) ranked by counting) and the four wide shapes,
     K3's at (160, 80), (256, 128), (1,024, 1,024) and 1,025, 2,048 and
     4,096 slots in both modes and its small instance at (128, 64) as the
     yardstick, K5's large instance at (64, 8,400) and (2, 33,600), by CUDA
     events and a profiler trace, beside their bounds, plain versions,
     cluster sizes and rounds, with each instance's device time by kernel
     (K1's rank and stage kernels against its cluster kernel, K5's mask
     against its scan), and K4 on the staircase, a round's device time
     (`round_cost`); and K1's cluster kernel by phase (`k1_phases`: loads,
     id rank, staging, rounds, ring copy, updates, confirmed order, in
     clock64() cycles, from tracker_step.cu built with
     -DMADPP_PHASE_CLOCKS beside the kernels' own build) at (1,024, 64),
     (1,025, 64) and (4,096, 1,024);
     then (`large_paths`) the YOLO path at max_detections=300 (float32,
     score 0.05, 300 frames in 5 chunks of 64: K1 at (64, 300) every
     frame) and ROADMAP §3's tagging path (160 slots, 80 detections, 300
     frames), each against its CPU run, and with the three wide paths
     timed in turns, with each one's launches, busy share and K1's device
     us a launch.
Then the script's seconds, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero.  Without a card it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
from multimodal_autonomous_driving_perception_and_planning_torch.data.synthetic import (
    ego_motion_stream,
    simulated_detection_stream,
)
from multimodal_autonomous_driving_perception_and_planning_torch.estimation.ego import (
    _estimator_row_fused,
    _estimator_step_fused,
    _estimator_step_xla,
)
from multimodal_autonomous_driving_perception_and_planning_torch.kernels import build
from multimodal_autonomous_driving_perception_and_planning_torch.models import yolov8
from multimodal_autonomous_driving_perception_and_planning_torch.ops import (
    association_kernel,
    kalman_kernel,
    nms_kernel,
    tagging_kernel,
    tracker_kernel,
)
from multimodal_autonomous_driving_perception_and_planning_torch.ops.association import (
    _greedy_associate_plain,
)
from multimodal_autonomous_driving_perception_and_planning_torch.ops.geometry import pairwise_iou
from multimodal_autonomous_driving_perception_and_planning_torch.ops.kalman import (
    KalmanModel,
    make_constant_accel_model,
)
from multimodal_autonomous_driving_perception_and_planning_torch.ops.nms import (
    _nms_keep_plain,
    nms,
    nms_prefilter,
)
from multimodal_autonomous_driving_perception_and_planning_torch.planning import planner
from multimodal_autonomous_driving_perception_and_planning_torch.perception.detector import (
    make_yolo_sequence_runner,
)
from multimodal_autonomous_driving_perception_and_planning_torch.tagging.rules import (
    TaggingRules,
    make_packed_tagging_step,
    tagging_step_plain,
    unpack_tags,
)
from multimodal_autonomous_driving_perception_and_planning_torch.tracking.tracker import (
    _rank_by_count,
    confirmed_order,
    tracker_update,
)
from multimodal_autonomous_driving_perception_and_planning_torch.types import (
    Detections,
    KalmanState,
    LaneObservation,
    TaggingState,
    VEHICLE_STATE_FIELDS,
    TrackTable,
    VehicleState,
    tree_map,
    vehicle_state_from_row,
)
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import (
    kalman_model_from_numpy,
)
from multimodal_autonomous_driving_perception_and_planning_torch.utils.device import float32_matmuls

PKG = "multimodal_autonomous_driving_perception_and_planning_torch"
JAX_PKG = "multimodal_autonomous_driving_perception_and_planning_tpu"
NUM_FRAMES = 300
MAIN_ATOL = 1e-4  # PARITY.md budget: card against CPU over the whole run
K2_ATOL, K2_RTOL = 1e-5, 1e-6  # kernel K2 against its plain version, per step
# Kernel K3 against its plain version (tests/test_tagging_pallas.py's bars):
# floats of the tags, and of the carried state.
K3_ATOL, K3_STATE_ATOL = 1e-5, 1e-6
# TTC = distance / closing speed turns the card's and the CPU's speed gap
# (K2, about 5e-5 m/s) into distance / speed^2 times as much: up to about
# 57 s^2/m on the synthetic stream.  The tagging path holds the two TTC tags
# at MAIN_ATOL plus this relative bound.
TTC_RTOL = 1e-5
TTC_TAGS = ("track_ttc", "min_ttc")
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12  # the data sheet's float64 rate outside the tensor cores
PEAK_BF16_PER_S = 989e12  # dense bf16 on the tensor cores
# The card's activity only: tracing the host's operators too slows the
# profiled run and takes seconds to read back.
PROFILED = [torch.profiler.ProfilerActivity.CUDA]
PLAIN_REPS = 50  # calls of a plain version a timing (the kernels take 2000)

KERNEL_MODULES = {
    "tracker_step": tracker_kernel,
    "kalman_step": kalman_kernel,
    "tagging_step": tagging_kernel,
    "associate": association_kernel,
    "nms_keep": nms_kernel,
}
# K6 (the planner) where the checkout has it: split_compare.py loads this
# script against another checkout's package, which may predate it.
if importlib.util.find_spec(f"{PKG}.ops.planner_kernel") is not None:
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import planner_kernel

    KERNEL_MODULES["plan_step"] = planner_kernel
# The YOLO path: yolov8n at 640 in 64-frame chunks, benchmarks/suite.py's
# frames, with the JAX test's thresholds for random weights
# (tests/test_yolo_nms.py:218-225) in float32 and the JAX defaults in bf16.
YOLO_IMG, YOLO_BATCH, YOLO_PRE_TOPK, YOLO_IOU = 640, 64, 256, 0.45
YOLO_F32 = dict(compute_dtype=torch.float32, score_threshold=0.05, map_to_taxonomy=False)
YOLO_BF16 = dict(compute_dtype=torch.bfloat16, score_threshold=0.25, map_to_taxonomy=True)
# Head logits against a reference, each scale's box and class logits: the
# largest gap over the largest logit.  The card's float32 against the CPU's
# (cuDNN and oneDNN sum in other orders; the port's CPU run stands 1.5e-6
# from JAX's): 1e-4.  bf16 against float32 on the card: 0.05, from a bf16
# CPU run at 160 and 640 px, which gave 0.013-0.021
# (tests/test_torch_yolo.py holds the CPU to it).
F32_LOGIT_REL = 1e-4
BF16_LOGIT_REL = 0.05
TABLE_FIELDS = (
    "track_id", "bbox", "class_id", "confidence", "age", "hits", "misses",
    "trajectory", "traj_len", "velocity", "vel_count", "next_id",
)
MAIN_DISCRETE = (
    "track_id", "track_class_id", "track_hits", "track_misses", "track_age",
    "track_vel_count", "confirmed_order", "num_confirmed", "match", "plan_best",
)
MAIN_FLOAT = (
    "track_bbox", "track_confidence", "track_velocity", "plan_costs",
    "plan_best_positions", "plan_best_velocities",
)


_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries the seconds since the imports."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _START, 3)}
    print(json.dumps(obj), flush=True)


def bench_config(enable_tagging: bool = False):
    """bench.py:146-151: detections in, no frames, no tagging, serving
    outputs; with ``enable_tagging``, apps/serve.py:731-732's default."""
    return pt.DEFAULT_CONFIG.replace(
        use_frames=False, enable_tagging=enable_tagging, emit_candidates=False, emit_trajectories=False
    )


def synthetic_inputs(num_frames: int = NUM_FRAMES) -> dict:
    dets = simulated_detection_stream(num_frames)
    ego = ego_motion_stream(num_frames, dt=1.0 / 30.0, seed=0).astype(np.float32)
    return dict(dets, ego_measurement=ego)


def random_dets(rng, d_cap: int, device, p_valid: float = 0.6) -> Detections:
    """Tie-heavy detections: coordinates quantized to 20 px give exact IoU
    ties (the cases of tests/test_tracker_pallas.py)."""
    cx, cy = rng.uniform(0, 600, d_cap), rng.uniform(0, 400, d_cap)
    w, h = rng.uniform(30, 150, d_cap), rng.uniform(30, 150, d_cap)
    cx, cy, w, h = (np.round(v / 20) * 20 for v in (cx, cy, w, h))
    bbox = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)
    return Detections(
        bbox=torch.tensor(bbox, dtype=torch.float32, device=device),
        class_id=torch.tensor(rng.integers(0, 8, d_cap), dtype=torch.int32, device=device),
        confidence=torch.tensor(rng.uniform(0.5, 1.0, d_cap), dtype=torch.float32, device=device),
        valid=torch.tensor(rng.random(d_cap) < p_valid, device=device),
    )


def frame_dets(inputs: dict, f: int, device) -> Detections:
    return pt.detections_from_arrays({k: inputs[k][f] for k in ("bbox", "class_id", "confidence", "valid")}, device)


def plain_tracker_step(table, dets, cfg):
    new_table, match = tracker_update(table, dets, cfg)
    order, n_confirmed = confirmed_order(new_table, cfg.min_hits)
    return new_table, match, order, n_confirmed


def _tracker_case(name, cfg, dets_fn, steps, device, table=None) -> dict:
    """Step K1 and the plain version side by side from the same table (an
    empty one unless given); every output must be equal at every step."""
    if table is None:
        table = TrackTable.empty(cfg.max_tracks, cfg.trajectory_length, device)
    max_alive = max_matched = 0
    for step in range(steps):
        dets = dets_fn(step)
        want = plain_tracker_step(table, dets, cfg)
        got = tracker_kernel.tracker_step(table, dets, cfg, cfg.min_hits)
        pairs = [(f, getattr(got[0], f), getattr(want[0], f)) for f in TABLE_FIELDS]
        pairs += list(zip(("match", "order", "n_confirmed"), got[1:], want[1:]))
        for field, a, b in pairs:
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"K1 {name} step {step}: {field} differs from the plain version")
        table = want[0]
        max_alive = max(max_alive, int((table.track_id > 0).sum()))
        max_matched = max(max_matched, int((want[1] >= 0).sum()))
    return {"case": name, "T": cfg.max_tracks, "steps": steps, "max_alive": max_alive, "max_matched": max_matched}


def ladder_arrays(t: int, d: int, step: float):
    """A full table of ``t`` live tracks and ``d`` valid detections, as numpy
    arrays: boxes 200 x 100 px, track i at x = i step and detection j at x =
    -j step.  With step 1 the IoU falls with i + j (a staircase), and with
    step 0 every pair has IoU 1; either way each association round accepts
    exactly one pair, (k, k) in round k, the most rounds there are: d + 1.
    Ids ascend with the slot, every track has 3 hits.  Returns the table's
    fields that differ from an empty table, and the detections."""
    def boxes(x):
        x = np.asarray(x, np.float32)
        return np.stack([x, np.zeros_like(x), x + 200, np.full_like(x, 100)], 1)

    table = {"track_id": np.arange(1, t + 1, dtype=np.int32), "bbox": boxes(step * np.arange(t)),
             "hits": np.full(t, 3, np.int32), "next_id": np.int32(t + 1)}
    dets = {"bbox": boxes(-step * np.arange(d)), "class_id": np.zeros(d, np.int32),
            "confidence": np.full(d, 0.9, np.float32), "valid": np.ones(d, bool)}
    return table, dets


def ladder_boxes(t: int, d: int, step: float, device):
    """`ladder_arrays` as a TrackTable (L = 50) and Detections on ``device``."""
    return table_on(*ladder_arrays(t, d, step), device)


def table_on(table: dict, dets: dict, device):
    """A table's fields that differ from an empty one and detections, as
    numpy arrays, as a TrackTable (L = 50) and Detections on ``device``."""
    t = len(table["track_id"])
    empty = TrackTable.empty(t, bench_config().tracker.trajectory_length, device)
    table = dataclasses.replace(empty, **{k: torch.tensor(v, device=device) for k, v in table.items()})
    return table, Detections(**{k: torch.tensor(v, device=device) for k, v in dets.items()})


def ladder_iou(t: int, d: int, step: float) -> np.ndarray:
    """K4's counterpart of `ladder_arrays`: iou[i, j] = (128 - step (i + j))
    / 128, exact in float32 for a step of a multiple of 1/2; with step 1
    the pairs (k, k) stand above 0.3 up to (64, 16), with step 1/2 up to
    (128, 64).  With ranks 0..t-1 round k accepts (k, k)."""
    i, j = np.meshgrid(np.arange(t), np.arange(d), indexing="ij")
    return ((128 - step * (i + j)) / 128).astype(np.float32)


def corner_arrays(t: int, d: int, zero_iou: bool):
    """K1's key-order corners as numpy arrays, like `ladder_arrays`: a full
    table of ``t`` live tracks whose ids are a seeded permutation (so the
    rank by id is not the slot) and ``d`` valid detections.  Every track has
    the box [0, 0, 10, 1]; the even detections [0, 0, 3, 1] stand at IoU
    0.3 exactly (3 / 10 in float32), the threshold, with every track, and
    the odd ones just below it.  With ``zero_iou`` the tracks lie apart
    from every detection instead: each pair has IoU +0, which a threshold of
    0 admits, all tied."""
    ids = np.random.default_rng(t * d).permutation(t).astype(np.int32) + 1
    if zero_iou:
        x = 1000 + 20 * np.arange(t, dtype=np.float32)
        tb = np.stack([x, np.zeros(t), x + 10, np.full(t, 10)], 1)
        y = 20 * np.arange(d, dtype=np.float32)
        db = np.stack([y, np.full(d, 500), y + 10, np.full(d, 510)], 1)
    else:
        tb = np.tile(np.array([0, 0, 10, 1]), (t, 1))
        db = np.array([[0, 0, 3 if j % 2 == 0 else 2.99, 1] for j in range(d)])
    table = {"track_id": ids, "bbox": tb.astype(np.float32), "hits": np.full(t, 3, np.int32),
             "next_id": np.int32(t + 1)}
    dets = {"bbox": db.astype(np.float32), "class_id": np.zeros(d, np.int32),
            "confidence": np.full(d, 0.9, np.float32), "valid": np.ones(d, bool)}
    return table, dets


def boundary_arrays(live: int, at_threshold: int):
    """`corner_arrays(64, 16, False)` with only the first ``live`` tracks
    alive and only the first ``at_threshold`` detections at IoU 0.3, the
    others just below it: exactly live * at_threshold eligible pairs, all
    tied, one accepted a round."""
    table, dets = corner_arrays(64, 16, False)
    table["track_id"][live:] = 0
    table["hits"][live:] = 0
    dets["bbox"][:, 2] = np.where(np.arange(16) < at_threshold, np.float32(3), np.float32(2.99))
    return table, dets


def near_threshold_arrays(seed: int, thr: float = 0.3, pairs: int = 64, tracks: int = 128, dets: int | None = None):
    """A (``tracks``, ``dets``) tracker step, (128, 64) by default, as numpy
    arrays like `corner_arrays`: track m and detection m (m < ``pairs``)
    are boxes of unequal sizes, on a row of their own, whose float32 IoU
    (as the jitted JAX package computes it, `_iou32`) stands 0, 1 or 2 ulps
    from float32(thr), either side; where one of the shifts that give it is
    decided the other way by the union op for op, that shift is taken.  The
    other tracks and detections lie far from every box."""
    rng = np.random.default_rng(seed)
    t = np.float32(thr)
    dets = pairs if dets is None else dets
    tb = _far_boxes(tracks, y=90000.0)
    db = np.concatenate([np.zeros((pairs, 4), np.float32), _far_boxes(dets - pairs, y=95000.0)])
    for m in range(pairs):
        want, y0 = m % 5 - 2, np.float32(300.0 * m)
        for _ in range(1000):
            wa, ha, wb, hb = rng.uniform(20, 100, 4).astype(np.float32)
            ys = np.float32(y0 + rng.uniform(0, 20))
            oh = min(float(y0 + ha), float(ys + hb)) - float(ys)
            iw = thr * (float(wa) * float(ha) + float(wb) * float(hb)) / (1 + thr) / oh
            if not 0 < iw < min(wa, wb):
                continue
            d0 = np.float32(float(wa) - iw)
            d = d0 + np.arange(-64, 65, dtype=np.float32) * np.spacing(d0)
            a = np.array([0, y0, wa, y0 + ha], np.float32)
            b = np.stack([d, np.full_like(d, ys), d + wb, np.full_like(d, ys + hb)], 1).astype(np.float32)
            iou = _iou32(a[None], b)
            hit = np.flatnonzero(iou.view(np.int32) - t.view(np.int32) == want)
            if hit.size:
                flips = hit[(iou[hit] >= t) != (_iou32(a[None], b[hit], contracted=False) >= t)]
                tb[m], db[m] = a, b[(flips if flips.size else hit)[0]]
                break
        else:
            raise AssertionError(f"no pair {want} ulps from {thr} at pair {m}")
    ids = np.random.default_rng(seed + 1).permutation(tracks).astype(np.int32) + 1
    table = {"track_id": ids, "bbox": tb, "hits": np.full(tracks, 3, np.int32), "next_id": np.int32(tracks + 1)}
    return table, {"bbox": db, "class_id": np.zeros(dets, np.int32),
                   "confidence": np.full(dets, 0.9, np.float32), "valid": np.ones(dets, bool)}


# Seeds of `near_threshold_arrays`, K1's near-threshold cases.
NEAR_THRESHOLD_SEEDS = (11, 12)

# (live tracks, detections at the threshold): 32 and 33 eligible pairs, the
# two sides of the association's sparse limit (association.cuh).
BOUNDARY_CASES = ((16, 2), (11, 3))


def check_tracker_kernel(device, steps: int = 50) -> list:
    """K1 against its plain version: churn at (64, 16) and (128, 64), a
    saturated (64, 16) table and a (128, 64) one at full occupancy, the
    staircase and all-equal ladders at (64, 16) (one pair a round, 17
    rounds) and the staircase at (128, 64) (65 rounds), the key-order
    corners of `corner_arrays`, 32 and 33 eligible pairs
    (`boundary_arrays`), IoUs within 2 ulps of the threshold
    (`near_threshold_arrays`), and the synthetic stream at the default size."""
    cases = []
    for t_cap, d_cap, seed in ((64, 16, 1), (128, 64, 2)):
        cfg = pt.TrackerConfig(iou_threshold=0.1, max_age=2, min_hits=3, max_tracks=t_cap)
        rng = np.random.default_rng(seed)
        cases.append(_tracker_case(
            f"churn_{t_cap}x{d_cap}", cfg, lambda s, rng=rng, d=d_cap: random_dets(rng, d, device), steps, device
        ))
    for t_cap, d_cap, seed in ((64, 16, 3), (128, 64, 4)):
        cfg = pt.TrackerConfig(iou_threshold=0.3, max_age=30, min_hits=3, max_tracks=t_cap)
        rng = np.random.default_rng(seed)
        cases.append(_tracker_case(
            f"saturated_{t_cap}x{d_cap}", cfg, lambda s, rng=rng, d=d_cap: random_dets(rng, d, device, p_valid=1.0),
            steps, device,
        ))
        if cases[-1]["max_alive"] != t_cap:
            raise AssertionError(f"the saturated {t_cap}x{d_cap} case never filled its table")
    cfg = bench_config().tracker
    for name, step in (("staircase_64x16", 1.0), ("all_equal_64x16", 0.0)):
        table, dets = ladder_boxes(64, 16, step, device)
        cases.append(_tracker_case(name, cfg, lambda s, dets=dets: dets, 3, device, table=table))
        if cases[-1]["max_matched"] != 16:
            raise AssertionError(f"K1 {name}: the ladder did not match all 16 detections")
    table, dets = ladder_boxes(128, 64, 0.5, device)
    cfg128 = dataclasses.replace(cfg, max_tracks=128)
    cases.append(_tracker_case("staircase_128x64", cfg128, lambda s: dets, 3, device, table=table))
    if cases[-1]["max_matched"] != 64:
        raise AssertionError("K1 staircase_128x64: the ladder did not match all 64 detections")
    # The key-order corners: IoU exactly at the threshold, and +0 IoUs all
    # tied under a threshold of 0; ranks by permuted ids.
    corners = (("threshold_ties_64x16", False, 0.3, 8), ("zero_iou_ties_64x16", True, 0.0, 16))
    for name, zero_iou, thr, matched in corners:
        table, dets = table_on(*corner_arrays(64, 16, zero_iou), device)
        corner_cfg = dataclasses.replace(cfg, iou_threshold=thr)
        cases.append(_tracker_case(name, corner_cfg, lambda s, dets=dets: dets, 3, device, table=table))
        if cases[-1]["max_matched"] != matched:
            raise AssertionError(f"K1 {name}: {cases[-1]['max_matched']} matches, expected {matched}")
    for live, at_threshold in BOUNDARY_CASES:
        table, dets = table_on(*boundary_arrays(live, at_threshold), device)
        name = f"eligible_{live * at_threshold}_64x16"
        cases.append(_tracker_case(name, cfg, lambda s, dets=dets: dets, 1, device, table=table))
        if cases[-1]["max_matched"] != at_threshold:
            raise AssertionError(f"K1 {name}: {cases[-1]['max_matched']} matches, expected {at_threshold}")
    # IoUs within 2 ulps of the threshold, where the union's rounding decides.
    for seed in NEAR_THRESHOLD_SEEDS:
        table, dets = table_on(*near_threshold_arrays(seed), device)
        cases.append(_tracker_case(f"near_threshold_{seed}_128x64", cfg128, lambda s, dets=dets: dets, 1, device,
                                   table=table))
    inputs = synthetic_inputs()
    cases.append(_tracker_case(
        "synthetic_64x16", pt.TrackerConfig(), lambda s: frame_dets(inputs, s, device), NUM_FRAMES, device
    ))
    # Rings off the fast path, on the synthetic stream's first 100 frames:
    # T L odd (a ring that is not a multiple of 16 bytes, wrapping every 5
    # writes), and L = 500 (a ring too large for shared memory).
    for name, t_cap, length in (("odd_ring_63x16", 63, 5), ("long_ring_64x16", 64, 500)):
        cfg = pt.TrackerConfig(max_tracks=t_cap, trajectory_length=length)
        cases.append(_tracker_case(name, cfg, lambda s: frame_dets(inputs, s, device), 100, device))
    return cases


def _kalman_close(got, want, scale=1.0):
    """|got - want| * scale <= atol + rtol |want * scale|, and the worst raw error."""
    err = (got - want).abs()
    ok = bool((err * scale <= K2_ATOL + K2_RTOL * (want * scale).abs()).all())
    return ok, float(err.max())


def kalman_corner_states(hold: float, initial_covariance: float) -> dict:
    """Single ego steps from crafted states, as float32 numpy arrays
    ``(x, P, time, prev_heading, prev_speed, z, has_measurement)``: the
    speed 0.1% below and above ``hold`` (the heading held, then taken from
    atan2; far enough from it that float32 and float64 agree on the side),
    a heading that wraps across +-pi between the predicted and the updated
    state, an unmeasured step with a measurement far off, P at 1e4 on the
    diagonal (S = P1[:4, :4] + R dwarfs R but is well conditioned, about
    1.07), and ``ill_conditioned_P``: 1e4 in every entry plus 1e-3 on the
    diagonal, position, velocity and acceleration fully correlated
    (eigenvalues 1e-3 and 6e4), whose S has a condition number of about
    3.9e4."""
    f32 = np.float32
    P0 = np.eye(6, dtype=f32) * f32(initial_covariance)
    cases = {}
    for name, scale in (("speed_below_hold", 1 - 1e-3), ("speed_above_hold", 1 + 1e-3)):
        v = hold * scale
        x = np.array([1.0, 2.0, v * math.cos(0.7), v * math.sin(0.7), 0.0, 0.0], f32)
        # The measurement equals the prediction: the update leaves the speed.
        z = np.array([x[0] + x[2] * 0.033, x[1] + x[3] * 0.033, x[2], x[3]], f32)
        cases[name] = (x, P0, f32(1.0), f32(0.5), f32(v), z, True)
    x = np.array([0.0, 0.0, -5.0, 0.01, 0.0, 0.0], f32)
    z = np.array([-0.165, 0.0003, -5.0, -0.08], f32)
    cases["heading_wrap"] = (x, P0, f32(2.0), f32(3.14), f32(5.0), z, True)
    x = np.array([3.0, -2.0, 4.0, 1.0, 0.5, -0.2], f32)
    cases["unmeasured"] = (x, P0, f32(3.0), f32(0.2), f32(4.1), np.full(4, 1e3, f32), False)
    x = np.array([10.0, 5.0, 3.0, 1.0, 0.0, 0.0], f32)
    z = np.array([10.5, 4.8, 3.3, 0.9], f32)
    cases["large_P"] = (x, np.eye(6, dtype=f32) * f32(1e4), f32(4.0), f32(0.3), f32(3.2), z, True)
    P = np.full((6, 6), 1e4, f32) + np.eye(6, dtype=f32) * f32(1e-3)
    cases["ill_conditioned_P"] = (x, P, f32(4.0), f32(0.3), f32(3.2), z, True)
    return cases


# Crafted states whose plain step in float32 stands off its own algebra in
# float64 by more than K2's bars: K2 keeps its algebra in double, so it is
# held to `plain_step_float64` there.
KALMAN_FLOAT64_CASES = ("ill_conditioned_P",)


def plain_step_float64(ks, model, z, has, cfg):
    """`_estimator_step_xla` on float64 copies of its inputs, its outputs
    rounded to float32: the plain step without float32's rounding."""
    f64 = torch.float64
    ks64 = KalmanState(*(t.to(f64) for t in (ks.x, ks.P, ks.time, ks.prev_heading, ks.prev_speed)))
    new, vs = _estimator_step_xla(ks64, KalmanModel(*(m.to(f64) for m in model)), z.to(f64), has, cfg)
    new = KalmanState(*(t.float() for t in (new.x, new.P, new.time, new.prev_heading, new.prev_speed)))
    return new, VehicleState(**{f: getattr(vs, f).float() for f in VEHICLE_STATE_FIELDS})


def check_kalman_kernel(device, frames: int = NUM_FRAMES) -> dict:
    """K2 against its plain version, step by step from the plain chain's
    state, every seventh frame unmeasured, then on the single steps of
    `kalman_corner_states`.  x, P and the reported fields are held at atol
    1e-5 + rtol 1e-6 (positions reach 100 m, where one float32 step is
    8e-6); acceleration and yaw rate are finite differences over dt, so
    that bound holds for them times dt.  On `KALMAN_FLOAT64_CASES` the
    reference is `plain_step_float64`, and the float32 plain step's own
    distance from it is reported (``float32_plain_gap``)."""
    cfg = pt.DEFAULT_CONFIG.estimator
    model = kalman_model_from_numpy(
        *make_constant_accel_model(cfg.dt, cfg.process_noise, cfg.measurement_noise, cfg.accel_noise_scale),
        device=device,
    )
    worst, gap = {}, {}

    def compare(label, ks, z, has, plain=_estimator_step_xla):
        want_ks, want_vs = plain(ks, model, z, has, cfg)
        got_ks, got_vs = _estimator_step_fused(ks, model, z, has, cfg)
        checks = [("state.x", got_ks.x, want_ks.x, 1.0), ("state.P", got_ks.P, want_ks.P, 1.0)]
        for name in VEHICLE_STATE_FIELDS:
            scale = cfg.dt if name in ("acceleration", "yaw_rate") else 1.0
            checks.append((name, getattr(got_vs, name), getattr(want_vs, name), scale))
        for name, a, b, scale in checks:
            ok, err = _kalman_close(a, b, scale)
            worst[name] = max(worst.get(name, 0.0), err)
            if not ok:
                raise AssertionError(f"K2 {label}: {name} {a.tolist()} vs plain {b.tolist()}")
        return want_ks

    ego = torch.tensor(ego_motion_stream(frames, dt=1.0 / 30.0, seed=0), dtype=torch.float32, device=device)
    ks = KalmanState.initial(cfg.initial_covariance, device)
    for f in range(frames):
        ks = compare(f"frame {f}", ks, ego[f], torch.tensor(f % 7 != 3, device=device))
    corners = kalman_corner_states(cfg.speed_heading_hold, cfg.initial_covariance)
    for name, (x, P, time0, heading, speed, z, has) in corners.items():
        ks = KalmanState(*(torch.tensor(a, device=device) for a in (x, P, time0, heading, speed)))
        z, has = torch.tensor(z, device=device), torch.tensor(has, device=device)
        if name in KALMAN_FLOAT64_CASES:
            compare(name, ks, z, has, plain_step_float64)
            exact, plain = plain_step_float64(ks, model, z, has, cfg), _estimator_step_xla(ks, model, z, has, cfg)
            gap[name] = {"x": float((plain[0].x - exact[0].x).abs().max()),
                         "P": float((plain[0].P - exact[0].P).abs().max())}
        else:
            compare(name, ks, z, has)
    return {"frames": frames, "unmeasured": sum(f % 7 == 3 for f in range(frames)), "corners": list(corners),
            "max_abs_err": worst, "float32_plain_gap": gap}


TAG_STATE_FIELDS = (
    "scene_votes", "scene_count", "man_history", "man_count",
    "int_centers", "int_len", "int_track_id", "frame_count",
)


def random_tagging_frame(rng, f: int, t_cap: int, d_cap: int, device):
    """tests/test_tagging_pallas.py `_rand_frame` at (t_cap, d_cap): a random
    detection table, a table whose live slots keep their ids (so the center
    rings fill), and a vehicle-state row as kernel K2 writes it."""
    n = int(rng.integers(0, d_cap))
    valid = np.zeros(d_cap, bool)
    valid[:n] = True
    x1, y1 = rng.uniform(0, 600, d_cap), rng.uniform(0, 440, d_cap)
    bw, bh = rng.uniform(5, 80, d_cap), rng.uniform(5, 80, d_cap)

    def on(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    dets = Detections(
        bbox=on(np.stack([x1, y1, x1 + bw, y1 + bh], 1), torch.float32),
        class_id=on(rng.integers(0, 8, d_cap), torch.int32),
        confidence=on(rng.uniform(0.3, 1.0, d_cap), torch.float32),
        valid=on(valid, torch.bool),
    )
    alive = rng.random(t_cap) < 0.4
    tx1, ty1 = rng.uniform(0, 600, t_cap), rng.uniform(0, 440, t_cap)
    tw, th = rng.uniform(5, 120, t_cap), rng.uniform(1, 120, t_cap)
    empty = TrackTable.empty(t_cap, 2, device)
    table = TrackTable(**{
        **{name: getattr(empty, name) for name in TABLE_FIELDS},
        "track_id": on(np.where(alive, np.arange(1, t_cap + 1), 0), torch.int32),
        "bbox": on(np.stack([tx1, ty1, tx1 + tw, ty1 + th], 1), torch.float32),
        "class_id": on(rng.integers(0, 8, t_cap), torch.int32),
        "hits": on(rng.integers(0, 6, t_cap), torch.int32),
        "velocity": on(rng.normal(0, 3, (t_cap, 2)), torch.float32),
        "vel_count": on(rng.integers(0, 3, t_cap), torch.int32),
    })
    row = [rng.uniform(-50, 50), rng.uniform(-50, 50), 0.0, 0.0, rng.uniform(-3.1, 3.1),
           rng.uniform(0, 20), rng.uniform(-4, 2), rng.uniform(-0.4, 0.4), f / 30.0, 1.0, 1.0]
    return dets, table, on(row, torch.float32)


def random_lane_feats(rng, device):
    """tests/test_tagging_pallas.py `_rand_lane_feats`, on the card."""
    lf, rf = bool(rng.random() < 0.7), bool(rng.random() < 0.7)

    def f32(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    lane = LaneObservation(
        left_fit=f32(rng.normal(0, [1e-4, 0.3, 200])),
        right_fit=f32(rng.normal([0, 0, 450], [1e-4, 0.3, 100])),
        left_found=torch.tensor(lf, device=device),
        right_found=torch.tensor(rf, device=device),
        left_confidence=f32(rng.uniform(0, 1)),
        right_confidence=f32(rng.uniform(0, 1)),
        offset_px=f32(rng.normal(0, 10)),
        has_offset=torch.tensor(lf and rf, device=device),
    )
    feats = {
        "center_edge_density": f32(rng.uniform(0, 0.4)),
        "num_long_lines": torch.tensor(int(rng.integers(0, 12)), dtype=torch.int32, device=device),
        "avg_line_length": f32(rng.uniform(50, 300)),
        "green_ratio": f32(rng.uniform(0, 0.3)),
        "brightness": f32(rng.uniform(30, 200)),
        "laplacian_var": f32(rng.uniform(20, 2000)),
    }
    return lane, feats


def crafted_tagging_arrays(rng, f: int, t_cap: int, d_cap: int):
    """Frame ``f`` of a stream built to corner K3's aggregates, as numpy
    arrays in the layout of tests/test_torch_tagging.py `_rand_frame`
    (detections, table fields, vehicle state).  Every slot of six groups
    of t_cap // 8 keeps its id (a fixed permutation, so id order is not slot
    order) and is confirmed, and each group gives one interaction type, all
    in every frame once the cut-ins have 10 frames of history: cut-in (cars
    drifting toward the centre from x = 20 + 3 f, risk 1, confidence 0.7),
    following (identical cars ahead, one TTC of about 5 s: equal minimum
    TTC in every slot of the group), pedestrian crossing, pedestrian
    waiting, cyclist (risk 1, confidence 0.7: ties the cut-ins on risk and
    confidence, decided by id) and near miss.  The six types are all the
    cascade can give; the other seven of the 13 codes never come out of
    it.  The remaining slots are random and come and go.  Over 40 frames
    the 30-entry center rings cross their wrap."""
    ids = np.random.default_rng(t_cap).permutation(t_cap).astype(np.int32) + 1
    g = t_cap // 8
    # Per group: class, box (x1, y1, x2, y2), velocity count.
    groups = (
        (0, (-3 + 3 * f, 277, 37 + 3 * f, 317), 0),  # cut-in, distance about 12
        (0, (300, 123, 340, 163), 1),  # following, distance about 20
        (2, (300, 334, 340, 374), 0),  # pedestrian crossing, distance about 9
        (2, (20, 334, 60, 374), 0),  # pedestrian waiting
        (3, (300, 392, 340, 432), 0),  # cyclist, distance 6
        (0, (300, 280, 340, 480), 0),  # near miss, distance about 2.7
    )
    alive = rng.random(t_cap) < 0.6
    alive[: len(groups) * g] = True
    tx1, ty1 = rng.uniform(0, 600, t_cap), rng.uniform(0, 440, t_cap)
    tw, th = rng.uniform(5, 120, t_cap), rng.uniform(1, 120, t_cap)
    bbox = np.stack([tx1, ty1, tx1 + tw, ty1 + th], 1)
    cls = rng.integers(0, 8, t_cap)
    hits = rng.integers(0, 6, t_cap)
    vel_count = np.zeros(t_cap, np.int32)
    velocity = rng.normal(0, 3, (t_cap, 2))
    for k, (c, box, vc) in enumerate(groups):
        sl = slice(k * g, (k + 1) * g)
        cls[sl], bbox[sl], hits[sl], vel_count[sl] = c, box, 5, vc
        velocity[sl] = (0.0, 6.0)
    n = int(rng.integers(0, d_cap))
    valid = np.zeros(d_cap, bool)
    valid[:n] = True
    x1, y1 = rng.uniform(0, 600, d_cap), rng.uniform(0, 440, d_cap)
    dets = dict(
        bbox=np.stack([x1, y1, x1 + 40, y1 + 40], 1).astype(np.float32),
        class_id=rng.integers(0, 8, d_cap).astype(np.int32),
        confidence=rng.uniform(0.3, 1.0, d_cap).astype(np.float32),
        valid=valid,
    )
    table = dict(
        track_id=np.where(alive, ids, 0).astype(np.int32), bbox=bbox.astype(np.float32),
        class_id=cls.astype(np.int32), hits=hits.astype(np.int32),
        velocity=velocity.astype(np.float32), vel_count=vel_count,
    )
    vs = dict(
        x=rng.uniform(-50, 50), y=rng.uniform(-50, 50), vx=0.0, vy=0.0, heading=rng.uniform(-3.1, 3.1),
        speed=10.0, acceleration=rng.uniform(-4, 2), yaw_rate=rng.uniform(-0.4, 0.4), timestamp=f / 30.0,
        pos_uncertainty=1.0, vel_uncertainty=1.0,
    )
    return dets, table, {k: np.float32(v) for k, v in vs.items()}


def crafted_tagging_frame(rng, f: int, t_cap: int, d_cap: int, device):
    """`crafted_tagging_arrays` on ``device``: detections, table, vehicle row."""
    dets, fields, vs = crafted_tagging_arrays(rng, f, t_cap, d_cap)

    def on(a):
        return torch.tensor(a, device=device)

    empty = TrackTable.empty(t_cap, 2, device)
    table = dataclasses.replace(empty, **{k: on(v) for k, v in fields.items()})
    return (Detections(**{k: on(v) for k, v in dets.items()}), table,
            on(np.array([vs[k] for k in VEHICLE_STATE_FIELDS], np.float32)))


def aggregate_corners(tags: dict, table, ring_len, HI: int) -> dict:
    """Which of K3's corner cases a frame reached, from the plain version's
    tags: every type the cascade gives present at once; the primary
    interaction's (risk rank, confidence) shared by two slots or more, so
    that the id decides; the minimum TTC reached by two slots or more; a
    center ring past its wrap."""
    itype = tags["track_interaction_type"].cpu().numpy()
    risk_rank = np.array([2, 3, 1, 0])[tags["track_interaction_risk"].cpu().numpy()]
    conf = tags["track_interaction_confidence"].cpu().numpy()
    has = itype >= 0
    tie = False
    if has.any():
        best = max(zip(risk_rank[has], -conf[has]))
        tie = int(((risk_rank == best[0]) & (-conf == best[1]) & has).sum()) >= 2
    confirmed = ((table.track_id > 0) & (table.hits >= 3)).cpu().numpy()
    ttc = tags["track_ttc"].cpu().numpy()
    with_ttc = confirmed & tags["track_has_ttc"].cpu().numpy()
    return {
        "all_types": {1, 4, 6, 7, 8, 9} <= set(itype[has].tolist()),
        "primary_tie": tie,
        "equal_min_ttc": bool(with_ttc.any()) and int((ttc[with_ttc] == ttc[with_ttc].min()).sum()) >= 2,
        "ring_wrap": int(ring_len.max()) > HI,
    }


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two float32 tensors equal bit for bit (so +0 is not -0)."""
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _tagging_case(name, cfg, frames, seed, d_cap, frames_mode, device, frame_fn=random_tagging_frame,
                  exact: bool = False) -> dict:
    """Step K3 and the plain version side by side, each threading its own
    state: discrete tags and state equal, floats within their bounds, or,
    with ``exact``, every float bit for bit.  Counts the frames that
    reached each of `aggregate_corners`."""
    rules = TaggingRules.from_config(cfg)
    step = make_packed_tagging_step(cfg)  # CUDA tensors: kernel K3
    T = rules.max_tracks

    def initial():
        return TaggingState.initial(rules.window, rules.history, T, device,
                                    interaction_history=rules.interaction_history)

    s_plain, s_kern = initial(), initial()
    rng = np.random.default_rng(seed)
    worst: dict = {}
    seen = {"road_type_raw": set(), "turning": set(), "primary_interaction": set()}
    corners = dict.fromkeys(("all_types", "primary_tie", "equal_min_ttc", "ring_wrap"), 0)
    for f in range(frames):
        dets, table, vrow = frame_fn(rng, f, T, d_cap, device)
        lane, feats = random_lane_feats(rng, device) if frames_mode else (None, None)
        s_plain, *rows_p = tagging_step_plain(rules, s_plain, dets, table, vrow, lane, feats)
        s_kern, *rows_k = step(s_kern, dets, table, vrow, lane, feats)
        want, got = unpack_tags(*rows_p, T), unpack_tags(*rows_k, T)
        for k, b in want.items():
            a = got[k]
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"K3 {name} frame {f}: {k} is {a.dtype} {tuple(a.shape)}")
            if b.is_floating_point():
                err = _max_abs(a, b)
                worst[k] = max(worst.get(k, 0.0), err)
                if not err <= K3_ATOL or exact and not _bits_equal(a, b):
                    raise AssertionError(f"K3 {name} frame {f}: {k} off by {err}")
            elif not torch.equal(a, b):
                raise AssertionError(f"K3 {name} frame {f}: {k} {a.tolist()} vs plain {b.tolist()}")
        for fld in TAG_STATE_FIELDS:
            a, b = getattr(s_kern, fld), getattr(s_plain, fld)
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"K3 {name} frame {f}: state {fld} is {a.dtype} {tuple(a.shape)}")
            if b.is_floating_point():
                err = _max_abs(a, b)
                worst[f"state.{fld}"] = max(worst.get(f"state.{fld}", 0.0), err)
                if not err <= K3_STATE_ATOL or exact and not _bits_equal(a, b):
                    raise AssertionError(f"K3 {name} frame {f}: state {fld} off by {err}")
            elif not torch.equal(a, b):
                raise AssertionError(f"K3 {name} frame {f}: state {fld} differs from the plain version")
        for k in seen:
            seen[k].add(int(want[k]))
        for k, hit in aggregate_corners(want, table, s_plain.int_len, rules.interaction_history).items():
            corners[k] += hit
    return {"case": name, "T": T, "D": d_cap, "frames": frames, "max_abs_err": worst, "bitwise": exact,
            "distinct": {k: sorted(v) for k, v in seen.items()}, "corner_frames": corners}


def check_tagging_kernel(device, frames=(120, 60, 60, 40)) -> list:
    """K3 against its plain version: detections mode at (64, 16), frames
    mode at (64, 16), and detections mode at (128, 64), on random streams;
    then the crafted stream (`crafted_tagging_arrays`) in detections mode at
    (64, 16) and in frames mode at (128, 64), which must reach every corner
    of `aggregate_corners`; then center rings of odd and of too large a
    size for shared memory."""
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    dense = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=128))
    cases = [
        _tagging_case("detections_64x16", cfg, frames[0], 7, 16, False, device),
        _tagging_case("frames_64x16", cfg.replace(use_frames=True), frames[1], 11, 16, True, device),
        _tagging_case("detections_128x64", dense, frames[2], 13, 64, False, device),
        _tagging_case("crafted_64x16", cfg, frames[3], 17, 16, False, device, crafted_tagging_frame),
        _tagging_case("crafted_frames_128x64", dense.replace(use_frames=True), frames[3], 19, 64, True, device,
                      crafted_tagging_frame),
    ]
    for case in cases[3:5]:
        missed = [k for k, n in case["corner_frames"].items() if n == 0]
        if missed:
            raise AssertionError(f"K3 {case['case']}: the crafted stream never reached {missed}")
    # Rings off the fast path: 63 slots of 29 centers (a ring that is not a
    # multiple of 16 bytes), and 500 centers (too large for shared memory).
    odd = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=63),
                      tagging=dataclasses.replace(cfg.tagging, interaction_history=29))
    long = cfg.replace(tagging=dataclasses.replace(cfg.tagging, interaction_history=500))
    cases.append(_tagging_case("odd_ring_63x16", odd, frames[3], 23, 16, False, device, crafted_tagging_frame))
    cases.append(_tagging_case("long_ring_64x16", long, frames[2], 29, 16, False, device))
    return cases


def random_association(rng, t: int, d: int, tied: bool = False):
    """tests/test_association_pallas.py `_random_case`: IoUs quantized to
    exact ties, dead rows and invalid columns at -1, a random rank
    permutation; with ``tied``, ranks drawn with repeats instead."""
    iou = rng.random((t, d), np.float32)
    q = int(rng.integers(1, 6))
    iou = np.round(iou * q) / q
    alive, valid = rng.random(t) < 0.7, rng.random(d) < 0.8
    iou = np.where(alive[:, None] & valid[None, :], iou, -1.0).astype(np.float32)
    rank = np.argsort(np.argsort(rng.random(t))).astype(np.int32)
    if tied:
        rank = rng.integers(0, max(t // 4, 1), t).astype(np.int32)
    return iou, rank


def full_association(rng, t: int, d: int):
    """A (t, d) matrix with every row alive and every column valid: IoUs
    quantized to exact ties, and a random rank permutation."""
    iou = (np.round(rng.random((t, d)) * 4) / 4).astype(np.float32)
    return iou, np.argsort(np.argsort(rng.random(t))).astype(np.int32)


I32_MIN, I32_MAX = int(np.iinfo(np.int32).min), int(np.iinfo(np.int32).max)
# Ranks at the ends of int32, negative and around zero: their tie-break keys
# rank * D + column wrap in int32, as the plain version computes them.
KEY_RANKS = (I32_MIN, I32_MIN + 1, -7, -1, 0, 1, I32_MAX - 1, I32_MAX)
KEY_CORNER_SHAPES = ((16, 16), (64, 16), (16, 3), (33, 17), (128, 64))
KEY_CORNER_THRESHOLDS = (0.0, 0.3)


def key_corner_values(thr: float) -> np.ndarray:
    """The key-order corners as float32 IoUs: -1, -0.0, +0.0, exactly the
    threshold, a float just below it, NaN, and three IoUs that tie."""
    f32 = np.float32
    # Just below the threshold, but never a subnormal: XLA on the CPU
    # flushes those to zero, so JAX would take -1e-45 for -0.
    below = np.nextafter(f32(thr), f32(-1)) if thr > 0 else f32(-1e-6)
    return np.array([-1.0, -0.0, 0.0, thr, below, np.nan, 0.5, 0.75, 1.0], f32)


def key_corner_ranks(rng, t: int, d: int) -> np.ndarray:
    """``t`` ranks drawn with repeats (tied groups) from `KEY_RANKS` and the
    two ranks whose key rank * d + column crosses int32's end inside the
    row when d is not a power of two."""
    wrap = I32_MAX // d
    pool = np.array(KEY_RANKS + (wrap, -wrap - 1), np.int64)
    return rng.choice(pool, t).astype(np.int32)


def key_corner_association(rng, t: int, d: int, thr: float, keep: int | None = None):
    """A (t, d) matrix on the corners of the association's key order
    (`key_corner_values`) with `key_corner_ranks`.  With ``keep``, all but
    that many entries are -1 (few eligible pairs, as on the paths)."""
    iou = rng.choice(key_corner_values(thr), (t, d), p=[0.2, 0.1, 0.1, 0.15, 0.05, 0.1, 0.1, 0.1, 0.1])
    if keep is not None:
        dead = np.ones(t * d, bool)
        dead[rng.choice(t * d, min(keep, t * d), replace=False)] = False
        iou[dead.reshape(t, d)] = -1.0
    return iou.astype(np.float32), key_corner_ranks(rng, t, d)


def eligible_association(rng, t: int, d: int, thr: float, n: int):
    """A key-order corner matrix with exactly ``n`` eligible entries: those
    drawn from the eligible corners (-0 and +0 under a threshold of 0, the
    threshold, the tied IoUs), every other entry from the others (-1, just
    below the threshold, NaN); ranks from `key_corner_ranks`."""
    vals = key_corner_values(thr)
    ok = (vals >= thr) & (vals >= 0)
    iou = rng.choice(vals[~ok], t * d)
    iou[rng.choice(t * d, n, replace=False)] = rng.choice(vals[ok], n)
    return iou.reshape(t, d).astype(np.float32), key_corner_ranks(rng, t, d)


def check_association_kernel(device, trials: int = 10) -> list:
    """K4 against its plain version, exact, at (64, 16), (64, 64), (128, 64)
    and (16, 16), with rank permutations and with tied ranks; on the empty
    and full (16, 16) matrices; on the (64, 16) staircase and all-equal
    ladders (17 rounds) and the (128, 64) staircase (65 rounds); on
    (128, 64) matrices with nothing dead; on the key-order corners of
    `key_corner_association`; and on exactly 32 and 33 eligible entries
    (`eligible_association`), either side of the sparse limit."""
    cases = []

    def compare(name, iou, rank, thr):
        iou_t = torch.tensor(iou, device=device)
        rank_t = torch.tensor(rank, device=device)
        got = association_kernel.greedy_associate(iou_t, rank_t, thr)
        want = _greedy_associate_plain(iou_t, rank_t, thr)
        if not torch.equal(got, want):
            raise AssertionError(f"K4 {name}: {got.tolist()} vs plain {want.tolist()}")
        return int((want >= 0).sum())

    for t, d in ((64, 16), (64, 64), (128, 64), (16, 16)):
        rng = np.random.default_rng(t * 1000 + d)
        matched = [compare(f"{t}x{d} trial {i}", *random_association(rng, t, d),
                           float(rng.choice([0.0, 0.3, 0.5]))) for i in range(trials)]
        cases.append({"case": f"random_{t}x{d}", "trials": trials, "matched": matched})
        tied = [compare(f"{t}x{d} tied trial {i}", *random_association(rng, t, d, tied=True), 0.3)
                for i in range(trials)]
        cases.append({"case": f"tied_ranks_{t}x{d}", "trials": trials, "matched": tied})
    rank = np.arange(16, dtype=np.int32)
    if compare("empty", np.full((16, 16), -1.0, np.float32), rank, 0.3) != 0:
        raise AssertionError("K4 matched a pair in an empty matrix")
    if compare("full", np.ones((16, 16), np.float32), rank, 0.3) != 16:
        raise AssertionError("K4 left a row of a full matrix unmatched")
    # Two rows of rank 0 at the best IoU of column 0 both take it.
    two = np.full((16, 16), -1.0, np.float32)
    two[0, 0] = two[1, 0] = 0.9
    if compare("tied pair", two, np.zeros(16, np.int32), 0.3) != 2:
        raise AssertionError("K4 did not give column 0 to both rows of a tied pair")
    cases.append({"case": "empty_full_and_tied_pair_16x16"})
    # The ladders: one pair a round, d + 1 rounds; and a (128, 64) matrix
    # with every row alive and every column valid.
    rank = np.arange(64, dtype=np.int32)
    for name, step in (("staircase_64x16", 1), ("all_equal_64x16", 0)):
        if compare(name, ladder_iou(64, 16, step), rank, 0.3) != 16:
            raise AssertionError(f"K4 {name}: the ladder did not match all 16 columns")
        cases.append({"case": name, "matched": 16})
    if compare("staircase_128x64", ladder_iou(128, 64, 0.5), np.arange(128, dtype=np.int32), 0.3) != 64:
        raise AssertionError("K4 staircase_128x64: the ladder did not match all 64 columns")
    cases.append({"case": "staircase_128x64", "matched": 64})
    rng = np.random.default_rng(128064)
    full = [compare(f"full 128x64 trial {i}", *full_association(rng, 128, 64), 0.3) for i in range(trials)]
    cases.append({"case": "full_128x64", "trials": trials, "matched": full})
    # The key-order corners: -0 and +0, IoU at the threshold, NaN, ranks at
    # int32's ends in tied groups.
    for t, d in KEY_CORNER_SHAPES:
        rng = np.random.default_rng(7 * t + d)
        matched = [compare(f"key corners {t}x{d} thr {thr} trial {i}", *key_corner_association(rng, t, d, thr), thr)
                   for thr in KEY_CORNER_THRESHOLDS for i in range(trials)]
        cases.append({"case": f"key_corners_{t}x{d}", "trials": len(matched), "matched": matched})
    # The same corners with at most 32 entries left (the kernel's list of
    # eligible entries) and with just more than 32.
    for t, d in ((64, 16), (128, 64)):
        rng = np.random.default_rng(11 * t + d)
        matched = [compare(f"few corners {t}x{d} keep {keep} thr {thr}",
                           *key_corner_association(rng, t, d, thr, keep=keep), thr)
                   for keep in (24, 40, 64) for thr in KEY_CORNER_THRESHOLDS for _ in range(trials)]
        cases.append({"case": f"key_corners_few_{t}x{d}", "trials": len(matched), "matched": matched})
    for t, d in ((64, 16), (128, 64)):
        rng = np.random.default_rng(13 * t + d)
        matched = [compare(f"eligible {n} {t}x{d} thr {thr}", *eligible_association(rng, t, d, thr, n), thr)
                   for n in (32, 33) for thr in KEY_CORNER_THRESHOLDS for _ in range(trials)]
        cases.append({"case": f"eligible_32_33_{t}x{d}", "trials": len(matched), "matched": matched})
    return cases


def random_nms_case(rng, k: int):
    """tests/test_nms_pallas.py `_random_case`: centres and sizes quantized
    to 10 px (exact IoU ties), scores descending with about a fifth dead."""
    cx, cy = rng.uniform(0, 300, k), rng.uniform(0, 200, k)
    w, h = rng.uniform(20, 120, k), rng.uniform(20, 120, k)
    cx, cy, w, h = (np.round(v / 10) * 10 for v in (cx, cy, w, h))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, k).astype(np.float32))[::-1].copy()
    scores[rng.random(k) < 0.2] = 0.0
    return boxes, np.sort(scores)[::-1].copy()


class NmsCase(NamedTuple):
    """One input of the keep mask: boxes (B, K, 4) and scores (B, K),
    float32, a threshold, the kept count the case is built to give (None:
    not built for one), and whether JAX on the CPU, jitted and in the
    Pallas interpreter, equals the plain version there: "compiled", or
    "none" (XLA on the CPU flushes subnormal IoUs)."""

    boxes: np.ndarray
    scores: np.ndarray
    thr: float
    kept: int | None = None
    jax: str = "compiled"


NMS_SIZES = (1, 31, 32, 33, 63, 65, 255, 257, 1023)
NMS_BATCHES = ((1, 256), (8, 256), (64, 256), (132, 256), (200, 256), (8, 1024))
NMS_NEAR_THRESHOLDS = (0.3, 0.45, 0.7)


def _iou32(a: np.ndarray, b: np.ndarray, contracted: bool = True) -> np.ndarray:
    """`pairwise_iou` of row pairs in float32, as the jitted JAX package
    computes it: the union fma(w_b, h_b, area_a) - inter, one rounding for
    the fma (the float32 product is exact in float64, and on these boxes
    so is the sum); ``contracted=False``: op for op."""
    iw = np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0])
    ih = np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1])
    inter = np.where((iw > 0) & (ih > 0), iw * ih, np.float32(0))
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    w_b, h_b = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
    if contracted:
        total = w_b.astype(np.float64) * h_b + area_a
        assert (total - w_b.astype(np.float64) * h_b == area_a).all()  # exact: one rounding below
        union = total.astype(np.float32) - inter
    else:
        union = area_a + w_b * h_b - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / np.where(union > 0, union, np.float32(1)), np.float32(0))


def _far_boxes(n: int, y: float = 5000.0) -> np.ndarray:
    """``n`` disjoint 10x10 boxes 100 apart on the row at ``y``."""
    x = np.arange(n) * 100.0
    return np.stack([x, np.full(n, y), x + 10.0, np.full(n, y + 10.0)], 1).astype(np.float32)


def _descending(k: int) -> np.ndarray:
    return np.linspace(0.95, 0.05, k).astype(np.float32)


def _pools(rng, b: int, k: int):
    pools = [random_nms_case(rng, k) for _ in range(b)]
    return np.stack([p[0] for p in pools]), np.stack([p[1] for p in pools])


def _chain(n: int, k: int) -> NmsCase:
    """A chain of ``n`` boxes 5 apart (IoU 1/3 with the next, 0 with the one
    after) then ``k - n`` disjoint ones: every other link kept, across words."""
    x = np.arange(n) * 5.0
    chain = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], 1).astype(np.float32)
    boxes = np.concatenate([chain, _far_boxes(k - n)])
    return NmsCase(boxes[None], _descending(k)[None], 0.3, kept=(n + 1) // 2 + k - n)


def _near_threshold(rng, thr: float, pairs: int = 128) -> NmsCase:
    """``pairs`` pairs of boxes, each pair on a row of its own, whose
    float32 IoU stands 0, 1 or 2 ulps from float32(thr), either side, found
    by nudging the second box's shift d in ulps about (w - d) / (w + d) =
    thr.  The pairs' boxes stand in a random order."""
    t = np.float32(thr)
    found = []
    for m in range(pairs):
        want = m % 5 - 2  # ulps from thr
        y0 = np.float32(200.0 * m)
        for _ in range(100):
            w, h = (np.float32(v) for v in rng.uniform(20, 100, 2))
            d0 = np.float32(float(w) * (1 - thr) / (1 + thr))
            d = d0 + np.arange(-64, 65, dtype=np.float32) * np.spacing(d0)
            a = np.array([0, y0, w, y0 + h], np.float32)
            b = np.stack([d, np.full_like(d, y0), d + w, np.full_like(d, y0 + h)], 1).astype(np.float32)
            ulps = _iou32(a[None], b).view(np.int32) - t.view(np.int32)
            hit = np.flatnonzero(ulps == want)
            if hit.size:
                found.append((a, b[hit[0]]))
                break
        else:
            raise AssertionError(f"no pair {want} ulps from {thr} at pair {m}")
    boxes = np.stack([x for pair in found for x in pair])
    order = rng.permutation(len(boxes))
    # The union is not symmetric: the earlier box of a pair is the row.
    first = np.argsort(order)[0::2] < np.argsort(order)[1::2]
    suppressed = sum(int(_iou32(*(pair if f else pair[::-1])) > t) for pair, f in zip(found, first))
    return NmsCase(boxes[order][None], _descending(len(boxes))[None], thr, kept=len(boxes) - suppressed)


def _three_level(c_index: int) -> np.ndarray:
    """K = 128 disjoint boxes but for A at 31, B at 32 (next word) and C at
    ``c_index``: A suppresses B, B would suppress C, A does not reach C."""
    boxes = _far_boxes(128)
    boxes[31] = [0, 0, 10, 10]
    boxes[32] = [3, 0, 13, 10]  # IoU with A 7/13
    boxes[c_index] = [6, 0, 16, 10]  # with A 4/16, with B 7/13
    return boxes


def _degenerate(rng, k: int = 128) -> np.ndarray:
    """Random pools with zero-area, inverted and repeated boxes."""
    boxes, _ = random_nms_case(rng, k)
    idx = rng.permutation(k)
    boxes[idx[:16], 2] = boxes[idx[:16], 0]  # zero width
    boxes[idx[16:32], 3] = boxes[idx[16:32], 1]  # zero height
    boxes[idx[32:48]] = boxes[idx[32:48]][:, [2, 3, 0, 1]]  # inverted
    boxes[idx[48:64]] = boxes[idx[64:80]]  # repeated
    return boxes


def _subnormal_iou(k: int = 32) -> NmsCase:
    """IoUs and intersections below float32's normal range at threshold 0:
    a 1e5 box over a 1e-15 one (IoU about 1e-40) and two equal 1e-20 boxes
    (their intersection about 1e-40), beside disjoint ones.  XLA on the CPU
    flushes these to 0, so JAX cannot be held to this case; the kernel and
    the plain version keep them."""
    boxes = _far_boxes(k, y=-5000.0)
    boxes[0], boxes[1] = [0, 0, 1e5, 1e5], [0, 0, 1e-15, 1e-15]
    boxes[2] = boxes[3] = [-1e-19, -1e-19, -9e-20, -9e-20]
    return NmsCase(boxes[None], _descending(k)[None], 0.0, kept=k - 2, jax="none")


@functools.lru_cache(maxsize=None)
def nms_cases() -> dict:
    """K5's cases, by name, built with numpy from fixed seeds: the sizes
    either side of a 32-bit word at B = 1 and 3, chains that cross words,
    a three-level chain whose middle link sits in the next word, one box
    that suppresses in every later word, IoUs at and within 2 ulps of the
    threshold, thresholds of 0 (touching boxes), below 0 and from 1 up,
    class-offset coordinates at class 79, degenerate boxes, NaN and inf
    coordinates, dead entries between live ones, subnormal IoUs, and
    batches of 1 to 200 images."""
    cases = {}
    for k in NMS_SIZES:
        for b in (1, 3):
            rng = np.random.default_rng(1000 * k + b)
            cases[f"K{k}_B{b}"] = NmsCase(*_pools(rng, b, k), float(rng.choice([0.1, 0.3, 0.45, 0.7])))
    cases["chain_100_K256"] = _chain(100, 256)
    cases["chain_600_K1024"] = _chain(600, 1024)
    cases["three_level_next_word"] = NmsCase(np.stack([_three_level(40), _three_level(95)]),
                                             np.stack([_descending(128)] * 2), 0.45, kept=2 * 127)
    early = _far_boxes(256)
    early[0] = [0, 0, 100, 100]
    for j in [3] + [32 * w + 7 for w in range(1, 8)]:
        early[j] = [1, 1, 100, 100]  # IoU 0.9801 with box 0
    cases["early_box_every_word"] = NmsCase(early[None], _descending(256)[None], 0.45, kept=256 - 8)
    half = _far_boxes(64)
    for i, j in ((0, 1), (31, 32), (10, 50), (62, 63)):
        half[i] = [1000 * i, 0, 1000 * i + 2, 1]
        half[j] = [1000 * i, 0, 1000 * i + 1, 1]  # IoU exactly 0.5
    cases["iou_at_threshold"] = NmsCase(half[None], _descending(64)[None], 0.5, kept=64)
    cases["iou_above_threshold"] = NmsCase(half[None], _descending(64)[None],
                                           float(np.nextafter(np.float32(0.5), np.float32(0))), kept=60)
    rng = np.random.default_rng(77)
    for thr in NMS_NEAR_THRESHOLDS:
        cases[f"near_threshold_{thr}"] = _near_threshold(rng, thr)
    grid = np.arange(64, dtype=np.float32)
    touching = np.stack([grid % 8 * 10, grid // 8 * 10, grid % 8 * 10 + 10, grid // 8 * 10 + 10], 1)
    touching[::5] += 5.0  # some overlap their neighbours
    cases["thr_zero_touching"] = NmsCase(touching[None].astype(np.float32), _descending(64)[None], 0.0)
    for name, thr in (("thr_negative", -0.1), ("thr_one", 1.0), ("thr_above_one", 1.5)):
        boxes, scores = _pools(np.random.default_rng(int(10 * thr) + 50), 2, 96)
        boxes[:, 48:64] = boxes[:, 0:16]  # identical boxes: IoU exactly 1
        cases[name] = NmsCase(boxes, scores, thr)
    rng = np.random.default_rng(79)
    boxes, scores = _pools(rng, 2, 256)
    boxes = boxes * np.float32(2.0)  # up to 640 px
    classes = rng.integers(77, 80, (2, 256)).astype(np.float32)
    cases["class_offset_79"] = NmsCase(boxes + (classes * np.float32(7680.0))[..., None], scores, 0.45)
    rng = np.random.default_rng(17)
    degenerate = np.stack([_degenerate(rng), _degenerate(rng)])
    scores = np.stack([random_nms_case(rng, 128)[1] for _ in range(2)])
    cases["degenerate_boxes"] = NmsCase(degenerate, scores, 0.45)
    cases["degenerate_boxes_thr0"] = NmsCase(degenerate, scores, 0.0)
    boxes, scores = _pools(np.random.default_rng(23), 2, 96)
    bad = np.random.default_rng(24).random(boxes.shape) < 0.08
    boxes[bad] = np.random.default_rng(25).choice(np.float32([np.nan, np.inf, -np.inf]), int(bad.sum()))
    cases["nan_inf_coords"] = NmsCase(boxes, scores, 0.3)
    rng = np.random.default_rng(29)
    boxes, scores = _pools(rng, 2, 96)
    scores = rng.uniform(0.05, 1.0, scores.shape).astype(np.float32)  # live, in no order
    dead = rng.random(scores.shape) < 0.3
    scores[dead] = rng.choice(np.float32([0.0, -0.0, -0.5, np.nan]), int(dead.sum()))
    cases["dead_between_live"] = NmsCase(boxes, scores, 0.45)
    cases["subnormal_iou"] = _subnormal_iou()
    for b, k in NMS_BATCHES:
        rng = np.random.default_rng(b * 7 + k)
        cases[f"batch_{b}x{k}"] = NmsCase(*_pools(rng, b, k), 0.45)
    return cases


def check_nms_kernel(device, trials: int = 8) -> list:
    """K5 against its plain version, exact: tie-quantized pools at K = 16,
    64, 256 and 1024 with thresholds of 0.1 to 0.7, the 24-box suppression
    chain, all dead and all kept, and every case of `nms_cases` (with the
    kept count a case is built for), batches of 1 to 200 pools among them."""
    cases = []

    def compare(name, boxes, scores, thr):
        b = torch.tensor(boxes, device=device).reshape(-1, boxes.shape[-2], 4)
        s = torch.tensor(scores, device=device).reshape(b.shape[:2])
        got = nms_kernel.nms_keep(b, s, thr)
        want = _nms_keep_plain(b, s, thr)
        if not torch.equal(got, want):
            raise AssertionError(f"K5 {name}: {got.int().tolist()} vs plain {want.int().tolist()}")
        return int(want.sum())

    for k in (16, 64, 256, 1024):
        rng = np.random.default_rng(k)
        kept = [compare(f"K={k} trial {i}", *random_nms_case(rng, k), float(rng.choice([0.1, 0.3, 0.45, 0.7])))
                for i in range(trials)]
        cases.append({"case": f"fuzz_K{k}", "trials": trials, "kept": kept})
    n = 24
    chain = np.stack([np.arange(n) * 5.0, np.zeros(n), np.arange(n) * 5.0 + 10.0, np.full(n, 10.0)], 1)
    if compare("chain", chain.astype(np.float32), np.linspace(0.95, 0.5, n).astype(np.float32), 0.3) != (n + 1) // 2:
        raise AssertionError("K5 did not keep every other box of the suppression chain")
    k = 32
    apart = np.stack([np.arange(k) * 100.0, np.zeros(k), np.arange(k) * 100.0 + 10, np.full(k, 10.0)], 1)
    apart = apart.astype(np.float32)
    if compare("all kept", apart, np.linspace(0.9, 0.3, k).astype(np.float32), 0.45) != k:
        raise AssertionError("K5 dropped a box of a disjoint set")
    if compare("all dead", apart, np.zeros(k, np.float32), 0.45) != 0:
        raise AssertionError("K5 kept a dead box")
    cases.append({"case": "chain_all_kept_all_dead"})
    for name, case in nms_cases().items():
        kept = compare(name, case.boxes, case.scores, case.thr)
        if case.kept is not None and kept != case.kept:
            raise AssertionError(f"K5 {name}: kept {kept}, the case is built to keep {case.kept}")
        cases.append({"case": name, "shape": list(case.scores.shape), "thr": case.thr, "kept": kept})
    # Boxes 4 bytes past a 16-byte boundary: the kernel's scalar loads.
    case = nms_cases()["batch_8x256"]
    flat = torch.empty(case.boxes.size + 1, device=device)
    b = flat[1:].view(case.boxes.shape)
    b.copy_(torch.tensor(case.boxes, device=device))
    s = torch.tensor(case.scores, device=device)
    if not torch.equal(nms_kernel.nms_keep(b, s, case.thr), _nms_keep_plain(b, s, case.thr)):
        raise AssertionError("K5 differs from the plain version on boxes that are not 16-byte aligned")
    cases.append({"case": "misaligned_boxes", "shape": list(case.scores.shape)})
    return cases


# --- kernel K6, the planner -------------------------------------------------
# Start states (x, y, heading, speed) of the planner checks: headings near
# +pi and -pi (from y = 0, so that the heading's small sine keeps one sign
# along the straight plan: where it flips, atan2 jumps by 2 pi and either
# side's rounding decides), from rest, backing up (the speed crosses zero
# between waypoints), far from the origin, and a plain one.
PLANNER_STATES = {
    "plain": (3.2, -1.5, 0.12, 9.3),
    "heading_pi": (0.0, 0.0, 3.1415925, 10.0),
    "heading_minus_pi": (0.0, 0.0, -3.1415925, 10.0),
    "zero_speed": (1.0, 2.0, 0.7, 0.0),
    "negative_speed": (-4.0, 1.0, -0.4, -2.0),
    "far_off": (30000.0, -12000.0, 1.1, 12.0),
}
# A grid beyond a warp a candidate: 55 candidates (the block's 32 warps
# loop) of 81 waypoints (three chunks of 32 lanes).
PLANNER_WIDE = pt.PlannerConfig(num_samples=11, target_velocities=(6.0, 8.0, 10.0, 12.0, 14.0), planning_horizon=8.0)
# K6 against its plain version: positions, speeds and costs within 1e-5 of
# their largest magnitude (at least 1).  The two sum in other orders: the
# arc length is a prefix sum over up to 51 speeds (the kernel's warp scan,
# the tensor op's own tree), and a cost a sum of 51 squares a term; float32
# keeps 2^-24 relative a rounding, so the sums part by a few ulps of their
# largest partial sums (2e-7 to 1e-6 relative), the positions by the ulps
# of the arc length they carry.  The order holds exactly but between costs
# within that bar of each other, where either side's rounding decides.
PLAN_RTOL = 1e-5
F32_EPS = 2.0**-23


def plan_fields(pr, best_positions=None, best_velocities=None) -> dict:
    """A plan's fields as float64 numpy arrays (ints as they are)."""
    out = {k: getattr(pr, k).detach().cpu().numpy() for k in
           ("positions", "headings", "velocities", "curvatures", "costs", "order", "best")}
    for k in ("positions", "headings", "velocities", "curvatures", "costs"):
        out[k] = out[k].astype(np.float64)
    if best_positions is not None:
        out["best_positions"] = best_positions.detach().cpu().numpy()
        out["best_velocities"] = best_velocities.detach().cpu().numpy()
    return out


def _plan_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Largest gap over the largest finite magnitude of ``want`` (at least
    1); NaN against NaN is no gap, NaN against a number an infinite one."""
    both = np.isnan(got) & np.isnan(want)
    diff = np.where(both, 0.0, np.abs(got - want))
    diff = np.where(np.isnan(diff), np.inf, diff)
    scale = np.abs(want[np.isfinite(want)])
    return float(diff.max() / max(1.0, scale.max() if scale.size else 1.0))


def hold_plan(label: str, got: dict, want: dict, dt: float) -> dict:
    """One lane's plan from K6 (``got``, `plan_fields`) against its plain
    version (``want``): positions, speeds and costs at PLAN_RTOL; headings
    within 2 ulps of the largest coordinate over the shortest step between
    waypoints (atan2 of neighbours' differences, which carry the
    coordinates' rounding), curvatures within twice that over the smallest
    v dt + 1e-6 (their divisor) and 4 ulps of the largest; the order a
    permutation in which every place holds a cost within the cost bar of
    the plain order's, exactly the stable sort of K6's own costs, and
    ``best`` its first place.  Returns the gaps."""
    gaps = {k: _plan_gap(got[k], want[k]) for k in ("positions", "velocities", "costs")}
    bad = {k: g for k, g in gaps.items() if not g <= PLAN_RTOL}
    pos = want["positions"]
    finite = np.isfinite(pos).all()
    if finite:
        scale = max(1.0, float(np.abs(pos).max()))
        step = float(np.linalg.norm(np.diff(pos, axis=-2), axis=-1).min())
        head_bar = 2 * F32_EPS * scale / step if step > 0 else np.inf
        v = want["velocities"][..., 1:-1] * dt + 1e-6
        kappa = want["curvatures"]
        curv_bar = 2 * head_bar / float(np.abs(v).min()) + 4 * F32_EPS * float(np.abs(kappa).max())
        gaps["headings"] = float(np.abs(got["headings"] - want["headings"]).max())
        gaps["curvatures"] = float(np.abs(got["curvatures"] - kappa).max())
        gaps["heading_bar"], gaps["curvature_bar"] = head_bar, curv_bar
        if not gaps["headings"] <= head_bar:
            bad["headings"] = gaps["headings"]
        if not gaps["curvatures"] <= curv_bar:
            bad["curvatures"] = gaps["curvatures"]
    if bad:
        raise AssertionError(f"{label}: K6 beyond its bars against the plain version: {bad} ({gaps})")
    costs, order = want["costs"], got["order"]
    if sorted(order.tolist()) != list(range(costs.size)):
        raise AssertionError(f"{label}: K6's order {order.tolist()} is not a permutation")
    own = torch.sort(torch.from_numpy(got["costs"]), stable=True).indices.numpy()
    if not np.array_equal(order, own):
        raise AssertionError(f"{label}: K6's order {order.tolist()} is not the stable sort of its costs {own.tolist()}")
    if int(got["best"]) != int(order[0]):
        raise AssertionError(f"{label}: K6's best {int(got['best'])} is not its order's first")
    if not np.isnan(costs).all():
        bar = PLAN_RTOL * max(1.0, float(np.nanmax(np.abs(costs))))
        off = np.abs(costs[order] - costs[want["order"]])
        if not (off <= bar).all():
            raise AssertionError(f"{label}: K6's order {order.tolist()} parts from {want['order'].tolist()} "
                                 f"beyond the cost bar {bar}")
        gaps["order_places_off"] = int((order != want["order"]).sum())
    elif not np.array_equal(order, want["order"]):
        raise AssertionError(f"{label}: with every cost NaN the order is not the index order")
    if "best_positions" in got:
        b = int(got["best"])
        if not (np.array_equal(got["best_positions"], got["positions"][b].astype(np.float32), equal_nan=True)
                and np.array_equal(got["best_velocities"], got["velocities"][b].astype(np.float32), equal_nan=True)):
            raise AssertionError(f"{label}: K6's chosen rows are not candidate {b}'s")
    return gaps


def planner_inputs(case: str, R: int = 64, O: int = 16) -> dict:
    """A case's reference path and obstacles as numpy arrays: a path of R
    points with none, 20 or all valid, or obstacles that the plain plans
    pass inside twice the radius (the hard band) and between twice and
    four times (the soft band), a third one masked; else none."""
    if case.startswith("ref"):
        pts = np.zeros((R, 2), np.float32)
        pts[:, 0] = np.arange(R, dtype=np.float32) * np.float32(1.5)
        pts[:, 1] = np.float32(0.8) + np.sin(np.arange(R, dtype=np.float32) * np.float32(0.2))
        valid = np.arange(R) < {"ref_none": 0, "ref_some": 20, "ref_all": R}[case]
        return dict(reference_positions=pts, reference_valid=valid)
    if case == "obstacles":
        obs = np.zeros((O, 3), np.float32)
        obs[0] = (15.0, 0.5, 2.0)
        obs[1] = (30.0, -3.0, 1.5)
        obs[2] = (20.0, 2.0, 3.0)
        valid = np.zeros(O, bool)
        valid[:2] = True
        return dict(obstacles=obs, obstacles_valid=valid)
    return {}


def _random_lanes(B: int, cfg, seed: int) -> tuple:
    """B random start states, reference paths (a random count of valid
    points, some lanes none) and obstacles (about half masked)."""
    rng = np.random.default_rng(seed)
    R, O = cfg.max_reference_points, cfg.max_obstacles
    states = np.stack([rng.uniform(-50, 50, B), rng.uniform(-50, 50, B), rng.uniform(-np.pi, np.pi, B),
                       rng.uniform(-1, 15, B)], 1).astype(np.float32)
    ref = np.cumsum(rng.uniform(-1, 2, (B, R, 2)), axis=1).astype(np.float32) + states[:, None, :2]
    ref_valid = np.arange(R)[None, :] < rng.integers(0, R + 1, (B, 1))
    obs = np.concatenate([states[:, None, :2] + rng.uniform(-30, 30, (B, O, 2)), rng.uniform(0.5, 3, (B, O, 1))],
                         -1).astype(np.float32)
    obs_valid = rng.uniform(size=(B, O)) < 0.5
    return states, dict(reference_positions=ref, reference_valid=ref_valid, obstacles=obs, obstacles_valid=obs_valid)


def check_planner_kernel(device, lane_counts=None) -> list:
    """K6 against its plain version (`planner.plan_plain`) on the card,
    each lane held by `hold_plan`: the default grid from `PLANNER_STATES`,
    also as K2's vehicle row (bit for bit the state's launch); a NaN
    start (every cost NaN, the index order); the reference path with
    none, some and all points valid; obstacles in the hard and soft bands,
    one masked; ties: every weight 0 (all costs equal) and a target speed
    listed twice (two equal minima, best the first); the grid beyond a warp
    (`PLANNER_WIDE`); and B = 1, 8 and 64 random lanes with paths and
    obstacles, each lane bit for bit its B = 1 launch."""
    cases = []

    def run(label, states, cfg, arrays, lanes):
        st = torch.tensor(states, device=device)
        ins = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}
        got = plan_fields(*planner_kernel.plan_step(st, cfg, **ins))
        gaps = []
        for b in range(lanes):
            lane_ins = {k: v[b] for k, v in ins.items()} if st.dim() > 1 else ins
            lane_st = st[b] if st.dim() > 1 else st
            want = plan_fields(planner.plan_plain(lane_st, cfg, **lane_ins))
            mine = {k: (v[b] if st.dim() > 1 else v) for k, v in got.items()}
            gaps.append(hold_plan(f"K6 {label} lane {b}", mine, want, cfg.dt))
            if st.dim() > 1:
                one = plan_fields(*planner_kernel.plan_step(lane_st.contiguous(), cfg,
                                                            **{k: v.contiguous() for k, v in lane_ins.items()}))
                for k, v in one.items():
                    if not np.array_equal(mine[k], v, equal_nan=np.issubdtype(np.asarray(v).dtype, np.floating)):
                        raise AssertionError(f"K6 {label}: lane {b}'s {k} differs from its B = 1 launch")
        worst = {k: max(g[k] for g in gaps if k in g) for k in gaps[0]}
        cases.append({"case": label, "lanes": lanes, "C": int(got["costs"].shape[-1]),
                      "N": int(got["velocities"].shape[-1]), "worst": worst})
        return got

    cfg = pt.PlannerConfig()
    for name, state in PLANNER_STATES.items():
        got = run(name, np.asarray(state, np.float32), cfg, {}, 1)
        row = torch.zeros(len(VEHICLE_STATE_FIELDS), device=device)
        row[list(planner_kernel.ROW_FIELDS)] = torch.tensor(state, device=device)
        by_row = plan_fields(*planner_kernel.plan_step(row, cfg, fields=planner_kernel.ROW_FIELDS))
        for k, v in by_row.items():
            if not np.array_equal(got[k], v):
                raise AssertionError(f"K6 {name}: {k} from the vehicle row differs from the state's launch")
    run("nan_start", np.asarray((np.nan, 0.0, 0.0, 10.0), np.float32), cfg, {}, 1)
    for case in ("ref_none", "ref_some", "ref_all", "obstacles"):
        run(case, np.asarray(PLANNER_STATES["plain"], np.float32), cfg,
            planner_inputs(case, cfg.max_reference_points, cfg.max_obstacles), 1)
    zero = dataclasses.replace(cfg, w_velocity=0.0, w_acceleration=0.0, w_curvature=0.0)
    got = run("all_costs_equal", np.asarray(PLANNER_STATES["plain"], np.float32), zero, {}, 1)
    if got["order"].tolist() != list(range(cfg.num_candidates)) or int(got["best"]) != 0:
        raise AssertionError(f"K6 all_costs_equal: order {got['order'].tolist()}, best {int(got['best'])}")
    twice = dataclasses.replace(cfg, target_velocities=(10.0, 10.0))
    got = run("two_equal_minima", np.asarray(PLANNER_STATES["plain"], np.float32), twice, {}, 1)
    b = int(got["best"])
    if b % 2 or got["costs"][b] != got["costs"][b + 1] or int(got["order"][1]) != b + 1:
        raise AssertionError(f"K6 two_equal_minima: best {b}, order {got['order'].tolist()}")
    run("wide_55x81", np.asarray(PLANNER_STATES["plain"], np.float32), PLANNER_WIDE, {}, 1)
    for B in lane_counts or LANE_COUNTS:
        states, arrays = _random_lanes(B, cfg, seed=B)
        run(f"lanes_{B}", states, cfg, arrays, B)
    torch.cuda.synchronize()
    return cases


def plan_step_work(B: int, C: int, N: int, R: int = 0, O: int = 0) -> tuple:
    """(bytes, operations) of one K6 launch: the grids (5 vectors) read once,
    a lane's 4 start fields, path and obstacles read, and its outputs
    written once; operations counted from the kernel's arithmetic, 28 a
    waypoint of a candidate (speed 2, arc length 3, blend 1, position 8,
    heading 3, curvature 5, the speed and acceleration terms 6) and 7 a
    reference point or obstacle, plus C comparisons a candidate for the
    order."""
    grids = 4 * (3 * N + 2 * C)
    lane_in = 4 * 4 + R * 9 + O * 13
    lane_out = 4 * (5 * C * N + C + 3 * N) + 4 * (C + 1)
    ops = C * N * (28 + 7 * (R + O)) + C * C
    return grids + B * (lane_in + lane_out), B * ops


def measure_planner_kernel(device, lane_counts=None, reps: int = 2000) -> dict:
    """K6 at the frame step's default grid, from a vehicle row, at each lane
    count: ms a call (CUDA events over ``reps`` wrapper calls, a quarter of
    them beyond one lane), device ms (a profiler trace of 100), the plain
    version's ms (`plan_from_row_plain`, the tensor ops the frame step ran,
    over PLAIN_REPS calls) and the bound."""
    cfg = pt.PlannerConfig()
    out = {}
    for B in lane_counts or LANE_COUNTS:
        states, _ = _random_lanes(B, cfg, seed=100 + B)
        rows = torch.zeros((B, len(VEHICLE_STATE_FIELDS)), device=device)
        rows[:, list(planner_kernel.ROW_FIELDS)] = torch.from_numpy(states).to(device)
        row = rows[0] if B == 1 else rows

        def launch():
            return planner.plan_from_row(row, cfg)

        n_bytes, ops = plan_step_work(B, cfg.num_candidates, cfg.num_waypoints)
        m = {"ms": time_cuda(launch, reps if B == 1 else reps // 4),
             "plain_ms": time_cuda(lambda: planner.plan_from_row_plain(row, cfg), PLAIN_REPS),
             "bytes": n_bytes, "operations": ops}
        m["device_ms"], m["profiled_launches"] = device_times({"plan_step": (launch, "plan_step_kernel")})["plan_step"]
        t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_PER_S * 1e3
        m["bound_ms"], m["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        out[f"lanes_{B}"] = m
    return out


def _zero_counts() -> None:
    for module in KERNEL_MODULES.values():
        module.launches = 0


def _read_counts() -> dict:
    return {name: module.launches for name, module in KERNEL_MODULES.items()}


def compare_outputs(label: str, got: dict, want: dict) -> dict:
    """A card run's outputs against the CPU run's: discrete outputs and
    tags exact, floats within MAIN_ATOL (the TTC tags with TTC_RTOL on
    top), every float finite.  Returns the worst gap of each float."""
    for k in MAIN_DISCRETE:
        if not torch.equal(got[k].cpu(), want[k]):
            raise AssertionError(f"{label}: {k} on the card differs from the CPU run")
    errs = {}
    for k in MAIN_FLOAT:
        errs[k] = float((got[k].cpu() - want[k]).abs().max())
    for name in VEHICLE_STATE_FIELDS:
        errs[f"vehicle_state.{name}"] = float(
            (getattr(got["vehicle_state"], name).cpu() - getattr(want["vehicle_state"], name)).abs().max()
        )
    bad = {k: v for k, v in errs.items() if not v <= MAIN_ATOL}
    if set(got["tags"]) != set(want["tags"]):
        raise AssertionError(f"{label}: the card run's tags differ in their keys from the CPU run's")
    for k, b in want["tags"].items():
        a = got["tags"][k].cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{label}: tag {k} is {a.dtype} {tuple(a.shape)}")
        if not b.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: tag {k} on the card differs from the CPU run")
            continue
        err = (a - b).abs()
        errs[f"tags.{k}"] = float(err.max())
        rtol = TTC_RTOL if k in TTC_TAGS else 0.0
        if not bool((err <= MAIN_ATOL + rtol * b.abs()).all()):
            bad[f"tags.{k}"] = float(err.max())
    if bad:
        raise AssertionError(f"{label}: beyond atol {MAIN_ATOL}: {bad}")
    for k, v in list(got.items()) + [(f"tags.{k}", v) for k, v in got["tags"].items()]:
        if isinstance(v, torch.Tensor) and v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: {k} is not finite")
    return errs


def check_main_path(device, inputs: dict, enable_tagging: bool = False):
    """The runner on the card against the same runner on the CPU; the
    kernels' counts are zeroed just before the card run and read after.
    Returns the summary and the card run's outputs."""
    cfg = bench_config(enable_tagging)
    _, want = pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"), inputs)
    run = pt.make_sequence_runner(cfg, device=device)
    state = pt.initial_state(cfg, device=device)
    _zero_counts()
    _, got = run(state, inputs)
    torch.cuda.synchronize()
    launches = _read_counts()
    errs = compare_outputs("main path", got, want)
    expected = {name: 0 for name in KERNEL_MODULES}
    expected.update(tracker_step=NUM_FRAMES, kalman_step=NUM_FRAMES, plan_step=NUM_FRAMES)
    if enable_tagging:
        expected["tagging_step"] = NUM_FRAMES
    if launches != expected:
        raise AssertionError(f"main path: kernel launches {launches}, expected {expected}")
    summary = {"frames": NUM_FRAMES, "tagging": enable_tagging, "launches": launches, "max_abs_err": errs,
               "num_confirmed_last": int(got["num_confirmed"][-1]), "plan_best_last": int(got["plan_best"][-1])}
    if enable_tagging:
        summary["ttc_beyond_atol"] = any(errs[f"tags.{k}"] > MAIN_ATOL for k in TTC_TAGS)
        summary["distinct"] = {
            k: sorted(set(got["tags"][k].cpu().tolist()))
            for k in ("road_type", "lateral", "longitudinal", "turning", "primary_interaction", "overall_risk")
        }
    return summary, got


def check_association_path(device, inputs: dict, outs: dict) -> dict:
    """The public `ops.greedy_associate` (kernel K4 on the card) on every
    frame of a card run: the table before the frame against its detections.
    It must give K1's match of that frame.  The count is zeroed just before
    and read after."""
    cfg = bench_config(True).tracker
    track_id, bbox, match = outs["track_id"], outs["track_bbox"], outs["match"]
    det_bbox = torch.as_tensor(inputs["bbox"], device=device)
    det_valid = torch.as_tensor(inputs["valid"], device=device)
    i32_max = torch.iinfo(torch.int32).max
    _zero_counts()
    for f in range(NUM_FRAMES):
        if f == 0:
            prev_id = torch.zeros_like(track_id[0])
            prev_bbox = torch.zeros_like(bbox[0])
        else:
            prev_id, prev_bbox = track_id[f - 1], bbox[f - 1]
        alive = prev_id > 0
        iou = torch.where(alive[:, None] & det_valid[f][None, :], pairwise_iou(prev_bbox, det_bbox[f]), -1.0)
        rank = _rank_by_count(torch.where(alive, prev_id, i32_max))
        got = pt.ops.greedy_associate(iou.contiguous(), rank, cfg.iou_threshold)
        if not torch.equal(got, match[f]):
            raise AssertionError(f"association path frame {f}: {got.tolist()} vs K1 {match[f].tolist()}")
    torch.cuda.synchronize()
    launches = _read_counts()
    if launches != {**{name: 0 for name in KERNEL_MODULES}, "associate": NUM_FRAMES}:
        raise AssertionError(f"association path: kernel launches {launches}")
    return {"frames": NUM_FRAMES, "launches": launches, "matched": int((match >= 0).sum())}


def yolo_inputs(num_frames: int = NUM_FRAMES):
    """benchmarks/suite.py:445-451: seeded random 480x640 frames (as uint8:
    the same values in a quarter of the bytes) and the ego stream."""
    frames = np.random.default_rng(0).integers(0, 255, (num_frames, 480, 640, 3)).astype(np.uint8)
    return frames, ego_motion_stream(num_frames, seed=0).astype(np.float32)


def yolo_params(device) -> dict:
    """yolov8n's weights from the port's `init_fn` (Flax's initializers),
    seeded."""
    init_fn, _ = yolov8.make_yolo_detector(device=device)
    return init_fn(torch.Generator().manual_seed(0))


def ultralytics_state_from_port(params: dict) -> dict:
    """yolov8 weights of the port under ultralytics' key names, as numpy
    arrays (the inverse of `yolov8.load_torch_state_dict`): what
    tools/export_weights.py writes into an ``.npz``, so that
    ``ObjectDetector(mode="yolo", model_path=...)`` loads seeded weights."""
    layer_of = {base: layer for layer, base in yolov8._ULTRA_LAYER_TO_PORT.items()}
    out = {}
    for key, value in params.items():
        base, *rest = key.split(".")
        if base == "head":
            rest = rest[0].split("_") + rest[1:]  # cv2_0_1 -> cv2.0.1
        rest = [p for part in rest for p in (["m", part[1:]] if part[:1] == "m" and part[1:].isdigit() else [part])]
        out[".".join(["model", str(layer_of[base]), *rest])] = value.detach().cpu().numpy()
    return out


def relative_gaps(got, want) -> list:
    """Each scale's box and class logits: the largest gap over the largest
    logit."""
    return [float((g.float().cpu() - w.float().cpu()).abs().max() / w.float().abs().max())
            for gs, ws in zip(got, want) for g, w in zip(gs, ws)]


@torch.inference_mode()
def head_outputs(params: dict, frames, device, dtype):
    """The conv tower's head outputs on ``frames`` at YOLO_IMG."""
    model = yolov8.YOLOv8(variant="n", dtype=dtype).to(device)
    model.load_state_dict(params, strict=True)
    x, _, _ = yolov8.preprocess(torch.as_tensor(frames).to(device), YOLO_IMG)
    return model(x)


def check_yolo_tower(device, params: dict, frames):
    """(a) The first chunk's conv tower and decode in float32, the card
    against the CPU: head logits within F32_LOGIT_REL.  Returns the summary
    and the card's head outputs."""
    chunk = frames[:YOLO_BATCH]
    got = head_outputs(params, chunk, device, torch.float32)
    want = head_outputs({k: v.cpu() for k, v in params.items()}, chunk, torch.device("cpu"), torch.float32)
    gaps = relative_gaps(got, want)
    if not max(gaps) <= F32_LOGIT_REL:
        raise AssertionError(f"YOLO tower: the card's head logits stand {gaps} from the CPU's")
    cg = yolov8.candidates_from_outputs([(b.cpu(), c.cpu()) for b, c in got], 1.0, (0, 0))
    cw = yolov8.candidates_from_outputs(want, 1.0, (0, 0))
    return {
        "frames": len(chunk), "relative_gaps": gaps, "bound": F32_LOGIT_REL,
        "max_logit": [float(w.abs().max()) for ws in want for w in ws],
        "decoded_max_abs_err": {k: _max_abs(cg[k], cw[k]) for k in ("boxes", "scores")},
        "class_agreement": float((cg["classes"] == cw["classes"]).double().mean()),
    }, got


YOLO_DEFAULT_FLAGS_FRAMES = 4


def yolo_default_flags(device="cuda", frames: int = YOLO_DEFAULT_FLAGS_FRAMES) -> dict:
    """In a fresh process, with torch's default TF32 flags (cuDNN's on,
    cuBLAS's off): yolov8n's float32 tower on the first ``frames`` seeded
    frames at YOLO_IMG on the card against the CPU, head logits within
    F32_LOGIT_REL of each output's scale (`relative_gaps`), and the flags
    as the process left them after the forward."""
    device = torch.device(device)
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if before != (False, True):
        raise AssertionError(f"YOLO default flags: the process starts with TF32 flags {before}, not torch's defaults")
    params = yolo_params(device)
    chunk = yolo_inputs(frames)[0]
    got = head_outputs(params, chunk, device, torch.float32)
    torch.cuda.synchronize()
    after = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    want = head_outputs({k: v.cpu() for k, v in params.items()}, chunk, torch.device("cpu"), torch.float32)
    gaps = relative_gaps(got, want)
    if not max(gaps) <= F32_LOGIT_REL:
        raise AssertionError(f"YOLO default flags: the card's float32 head logits stand {gaps} from the CPU's")
    if after != before:
        raise AssertionError(f"YOLO default flags: the forward left the TF32 flags at {after}, not {before}")
    return {"frames": frames, "relative_gaps": gaps, "bound": F32_LOGIT_REL, "flags_before": before,
            "flags_after": after, "device": torch.cuda.get_device_name(device)}


def check_yolo_default_flags() -> dict:
    """The `yolo_default_flags` phase: `yolo_default_flags` in a fresh
    process (``python3 chip_smoke.py --yolo-default-flags``), as a user's
    process runs the float32 tower: this one has turned TF32 off for
    itself."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--yolo-default-flags"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"YOLO default flags: the fresh process exited {proc.returncode}: {proc.stderr[-3000:]}")
    return {**json.loads(proc.stdout.strip().splitlines()[-1]), "process_s": time.perf_counter() - t0}


def check_yolo_path(device, params: dict, frames, ego, settings: dict, label: str, cfg=None):
    """The YOLO runner on the card, its counts zeroed just before and read
    after; (b) its detection tables against the plain `nms` run on the CPU
    over the card's own candidates, bit for bit; (c) the CPU pipeline on
    those tables against the card's outputs (`compare_outputs`).  Returns
    the summary and the card's candidates.  ``cfg`` defaults to
    `bench_config()`."""
    cfg = bench_config() if cfg is None else cfg
    _, run = make_yolo_sequence_runner(cfg, batch=YOLO_BATCH, iou_threshold=YOLO_IOU, img_size=YOLO_IMG,
                                       device=device, **settings)
    state = pt.initial_state(cfg, device=device)
    _zero_counts()
    _, outs = run(params, state, frames, ego, keep_candidates=True)
    torch.cuda.synchronize()
    launches = _read_counts()
    expected = {name: 0 for name in KERNEL_MODULES}
    expected.update(tracker_step=len(frames), kalman_step=len(frames), plan_step=len(frames),
                    nms_keep=math.ceil(len(frames) / YOLO_BATCH))
    if launches != expected:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")
    tables, cands = outs.pop("detections"), outs.pop("candidates")
    cpu_cands = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in cands.items()}
    taxonomy = yolov8.taxonomy_map() if settings["map_to_taxonomy"] else None
    want_tables = yolov8.tables_from_candidates(cpu_cands, YOLO_IOU, settings["score_threshold"],
                                                cfg.detector.max_detections, YOLO_PRE_TOPK, taxonomy)
    for k, want in want_tables.items():
        got = tables[k].cpu()
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{label}: the card's {k} table differs from the plain nms on its candidates")
    # The NMS result before the taxonomy drops classes, all frames in one
    # K5 launch against the plain version (outside the counted run).
    kw = dict(iou_threshold=YOLO_IOU, score_threshold=settings["score_threshold"],
              max_det=cfg.detector.max_detections, pre_topk=YOLO_PRE_TOPK)
    got_nms = nms(cands["boxes"], cands["scores"], cands["classes"], **kw)
    want_nms = nms(cpu_cands["boxes"], cpu_cands["scores"], cpu_cands["classes"], **kw)
    for k, want in want_nms._asdict().items():
        if not torch.equal(getattr(got_nms, k).cpu(), want):
            raise AssertionError(f"{label}: nms {k} with K5 differs from the plain nms over all frames")
    inputs = {k: v.cpu() for k, v in tables.items()}
    inputs["ego_measurement"] = ego
    _, want = pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"), inputs)
    errs = compare_outputs(label, outs, want)
    valid = tables["valid"]
    ids = outs["track_id"]
    per_frame = valid.sum(dim=1)
    return {
        "frames": len(frames), "settings": {k: str(v) for k, v in settings.items()}, "launches": launches,
        "nms_kept": int(want_nms.valid.sum()),
        "frames_with_detections": int(valid.any(dim=1).sum()), "detections": int(valid.sum()),
        "valid_per_frame": {"mean": float(per_frame.double().mean()), "max": int(per_frame.max())},
        "track_births": int(torch.unique(ids[ids > 0]).numel()),
        "num_confirmed_last": int(outs["num_confirmed"][-1]), "max_abs_err": errs,
    }, cands


# The frames path: the JAX package's default configuration with the
# serving outputs (benchmarks/suite.py's frames rows), 300 road frames.
LANE_X_ATOL = 1e-3  # a fit's x at rows h, 0.8h and 0.6h, the card against the CPU
LANE_FIT_RTOL = 1e-4  # a fit's linear and constant coefficients
LANE_A_RTOL = 1e-3  # its curvature coefficient, ~1e-5 on straight lanes (tests/test_torch_lanes.py)
LANE_FIELDS = ("left_fit", "right_fit", "left_found", "right_found", "left_confidence", "right_confidence",
               "offset_px", "has_offset")
# The tags that only the frame decides (brightness, Laplacian, lanes): the
# YOLO run with frames must give the frames path's.
FRAME_TAGS = ("cond_night", "cond_day", "cond_day_confidence", "cond_fog", "lane_count")


def frames_config():
    """DEFAULT_CONFIG (frames and tagging on) with the serving outputs."""
    return pt.DEFAULT_CONFIG.replace(emit_candidates=False, emit_trajectories=False)


def frames_inputs(num_frames: int = NUM_FRAMES) -> dict:
    """The synthetic stream with road frames from the port's generator, the
    adjacent lane's dashes scrolling (uint8, 276 MB at 300 frames)."""
    from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import SyntheticRoadGenerator

    frames = SyntheticRoadGenerator(draw_adjacent_dash=True).generate_frames(num_frames)
    return dict(synthetic_inputs(num_frames), frame=frames)


def compare_lane_obs(label: str, got: LaneObservation, want: LaneObservation) -> dict:
    """A card run's lane observations against the CPU run's: the flags, the
    confidences and the offset equal (an offset may differ only where its
    truncated value stands within 1e-3 of an integer), the fits' x at rows
    h, 0.8h and 0.6h within LANE_X_ATOL, their linear and constant
    coefficients within LANE_FIT_RTOL, and the curvature within LANE_A_RTOL
    and by its share of x at the bottom row within LANE_X_ATOL.  Returns
    the largest gaps."""
    g = {k: getattr(got, k).cpu() for k in LANE_FIELDS}
    w = {k: getattr(want, k) for k in LANE_FIELDS}
    for k in ("left_found", "right_found", "has_offset", "left_confidence", "right_confidence"):
        if not torch.equal(g[k], w[k]):
            raise AssertionError(f"{label}: lane {k} on the card differs from the CPU run")
    h = float(frames_config().frame_height)
    flipped = g["offset_px"] != w["offset_px"]
    if bool(flipped.any()):
        for k in ("left_fit", "right_fit"):
            fit = w[k][flipped]
            v = fit[:, 0] * h * h + fit[:, 1] * h + fit[:, 2]
            if not bool(((v - v.round()).abs() <= 1e-3).all()):
                raise AssertionError(f"{label}: lane offset differs where no truncation stands at an integer")
    gaps = {"offset_flips": int(flipped.sum())}
    for k in ("left_fit", "right_fit"):
        a, b = g[k].double(), w[k].double()
        x_gap = max(float(((a[:, 0] - b[:, 0]) * y * y + (a[:, 1] - b[:, 1]) * y + a[:, 2] - b[:, 2]).abs().max())
                    for y in (h, 0.8 * h, 0.6 * h))
        rel = torch.where(a == b, 0.0, (a - b).abs() / b.abs())  # 0 where a frame found no lane
        a_gap = float(((a[:, 0] - b[:, 0]).abs() * h * h).max())
        gaps[k] = {"x_at_rows": x_gap, "rel_a": float(rel[:, 0].max()), "rel_b": float(rel[:, 1].max()),
                   "rel_c": float(rel[:, 2].max()), "a_h2": a_gap}
        if not (x_gap <= LANE_X_ATOL and float(rel[:, 1:].max()) <= LANE_FIT_RTOL and a_gap <= LANE_X_ATOL
                and float(rel[:, 0].max()) <= LANE_A_RTOL):
            raise AssertionError(f"{label}: lane {k} beyond its bounds: {gaps[k]}")
    if not all(bool(torch.isfinite(g[k]).all()) for k in ("left_fit", "right_fit", "offset_px")):
        raise AssertionError(f"{label}: a lane fit is not finite")
    return gaps


def check_frames_path(device, inputs: dict):
    """The frames path: `make_sequence_runner(DEFAULT_CONFIG)` on the card
    over 300 road frames against the same runner on the CPU
    (`compare_outputs` and `compare_lane_obs`), the kernels' counts zeroed
    just before the card run and read after.  Returns the summary and the
    card run's outputs."""
    cfg = frames_config()
    t0 = time.perf_counter()
    _, want = pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"), inputs)
    cpu_s = time.perf_counter() - t0
    run = pt.make_sequence_runner(cfg, device=device)
    state = pt.initial_state(cfg, device=device)
    _zero_counts()
    _, got = run(state, inputs)
    torch.cuda.synchronize()
    launches = _read_counts()
    expected = {name: 0 for name in KERNEL_MODULES}
    expected.update(tracker_step=NUM_FRAMES, kalman_step=NUM_FRAMES, tagging_step=NUM_FRAMES, plan_step=NUM_FRAMES)
    if launches != expected:
        raise AssertionError(f"frames path: kernel launches {launches}, expected {expected}")
    errs = compare_outputs("frames path", got, want)
    lane_gaps = compare_lane_obs("frames path", got["lane_obs"], want["lane_obs"])
    lane = got["lane_obs"]
    summary = {
        "frames": NUM_FRAMES, "config": "DEFAULT_CONFIG", "launches": launches, "max_abs_err": errs,
        "lane_gaps": lane_gaps, "cpu_seconds": cpu_s,
        "lanes_found": {"left": int(lane.left_found.sum()), "right": int(lane.right_found.sum()),
                        "offset": int(lane.has_offset.sum())},
        "distinct": {k: sorted(set(got["tags"][k].cpu().tolist())) for k in ("road_type", "lane_count", "cond_fog")},
        "num_confirmed_last": int(got["num_confirmed"][-1]), "plan_best_last": int(got["plan_best"][-1]),
    }
    return summary, got


def check_yolo_frames(device, params: dict, inputs: dict, frames_out: dict) -> dict:
    """One 64-frame chunk of road frames through `make_yolo_sequence_runner`
    with ``use_frames=True`` in the serving configuration (bf16), its counts
    zeroed just before and read after: every output equals the frames
    runner's on the card fed the same detection tables, and the lane
    observations and the frame-decided tags equal the frames path's on
    those frames (lanes do not depend on detections)."""
    cfg = frames_config()
    n = YOLO_BATCH
    frames, ego = inputs["frame"][:n], inputs["ego_measurement"][:n]
    _, run = make_yolo_sequence_runner(cfg, batch=YOLO_BATCH, iou_threshold=YOLO_IOU, img_size=YOLO_IMG,
                                       device=device, **YOLO_BF16)
    _zero_counts()
    _, outs = run(params, pt.initial_state(cfg, device=device), frames, ego, keep_candidates=True)
    torch.cuda.synchronize()
    launches = _read_counts()
    expected = {name: 0 for name in KERNEL_MODULES}
    expected.update(tracker_step=n, kalman_step=n, tagging_step=n, plan_step=n, nms_keep=1)
    if launches != expected:
        raise AssertionError(f"YOLO with frames: kernel launches {launches}, expected {expected}")
    tables = outs.pop("detections")
    outs.pop("candidates")
    _, want = pt.make_sequence_runner(cfg, device=device)(pt.initial_state(cfg, device=device),
                                                          dict(tables, ego_measurement=ego, frame=frames))
    for k in MAIN_DISCRETE + MAIN_FLOAT:
        if not torch.equal(outs[k], want[k]):
            raise AssertionError(f"YOLO with frames: {k} differs from the frames runner on its tables")
    for k, v in want["tags"].items():
        if not torch.equal(outs["tags"][k], v):
            raise AssertionError(f"YOLO with frames: tag {k} differs from the frames runner on its tables")
    for k in LANE_FIELDS:
        a = getattr(outs["lane_obs"], k)
        if not (torch.equal(a, getattr(want["lane_obs"], k)) and torch.equal(a, getattr(frames_out["lane_obs"], k)[:n])):
            raise AssertionError(f"YOLO with frames: lane {k} differs from the frames path's")
    for k in FRAME_TAGS:
        if not torch.equal(outs["tags"][k], frames_out["tags"][k][:n]):
            raise AssertionError(f"YOLO with frames: tag {k} differs from the frames path's")
    valid = tables["valid"]
    return {"frames": n, "settings": {k: str(v) for k, v in YOLO_BF16.items()}, "launches": launches,
            "detections": int(valid.sum()), "lanes_found": int(outs["lane_obs"].has_offset.sum()),
            "checked": "every output equal to the frames runner on its tables; lanes and frame tags equal to "
                       "the frames path's"}


def tower_flops_per_frame() -> int:
    """The conv tower's FLOPs a frame (2 per multiply-add), counted by
    PyTorch's FLOP counter from the port's own conv shapes on meta
    tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = yolov8.YOLOv8(variant="n")
        x = torch.empty(1, 3, YOLO_IMG, YOLO_IMG)
    with FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops()


def time_cuda(fn, reps: int, warmup: int = 20) -> float:
    """Milliseconds per call by CUDA events over ``reps`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The tracer loses the first records of a trace once the process has
# traced before: on an H100, none in a fresh process, then 6 to 65 of the
# first 100 of a kernel's trace, and more than 256 right after a trace of
# the frames path's 169,000 records.  So every trace opens with fillers,
# launches of a kernel that no measured path launches, and its records are
# read past them; a trace that shows none of its fillers may have lost
# measured records too, and is taken again with eight times as many.
FILLERS = 256
FILLER_TRIES = 3  # 256, 2,048, then 16,384 fillers
FILLER = "spin_kernel"  # `torch.cuda._sleep`'s kernel


def card_trace(body):
    """``body()`` under a profiler trace of the card (``PROFILED``) that
    opens with fillers, finished before the body runs.  Returns the body's
    value and the card's records without the fillers, from the first trace
    that shows at least one of its fillers."""
    fillers = FILLERS
    for _ in range(FILLER_TRIES):
        with torch.profiler.profile(activities=PROFILED) as prof:
            for _ in range(fillers):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            value = body()
            torch.cuda.synchronize()
        on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        records = [e for e in on_device if FILLER not in e.name]
        if len(records) < len(on_device):
            return value, records
        print(f"# a trace shows none of its {fillers} fillers", file=sys.stderr)
        fillers *= 8
    raise AssertionError(f"{FILLER_TRIES} traces each show none of their fillers ({FILLER})")


def traced_device_us(run, kernel_names, reps: int, tries: int = 3, min_seen: int | None = None) -> dict:
    """Device microseconds of each launch of each kernel in
    ``kernel_names`` (a part of its name in the trace; "" takes every
    kernel) while ``run()`` launches each ``reps`` times, from one
    `card_trace` of the card.  A kernel may show one launch short.  The
    tracer also drops a few records now and then past the fillers (3 of
    100 once, on an H100), so a trace that shows fewer is taken again, up
    to ``tries`` traces in all; with ``min_seen``, a trace that shows at
    least that many launches of each kernel is kept."""
    for attempt in range(tries):
        _, on_device = card_trace(run)
        times = {k: [e.time_range.elapsed_us() for e in on_device if k in e.name] for k in kernel_names}
        least = reps - 1 if min_seen is None else min_seen
        short = {k: len(t) for k, t in times.items() if not least <= len(t) <= reps}
        if not short:
            return times
        print(f"# trace {attempt + 1} of {tries} saw {short} launches, expected {reps}", file=sys.stderr)
    raise AssertionError(f"the profiler saw {short} launches, expected {reps}, in each of {tries} traces")


def device_times(launchers: dict, reps: int = 100, min_seen: int | None = None) -> dict:
    """Mean device time of each kernel over ``reps`` calls of its launcher,
    from one profiler trace of the card, and the launches the trace saw.
    ``launchers`` maps a name to the launch function and the kernel's name
    in the trace."""

    def run():
        for fn, _ in launchers.values():
            for _ in range(reps):
                fn()

    times = traced_device_us(run, {k for _, k in launchers.values()}, reps, min_seen=min_seen)
    return {name: (sum(times[k]) / len(times[k]) / 1e3, len(times[k])) for name, (_, k) in launchers.items()}


def launch_floor_ms(reps: int = 100) -> float:
    """The device time of a one-element `add_`, from one profiler trace of
    ``reps`` launches: the least a launch costs on the card, the yardstick
    of the one-block kernels beside their bounds of nanoseconds."""
    x = torch.ones(1, device="cuda")
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            x.add_(1)

    times = traced_device_us(run, {""}, reps)[""]
    return sum(times) / len(times) / 1e3


def host_split(fn, reps: int = 2000, top: int = 8) -> dict:
    """Where a wrapper's host time goes: microseconds a call on the host
    clock over ``reps`` calls (no synchronise inside), then ``cProfile``'s
    own time of each function over another ``reps`` calls, the ``top``
    largest, as microseconds and calls a wrapper call.  The profiler slows
    every Python call, so its total stands above the clock's."""
    import cProfile
    import pstats

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, nc, func) for func, (_, nc, tt, _, _) in stats.items()), reverse=True)
    return {
        "host_us": host_us,
        "profiled_total_us": sum(r[0] for r in rows) / reps * 1e6,
        "split_us": {f"{name} ({Path(file).name}:{line})" if line else name: [tt / reps * 1e6, nc / reps]
                     for tt, nc, (file, line, name) in rows[:top]},
    }


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _tensors(out) -> list:
    """The tensors of a wrapper's result (tuples and tables of them)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if dataclasses.is_dataclass(out):
        return [t for f in dataclasses.fields(out) for t in _tensors(getattr(out, f.name))]
    return [t for o in out for t in _tensors(o)]


def _table_tensors(table):
    return [getattr(table, f) for f in TABLE_FIELDS]


def association_inputs(table, dets):
    """The IoU matrix and row ranks of K1's association for ``table`` and
    ``dets``, as K4 takes them."""
    alive = table.track_id > 0
    iou = torch.where(alive[:, None] & dets.valid[None, :], pairwise_iou(table.bbox, dets.bbox), -1.0).contiguous()
    return iou, _rank_by_count(torch.where(alive, table.track_id, torch.iinfo(torch.int32).max))


def tracker_state(device, inputs: dict, frames: int = 100):
    """The main path's tracker table after ``frames`` synthetic frames (the
    plain version) and the next frame's detections."""
    cfg = bench_config().tracker
    table = TrackTable.empty(cfg.max_tracks, cfg.trajectory_length, device)
    for f in range(frames):
        table = plain_tracker_step(table, frame_dets(inputs, f, device), cfg)[0]
    return table, frame_dets(inputs, frames, device)


def tagging_state(device, inputs: dict, frames: int = 100):
    """The tagging path's state after ``frames`` synthetic frames of the
    runner on the card, and the next frame's detections and vehicle row."""
    cfg = bench_config(True)
    est = cfg.estimator
    model = kalman_model_from_numpy(
        *make_constant_accel_model(est.dt, est.process_noise, est.measurement_noise, est.accel_noise_scale),
        device=device,
    )
    sub = {k: v[:frames] for k, v in inputs.items()}
    st, _ = pt.make_sequence_runner(cfg, device=device)(pt.initial_state(cfg, device=device), sub)
    z = torch.tensor(inputs["ego_measurement"][frames], device=device)
    _, vrow = _estimator_row_fused(st.kalman, model, z, torch.ones((), dtype=torch.bool, device=device), est)
    return TaggingRules.from_config(cfg), st.tagging, frame_dets(inputs, frames, device), st.tracks, vrow


def kalman_state(device, inputs: dict, frames: int = 100):
    """The main path's ego filter after ``frames`` measured synthetic frames
    (the plain version), its model, and the next frame's measurement and
    has-measurement flag (True)."""
    est = bench_config().estimator
    model = kalman_model_from_numpy(
        *make_constant_accel_model(est.dt, est.process_noise, est.measurement_noise, est.accel_noise_scale),
        device=device,
    )
    ego = torch.tensor(inputs["ego_measurement"], device=device)
    ks = KalmanState.initial(est.initial_covariance, device)
    has = torch.ones((), dtype=torch.bool, device=device)
    for f in range(frames):
        ks, _ = _estimator_step_xla(ks, model, ego[f], has, est)
    return ks, model, ego[frames], has


def yolo_chunk_candidates(device, params: dict | None = None) -> dict:
    """The NMS candidates of the YOLO path's first float32 chunk: yolov8n at
    YOLO_IMG on the first 64 seeded frames, in network coordinates."""
    frames, _ = yolo_inputs(YOLO_BATCH)
    outputs = head_outputs(params if params is not None else yolo_params(device), frames, device, torch.float32)
    return yolov8.candidates_from_outputs(outputs, 1.0, (0, 0))


def nms_pools_from(cands: dict) -> dict:
    """K5's inputs (iou_boxes, scores) from the first chunk of the YOLO
    path's float32 candidates, as `nms` builds them: the 64 frames at
    pre_topk 256 (the path's) and the first 8 at 1024 (`nms`'s default)."""
    pools = {}
    for name, b, k in (("yolo_64x256", YOLO_BATCH, YOLO_PRE_TOPK), ("yolo_8x1024", 8, 1024)):
        scores, _, _, iou_boxes = nms_prefilter(*(cands[f][:b] for f in ("boxes", "scores", "classes")),
                                                YOLO_F32["score_threshold"], k)
        pools[name] = (iou_boxes, scores)
    return pools


def nms_variants(device, pools: dict) -> dict:
    """`measure_split`'s K5 inputs, by name: (iou_boxes, scores, threshold)
    on the card."""
    boxes, scores = pools["yolo_64x256"]
    B, K = scores.shape

    def tile(box_rows, score_row):
        b = torch.tensor(np.broadcast_to(box_rows, (B, K, 4)).copy(), device=device)
        return b, torch.tensor(np.broadcast_to(score_row, (B, K)).copy(), device=device)

    chain = nms_cases()["chain_100_K256"]
    alive = _descending(K)
    return {
        "yolo_64x256": (boxes, scores, YOLO_IOU),
        "yolo_8x256": (boxes[:8].contiguous(), scores[:8].contiguous(), YOLO_IOU),
        "yolo_1x256": (boxes[:1].contiguous(), scores[:1].contiguous(), YOLO_IOU),
        "yolo_8x1024": (*pools["yolo_8x1024"], YOLO_IOU),
        "all_dead_64x256": (boxes, torch.zeros_like(scores), YOLO_IOU),
        "all_kept_64x256": (*tile(_far_boxes(K), alive), YOLO_IOU),
        "one_survivor_64x256": (*tile(np.tile(np.float32([[0, 0, 10, 10]]), (K, 1)), alive), YOLO_IOU),
        "chain_100_64x256": (*tile(chain.boxes[0], chain.scores[0]), chain.thr),
    }


def nms_cluster_size(B: int, K: int) -> int | None:
    """The thread block cluster, in blocks an image, that K5 launches with
    at (B, K) on this card, from the built library (None where the library
    has no such query, as a checkout's from before the clusters)."""
    lib = build.kernels()
    path = getattr(lib, "__file__", None) or str(build.BUILD_DIR / "libnms_keep.so")
    query = getattr(ctypes.CDLL(path), "madpp_nms_keep_cluster", None)
    if query is None:
        return None
    query.argtypes, query.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return query(B, K)


def measure_split(device, inputs: dict, nms_pools: dict | None = None) -> dict:
    """Where K1's to K5's time goes, on the wrappers that a path calls.
    The launch floor; each wrapper's host split (`host_split`); and each
    kernel's device time on inputs that remove one part of its work at a
    time: K1 at the main path's state (`tracker_state`), with its
    trajectory ring cut to one point (L = 1), with no valid detection (one
    association round, no birth), on the (64, 16) staircase (17 rounds)
    and on the (128, 64) staircase (65 rounds, the most at the kernel's
    largest shape); K3 at the tagging path's state (`tagging_state`), with
    its center ring cut to one entry (HI = 1) and with 64 detections; K2
    at the main path's filter state (`kalman_state`), measured and
    unmeasured (no update); K4 on the tagging state's matrix, as
    `measure_kernels` times it, on the two staircases, and on a (128, 64)
    matrix with nothing dead (`full_association`); K5 on the YOLO path's
    first float32 chunk (`nms_pools`, from `yolo_chunk_candidates` when not
    given) at (64, 256) as `measure_nms_kernel` times it, its first 8 images
    and its first image, its first 8 at pre_topk 1024, and at (64, 256) all
    dead, all kept (disjoint boxes), one survivor an image (one box
    repeated) and the 100-box chain (`nms_cases`) in every image, with the
    cluster size each launch takes (`nms_cluster_size`)."""
    cfg = bench_config().tracker
    est = bench_config().estimator
    ks, model, z, has = kalman_state(device, inputs)
    table, dets = tracker_state(device, inputs)
    rules, tstate, tdets, ttable, vrow = tagging_state(device, inputs)

    def k1(tab, d):
        return lambda: tracker_kernel.tracker_step(tab, d, cfg, cfg.min_hits)

    def k3(r, s, d):
        return lambda: tagging_kernel.tagging_step(r, s, d, ttable, vrow)

    def k4(iou, rank):
        return lambda: association_kernel.greedy_associate(iou, rank, cfg.iou_threshold)

    def k2(h):
        return lambda: kalman_kernel.kalman_step(ks, model, z, h, est.dt, est.speed_heading_hold)

    no_dets = dataclasses.replace(dets, valid=torch.zeros_like(dets.valid))
    ring1 = dataclasses.replace(table, trajectory=table.trajectory[:, :2].contiguous())
    rules1 = dataclasses.replace(rules, interaction_history=1)
    state1 = dataclasses.replace(tstate, int_centers=tstate.int_centers[:, :2].contiguous())
    dense = random_dets(np.random.default_rng(5), 64, device, p_valid=0.7)
    iou, rank = association_inputs(ttable, tdets)
    stair_table, stair_dets = ladder_boxes(64, 16, 1.0, device)
    stair_iou = torch.tensor(ladder_iou(64, 16, 1), device=device)
    stair_rank = torch.arange(64, dtype=torch.int32, device=device)
    big_table, big_dets = ladder_boxes(128, 64, 0.5, device)
    big_cfg = dataclasses.replace(cfg, max_tracks=128)
    big_iou = torch.tensor(ladder_iou(128, 64, 0.5), device=device)
    big_rank = torch.arange(128, dtype=torch.int32, device=device)
    full_iou, full_rank = (torch.tensor(a, device=device) for a in full_association(np.random.default_rng(5), 128, 64))
    variants = {
        "tracker_step": {"base": k1(table, dets), "ring_L1": k1(ring1, dets), "no_detections": k1(table, no_dets),
                         "staircase_64x16": k1(stair_table, stair_dets),
                         "staircase_128x64": lambda: tracker_kernel.tracker_step(big_table, big_dets, big_cfg,
                                                                                 big_cfg.min_hits)},
        "tagging_step": {"base": k3(rules, tstate, tdets), "ring_HI1": k3(rules1, state1, tdets),
                         "detections_64": k3(rules, tstate, dense)},
        "kalman_step": {"base": k2(has), "unmeasured": k2(torch.zeros_like(has))},
        "associate": {"base": k4(iou, rank), "staircase_64x16": k4(stair_iou, stair_rank),
                      "staircase_128x64": k4(big_iou, big_rank), "full_128x64": k4(full_iou, full_rank)},
    }
    nms_inputs = nms_variants(device, nms_pools or nms_pools_from(yolo_chunk_candidates(device)))
    variants["nms_keep"] = {
        v: (lambda b=b, s=s, t=t: nms_kernel.nms_keep(b, s, t)) for v, (b, s, t) in nms_inputs.items()
    }
    names = {name: f"{name}_kernel" for name in variants}
    device_ms = {
        kernel: {v: device_times({v: (fn, names[kernel])})[v][0] for v, fn in vs.items()}
        for kernel, vs in variants.items()
    }
    return {
        "floor_ms": launch_floor_ms(),
        "device_ms": device_ms,
        "host": {kernel: host_split(next(iter(vs.values()))) for kernel, vs in variants.items()},
        "nms_cluster": {v: nms_cluster_size(*s.shape) for v, (_, s, _) in nms_inputs.items()},
    }


def measure_kernels(device, inputs: dict, reps: int = 2000) -> dict:
    """Each kernel and its plain version at the main path's shapes: the
    tracker table after 100 synthetic frames with frame 101's detections,
    the ego filter after 100 frames with a measured frame, and the tagging
    stage and the association at the tagging path's state after 100
    frames."""
    cfg = bench_config()
    table, dets = tracker_state(device, inputs)
    out = tracker_kernel.tracker_step(table, dets, cfg.tracker, cfg.tracker.min_hits)
    t_cap, d_cap = cfg.tracker.max_tracks, inputs["bbox"].shape[1]
    k1_bytes = _nbytes(*_table_tensors(table), dets.bbox, dets.class_id, dets.confidence, dets.valid) + _nbytes(
        *_table_tensors(out[0]), out[1], out[2], out[3]
    )
    # Counted from the kernel's loops on this run's data: 16 operations an
    # IoU pair, a row and a column scan of the matrix each association round
    # (at most matches + 1 rounds, as each round but the last accepts a
    # pair), and two stable ranks over the slots.
    rounds = int((out[1] >= 0).sum()) + 1
    k1_ops = t_cap * d_cap * (16 + 2 * rounds) + 2 * t_cap * t_cap
    def launch_k1():
        return tracker_kernel.tracker_step(table, dets, cfg.tracker, cfg.tracker.min_hits)

    k1 = {
        "ms": time_cuda(launch_k1, reps),
        "plain_ms": time_cuda(lambda: plain_tracker_step(table, dets, cfg.tracker), PLAIN_REPS),
        "bytes": k1_bytes, "operations": k1_ops, "peak_ops_per_s": PEAK_F32_PER_S,
    }

    est = cfg.estimator
    ks, model, z, has = kalman_state(device, inputs)
    out = kalman_kernel.kalman_step(ks, model, z, has, est.dt, est.speed_heading_hold)
    k2_bytes = _nbytes(ks.x, ks.P, ks.time, ks.prev_heading, z, has, model.F, model.Q, model.R) + _nbytes(
        *_tensors(out)
    )
    # Float64 operations of a measured step, counted from the
    # kernel's loops: predict 573, first extraction 4, innovation covariance
    # and Cholesky 46, gain 192, state update 58, Joseph form 1416, reported
    # extraction 14.
    k2_ops = 573 + 4 + 46 + 192 + 58 + 1416 + 14
    def launch_k2():
        return _estimator_step_fused(ks, model, z, has, est)

    k2 = {
        "ms": time_cuda(launch_k2, reps),
        "plain_ms": time_cuda(lambda: _estimator_step_xla(ks, model, z, has, est), PLAIN_REPS),
        "bytes": k2_bytes, "operations": k2_ops, "peak_ops_per_s": PEAK_F64_PER_S,
    }

    # K3 and K4 at the tagging path's shapes: the card run's state after 100
    # synthetic frames, frame 101's detections and ego step.
    rules, tstate, dets, table, vrow = tagging_state(device, inputs)
    new_state, tag_f, tag_i = tagging_kernel.tagging_step(rules, tstate, dets, table, vrow)
    k3_bytes = tagging_bytes(rules, tstate, dets, table, new_state, tag_f, tag_i)
    k3_ops = tagging_operations(t_cap, d_cap, rules.window, rules.history, rules.interaction_history)

    def launch_k3():
        return tagging_kernel.tagging_step(rules, tstate, dets, table, vrow)

    k3 = {
        "ms": time_cuda(launch_k3, reps),
        "plain_ms": time_cuda(lambda: tagging_step_plain(rules, tstate, dets, table, vrow), PLAIN_REPS),
        "bytes": k3_bytes, "operations": k3_ops, "peak_ops_per_s": PEAK_F32_PER_S,
    }

    iou, rank = association_inputs(table, dets)
    thr = cfg.tracker.iou_threshold
    match = association_kernel.greedy_associate(iou, rank, thr)
    # Counted from the kernel's loops on this run's data: a row scan and a
    # column scan of the matrix and an accepting pass over the rows each
    # round, at most matches + 1 rounds.
    rounds = int((match >= 0).sum()) + 1

    def launch_k4():
        return association_kernel.greedy_associate(iou, rank, thr)

    k4 = {
        "ms": time_cuda(launch_k4, reps),
        "plain_ms": time_cuda(lambda: _greedy_associate_plain(iou, rank, thr), PLAIN_REPS),
        "bytes": _nbytes(iou, rank, match), "operations": rounds * (2 * t_cap * d_cap + t_cap),
        "peak_ops_per_s": PEAK_F32_PER_S, "rounds_at_most": rounds,
    }
    launchers = {
        "tracker_step": (launch_k1, "tracker_step_kernel"),
        "kalman_step": (launch_k2, "kalman_step_kernel"),
        "tagging_step": (launch_k3, "tagging_step_kernel"),
        "associate": (launch_k4, "associate_kernel"),
    }
    for m, (dev_ms, seen) in zip((k1, k2, k3, k4), device_times(launchers).values()):
        m["device_ms"], m["profiled_launches"] = dev_ms, seen
    for m in (k1, k2, k3, k4):
        t_bytes = m["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = m["operations"] / m["peak_ops_per_s"] * 1e3
        m["bound_ms"], m["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return {"tracker_step": k1, "kalman_step": k2, "tagging_step": k3, "associate": k4}


def tagging_bytes(rules, state, dets, table, new_state, tag_f, tag_i) -> int:
    """Bytes one K3 step moves on this frame's data, counted from the
    kernel's reads: the valid flags, the class of each valid detection and
    the confidence of each valid traffic light or stop sign; the table's
    boxes, classes, ids, velocity counts and previous ids, the hits of live
    slots, the forward velocity of slots with a velocity and the ring
    lengths of slots that keep their id; six of the vehicle row's eleven
    floats; the state's counters, and its rings but for the entries this
    frame replaces.  Written: the new rings, lengths, counters and the two
    packed rows."""
    valid = dets.valid
    cls = dets.class_id
    n_valid = int(valid.sum())
    n_signs = int((valid & ((cls == 6) | (cls == 7))).sum())
    alive = table.track_id > 0
    confirmed = alive & (table.hits >= rules.min_hits)
    kept = state.int_track_id == table.track_id
    slots = table.track_id.numel()
    read = (
        valid.numel() + 4 * n_valid + 4 * n_signs
        + slots * (16 + 4 + 4 + 4 + 4) + 4 * int(alive.sum())
        + 4 * int((table.vel_count > 0).sum()) + 4 * int(kept.sum())
        + 4 * 6 + 4 * 3
        + 4 * (rules.window - 1) + 4 * 6 * (rules.history - 1)
        + 4 * (state.int_centers.numel() - 2 * int(confirmed.sum()))
    )
    written = _nbytes(new_state.scene_votes, new_state.man_history, new_state.int_centers,
                      new_state.int_len, tag_f, tag_i) + 4 * 3
    return read + written


def tagging_operations(T: int, D: int, W: int, H: int, HI: int) -> int:
    """Operations of one K3 step, counted from the kernel's loops: per slot
    24 arithmetic operations and 15 comparisons (distance, TTC, centers,
    drift, cascade); one select an entry of the center ring (2 HI a slot)
    and of the maneuver history (6 H); 3 comparisons a slot on each of the
    13 per-type threads and 10 on the count thread; the scene classifier's
    6 a detection, 168 for the scores and total, 12 for the normalised
    argmax, 5 a vote slot and about 60 more; the maneuver detector's
    about 90."""
    return T * (24 + 15 + 13 * 3 + 10 + 2 * HI) + 6 * H + 6 * D + 168 + 12 + 5 * W + 60 + 90


def measure_paths(device, inputs: dict, rounds: int = 2, profiled_frames: int = 100,
                  frames: dict | None = None) -> dict:
    """Frames/s of the main path and of the tagging path over the 300-frame
    stream (and of the frames path over ``frames``, `frames_inputs`, when
    given), on the host clock around runs that end in a synchronise.  After
    a warm run of each, ``rounds`` rounds in the order main, tagging,
    frames, frames, tagging, main, so that a drift in the host's speed falls
    on all; the best run of each counts.  Then a run of each over the
    stream's first ``profiled_frames`` frames under the profiler (reading a
    trace back takes longer the more device items it holds)."""
    configs = {"main_path": bench_config(False), "tagging_path": bench_config(True)}
    streams = {"main_path": inputs, "tagging_path": inputs}
    if frames is not None:
        configs["frames_path"], streams["frames_path"] = frames_config(), frames
    runs = {name: pt.make_sequence_runner(cfg, device=device) for name, cfg in configs.items()}
    xs = {name: {k: torch.as_tensor(v).to(device) for k, v in stream.items()} for name, stream in streams.items()}
    heads = {name: {k: v[:profiled_frames] for k, v in x.items()} for name, x in xs.items()}

    def timed(name, head=False):
        state = pt.initial_state(configs[name], device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name](state, (heads if head else xs)[name])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in configs:
        timed(name)
    times = {name: [] for name in configs}
    order = list(configs)
    for _ in range(rounds):
        for name in order + order[::-1]:
            times[name].append(timed(name))

    # The device's busy share of the wall time and the device work items
    # (kernels, copies) a frame.
    result = {}
    for name in configs:
        wall_s, on_device = card_trace(lambda: timed(name, head=True))
        wall_us = wall_s * 1e6
        busy_us = sum(e.time_range.elapsed_us() for e in on_device)
        result[name] = {
            "frames": NUM_FRAMES, "seconds": times[name], "frames_per_s": NUM_FRAMES / min(times[name]),
            "profiled": {"frames": profiled_frames, "wall_us": wall_us, "device_busy_us": busy_us,
                         "busy_share": busy_us / wall_us,
                         "device_items_per_frame": len(on_device) / profiled_frames},
        }
    return result


def stage_device_us(fn, reps: int) -> tuple[float, float]:
    """Device microseconds and device items (kernels, copies) a call of
    ``fn``, over ``reps`` calls, from one profiler trace, after a warm
    call."""
    fn()
    torch.cuda.synchronize()
    _, on_device = card_trace(lambda: [fn() for _ in range(reps)])
    return sum(e.time_range.elapsed_us() for e in on_device) / reps, len(on_device) / reps


def lane_stage_inputs(device, frame: torch.Tensor) -> dict:
    """The lane step's intermediates on one frame, from the public stage
    functions as `perception.lanes.make_lane_step` chains them, with the
    rounds and host reads of its two Canny hysteresis loops."""
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import hough, image as image_ops

    cfg = frames_config()
    lc = cfg.lanes
    h, w = cfg.frame_height, cfg.frame_width
    st = {"roi": torch.as_tensor(image_ops.trapezoid_roi_mask(h, w, lc.roi_bottom_frac, lc.roi_top_frac,
                                                              lc.roi_top_y_frac), device=device)}
    st["gray"] = image_ops.bgr_to_gray_u8(frame)
    st["blurred"] = image_ops.gaussian_blur5_u8(st["gray"])
    med = image_ops.median_u8(st["blurred"])
    low = torch.floor(torch.clamp(torch.tensor(0.7, device=device) * med, min=0.0))
    high = torch.floor(torch.clamp(torch.tensor(1.3, device=device) * med, max=255.0))
    edges, lane_rounds, lane_reads = image_ops.canny_rounds(st["blurred"], low, high)
    st["masked"] = edges & st["roi"]
    st["scene_edges"], scene_rounds, scene_reads = image_ops.canny_rounds(
        image_ops.downsample2_u8(st["gray"]), 50.0, 150.0)
    st["rounds"], st["reads"] = lane_rounds + scene_rounds, lane_reads + scene_reads
    st["low"], st["high"] = low, high
    passes = (("lane", st["masked"], lc.lane_edge_capacity, (int(h * lc.roi_top_y_frac), h),
               dict(vote_threshold=lc.hough_threshold, max_lines=lc.max_lines), int(math.ceil(math.hypot(h, w)))),
              ("scene", st["scene_edges"], max(256, lc.scene_edge_capacity // 4), None,
               dict(vote_threshold=50, max_lines=lc.scene_max_lines), int(math.ceil(math.hypot(h // 2, w // 2)))))
    for p, edge_map, capacity, rows, kw, diag in passes:
        x, y, valid, _ = hough.compact_edges(edge_map, capacity, rows)
        acc = hough.vote(x, y, valid, lc.num_thetas, diag)
        st[p] = dict(x=x, y=y, valid=valid, acc=acc, kw=kw, diag=diag, capacity=capacity, rows=rows,
                     peaks=hough.select_peaks(acc, **kw)[:2])
    return st


def measure_lane_split(device, frames, reps: int = 10, sweep: int = 100) -> dict:
    """The lane step's device time a frame by stage, on the frames path's
    road frames (each stage on the inputs the step gives it on frame 10):
    gray, blur, median and thresholds, the lane Canny with the ROI mask,
    the scene pass's downsample and Canny, the compaction of both edge
    lists, the voting of both, the peaks and pool of both, the segments of
    both, the fit with the EMA, and the scene statistics, with the device
    items (kernels, copies) each puts on the card; and the whole step on
    the same frame, beside the stages' sum.  Also the hysteresis rounds
    and host reads a frame of both Canny passes over the first ``sweep``
    frames."""
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import hough, image as image_ops
    from multimodal_autonomous_driving_perception_and_planning_torch.perception import lanes

    cfg = frames_config()
    lc = cfg.lanes
    h, w = cfg.frame_height, cfg.frame_width
    frames_dev = torch.as_tensor(frames[:sweep]).to(device)
    rounds = reads = 0
    for f in frames_dev:
        st = lane_stage_inputs(device, f)
        rounds, reads = rounds + st["rounds"], reads + st["reads"]
    frame = frames_dev[10]
    st = lane_stage_inputs(device, frame)
    step = lanes.make_lane_step(cfg, device)
    state = pt.initial_state(cfg, device=device).lanes
    lp, sp = st["lane"], st["scene"]
    hl = hough.hough_segments(st["masked"], min_line_length=lc.hough_min_line_length, num_thetas=lc.num_thetas,
                              edge_capacity=lp["capacity"], row_range=lp["rows"], **lp["kw"])
    _, obs, _ = step(state, frame)
    (lf, _, _), (rf, _, _) = lanes._separate_and_fit(hl.segments, hl.valid, w, h, min_abs_slope=lc.min_abs_slope)
    if not (torch.equal(obs.left_fit, lf) and torch.equal(obs.right_fit, rf)):
        raise AssertionError("lane split: the stages do not chain as the lane step does")
    stages = {
        "gray": lambda: image_ops.bgr_to_gray_u8(frame),
        "blur": lambda: image_ops.gaussian_blur5_u8(st["gray"]),
        "median": lambda: torch.floor(0.7 * image_ops.median_u8(st["blurred"])),
        "lane_canny": lambda: image_ops.canny(st["blurred"], st["low"], st["high"]) & st["roi"],
        "scene_downsample_canny": lambda: image_ops.canny(image_ops.downsample2_u8(st["gray"]), 50.0, 150.0),
        "compaction": lambda: (hough.compact_edges(st["masked"], lp["capacity"], lp["rows"]),
                               hough.compact_edges(st["scene_edges"], sp["capacity"])),
        "voting": lambda: tuple(hough.vote(p["x"], p["y"], p["valid"], lc.num_thetas, p["diag"]) for p in (lp, sp)),
        "peaks_pool": lambda: tuple(hough.select_peaks(p["acc"], **p["kw"]) for p in (lp, sp)),
        "segments": lambda: (
            hough.segments_from_peaks(lp["x"], lp["y"], lp["valid"], *lp["peaks"], lp["diag"], lc.num_thetas,
                                      lc.hough_min_line_length, True),
            hough.segments_from_peaks(sp["x"], sp["y"], sp["valid"], *sp["peaks"], sp["diag"], lc.num_thetas,
                                      50.0, lc.scene_refine)),
        "fit": lambda: lanes._separate_and_fit(hl.segments, hl.valid, w, h, min_abs_slope=lc.min_abs_slope),
        "scene_statistics": lambda: (image_ops.bgr_to_hsv_green_ratio(frame), image_ops.mean_u8(st["gray"]),
                                     image_ops.laplacian_variance(st["gray"]),
                                     image_ops.mean_bool(st["scene_edges"][80:160, 106:213])),
    }
    split = {name: stage_device_us(fn, reps) for name, fn in stages.items()}
    whole_us, whole_items = stage_device_us(lambda: step(state, frame), reps)
    n = len(frames_dev)
    return {"device_us_per_frame": {k: v[0] for k, v in split.items()},
            "device_items_per_frame": {k: v[1] for k, v in split.items()},
            "stages_sum_us": sum(v[0] for v in split.values()), "lane_step_us": whole_us,
            "lane_step_items": whole_items, "frame": 10, "reps": reps,
            "hysteresis": {"frames": n, "canny_calls_per_frame": 2, "rounds_per_frame": rounds / n,
                           "host_reads_per_frame": reads / n}}


def measure_nms_kernel(device, pools: dict, reps: int = 2000) -> dict:
    """K5 and its plain version at the YOLO path's shapes: the first
    chunk's 64 pools of 256 from the float32 run's candidates
    (`nms_pools_from`)."""
    iou_boxes, scores = pools["yolo_64x256"]
    keep = nms_kernel.nms_keep(iou_boxes, scores, YOLO_IOU)

    def launch():
        return nms_kernel.nms_keep(iou_boxes, scores, YOLO_IOU)

    # Counted on this chunk's data: 16 operations an IoU pair of live
    # candidates, and one OR a word of the mask row of each kept one.
    alive = (scores > 0).sum(dim=1).long()
    words = math.ceil(scores.shape[1] / 32)
    m = {
        "ms": time_cuda(launch, reps),
        "plain_ms": time_cuda(lambda: _nms_keep_plain(iou_boxes, scores, YOLO_IOU), PLAIN_REPS),
        "bytes": _nbytes(iou_boxes, scores, keep),
        "operations": int(16 * (alive * (alive - 1) // 2).sum() + words * keep.sum()),
        "peak_ops_per_s": PEAK_F32_PER_S, "shape": list(iou_boxes.shape), "kept": int(keep.sum()),
    }
    m["device_ms"], m["profiled_launches"] = device_times({"nms_keep": (launch, "nms_keep_kernel")})["nms_keep"]
    t_bytes = m["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = m["operations"] / m["peak_ops_per_s"] * 1e3
    m["bound_ms"], m["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return m


def measure_yolo(device, params: dict, frames, ego, rounds: int = 2, reps: int = 3,
                 profiled_frames: int = 100) -> dict:
    """The detection chunk by stage (letterbox, conv tower, decode, NMS
    with K5) by CUDA events over ``reps`` chunks after a warm one, in both
    dtypes, with the tower's achieved share of the data sheet's peak; then
    the YOLO path's frames/s, timed in turns (float32, bf16, bf16, float32)
    after a warm run of each, and its device busy share over the first
    ``profiled_frames`` frames."""
    flops = tower_flops_per_frame()
    chunk = torch.as_tensor(frames[:YOLO_BATCH]).to(device)
    cfg = bench_config()
    settings = {"float32": YOLO_F32, "bfloat16": YOLO_BF16}
    peaks = {"float32": PEAK_F32_PER_S, "bfloat16": PEAK_BF16_PER_S}
    result = {"tower_flops_per_frame": flops, "chunk": {}, "path": {}}
    for name, st in settings.items():
        model = yolov8.YOLOv8(variant="n", dtype=st["compute_dtype"]).to(device)
        model.load_state_dict(params, strict=True)
        taxonomy = yolov8.taxonomy_map() if st["map_to_taxonomy"] else None
        stages = ("letterbox", "tower", "decode", "nms")
        totals = dict.fromkeys(stages, 0.0)
        with torch.inference_mode():
            for rep in range(reps + 1):
                events = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
                events[0].record()
                x, scale, pad = yolov8.preprocess(chunk, YOLO_IMG)
                events[1].record()
                outputs = model(x)
                events[2].record()
                cands = yolov8.candidates_from_outputs(outputs, scale, pad)
                events[3].record()
                yolov8.tables_from_candidates(cands, YOLO_IOU, st["score_threshold"],
                                              cfg.detector.max_detections, YOLO_PRE_TOPK, taxonomy)
                events[4].record()
                torch.cuda.synchronize()
                if rep:
                    for i, stage in enumerate(stages):
                        totals[stage] += events[i].elapsed_time(events[i + 1]) / reps
        tower_s = totals["tower"] / 1e3
        result["chunk"][name] = {
            "frames": YOLO_BATCH, "ms": totals, "ms_per_frame": sum(totals.values()) / YOLO_BATCH,
            "tower_tflops_per_s": flops * YOLO_BATCH / tower_s / 1e12,
            "tower_share_of_peak": flops * YOLO_BATCH / tower_s / peaks[name], "peak_per_s": peaks[name],
        }

    runs = {name: make_yolo_sequence_runner(cfg, batch=YOLO_BATCH, iou_threshold=YOLO_IOU, img_size=YOLO_IMG,
                                            device=device, **st)[1] for name, st in settings.items()}

    def timed(name, n=len(frames)):
        state = pt.initial_state(cfg, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name](params, state, frames[:n], ego[:n])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in settings:
        timed(name)
    times = {name: [] for name in settings}
    for _ in range(rounds):
        for name in ("float32", "bfloat16", "bfloat16", "float32"):
            times[name].append(timed(name))
    for name in settings:
        wall_s, on_device = card_trace(lambda: timed(name, profiled_frames))
        wall_us = wall_s * 1e6
        busy_us = sum(e.time_range.elapsed_us() for e in on_device)
        result["path"][name] = {
            "frames": len(frames), "seconds": times[name], "frames_per_s": len(frames) / min(times[name]),
            "profiled": {"frames": profiled_frames, "wall_us": wall_us, "device_busy_us": busy_us,
                         "busy_share": busy_us / wall_us, "device_items": len(on_device)},
        }
    return result


# --- the lane axis: K1-K3 over B lanes, the batched runner, the multi-camera
# runner, the server, the Kalman bank --------------------------------------

LANE_COUNTS = (1, 8, 64)
LANE_STEPS = {1: 12, 8: 12, 64: 6}  # steps of each lane check (the plain version runs lane by lane)
BATCHED_LANES = 8  # the server's --batch, the batched path's and the multi-camera path's lanes
PLANNER_FLOATS = ("plan_costs", "plan_best_positions", "plan_best_velocities")
SERVE_CHUNK, SERVE_SESSIONS, SERVE_CHUNKS = 64, 8, 4


def _lane_ops():
    """The port's lane helpers, imported when called, so that
    `split_compare.py` can load this script against a checkout without them."""
    from multimodal_autonomous_driving_perception_and_planning_torch.types import lane_of, stack_lanes

    return lane_of, stack_lanes


def _assert_same(label: str, got, want) -> None:
    """Every tensor of ``got`` equal to ``want``'s, dtypes and bits."""
    for i, (a, b) in enumerate(zip(_tensors(got), _tensors(want), strict=True)):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{label}: output {i} differs")


def _lane_tracker_case(name, cfg, B, steps, d_cap, device, seed) -> dict:
    """K1 over B lanes of distinct random streams, each step from the plain
    chain's tables: the batched launch equal to each lane's plain step and
    to each lane's B = 1 launch, every output, bit for bit."""
    lane_of, stack_lanes = _lane_ops()
    rngs = [np.random.default_rng(seed + 1000 * b) for b in range(B)]
    tables = [TrackTable.empty(cfg.max_tracks, cfg.trajectory_length, device)] * B
    matched = 0
    for step in range(steps):
        dets = [random_dets(rng, d_cap, device) for rng in rngs]
        got = tracker_kernel.tracker_step(stack_lanes(tables), stack_lanes(dets), cfg, cfg.min_hits)
        want = [plain_tracker_step(t, d, cfg) for t, d in zip(tables, dets)]
        ones = [tracker_kernel.tracker_step(t, d, cfg, cfg.min_hits) for t, d in zip(tables, dets)]
        _assert_same(f"K1 {name} B={B} step {step} against the plain version", got, stack_lanes(want))
        _assert_same(f"K1 {name} B={B} step {step} against B = 1 launches", got, stack_lanes(ones))
        tables = [w[0] for w in want]
        matched += int((got[1] >= 0).sum())
    return {"case": name, "B": B, "steps": steps, "matches": matched}


def _lane_kalman_case(B, steps, device, seed) -> dict:
    """K2 over B lanes of distinct ego streams (some frames unmeasured),
    each step from the plain chain's states: the batched launch bit for bit
    each lane's B = 1 launch, and within K2's bounds of the plain step."""
    lane_of, stack_lanes = _lane_ops()
    cfg = pt.DEFAULT_CONFIG.estimator
    model = kalman_model_from_numpy(
        *make_constant_accel_model(cfg.dt, cfg.process_noise, cfg.measurement_noise, cfg.accel_noise_scale),
        device=device,
    )
    ego = torch.tensor(np.stack([ego_motion_stream(steps, dt=cfg.dt, seed=seed + b) for b in range(B)]),
                       dtype=torch.float32, device=device)
    has = torch.tensor(np.random.default_rng(seed).random((B, steps)) < 0.85, device=device)
    states = [KalmanState.initial(cfg.initial_covariance, device)] * B
    worst = 0.0
    for f in range(steps):
        z, h = ego[:, f].contiguous(), has[:, f].contiguous()
        got = kalman_kernel.kalman_step(stack_lanes(states), model, z, h, cfg.dt, cfg.speed_heading_hold)
        ones = [kalman_kernel.kalman_step(s, model, z[b], h[b], cfg.dt, cfg.speed_heading_hold)
                for b, s in enumerate(states)]
        _assert_same(f"K2 B={B} frame {f} against B = 1 launches", got, stack_lanes(ones))
        for b, s in enumerate(states):
            want_ks, want_vs = _estimator_step_xla(s, model, z[b], h[b], cfg)
            got_ks, got_vs = lane_of(got[0], b), vehicle_state_from_row(got[1][b])
            checks = [(got_ks.x, want_ks.x, 1.0), (got_ks.P, want_ks.P, 1.0)] + [
                (getattr(got_vs, n), getattr(want_vs, n), cfg.dt if n in ("acceleration", "yaw_rate") else 1.0)
                for n in VEHICLE_STATE_FIELDS
            ]
            for a, w, scale in checks:
                ok, err = _kalman_close(a, w, scale)
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(f"K2 B={B} frame {f} lane {b}: {a.tolist()} vs plain {w.tolist()}")
            states[b] = want_ks
    return {"case": "ego_streams", "B": B, "steps": steps, "unmeasured": int((~has).sum()), "max_abs_err": worst}


def _lane_tagging_case(name, cfg, B, steps, d_cap, frames_mode, device, seed) -> dict:
    """K3 over B lanes of distinct random frames, each step from the plain
    chain's states: the batched launch bit for bit each lane's B = 1
    launch (rows and state), its discrete tags and state equal to the plain
    version's and its floats within K3's bounds."""
    lane_of, stack_lanes = _lane_ops()
    rules = TaggingRules.from_config(cfg)
    T = rules.max_tracks
    rngs = [np.random.default_rng(seed + 1000 * b) for b in range(B)]
    states = [TaggingState.initial(rules.window, rules.history, T, device,
                                   interaction_history=rules.interaction_history)] * B
    worst = 0.0
    for f in range(steps):
        frames = [random_tagging_frame(rng, f, T, d_cap, device) for rng in rngs]
        lanes = [random_lane_feats(rng, device) if frames_mode else (None, None) for rng in rngs]
        lane_rows = feat_rows = None
        if frames_mode:
            lane_rows = torch.stack([torch.cat([l.left_fit, l.right_fit, torch.stack([l.left_found, l.right_found]).float()])
                                     for l, _ in lanes])
            feat_rows = torch.stack([torch.stack([fe[k].float() for k in (
                "center_edge_density", "num_long_lines", "avg_line_length", "green_ratio", "brightness",
                "laplacian_var")]) for _, fe in lanes])
        dets, tables, vrows = (stack_lanes([fr[i] for fr in frames]) for i in range(3))
        got = tagging_kernel.tagging_step(rules, stack_lanes(states), dets, tables, vrows, lane_rows, feat_rows)
        ones = [tagging_kernel.tagging_step(rules, s, *frames[b],
                                            None if lane_rows is None else lane_rows[b],
                                            None if feat_rows is None else feat_rows[b])
                for b, s in enumerate(states)]
        _assert_same(f"K3 {name} B={B} frame {f} against B = 1 launches", got, stack_lanes(ones))
        for b, s in enumerate(states):
            want = tagging_step_plain(rules, s, *frames[b], *lanes[b])
            got_b = lane_of(got, b)
            for a, w in zip(_tensors(got_b), _tensors(want), strict=True):
                if a.dtype != w.dtype or a.shape != w.shape:
                    raise AssertionError(f"K3 {name} B={B} frame {f} lane {b}: {a.dtype} {tuple(a.shape)}")
                if w.is_floating_point():
                    err = _max_abs(a, w)
                    worst = max(worst, err)
                    if not err <= K3_ATOL:
                        raise AssertionError(f"K3 {name} B={B} frame {f} lane {b}: off by {err}")
                elif not torch.equal(a, w):
                    raise AssertionError(f"K3 {name} B={B} frame {f} lane {b}: differs from the plain version")
            states[b] = want[0]
    return {"case": name, "B": B, "steps": steps, "max_abs_err": worst}


def check_lane_kernels(device, lane_counts=LANE_COUNTS, steps: dict | None = None) -> list:
    """K1, K2 and K3 at B lanes a launch, each lane on its own stream:
    every lane equal to its B = 1 launch (bit for bit) and to its plain
    version (K1 and K3's discrete outputs exact, floats within their
    bounds); at B = 8 also K1 and K3 on rings of 63 slots (lanes off
    16-byte alignment), K3 in frames mode at (128, 64)."""
    steps = steps or LANE_STEPS
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    odd = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=63, trajectory_length=7),
                      tagging=dataclasses.replace(cfg.tagging, interaction_history=29))
    dense = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=128))
    cases = []
    for B in lane_counts:
        n = steps[B]
        cases.append(_lane_tracker_case("churn_64x16", cfg.tracker, B, n, 16, device, 31))
        cases.append(_lane_kalman_case(B, n, device, 37))
        cases.append(_lane_tagging_case("detections_64x16", cfg, B, n, 16, False, device, 41))
        cases.append(_lane_tagging_case("frames_64x16", cfg, B, n, 16, True, device, 43))
        if B == 8:
            cases.append(_lane_tracker_case("odd_ring_63x16", odd.tracker, B, n, 16, device, 47))
            cases.append(_lane_tagging_case("odd_ring_63x16", odd, B, n, 16, False, device, 53))
            cases.append(_lane_tagging_case("frames_128x64", dense, B, n, 64, True, device, 59))
    return cases


def lane_streams(B: int, num_frames: int = NUM_FRAMES) -> list:
    """B distinct synthetic streams: the detector's counter phase and the
    ego noise's seed differ a lane (tests/test_multicamera.py's streams)."""
    out = []
    for b in range(B):
        dets = simulated_detection_stream(num_frames, start_frame_count=1 + 7 * b)
        ego = ego_motion_stream(num_frames, dt=1.0 / 30.0, seed=b).astype(np.float32)
        out.append(dict(dets, ego_measurement=ego))
    return out


def _stack_streams(streams: list) -> dict:
    return {k: np.stack([s[k] for s in streams]) for k in streams[0]}


def compare_lane(label: str, got: dict, b: int, want: dict) -> float:
    """Lane ``b`` of a batched card run against an unbatched card run: every
    output and tag bit for bit, the planner's floats too (the kernels, K6
    among them, run each lane as its B = 1 launch does); returns the
    planner floats' largest gap, 0 where they hold."""
    gap = 0.0
    for k, w in want.items():
        if k == "tags":
            for t, v in w.items():
                if not torch.equal(got["tags"][t][b], v):
                    raise AssertionError(f"{label}: lane {b} tag {t} differs from its unbatched run")
        elif k == "vehicle_state":
            for f in VEHICLE_STATE_FIELDS:
                if not torch.equal(getattr(got[k], f)[b], getattr(w, f)):
                    raise AssertionError(f"{label}: lane {b} vehicle_state.{f} differs from its unbatched run")
        elif k in PLANNER_FLOATS and not torch.equal(got[k][b], w):
            gap = max(gap, float((got[k][b] - w).abs().max()))
            raise AssertionError(f"{label}: lane {b} {k} off by {gap} from its unbatched run")
        elif not torch.equal(got[k][b], w):
            raise AssertionError(f"{label}: lane {b} {k} differs from its unbatched run")
    return gap


def _singles(cfg, device, streams: list) -> list:
    run = pt.make_sequence_runner(cfg, device=device)
    return [run(pt.initial_state(cfg, device=device), s) for s in streams]


def check_batched_path(device, streams: list) -> dict:
    """The tagging path at B lanes (`make_batched_sequence_runner`) on the
    card, its counts zeroed just before and read after: each lane equal to
    its own unbatched card run, and one launch of K1, K2 and K3 a frame
    for all lanes."""
    _, stack_lanes = _lane_ops()
    cfg = bench_config(True)
    B, frames = len(streams), streams[0]["bbox"].shape[0]
    singles = _singles(cfg, device, streams)
    run = pt.make_batched_sequence_runner(cfg, device=device)
    state = stack_lanes([pt.initial_state(cfg, device=device)] * B)
    inputs = _stack_streams(streams)
    _zero_counts()
    final, got = run(state, inputs)
    torch.cuda.synchronize()
    launches = _read_counts()
    expected = {name: 0 for name in KERNEL_MODULES}
    expected.update(tracker_step=frames, kalman_step=frames, tagging_step=frames, plan_step=frames)
    if launches != expected:
        raise AssertionError(f"batched path: kernel launches {launches}, expected {expected}")
    gap = max(compare_lane("batched path", got, b, w) for b, (_, w) in enumerate(singles))
    for b, (f, _) in enumerate(singles):
        _assert_same(f"batched path: lane {b}'s final state", _lane_ops()[0](final, b), f)
    return {"lanes": B, "frames": frames, "launches": launches, "planner_max_abs_gap": gap,
            "num_confirmed_last": got["num_confirmed"][:, -1].tolist()}


def check_multicamera_path(device, streams: list) -> dict:
    """The multi-camera runner (`parallel.mesh`) on one card over C cameras
    in the main path's configuration, its counts zeroed just before and
    read after: each camera equal to its own unbatched card run, the fleet
    count the sum over cameras."""
    from multimodal_autonomous_driving_perception_and_planning_torch.parallel.mesh import (
        make_camera_mesh,
        make_multicamera_runner,
        stack_states,
    )

    cfg = bench_config(False)
    C, frames = len(streams), streams[0]["bbox"].shape[0]
    singles = _singles(cfg, device, streams)
    runner = make_multicamera_runner(cfg, make_camera_mesh(1, device=device))
    states = stack_states(cfg, C, device=device)
    inputs = _stack_streams(streams)
    _zero_counts()
    _, got, fleet = runner(states, inputs)
    torch.cuda.synchronize()
    launches = _read_counts()
    expected = {name: 0 for name in KERNEL_MODULES}
    expected.update(tracker_step=frames, kalman_step=frames, plan_step=frames)
    if launches != expected:
        raise AssertionError(f"multi-camera path: kernel launches {launches}, expected {expected}")
    gap = max(compare_lane("multi-camera path", got, c, w) for c, (_, w) in enumerate(singles))
    fleet = fleet["fleet_confirmed_per_frame"]
    if not torch.equal(fleet, torch.stack([w["num_confirmed"] for _, w in singles]).sum(0, dtype=torch.int32)):
        raise AssertionError("multi-camera path: the fleet count is not the sum of the cameras' own counts")
    return {"cameras": C, "frames": frames, "launches": launches, "planner_max_abs_gap": gap,
            "fleet_confirmed_last": int(fleet[-1])}


SERVED_KEYS = ("track_id", "track_bbox", "track_class_id", "track_confidence", "confirmed_order", "num_confirmed",
               "plan_best", "plan_best_positions", "plan_best_velocities")


def check_serve_path(device) -> dict:
    """The port's server (`apps.serve`) on the card with --batch 8 and
    64-frame chunks, serving from the artifact it exports at startup
    (/info's ``artifact_bytes`` > 0), driven by ``tools/serve_loadgen.py --sessions 8
    --chunks 4`` in a subprocess, the counts zeroed just before and read
    after: no error, and one launch of K1, K2 and K3 a frame of each
    batched run.  Then one session's chunk over HTTP against the unbatched
    runner on the card."""
    import urllib.request

    from multimodal_autonomous_driving_perception_and_planning_torch.apps.serve import _npz_bytes, _npz_load, serve

    cfg = bench_config(True)
    httpd = serve(cfg=cfg, chunk=SERVE_CHUNK, port=0, block=False, batch=BATCHED_LANES, device=device)
    ps = httpd.pipeline_server
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/info", timeout=60) as r:
            artifact_bytes = json.loads(r.read())["artifact_bytes"]
        if not (isinstance(artifact_bytes, int) and artifact_bytes > 0):
            raise AssertionError(f"serve path: /info gives artifact_bytes {artifact_bytes}")
        runs0 = ps.batcher.stats()["dispatches"]
        _zero_counts()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve().parent / "tools" / "serve_loadgen.py"), "--url", url,
             "--sessions", str(SERVE_SESSIONS), "--chunks", str(SERVE_CHUNKS)],
            capture_output=True, text=True, timeout=600,
        )
        torch.cuda.synchronize()
        launches = _read_counts()
        runs = ps.batcher.stats()["dispatches"] - runs0
        if proc.returncode != 0:
            raise AssertionError(f"serve path: the load generator exited {proc.returncode}: "
                                 f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        loadgen = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(loadgen), flush=True)
        if loadgen["errors"] or loadgen["completed_requests"] != SERVE_SESSIONS * SERVE_CHUNKS:
            raise AssertionError(f"serve path: {loadgen['completed_requests']} requests, errors {loadgen['errors']}")
        # No K6: the server runs the exported program, whose planner is the
        # tensor ops (utils/export.py traces no call of the kernel library).
        expected = {name: 0 for name in KERNEL_MODULES}
        expected.update(tracker_step=runs * SERVE_CHUNK, kalman_step=runs * SERVE_CHUNK,
                        tagging_step=runs * SERVE_CHUNK)
        if launches != expected:
            raise AssertionError(f"serve path: kernel launches {launches}, expected {expected} for {runs} runs")

        chunk = {k: v[:SERVE_CHUNK] for k, v in synthetic_inputs(SERVE_CHUNK).items()}
        with urllib.request.urlopen(urllib.request.Request(f"{url}/session", method="POST"), timeout=60) as r:
            sid = json.loads(r.read())["session"]
        req = urllib.request.Request(f"{url}/infer?session={sid}", data=_npz_bytes(chunk), method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            served = _npz_load(r.read())
        _, want = pt.make_sequence_runner(cfg, device=device)(pt.initial_state(cfg, device=device), chunk)
        want_host = {k: want[k].cpu().numpy() for k in SERVED_KEYS}
        want_host.update({f"tag_{k}": v.cpu().numpy() for k, v in want["tags"].items()})
        gap = 0.0
        for k, w in want_host.items():
            if k in PLANNER_FLOATS:
                gap = max(gap, float(np.abs(served[k] - w).max()))
                if not gap <= MAIN_ATOL:
                    raise AssertionError(f"serve path: the served {k} is off by {gap}")
            elif served[k].dtype != w.dtype or not np.array_equal(served[k], w):
                raise AssertionError(f"serve path: the served {k} differs from the runner's")
        return {"batch": BATCHED_LANES, "chunk": SERVE_CHUNK, "runs": runs, "launches": launches,
                "loadgen": {k: loadgen[k] for k in ("value", "unit", "completed_requests", "request_latency_ms",
                                                     "warmup_seconds")},
                "server_metrics": loadgen["server_metrics"], "session_check": {"planner_max_abs_gap": gap},
                "artifact": {"bytes": artifact_bytes, "export_s": ps.export_seconds, "load_s": ps.load_seconds,
                             "warmup_s": ps.warmup_seconds},
                "device": ps.device.type}
    finally:
        httpd.shutdown()
        httpd.server_close()
        ps.close()


def kalman_bank_workload(T: int = NUM_FRAMES, N: int = 64) -> dict:
    """benchmarks/suite.py `bench_kalman_bank`'s workload: N agents on
    drifting paths over T frames."""
    rng = np.random.default_rng(0)
    path = np.cumsum(rng.normal(2.0, 0.5, (T, N, 2)), axis=0).astype(np.float32)
    bbox = np.zeros((T, N, 4), np.float32)
    bbox[..., 0], bbox[..., 2] = path[..., 0] - 10, path[..., 0] + 10
    bbox[..., 1], bbox[..., 3] = path[..., 1] - 10, path[..., 1] + 10
    return {"track_id": np.tile(np.arange(1, N + 1, dtype=np.int32), (T, 1)), "track_bbox": bbox,
            "track_velocity": np.zeros((T, N, 2), np.float32), "track_vel_count": np.ones((T, N), np.int32)}


def check_kalman_bank(device) -> dict:
    """The per-agent Kalman bank (`tracking.kalman_bank`) on the card over
    300 frames x 64 agents against the CPU: valid exact, positions and
    velocities within MAIN_ATOL; its time on the host clock (the bank is
    torch ops, no kernel of this repository)."""
    from multimodal_autonomous_driving_perception_and_planning_torch.tracking.kalman_bank import make_kalman_bank

    outs = kalman_bank_workload()
    N = outs["track_id"].shape[1]
    cfg = pt.DEFAULT_CONFIG.replace(tracker=dataclasses.replace(pt.DEFAULT_CONFIG.tracker, max_tracks=N))
    want = make_kalman_bank(cfg, device="cpu")(outs)
    smooth = make_kalman_bank(cfg, device=device)
    xs = {k: torch.as_tensor(v).to(device) for k, v in outs.items()}
    got = smooth(xs)
    torch.cuda.synchronize()
    if not torch.equal(got["valid"].cpu(), want["valid"]):
        raise AssertionError("Kalman bank: valid differs from the CPU's")
    errs = {k: float((got[k].cpu() - want[k]).abs().max()) for k in ("positions", "velocities")}
    if not max(errs.values()) <= MAIN_ATOL:
        raise AssertionError(f"Kalman bank: beyond atol {MAIN_ATOL}: {errs}")
    seconds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        smooth(xs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    frames = outs["track_id"].shape[0]
    return {"frames": frames, "agents": N, "max_abs_err": errs, "seconds": seconds,
            "frames_per_s": frames / min(seconds)}


def measure_lane_kernels(device, inputs: dict, lane_counts=LANE_COUNTS, reps: int = 500) -> dict:
    """K1, K2 and K3 at B lanes a launch on the paths' states
    (`tracker_state`, `kalman_state`, `tagging_state`) repeated over the
    lanes: each wrapper's ms a call (CUDA events), its kernel's device ms
    (profiler), and the bound at B lanes: B times one lane's bytes and
    operations, counted as `measure_kernels` counts them."""
    _, stack_lanes = _lane_ops()
    cfg = bench_config()
    est = cfg.estimator
    table, dets = tracker_state(device, inputs)
    ks, model, z, has = kalman_state(device, inputs)
    rules, tstate, tdets, ttable, vrow = tagging_state(device, inputs)
    one = tracker_kernel.tracker_step(table, dets, cfg.tracker, cfg.tracker.min_hits)
    t_cap, d_cap = cfg.tracker.max_tracks, inputs["bbox"].shape[1]
    k1_bytes = _nbytes(*_table_tensors(table), dets.bbox, dets.class_id, dets.confidence, dets.valid) + _nbytes(
        *_tensors(one))
    k1_ops = t_cap * d_cap * (16 + 2 * (int((one[1] >= 0).sum()) + 1)) + 2 * t_cap * t_cap
    k2_bytes = _nbytes(ks.x, ks.P, ks.time, ks.prev_heading, z, has) + _nbytes(
        *_tensors(kalman_kernel.kalman_step(ks, model, z, has, est.dt, est.speed_heading_hold)))
    k2_ops = 573 + 4 + 46 + 192 + 58 + 1416 + 14
    new_state, tag_f, tag_i = tagging_kernel.tagging_step(rules, tstate, tdets, ttable, vrow)
    k3_bytes = tagging_bytes(rules, tstate, tdets, ttable, new_state, tag_f, tag_i)
    k3_ops = tagging_operations(t_cap, d_cap, rules.window, rules.history, rules.interaction_history)
    shared = _nbytes(model.F, model.Q, model.R)  # K2's model, read once for all lanes
    result = {}
    for B in lane_counts:
        tab, dt_, k, zz, hh = (stack_lanes([x] * B) for x in (table, dets, ks, z, has))
        ts, td, tt, tv = (stack_lanes([x] * B) for x in (tstate, tdets, ttable, vrow))
        launchers = {
            "tracker_step": (lambda: tracker_kernel.tracker_step(tab, dt_, cfg.tracker, cfg.tracker.min_hits),
                             "tracker_step_kernel"),
            "kalman_step": (lambda: kalman_kernel.kalman_step(k, model, zz, hh, est.dt, est.speed_heading_hold),
                            "kalman_step_kernel"),
            "tagging_step": (lambda: tagging_kernel.tagging_step(rules, ts, td, tt, tv), "tagging_step_kernel"),
        }
        work = {"tracker_step": (B * k1_bytes, B * k1_ops, PEAK_F32_PER_S),
                "kalman_step": (B * k2_bytes + shared, B * k2_ops, PEAK_F64_PER_S),
                "tagging_step": (B * k3_bytes, B * k3_ops, PEAK_F32_PER_S)}
        for name, launcher in launchers.items():
            # One trace a kernel; the mean over the launches the trace kept
            # (the tracer drops a few records now and then).
            dev_ms, seen = device_times({name: launcher}, min_seen=90)[name]
            nbytes, ops, peak = work[name]
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak * 1e3
            bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            result.setdefault(name, {})[f"B{B}"] = {
                "ms": time_cuda(launcher[0], reps), "device_ms": dev_ms, "profiled_launches": seen,
                "bytes": nbytes, "operations": ops, "bound_ms": bound, "bound_by": by,
            }
    return result


def measure_batched_paths(device, lane_counts=(BATCHED_LANES, 64), rounds: int = 2,
                          profiled_frames: int = 100) -> dict:
    """Lane-frames/s of the tagging path at B lanes (the batched runner over
    B distinct 300-frame streams) against the unbatched tagging path, on the
    host clock around runs that end in a synchronise, in turns (unbatched,
    then each B, then back), the best run of each; then the device's busy
    share and device items a frame over the first ``profiled_frames``
    frames under the profiler."""
    _, stack_lanes = _lane_ops()
    cfg = bench_config(True)
    streams = lane_streams(max(lane_counts))
    inputs = {1: {k: torch.as_tensor(v).to(device) for k, v in streams[0].items()}}
    runs = {1: pt.make_sequence_runner(cfg, device=device)}
    for B in lane_counts:
        inputs[B] = {k: torch.as_tensor(v).to(device) for k, v in _stack_streams(streams[:B]).items()}
        runs[B] = pt.make_batched_sequence_runner(cfg, device=device)

    def timed(B, frames=NUM_FRAMES):
        state = pt.initial_state(cfg, device=device)
        if B > 1:
            state = stack_lanes([state] * B)
        xs = {k: (v[:frames] if B == 1 else v[:, :frames]) for k, v in inputs[B].items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[B](state, xs)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    order = list(runs)
    for B in order:
        timed(B)
    times = {B: [] for B in order}
    for _ in range(rounds):
        for B in order + order[::-1]:
            times[B].append(timed(B))
    result = {}
    for B in order:
        wall_s, on_device = card_trace(lambda: timed(B, profiled_frames))
        wall_us = wall_s * 1e6
        busy_us = sum(e.time_range.elapsed_us() for e in on_device)
        result[f"B{B}"] = {
            "lanes": B, "frames": NUM_FRAMES, "seconds": times[B],
            "lane_frames_per_s": B * NUM_FRAMES / min(times[B]),
            "profiled": {"frames": profiled_frames, "wall_us": wall_us, "device_busy_us": busy_us,
                         "busy_share": busy_us / wall_us,
                         "device_items_per_frame": len(on_device) / profiled_frames},
        }
    return result


# ---------------------------------------------------------------------------
# BLIP: the captioner (models/blip.py) and the VLM tagger's torch backend
# ---------------------------------------------------------------------------

BLIP_SHORT_NEW = 8  # new tokens of the card-against-CPU decodes: seconds a decode on the CPU
# The card against the CPU (cuBLAS and the CPU's BLAS sum in other orders),
# each side from its own preprocessed frame: the largest gap over the
# largest value of the vision states, the cross K/V and the teacher-forced
# logits.
BLIP_REL = 1e-4
PREPROCESS_ATOL = 1e-5  # the normalized pixels: the card's antialiased bicubic against the CPU's
VLM_FRAMES = 30
VLM_CACHE_INTERVAL = 10
# The VLM tagger's prompts and token budgets (tagging/vlm.py `tag_frame`).
VLM_PROMPTS = {"scene": ("a photo of a driving scene showing", 75), "safety": ("this driving situation is", 50)}
BERT_SPECIAL_IDS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}


def synthetic_vocab() -> list:
    """A ``vocab.txt`` in place of bert-base-uncased's, which the repository
    does not hold: its size and special-token ids, the VLM prompts' words
    from id 1000, ``tok<i>`` on every other line.  No line holds "error" or
    "failed", on which `VLMTagger._generate` falls back to the stub."""
    vocab = [f"tok{i}" for i in range(30522)]
    for i, token in BERT_SPECIAL_IDS.items():
        vocab[i] = token
    words = sorted({w for prompt, _ in VLM_PROMPTS.values() for w in prompt.split()})
    for j, word in enumerate(words):
        vocab[1000 + j] = word
    return vocab


def blip_params(cfg) -> dict:
    """Seeded BLIP weights on the CPU (`blip.init_params`, Flax's
    initializers)."""
    from multimodal_autonomous_driving_perception_and_planning_torch.models import blip

    model = blip.BlipForCaptioning(cfg)
    blip.init_params(model, torch.Generator().manual_seed(0))
    return model.state_dict()


def hf_state_from_port(params: dict, cfg) -> dict:
    """The inverse of `blip.load_torch_state_dict`: the port's state dict
    under HuggingFace ``BlipForConditionalGeneration``'s key names, the
    vision query, key and value fused into one ``qkv`` projection, as numpy
    arrays."""
    p = {k: v.detach().cpu().numpy() for k, v in params.items()}
    sd = {}

    def pair(hf, port):  # a Linear's or a LayerNorm's weight and bias
        sd[f"{hf}.weight"], sd[f"{hf}.bias"] = p[f"{port}.weight"], p[f"{port}.bias"]

    v = "vision_model"
    sd[f"{v}.embeddings.class_embedding"] = p["vision.cls_token"]
    sd[f"{v}.embeddings.position_embedding"] = p["vision.pos_embed"]
    pair(f"{v}.embeddings.patch_embedding", "vision.patch_embed")
    for i in range(cfg.vision_layers):
        hf, pl = f"{v}.encoder.layers.{i}", f"vision.layer{i}"
        pair(f"{hf}.layer_norm1", f"{pl}.ln1")
        pair(f"{hf}.layer_norm2", f"{pl}.ln2")
        for part in ("weight", "bias"):
            sd[f"{hf}.self_attn.qkv.{part}"] = np.concatenate(
                [p[f"{pl}.attn.{n}.{part}"] for n in ("query", "key", "value")])
        pair(f"{hf}.self_attn.projection", f"{pl}.attn.output")
        pair(f"{hf}.mlp.fc1", f"{pl}.fc1")
        pair(f"{hf}.mlp.fc2", f"{pl}.fc2")
    pair(f"{v}.post_layernorm", "vision.post_ln")
    t = "text_decoder.bert"
    sd[f"{t}.embeddings.word_embeddings.weight"] = p["text.word_embeddings.weight"]
    sd[f"{t}.embeddings.position_embeddings.weight"] = p["text.position_embeddings"]
    pair(f"{t}.embeddings.LayerNorm", "text.emb_ln")
    for i in range(cfg.text_layers):
        hf, pl = f"{t}.encoder.layer.{i}", f"text.layer{i}"
        for block, attn, norm in (("attention", "self_attn", "self_ln"), ("crossattention", "cross_attn", "cross_ln")):
            for n in ("query", "key", "value"):
                pair(f"{hf}.{block}.self.{n}", f"{pl}.{attn}.{n}")
            pair(f"{hf}.{block}.output.dense", f"{pl}.{attn}.output")
            pair(f"{hf}.{block}.output.LayerNorm", f"{pl}.{norm}")
        pair(f"{hf}.intermediate.dense", f"{pl}.fc1")
        pair(f"{hf}.output.dense", f"{pl}.fc2")
        pair(f"{hf}.output.LayerNorm", f"{pl}.out_ln")
    c = "text_decoder.cls.predictions"
    pair(f"{c}.transform.dense", "text.transform")
    pair(f"{c}.transform.LayerNorm", "text.transform_ln")
    pair(f"{c}.decoder", "text.decoder")
    return sd


def top_two_margins(logits: np.ndarray) -> np.ndarray:
    """Each row's largest logit less its second largest (float64)."""
    s = np.sort(np.asarray(logits, np.float64), axis=-1)
    return s[..., -1] - s[..., -2]


def blip_logp_fn(model, cross_kvs, num_beams: int):
    """``logp_fn`` for `replay_beam`: the model's log-probabilities at row
    i - 1 of each running sequence, as the beam caption computes them."""
    kvs = [tuple(t.expand(num_beams, *t.shape[1:]) for t in kv) for kv in cross_kvs]
    device = kvs[0][0].device

    @torch.inference_mode()
    def logp_fn(run_seqs: np.ndarray, i: int) -> np.ndarray:
        logits = model.decode(torch.as_tensor(run_seqs).to(device), kvs)
        return torch.log_softmax(logits[:, i - 1].to(torch.float32), dim=-1).cpu().numpy()

    return logp_fn


def replay_beam(logp_fn, prompt_ids, prompt_len: int, max_new_tokens: int, num_beams: int, sep_token_id: int,
                pad_token_id: int = 0) -> dict:
    """`blip.make_beam_caption_fn`'s search in numpy float32 on the
    log-probabilities ``logp_fn(run_seqs, i)`` gives ((N, V), row i - 1 of
    each running sequence): the same sums, divisions and index-ordered
    top-k, so on the same log-probabilities it makes the same decisions.
    Returns the best sequence padded after its SEP (``seq``, ``length``),
    the running sequences and log-probabilities of each step (``inputs``,
    ``logps``; step t decodes position ``first + t``) and each step's
    smallest margin (``margins``): the least gap between two scores whose
    order can change what the search returns: which candidates within the
    first N are hits (they finish), which non-hits run on (while the search
    goes on), which entries of the merged finished pool are its best and
    its first N, and the early-stop test.  Scores near ``NEG`` are left
    out: they stand for beams that cannot win.  A score sums one
    log-probability a step, so where another run's log-probabilities
    stand ``eps_t`` off these at step t, a decision of step t can turn only
    if its margin is within ``2 * sum(eps_0 ... eps_t)`` (`beam_bounds`)."""
    from multimodal_autonomous_driving_perception_and_planning_torch.models.blip import NEG as NEG_

    N, K, NEG = num_beams, 2 * num_beams, np.float32(NEG_)
    L = len(prompt_ids) + max_new_tokens
    buf = np.zeros(L, np.int32)
    buf[: len(prompt_ids)] = prompt_ids
    run_seqs, run_scores = np.tile(buf, (N, 1)), np.full(N, NEG, np.float32)
    run_scores[0] = 0.0
    fin_seqs, fin_scores, fin_mask = run_seqs.copy(), np.full(N, NEG, np.float32), np.zeros(N, bool)
    unsat, max_len_total, top_rank = True, prompt_len + max_new_tokens, np.arange(K) < N
    inputs, logps, margins = [], [], []

    def order(x):  # descending, ties by index: torch.sort(stable=True) and lax.top_k
        return np.argsort(-x, kind="stable")

    def gap(hi, lo):  # the margin of hi over lo, or None where either cannot win
        return float(hi) - float(lo) if hi > NEG / 2 and lo > NEG / 2 else None

    for i in range(max(1, prompt_len), min(L, max_len_total)):
        inputs.append(run_seqs.copy())
        logp = logp_fn(run_seqs, i)
        logps.append(logp)
        V = logp.shape[1]
        cand = (run_scores[:, None] + logp).reshape(N * V)
        ranked = order(cand)
        s = cand[ranked[: K + 1]]  # the K candidates and the first left out
        s_hits = (ranked[: K + 1] % V == sep_token_id) | (i + 1 >= max_len_total)
        idx = ranked[:K]
        vals, tok = cand[idx], (idx % V).astype(np.int32)
        seqs = run_seqs[idx // V]
        seqs[:, i] = tok
        hits = (tok == sep_token_id) | (i + 1 >= max_len_total)
        run_cand = vals + hits.astype(np.float32) * NEG
        keep = order(run_cand)[:N]
        gen_len = np.float32(i + 1 - prompt_len)
        did_finish = hits & top_rank
        pen = np.where(did_finish & unsat, vals / gen_len, NEG).astype(np.float32)
        merged = np.concatenate([fin_scores, pen])
        ranked = order(merged)
        m = merged[ranked[: N + 1]]
        step_gaps = [gap(m[0], m[1]), gap(m[N - 1], m[N])]
        if unsat and s_hits[: N + 1].any():
            step_gaps.append(gap(s[N - 1], s[N]))
        best = ranked[:N]
        fin_seqs = np.concatenate([fin_seqs, seqs])[best]
        fin_scores = merged[best]
        fin_mask = np.concatenate([fin_mask, did_finish])[best]
        run_seqs, run_scores = seqs[keep], run_cand[keep]
        best_possible = run_scores[0] / gen_len
        worst_finished = fin_scores.min() if fin_mask.all() else NEG
        early = gap(best_possible, worst_finished)
        step_gaps.append(None if early is None else abs(early))
        unsat = unsat and bool(best_possible > worst_finished)
        done = not (unsat and not hits.all())
        running = np.flatnonzero(~s_hits)
        if not done and len(running) > N:
            step_gaps.append(gap(s[running[N - 1]], s[running[N]]))
        margins.append(min([g for g in step_gaps if g is not None], default=math.inf))
        if done:
            break
    seq = fin_seqs[0]
    ends = np.flatnonzero((seq == sep_token_id) & (np.arange(L) >= prompt_len))
    length = int(ends[0]) if len(ends) else min(max_len_total, L)
    seq = np.where(np.arange(L) <= length, seq, pad_token_id).astype(np.int32)
    return {"seq": seq, "length": length, "first": max(1, prompt_len), "inputs": inputs, "logps": logps,
            "margins": margins}


def beam_bounds(replay: dict, logp_fn) -> np.ndarray:
    """Each step's bound for `replay_beam`'s margins against another run
    (``logp_fn`` of another device or package on the same running
    sequences): twice the summed largest log-probability gaps so far."""
    eps = [float(np.abs(logp_fn(seqs, replay["first"] + t).astype(np.float64) - logp).max())
           for t, (seqs, logp) in enumerate(zip(replay["inputs"], replay["logps"]))]
    return 2 * np.cumsum(eps)


def check_blip_model(device, frame: np.ndarray, params: dict, cfg=None) -> dict:
    """The BLIP captioner at full width (`BlipConfig()`, ``params`` from
    `blip_params`) on the card against the same module on the CPU, each
    from its own `preprocess_bgr` of ``frame``: the normalized pixels
    within PREPROCESS_ATOL; the vision states, the cross K/V and the
    teacher-forced logits over one fixed buffer within BLIP_REL of their
    scale; the greedy and beam-3 decodes of the scene prompt at
    BLIP_SHORT_NEW new tokens.  A decoded token may differ only after a
    decision whose margin on the CPU (the top-two logit gap for the greedy
    decode, `replay_beam`'s margins for the beam) stands within the gap it
    could take from the measured logit gap; any other difference fails."""
    from multimodal_autonomous_driving_perception_and_planning_torch.models import blip
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.vlm import prompt_buffer
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.tokenizer import WordPieceTokenizer

    cfg = cfg or blip.BlipConfig()
    new_tokens = BLIP_SHORT_NEW
    models = {side: blip.model_from_state_dict(params, cfg, dev) for side, dev in (("cpu", "cpu"), ("card", device))}
    frame_t = torch.as_tensor(frame)
    px = {"cpu": blip.preprocess_bgr(frame_t, cfg.image_size),
          "card": blip.preprocess_bgr(frame_t.to(device), cfg.image_size)}
    pre_gap = float((px["card"].cpu() - px["cpu"]).abs().max())
    if not pre_gap <= PREPROCESS_ATOL:
        raise AssertionError(f"BLIP preprocess: the card's pixels stand {pre_gap} from the CPU's")
    tokenizer = WordPieceTokenizer(synthetic_vocab())
    prompt, prompt_len = prompt_buffer(tokenizer, VLM_PROMPTS["scene"][0], cfg)
    ids = np.concatenate([prompt[:prompt_len], np.random.default_rng(0).integers(
        0, cfg.vocab_size, len(prompt) + new_tokens - prompt_len)]).astype(np.int32)[None]
    out = {}
    with torch.inference_mode():
        for side, model in models.items():
            dev = device if side == "card" else torch.device("cpu")
            vision = model.vision(px[side])
            kvs = model.text.cross_kv(vision)
            logits = model.decode(torch.as_tensor(ids).to(dev), kvs)
            out[side] = {"vision": vision.cpu(), "kv": [t.cpu() for kv in kvs for t in kv], "logits": logits.cpu(),
                         "cross_kvs": kvs}
    torch.cuda.synchronize()
    rel = {
        "vision_states": float((out["card"]["vision"] - out["cpu"]["vision"]).abs().max()
                               / out["cpu"]["vision"].abs().max()),
        "cross_kv": max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(out["card"]["kv"], out["cpu"]["kv"])),
        "logits": float((out["card"]["logits"] - out["cpu"]["logits"]).abs().max() / out["cpu"]["logits"].abs().max()),
    }
    if not max(rel.values()) <= BLIP_REL:
        raise AssertionError(f"BLIP model: the card stands {rel} from the CPU (bound {BLIP_REL} of the scale)")
    gap = float((out["card"]["logits"] - out["cpu"]["logits"]).abs().max())

    decodes = {}
    for mode in ("greedy", "beam3"):
        tokens, seconds = {}, {}
        for side, model in models.items():
            dev = device if side == "card" else "cpu"
            if mode == "greedy":
                _, caption = blip.make_caption_fn(cfg, max_new_tokens=new_tokens, device=dev)
            else:
                _, caption = blip.make_beam_caption_fn(cfg, max_new_tokens=new_tokens, num_beams=3, device=dev)
            t0 = time.perf_counter()
            seq, length = caption(model, px[side], prompt, prompt_len)
            tokens[side] = (seq.cpu().numpy(), int(length))
            seconds[side] = time.perf_counter() - t0
        if mode == "greedy":
            with torch.inference_mode():
                rows = models["cpu"].decode(torch.as_tensor(tokens["cpu"][0])[None], out["cpu"]["cross_kvs"])[0]
            # Decisions at rows prompt_len - 1 ... the one that wrote the
            # last decoded token (the SEP, or the budget's last).
            seq, length = tokens["cpu"]
            last = length if seq[length] == cfg.sep_token_id else length - 1
            margins = list(top_two_margins(rows[prompt_len - 1: last].numpy()))
            differ = np.flatnonzero(tokens["card"][0] != seq)
            if len(differ):  # the decision that wrote the first differing token
                margins = margins[: differ[0] - prompt_len + 1][-1:]
            bound = 2 * gap  # a top-two gap moves by at most twice the logit gap
        else:
            replay = replay_beam(blip_logp_fn(models["cpu"], out["cpu"]["cross_kvs"], 3), prompt, prompt_len,
                                 new_tokens, 3, cfg.sep_token_id, cfg.pad_token_id)
            if not np.array_equal(replay["seq"], tokens["cpu"][0]):
                raise AssertionError("BLIP beam: the numpy replay disagrees with the CPU's beam caption")
            margins = replay["margins"]
            bound = beam_bounds(replay, blip_logp_fn(models["card"], out["card"]["cross_kvs"], 3))
        clear = np.asarray(margins) > bound
        equal = np.array_equal(tokens["card"][0], tokens["cpu"][0]) and tokens["card"][1] == tokens["cpu"][1]
        if not equal and clear.all():
            raise AssertionError(f"BLIP {mode}: the card decoded {tokens['card']}, the CPU {tokens['cpu']}, "
                                 f"and every decision stands clear of the gap (margins {margins}, bounds {bound})")
        decodes[mode] = {"equal": equal, "length": tokens["card"][1], "tokens": tokens["card"][0].tolist(),
                         "min_margin": float(min(margins)), "margin_bound": float(np.max(bound)),
                         "decisions_within_bound": int((~clear).sum()), "seconds": seconds}
    return {"config": "BlipConfig()" if cfg == blip.BlipConfig() else repr(cfg),
            "frame": list(frame.shape), "preprocess_max_abs_err": pre_gap, "relative_gaps": rel, "bound": BLIP_REL,
            "logit_gap": gap, "new_tokens": new_tokens, "prompt_len": prompt_len, **decodes}


def vlm_context(outs: dict, f: int):
    """The VLM tagger's context at frame ``f`` of a runner's outputs: the
    ego speed and acceleration, and the confirmed tracks with their class
    names."""
    from types import SimpleNamespace

    from multimodal_autonomous_driving_perception_and_planning_torch.data.synthetic import CLASS_NAMES

    vs = outs["vehicle_state"]
    state = SimpleNamespace(speed=float(vs.speed[f]), acceleration=float(vs.acceleration[f]))
    slots = outs["confirmed_order"][f][: int(outs["num_confirmed"][f])]
    classes = outs["track_class_id"][f][slots].tolist()
    return state, [SimpleNamespace(class_name=CLASS_NAMES[c]) for c in classes]


def check_vlm_path(device, params: dict, cfg=None) -> dict:
    """The frames path on the card over VLM_FRAMES road frames, then
    `VLMTagger(backend="torch")` on the card (``VLMConfig.device`` left
    ``""``) over the same frames with the runner's context, from an HF-named
    ``.npz`` archive of ``params`` and the synthetic ``vocab.txt`` beside
    it, at the default budgets (75 and 50 new tokens) and ``num_beams=3``.
    The backend must load, produce every caption itself (3 captioned frames
    x 2 prompts at cache_interval 10), the stub none; the other 27 frames
    are cache hits."""
    import tempfile

    from multimodal_autonomous_driving_perception_and_planning_torch.config import VLMConfig
    from multimodal_autonomous_driving_perception_and_planning_torch.models import blip
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.vlm import VLMTagger, _StubBackend
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.weights import save_npz_state_dict

    cfg = cfg or blip.BlipConfig()
    num_frames = VLM_FRAMES
    inputs = frames_inputs(num_frames)
    run_cfg = frames_config()
    _zero_counts()
    _, outs = pt.make_sequence_runner(run_cfg, device=device)(pt.initial_state(run_cfg, device=device), inputs)
    torch.cuda.synchronize()
    launches = _read_counts()

    with tempfile.TemporaryDirectory() as tmp:
        archive = str(Path(tmp) / "blip.npz")
        t0 = time.perf_counter()
        save_npz_state_dict(archive, hf_state_from_port(params, cfg), format="madpp-blip-v1")
        Path(tmp, "vocab.txt").write_text("\n".join(synthetic_vocab()) + "\n", encoding="utf-8")
        archive_s = time.perf_counter() - t0
        tagger = VLMTagger(VLMConfig(model_name=archive, cache_interval=VLM_CACHE_INTERVAL), backend="torch")
        backend, stub = tagger._backend, _StubBackend()
        produced, fell_back = [], []
        generate, fallback = backend.generate, tagger._fallback.generate
        backend.generate = lambda *a, **k: produced.append(generate(*a, **k)) or produced[-1]
        tagger._fallback.generate = lambda *a, **k: fell_back.append(fallback(*a, **k)) or fell_back[-1]
        stub_texts, seconds = set(), []
        t0 = time.perf_counter()
        for f in range(num_frames):
            state, tracks = vlm_context(outs, f)
            for prompt, _ in VLM_PROMPTS.values():
                stub_texts.add(stub.generate(inputs["frame"][f], prompt, {"vehicle_state": state, "tracks": tracks}))
            t1 = time.perf_counter()
            tagger.tag_frame(inputs["frame"][f], state, tracks)
            seconds.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    captioned = len(tagger.tag_history)
    expected = -(-num_frames // VLM_CACHE_INTERVAL)
    faults = []
    if backend.load_error is not None:
        faults.append(f"load error {backend.load_error}")
    if str(backend._device) == "cpu" or next(backend._model.parameters()).device.type != "cuda":
        faults.append(f"the backend ran on {backend._device}")
    if len(produced) != 2 * expected or captioned != expected:
        faults.append(f"{len(produced)} captions from the backend over {captioned} captioned frames, "
                      f"expected {2 * expected} over {expected}")
    if fell_back:
        faults.append(f"{len(fell_back)} stub fallbacks")
    for text in produced:
        if "error" in text.lower() or "failed" in text.lower() or text in stub_texts or not text:
            faults.append(f"caption {text[:80]!r}")
    if faults:
        raise AssertionError("VLM path: " + "; ".join(faults))
    return {"frames": num_frames, "captioned_frames": captioned, "cache_hits": num_frames - captioned,
            "backend_captions": len(produced), "stub_fallbacks": 0, "device": str(backend._device),
            "launches": launches, "archive_seconds": archive_s, "seconds": total_s,
            "captioned_frame_seconds": sorted(seconds)[-expected:],
            "captions": [t[:60] for t in produced[:2]], "tags": tagger.tag_history[-1].get_tags_list()}


def measure_blip(device, params: dict, frame: np.ndarray, cfg=None) -> dict:
    """CUDA-event times of the full-width BLIP on the card: the vision
    forward, and one greedy and one beam-3 caption of each VLM prompt at its
    budget (75 and 50 new tokens), each beside its FLOPs (matmuls and the
    patch conv, counted by PyTorch's FLOP counter over one run: the steps
    that run are the data's) and its bound at the float32 rate; the decode
    steps each caption ran; and the card's busy share over one beam-3 scene
    caption (the kernels' device time in a profiler trace over the call's
    host time)."""
    from torch.utils.flop_counter import FlopCounterMode

    from multimodal_autonomous_driving_perception_and_planning_torch.models import blip
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.vlm import prompt_buffer
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.tokenizer import WordPieceTokenizer

    cfg = cfg or blip.BlipConfig()
    model = blip.model_from_state_dict(params, cfg, device)
    tokenizer = WordPieceTokenizer(synthetic_vocab())
    px = blip.preprocess_bgr(torch.as_tensor(frame).to(device), cfg.image_size)

    def counted(fn):
        steps = []
        decode = model.decode
        model.decode = lambda *a: steps.append(1) or decode(*a)
        try:
            with FlopCounterMode(display=False) as counter:
                fn()
        finally:
            del model.decode
        return counter.get_total_flops(), len(steps)

    def row(fn, reps, warmup):
        flops, steps = counted(fn)
        ms = time_cuda(fn, reps, warmup=warmup)
        return {"ms": ms, "flops": flops, "bound_ms": flops / PEAK_F32_PER_S * 1e3, "steps": steps}

    with torch.inference_mode():
        out = {"vision": row(lambda: model.vision(px), 20, 3)}
    del out["vision"]["steps"]
    runs = {}
    for name, (prompt, budget) in VLM_PROMPTS.items():
        buf, n = prompt_buffer(tokenizer, prompt, cfg)
        for mode in ("greedy", "beam3"):
            if mode == "greedy":
                _, caption = blip.make_caption_fn(cfg, max_new_tokens=budget, device=device)
            else:
                _, caption = blip.make_beam_caption_fn(cfg, max_new_tokens=budget, num_beams=3, device=device)
            runs[f"{mode}_{name}"] = functools.partial(caption, model, px, buf, n)
            out[f"{mode}_{name}"] = {"new_tokens": budget, "prompt_len": n, "buffer": len(buf) + budget,
                                     **row(runs[f"{mode}_{name}"], 3, 1)}
    torch.cuda.synchronize()
    def beam3_scene() -> float:
        t0 = time.perf_counter()
        runs["beam3_scene"]()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    wall_us, kernels = card_trace(beam3_scene)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    frame_flops = out["beam3_scene"]["flops"] + out["beam3_safety"]["flops"]
    out["busy_share_beam3_scene"] = {"kernels": len(kernels), "device_us": busy_us, "host_us": wall_us,
                                     "share": busy_us / wall_us}
    out["vlm_frame"] = {"flops": frame_flops, "bound_ms": frame_flops / PEAK_F32_PER_S * 1e3,
                        "ms": out["beam3_scene"]["ms"] + out["beam3_safety"]["ms"]}
    return out



# Tables beyond the fast instances of K1, K3 and K4 (at most 128 slots and
# 64 detections), which their general instances take up to 1,024 each.
LARGE_SHAPES = ((160, 80), (256, 128), (1024, 1024))
# K1 and K4's general instances also at the YOLO path's table at the JAX
# `nms` default (64 slots, 300 detections).
GENERAL_SHAPES = ((64, 300),) + LARGE_SHAPES
# Rows and columns either side of the cluster partition's edges
# (association.cuh `assoc_plan`: 32-line slices, 2 to 16 blocks).
PARTITION_SIZES = (65, 129, 300, 1024)
# K3's slots either side of a warp's edge and of its cluster's (tagging_step.cu
# `tag_plan`: blocks of at most 128 slots, the warps split evenly; 2 blocks
# to 256, 3 at 257, 4 at 511, 5 at 513, 8 from 897 to 1,024; a warp short
# at 129, 255, 257, 511, 513 and 993).
TAG_PARTITION_SIZES = (129, 255, 256, 257, 511, 513, 993, 1024)
K3_YARDSTICK = (128, 64)  # K3's small instance at its most slots
LARGE_LANES = 8
LARGE_FRAMES = NUM_FRAMES  # ROADMAP §3's input: max_tracks=160, max_detections=80
YOLO_MAX_DET = 300  # the JAX `nms` default (ops/nms.py:73)


def stair_step(t: int, d: int) -> float:
    """The staircase's step at (t, d): 1/4, and 1/32 at 1,024 x 1,024, where
    every (k, k) pair must stand above 0.3 for the 1,025 rounds (both exact
    in float32 for `ladder_iou`)."""
    return 1.0 / 32.0 if max(t, d) >= 1024 else 0.25


def large_config(tracks: int, dets: int, enable_tagging: bool = True):
    """`bench_config` with ``tracks`` slots and ``dets`` detections a frame."""
    cfg = bench_config(enable_tagging)
    return cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=tracks),
                       detector=dataclasses.replace(cfg.detector, max_detections=dets))


def check_large_tracker(device) -> list:
    """K1's general instance against its plain version at GENERAL_SHAPES:
    churn, a saturated table, the key-order corners of `corner_arrays` (IoU
    at the threshold, +0 IoUs all tied), IoUs within 2 ulps of the
    threshold, and the staircase (one pair a round; min(t, d) + 1 rounds,
    1,025 at (1,024, 1,024)); an odd ring (T L odd) at (161, 80)."""
    cases = []
    base = bench_config().tracker
    for t, d in GENERAL_SHAPES:
        steps = 6 if t >= 1024 else 20
        churn = pt.TrackerConfig(iou_threshold=0.1, max_age=2, min_hits=3, max_tracks=t)
        rng = np.random.default_rng(t + d)
        cases.append(_tracker_case(f"churn_{t}x{d}", churn, lambda s, rng=rng, d=d: random_dets(rng, d, device),
                                   steps, device))
        sat = pt.TrackerConfig(iou_threshold=0.3, max_age=30, min_hits=3, max_tracks=t)
        rng = np.random.default_rng(t + d + 1)
        cases.append(_tracker_case(f"saturated_{t}x{d}", sat,
                                   lambda s, rng=rng, d=d: random_dets(rng, d, device, p_valid=1.0), steps, device))
        cfg = dataclasses.replace(base, max_tracks=t)
        for name, zero_iou, thr, matched in (("threshold_ties", False, 0.3, min(t, (d + 1) // 2)),
                                             ("zero_iou_ties", True, 0.0, min(t, d))):
            table, dets = table_on(*corner_arrays(t, d, zero_iou), device)
            case_cfg = dataclasses.replace(cfg, iou_threshold=thr)
            cases.append(_tracker_case(f"{name}_{t}x{d}", case_cfg, lambda s, dets=dets: dets, 2, device,
                                       table=table))
            if cases[-1]["max_matched"] != matched:
                raise AssertionError(f"K1 {name}_{t}x{d}: {cases[-1]['max_matched']} matches, expected {matched}")
        pairs = min(t, d, 256)
        table, dets = table_on(*near_threshold_arrays(t + d, pairs=pairs, tracks=t, dets=d), device)
        cases.append(_tracker_case(f"near_threshold_{t}x{d}", cfg, lambda s, dets=dets: dets, 1, device,
                                   table=table))
        table, dets = ladder_boxes(t, d, stair_step(t, d), device)
        cases.append(_tracker_case(f"staircase_{t}x{d}", cfg, lambda s, dets=dets: dets, 1 if t >= 1024 else 2,
                                   device, table=table))
        if cases[-1]["max_matched"] != min(t, d):
            raise AssertionError(f"K1 staircase_{t}x{d}: the ladder did not match all {min(t, d)} pairs")
    odd = pt.TrackerConfig(iou_threshold=0.1, max_age=2, max_tracks=161, trajectory_length=5)
    rng = np.random.default_rng(161)
    cases.append(_tracker_case("odd_ring_161x80", odd, lambda s: random_dets(rng, 80, device), 20, device))
    return cases


def check_partition_edges(device, sizes=PARTITION_SIZES) -> list:
    """K1 and K4's general instances at every (T, D) of ``sizes``, either
    side of the cluster partition's 32-line slices and of its cluster
    sizes: K1 over 3 churning steps, K4 on a random and a tied-rank
    matrix, each bit for bit its plain version."""
    cases = []
    for t in sizes:
        for d in sizes:
            cfg = pt.TrackerConfig(iou_threshold=0.1, max_age=2, min_hits=2, max_tracks=t)
            rng = np.random.default_rng(7 * t + d)
            k1 = _tracker_case(f"churn_{t}x{d}", cfg, lambda s: random_dets(rng, d, device), 3, device)
            matched = []
            for tied in (False, True):
                iou, rank = random_association(rng, t, d, tied=tied)
                iou_t, rank_t = torch.tensor(iou, device=device), torch.tensor(rank, device=device)
                got = association_kernel.greedy_associate(iou_t, rank_t, 0.3)
                want = _greedy_associate_plain(iou_t, rank_t, 0.3)
                if not torch.equal(got, want):
                    raise AssertionError(f"K4 {t}x{d} tied={tied}: differs in {int((got != want).sum())} rows")
                matched.append(int((want >= 0).sum()))
            cases.append({"T": t, "D": d, "k1_cluster": tracker_kernel.cluster_size(t, d, cfg.trajectory_length),
                          "k4_cluster": association_kernel.cluster_size(t, d), "k1_max_matched": k1["max_matched"],
                          "k4_matched": matched, "k4_kernels": k4_kernels(t, d)})
    return cases


def check_large_association(device, trials: int = 4) -> list:
    """K4's general instance against its plain version at GENERAL_SHAPES:
    random and tied ranks, full matrices, the key-order corners (ranks at
    int32's ends whose tie-break keys wrap at these D, -0 and +0, the
    threshold, NaN), and the staircase (1,025 rounds at (1,024, 1,024));
    each shape's kernels (`k4_kernels`: the staged route at (1,024,
    1,024)) with its random case."""
    cases = []

    def compare(name, iou, rank, thr):
        iou_t, rank_t = torch.tensor(iou, device=device), torch.tensor(rank, device=device)
        got = association_kernel.greedy_associate(iou_t, rank_t, thr)
        want = _greedy_associate_plain(iou_t, rank_t, thr)
        if not torch.equal(got, want):
            raise AssertionError(f"K4 {name}: differs from the plain version in {int((got != want).sum())} rows")
        return int((want >= 0).sum())

    for t, d in GENERAL_SHAPES:
        rng = np.random.default_rng(t * 7 + d)
        cases.append({"case": f"random_{t}x{d}", "matched": [
            compare(f"random {t}x{d} {i}", *random_association(rng, t, d), float(rng.choice([0.0, 0.3, 0.5])))
            for i in range(trials)], "kernels": k4_kernels(t, d)})
        cases.append({"case": f"tied_ranks_{t}x{d}", "matched": [
            compare(f"tied {t}x{d} {i}", *random_association(rng, t, d, tied=True), 0.3) for i in range(trials)]})
        cases.append({"case": f"full_{t}x{d}", "matched": [
            compare(f"full {t}x{d} {i}", *full_association(rng, t, d), 0.3) for i in range(trials)]})
        cases.append({"case": f"key_corners_{t}x{d}", "matched": [
            compare(f"key corners {t}x{d} thr {thr} {i}", *key_corner_association(rng, t, d, thr), thr)
            for thr in KEY_CORNER_THRESHOLDS for i in range(trials)]})
        cases.append({"case": f"key_corners_few_{t}x{d}", "matched": [
            compare(f"few corners {t}x{d} keep {keep}", *key_corner_association(rng, t, d, 0.3, keep=keep), 0.3)
            for keep in (24, 40, 4 * t)]})
        stairs = ladder_iou(t, d, stair_step(t, d))
        if compare(f"staircase {t}x{d}", stairs, np.arange(t, dtype=np.int32), 0.3) != min(t, d):
            raise AssertionError(f"K4 staircase_{t}x{d}: the ladder did not match all {min(t, d)} pairs")
        cases.append({"case": f"staircase_{t}x{d}", "matched": min(t, d)})
    return cases


def check_large_tagging(device) -> list:
    """K3's general instance against its plain version, every tag and the
    state bit for bit, at T = 160, 256 and 1,024, in detections and frames
    mode on random streams, and on the crafted stream (every aggregate
    corner) at T = 256 in both modes."""
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    cases = []
    for t, d in LARGE_SHAPES:
        wide = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=t))
        frames = 12 if t >= 1024 else 30
        cases.append(_tagging_case(f"detections_{t}x{d}", wide, frames, t, d, False, device, exact=True))
        cases.append(_tagging_case(f"frames_{t}x{d}", wide.replace(use_frames=True), frames, t + 1, d, True, device,
                                   exact=True))
    wide = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=256))
    for name, c, frames_mode in (("crafted_256x128", wide, False),
                                 ("crafted_frames_256x128", wide.replace(use_frames=True), True)):
        cases.append(_tagging_case(name, c, 40, 31, 128, frames_mode, device, crafted_tagging_frame, exact=True))
        missed = [k for k, n in cases[-1]["corner_frames"].items() if n == 0]
        if missed:
            raise AssertionError(f"K3 {name}: the crafted stream never reached {missed}")
    return cases


def check_tagging_partition_edges(device, sizes=TAG_PARTITION_SIZES, frames: int = 4) -> list:
    """K3's general instance either side of its warps' and its cluster's
    edges (tagging_step.cu `tag_plan`): each T of ``sizes`` in detections
    and frames mode over ``frames`` random frames, every tag and the state
    bit for bit its plain version's; then its rings off the fast path, at
    T = 255 with 29 centers a slot (a warp's rows not a multiple of 16
    bytes), 3 lanes of it (lane 1 off 16-byte alignment), and 160 slots of
    500 centers (too large for shared memory)."""
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    cases = []
    for t in sizes:
        wide = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=t))
        for mode, c in (("detections", wide), ("frames", wide.replace(use_frames=True))):
            case = _tagging_case(f"{mode}_{t}x80", c, frames, 3 * t + (mode == "frames"), 80, mode == "frames",
                                 device, exact=True)
            cases.append({**case, "cluster": tagging_kernel.cluster_size(t, 80)})
    odd = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=255),
                      tagging=dataclasses.replace(cfg.tagging, interaction_history=29))
    long = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=160),
                       tagging=dataclasses.replace(cfg.tagging, interaction_history=500))
    cases.append(_tagging_case("odd_ring_255x80", odd, 12, 255, 80, False, device, crafted_tagging_frame, exact=True))
    cases.append(_lane_tagging_case("odd_ring_255x80_3_lanes", odd, 3, 4, 80, False, device, seed=2550))
    cases.append(_tagging_case("long_ring_160x80", long, 12, 160, 80, False, device, exact=True))
    return cases


def check_large_lanes(device) -> list:
    """K1 and K3's general instances at LARGE_LANES lanes a launch at
    (256, 128), and K1's at (64, 300) and (1,024, 1,024) (a cluster a lane,
    16 blocks at 1,024): each lane bit for bit its B = 1 launch and its
    plain version's discrete outputs (floats within K3's bounds)."""
    t, d = 256, 128
    k1 = pt.TrackerConfig(iou_threshold=0.1, max_age=2, min_hits=3, max_tracks=t)
    k3 = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    k3 = k3.replace(tracker=dataclasses.replace(k3.tracker, max_tracks=t))
    return [
        _lane_tracker_case(f"churn_{t}x{d}", k1, LARGE_LANES, 10, d, device, seed=256),
        _lane_tagging_case(f"detections_{t}x{d}", k3, LARGE_LANES, 10, d, False, device, seed=257),
        _lane_tagging_case(f"frames_{t}x{d}", k3.replace(use_frames=True), LARGE_LANES, 10, d, True, device,
                           seed=258),
        _lane_tracker_case("churn_64x300", dataclasses.replace(k1, max_tracks=64), LARGE_LANES, 6, 300, device,
                           seed=64),
        _lane_tracker_case("churn_1024x1024", dataclasses.replace(k1, max_tracks=1024), LARGE_LANES, 2, 1024,
                           device, seed=1024),
    ]


def large_tagging_inputs(frames: int = LARGE_FRAMES) -> dict:
    """ROADMAP §3's input: `simulated_detection_stream(capacity=80)` and the
    ego stream, ``frames`` frames."""
    dets = simulated_detection_stream(frames, capacity=80)
    return dict(dets, ego_measurement=ego_motion_stream(frames, dt=1.0 / 30.0, seed=0).astype(np.float32))


def check_large_tagging_path(device, frames: int = LARGE_FRAMES) -> dict:
    """ROADMAP §3's input: the tagging path at max_tracks=160,
    max_detections=80 over ``frames`` frames of `large_tagging_inputs`, the
    card (K1 and K3's general instances) against the CPU run: discrete
    outputs and tags exact, floats within MAIN_ATOL; K1, K2 and K3 counted."""
    cfg = large_config(160, 80)
    inputs = large_tagging_inputs(frames)
    _, want = pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"), inputs)
    run = pt.make_sequence_runner(cfg, device=device)
    state = pt.initial_state(cfg, device=device)
    _zero_counts()
    _, got = run(state, inputs)
    torch.cuda.synchronize()
    launches = _read_counts()
    expected = {name: 0 for name in KERNEL_MODULES}
    expected.update(tracker_step=frames, kalman_step=frames, tagging_step=frames, plan_step=frames)
    if launches != expected:
        raise AssertionError(f"large tagging path: kernel launches {launches}, expected {expected}")
    errs = compare_outputs("large tagging path", got, want)
    valid = torch.as_tensor(inputs["valid"])
    return {"frames": frames, "max_tracks": 160, "max_detections": 80, "launches": launches,
            "valid_per_frame": {"mean": float(valid.sum(1).double().mean()), "max": int(valid.sum(1).max())},
            "num_confirmed_max": int(got["num_confirmed"].max()), "max_abs_err": errs}


def check_large_tables(device) -> dict:
    """The `large_tables` phase: K1, K4 and K3's general instances against
    their plain versions, at their partitions' edges, and at 8 lanes.  The
    paths that launch them run in `large_paths`."""
    t0 = time.perf_counter()
    edges = check_tagging_partition_edges(device)
    return {"tracker": check_large_tracker(device), "association": check_large_association(device),
            "partition_edges": check_partition_edges(device), "tagging": check_large_tagging(device),
            "tagging_partition_edges": edges, "tagging_partition_edges_s": time.perf_counter() - t0,
            "lanes": check_large_lanes(device)}


# --- Tables beyond 1,024 slots or detections, and pools beyond 1,024 ---------
# The general instances' widths (4,096 slots and detections) and K5's large
# instance (every anchor of yolov8 at 640, 8,400, and at 1,280, 33,600).
WIDE_SHAPES = ((1025, 64), (2048, 300), (4096, 1024), (4096, 4096))
WIDE_TAG_SIZES = (1025, 2048, 4096)
WIDE_NMS = ((64, 1025), (64, 8400), (2, 33600))
WIDE_LANES = (8, 2048, 300)  # K1 at 8 lanes a launch
PLAIN_NMS_IMAGES = 8  # images a plain K5 call on the card: its (B, K, K) bools stay under 10 GB
YOLO_ANCHORS_640 = 8400  # yolov8's anchors at 640: 80^2 + 40^2 + 20^2
WIDE_YOLO_SCORE = 0.05
WIDE_CPU_SECONDS = 20.0  # a path's CPU run stops after the chunk that passes this (at least 8 frames)
WIDE_CPU_MIN_FRAMES = 8
WIDE_CHUNK = 4  # frames a CPU chunk of a wide path
WIDE_TAG_FRAMES = 64  # the tagging_4096 path's card run
WIDE_FRAMES_FRAMES = 64  # the frames_360 path's
WIDE_FRAMES_PROFILED = 16  # its frames under the profiler: 1,700 device items a frame


def plain_nms_keep(boxes: torch.Tensor, scores: torch.Tensor, thr: float) -> torch.Tensor:
    """`_nms_keep_plain` on PLAIN_NMS_IMAGES images at a time, its
    suppression matrix and each round's temporary (B K^2 bytes each, 4.5 GB
    at (64, 8,400)) kept to a few GB."""
    n = PLAIN_NMS_IMAGES
    return torch.cat([_nms_keep_plain(boxes[i:i + n], scores[i:i + n], thr) for i in range(0, scores.shape[0], n)])


def wide_stair_step(t: int, d: int) -> float:
    """`stair_step` at the wide shapes: 1/128, so that every (k, k) pair of
    `ladder_arrays` and `ladder_iou` stands above 0.3 at 4,096 x 4,096
    (exact in float32)."""
    return 1.0 / 128.0 if max(t, d) > 1024 else stair_step(t, d)


def check_wide_tracker(device) -> list:
    """K1's general instance against its plain version at WIDE_SHAPES: churn
    and saturated tables, IoUs at the threshold and +0 IoUs all tied (ranks
    by a permuted id), IoUs within 2 ulps of the threshold, and the
    staircase and all-equal ladders (one pair a round: min(t, d) + 1
    rounds, 4,097 at 4,096 x 4,096), every output bit for bit."""
    cases = []
    base = bench_config().tracker
    for t, d in WIDE_SHAPES:
        steps = 2 if t * d > 4096 * 1024 else 4
        churn = pt.TrackerConfig(iou_threshold=0.1, max_age=2, min_hits=3, max_tracks=t)
        rng = np.random.default_rng(t + d)
        cases.append(_tracker_case(f"churn_{t}x{d}", churn, lambda s, rng=rng, d=d: random_dets(rng, d, device),
                                   steps, device))
        sat = pt.TrackerConfig(iou_threshold=0.3, max_age=30, min_hits=3, max_tracks=t)
        rng = np.random.default_rng(t + d + 1)
        cases.append(_tracker_case(f"saturated_{t}x{d}", sat,
                                   lambda s, rng=rng, d=d: random_dets(rng, d, device, p_valid=1.0), steps, device))
        cfg = dataclasses.replace(base, max_tracks=t)
        for name, zero_iou, thr, matched in (("threshold_ties", False, 0.3, min(t, (d + 1) // 2)),
                                             ("zero_iou_ties", True, 0.0, min(t, d))):
            table, dets = table_on(*corner_arrays(t, d, zero_iou), device)
            cases.append(_tracker_case(f"{name}_{t}x{d}", dataclasses.replace(cfg, iou_threshold=thr),
                                       lambda s, dets=dets: dets, 1, device, table=table))
            if cases[-1]["max_matched"] != matched:
                raise AssertionError(f"K1 {name}_{t}x{d}: {cases[-1]['max_matched']} matches, expected {matched}")
        table, dets = table_on(*near_threshold_arrays(t + d, pairs=min(t, d, 256), tracks=t, dets=d), device)
        cases.append(_tracker_case(f"near_threshold_{t}x{d}", cfg, lambda s, dets=dets: dets, 1, device,
                                   table=table))
        for name, step in (("staircase", wide_stair_step(t, d)), ("all_equal", 0.0)):
            table, dets = ladder_boxes(t, d, step, device)
            cases.append(_tracker_case(f"{name}_{t}x{d}", cfg, lambda s, dets=dets: dets, 1, device, table=table))
            if cases[-1]["max_matched"] != min(t, d):
                raise AssertionError(f"K1 {name}_{t}x{d}: the ladder did not match all {min(t, d)} pairs")
        cases[-1]["cluster"] = tracker_kernel.cluster_size(t, d, cfg.trajectory_length)
    return cases


def check_wide_association(device) -> list:
    """K4's general instance against its plain version at WIDE_SHAPES:
    random and tied ranks, full matrices, the key-order corners (ranks at
    int32's ends whose tie-break keys rank * D + column wrap at these D, -0
    and +0, the threshold, NaN), and the staircase and all-equal ladders
    (4,097 rounds at 4,096 x 4,096), bit for bit, every shape on the staged
    route (its kernels with its random case)."""
    cases = []

    def compare(name, iou, rank, thr):
        iou_t, rank_t = torch.tensor(iou, device=device), torch.tensor(rank, device=device)
        got = association_kernel.greedy_associate(iou_t, rank_t, thr)
        want = _greedy_associate_plain(iou_t, rank_t, thr)
        if not torch.equal(got, want):
            raise AssertionError(f"K4 {name}: differs from the plain version in {int((got != want).sum())} rows")
        return int((want >= 0).sum())

    for t, d in WIDE_SHAPES:
        if k4_kernels(t, d) != K4_STAGED_KERNELS + (K4_CLUSTER_KERNEL,):
            raise AssertionError(f"K4 at ({t}, {d}) does not take the staged route: {k4_kernels(t, d)}")
        rng = np.random.default_rng(t * 7 + d)
        cases.append({"case": f"random_{t}x{d}", "matched": [
            compare(f"random {t}x{d} {i}", *random_association(rng, t, d), thr) for i, thr in enumerate((0.0, 0.3))],
            "kernels": k4_kernels(t, d)})
        cases.append({"case": f"tied_ranks_{t}x{d}",
                      "matched": compare(f"tied {t}x{d}", *random_association(rng, t, d, tied=True), 0.3)})
        cases.append({"case": f"full_{t}x{d}", "matched": compare(f"full {t}x{d}", *full_association(rng, t, d), 0.3)})
        cases.append({"case": f"key_corners_{t}x{d}", "matched": [
            compare(f"key corners {t}x{d} thr {thr}", *key_corner_association(rng, t, d, thr), thr)
            for thr in KEY_CORNER_THRESHOLDS]})
        for name, step in (("staircase", wide_stair_step(t, d)), ("all_equal", 0.0)):
            if compare(f"{name} {t}x{d}", ladder_iou(t, d, step), np.arange(t, dtype=np.int32), 0.3) != min(t, d):
                raise AssertionError(f"K4 {name}_{t}x{d}: the ladder did not match all {min(t, d)} pairs")
            cases.append({"case": f"{name}_{t}x{d}", "matched": min(t, d)})
        cases[-1]["cluster"] = association_kernel.cluster_size(t, d)
    return cases


def check_wide_tagging(device, frames: int = 4) -> list:
    """K3's general instance at WIDE_TAG_SIZES slots (clusters of 5, 8 and 16
    blocks of up to 256 slots) in detections and frames mode over random
    frames of 1,024 detections, and on the crafted stream at 4,096 (every
    aggregate corner, 128 warp records), every tag and the state bit for
    bit its plain version's."""
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    cases = []
    for t in WIDE_TAG_SIZES:
        wide = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=t))
        for mode, c in (("detections", wide), ("frames", wide.replace(use_frames=True))):
            case = _tagging_case(f"{mode}_{t}x1024", c, frames, 5 * t + (mode == "frames"), 1024, mode == "frames",
                                 device, exact=True)
            cases.append({**case, "cluster": tagging_kernel.cluster_size(t, 1024)})
    wide = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=4096))
    cases.append(_tagging_case("crafted_4096x128", wide, 40, 41, 128, False, device, crafted_tagging_frame,
                               exact=True))
    missed = [k for k, n in cases[-1]["corner_frames"].items() if n == 0]
    if missed:
        raise AssertionError(f"K3 crafted_4096x128: the crafted stream never reached {missed}")
    return cases


def scale_nms_case(case: NmsCase, b: int, k: int) -> NmsCase:
    """``case`` at (b, k): its pools tiled along the candidates to k (every
    copy a twin of the first, so kept boxes suppress their twins across
    many words) and its images repeated to b."""
    boxes, scores = np.asarray(case.boxes, np.float32), np.asarray(case.scores, np.float32)
    reps = -(-k // boxes.shape[1])
    boxes = np.tile(boxes, (1, reps, 1))[:, :k]
    scores = np.tile(scores, (1, reps))[:, :k]
    pick = np.arange(b) % boxes.shape[0]
    return NmsCase(np.ascontiguousarray(boxes[pick]), np.ascontiguousarray(scores[pick]), case.thr)


def sparse_chain(k: int, n: int = 24) -> NmsCase:
    """`_chain`'s ``n`` links spread over ``k`` candidates, every k // n-th,
    the others disjoint: each link suppresses one in a word far after its
    own, the chain across every word (n rounds of the plain fixpoint, where
    `_chain` at this K would take thousands)."""
    boxes = _far_boxes(k)
    x = np.arange(n) * 5.0
    boxes[np.arange(n) * (k // n)] = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], 1)
    return NmsCase(boxes[None], _descending(k)[None], 0.3, kept=k - n // 2)


def wide_nms_cases(b: int, k: int) -> dict:
    """K5's cases at (b, k): at (64, 1,025) every case of `nms_cases` scaled
    (`scale_nms_case`); beyond, those whose plain fixpoint takes few rounds
    there (IoUs within 2 ulps of the threshold, the thresholds' corners,
    class-offset pools at class 79, degenerate boxes, NaN and inf
    coordinates, dead entries between live ones) scaled, and a chain across
    every word (`sparse_chain`); and tie-quantized random pools."""
    base = nms_cases()
    names = list(base) if k <= 1100 else [
        "near_threshold_0.45", "thr_negative", "thr_above_one", "class_offset_79", "degenerate_boxes",
        "nan_inf_coords", "dead_between_live"]
    cases = {f"{name}_{b}x{k}": scale_nms_case(base[name], b, k) for name in names}
    rng = np.random.default_rng(b * 31 + k)
    cases[f"random_{b}x{k}"] = NmsCase(*_pools(rng, b, k), 0.45)
    cases[f"sparse_chain_{b}x{k}"] = scale_nms_case(sparse_chain(k), b, k)
    return cases


def check_wide_nms(device) -> list:
    """K5's large instance against its plain version at WIDE_NMS, exact,
    over `wide_nms_cases`, and on boxes off 16-byte alignment."""
    cases = []
    for b, k in WIDE_NMS:
        for name, case in wide_nms_cases(b, k).items():
            bx = torch.tensor(case.boxes, device=device)
            sc = torch.tensor(case.scores, device=device)
            got = nms_kernel.nms_keep(bx, sc, case.thr)
            want = plain_nms_keep(bx, sc, case.thr)
            if not torch.equal(got, want):
                raise AssertionError(f"K5 {name}: differs from the plain version in {int((got != want).sum())} places")
            cases.append({"case": name, "thr": case.thr, "kept": int(want.sum())})
    case = wide_nms_cases(8, 2048)["random_8x2048"]
    flat = torch.empty(case.boxes.size + 1, device=device)
    bx = flat[1:].view(case.boxes.shape)
    bx.copy_(torch.tensor(case.boxes, device=device))
    sc = torch.tensor(case.scores, device=device)
    if not torch.equal(nms_kernel.nms_keep(bx, sc, case.thr), plain_nms_keep(bx, sc, case.thr)):
        raise AssertionError("K5's large instance differs from the plain version on boxes off 16-byte alignment")
    cases.append({"case": "misaligned_8x2048"})
    return cases


def check_wide_tables(device) -> dict:
    """The `wide_tables` phase: K1, K4 and K3's general instances beyond
    1,024 slots and detections, K5's large instance beyond 1,024
    candidates, and K1 at 8 lanes at (2,048, 300), each against its plain
    version on the card."""
    seconds = {}
    out = {}
    for name, check in (("tracker", check_wide_tracker), ("association", check_wide_association),
                        ("tagging", check_wide_tagging), ("nms", check_wide_nms)):
        t0 = time.perf_counter()
        out[name] = check(device)
        seconds[name] = time.perf_counter() - t0
    lanes, t, d = WIDE_LANES
    k1 = pt.TrackerConfig(iou_threshold=0.1, max_age=2, min_hits=3, max_tracks=t)
    out["lanes"] = [_lane_tracker_case(f"churn_{t}x{d}", k1, lanes, 3, d, device, seed=t)]
    return {**out, "seconds": seconds}


@contextlib.contextmanager
def plain_on_card():
    """The kernels' wrappers replaced by their plain versions, which run on
    the card's tensors as they run on the CPU's: the yardstick of a wide
    path's frames beyond its CPU run.  Nothing launches a kernel inside."""
    from multimodal_autonomous_driving_perception_and_planning_torch.estimation import ego
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.rules import frames_from_rows

    def tracker(table, dets, cfg, min_hits):
        new_table, match = tracker_update(table, dets, cfg)
        return (new_table, match, *confirmed_order(new_table, min_hits))

    def tagging(rules, state, dets, table, vrow, lane_row=None, feat_row=None):
        rows = () if lane_row is None else frames_from_rows(lane_row, feat_row)
        return tagging_step_plain(rules, state, dets, table, vrow, *rows)

    def kalman(ks, model, z, has, dt, hold):
        cfg = dataclasses.replace(pt.DEFAULT_CONFIG.estimator, dt=dt, speed_heading_hold=hold)
        new_ks, state = _estimator_step_xla(ks, model, z, has, cfg)
        return new_ks, ego.vehicle_row(state)

    saved = (tracker_kernel.tracker_step, tagging_kernel.tagging_step, kalman_kernel.kalman_step,
             nms_kernel.nms_keep)
    tracker_kernel.tracker_step, tagging_kernel.tagging_step = tracker, tagging
    kalman_kernel.kalman_step, nms_kernel.nms_keep = kalman, plain_nms_keep
    try:
        with plain_planner():
            yield
    finally:
        (tracker_kernel.tracker_step, tagging_kernel.tagging_step, kalman_kernel.kalman_step,
         nms_kernel.nms_keep) = saved


def _plan_step_plain(state, cfg, reference_positions=None, reference_valid=None, obstacles=None,
                     obstacles_valid=None, fields=None):
    """`planner_kernel.plan_step` in the tensor ops of the program
    utils/export.py traces (`planner.plan_from_row_plain`)."""
    refs = (reference_positions, reference_valid, obstacles, obstacles_valid)
    if tuple(fields or planner_kernel.STATE_FIELDS) != planner_kernel.ROW_FIELDS:
        row = state.new_zeros(state.shape[:-1] + (len(VEHICLE_STATE_FIELDS),))
        row[..., list(planner_kernel.ROW_FIELDS)] = state[..., list(fields or planner_kernel.STATE_FIELDS)]
        state = row
    return planner.plan_from_row_plain(state, cfg, *refs)


@contextlib.contextmanager
def plain_planner():
    """K6's wrapper replaced by its plain version: an eager runner inside
    plans as an exported program does, bit for bit, and launches no K6."""
    saved = planner_kernel.plan_step
    planner_kernel.plan_step = _plan_step_plain
    try:
        yield
    finally:
        planner_kernel.plan_step = saved


def cpu_prefix_run(cfg, inputs: dict, frames: int, chunk: int = WIDE_CHUNK) -> tuple:
    """The CPU runner over the first frames of ``inputs``, ``chunk`` at a
    time from its own state, until WIDE_CPU_SECONDS have passed, at least
    WIDE_CPU_MIN_FRAMES and at most ``frames``: ``(outputs, frames run,
    seconds)``."""
    run = pt.make_sequence_runner(cfg, device="cpu")
    state = pt.initial_state(cfg, device="cpu")
    chunks, n, t0 = [], 0, time.perf_counter()
    while n < frames and (n < WIDE_CPU_MIN_FRAMES or time.perf_counter() - t0 < WIDE_CPU_SECONDS):
        m = min(chunk, frames - n)
        state, outs = run(state, {k: v[n:n + m] for k, v in inputs.items()})
        chunks.append(outs)
        n += m
    return tree_map(lambda *xs: torch.cat(xs), *chunks), n, time.perf_counter() - t0


def _first(outs: dict, n: int) -> dict:
    """A run's outputs over its first ``n`` frames, on the CPU."""
    return tree_map(lambda x: x[:n].cpu(), outs)


def _counted_run(label: str, run, expected: dict):
    """``run()`` on the card with the kernels' counts zeroed just before and
    read just after, held to ``expected`` (every other kernel 0)."""
    want = {name: 0 for name in KERNEL_MODULES}
    want.update(expected)
    _zero_counts()
    out = run()
    torch.cuda.synchronize()
    launches = _read_counts()
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {want}")
    return out, launches


def wide_yolo_config():
    """The YOLO path at the JAX `nms` default of 300 detections."""
    cfg = bench_config()
    return cfg.replace(detector=dataclasses.replace(cfg.detector, max_detections=YOLO_MAX_DET))


def wide_yolo_runner(device):
    """`yolo_all_anchors`: yolov8n at 640 in float32 at score 0.05 with every
    anchor in the NMS pool (pre_topk 8,400) and 300 detections a frame."""
    return make_yolo_sequence_runner(wide_yolo_config(), batch=YOLO_BATCH, iou_threshold=YOLO_IOU,
                                     img_size=YOLO_IMG, device=device, pre_topk=YOLO_ANCHORS_640, **YOLO_F32)[1]


def check_yolo_all_anchors(device, params: dict, frames, ego) -> dict:
    """Path (a): `wide_yolo_runner` over one 64-frame chunk, counted (K5 at
    (64, 8,400) once, K1 at (64, 300) and K2 a frame); its detection tables
    against the plain `nms` on its own candidates, on the CPU over the first
    frames it finishes in WIDE_CPU_SECONDS (at least 8, a frame at a time)
    and on the card (`plain_on_card`) over all 64; the CPU pipeline on its
    tables against its outputs."""
    cfg = wide_yolo_config()
    run = wide_yolo_runner(device)
    frames, ego = frames[:YOLO_BATCH], ego[:YOLO_BATCH]
    state = pt.initial_state(cfg, device=device)
    (_, outs), launches = _counted_run("yolo_all_anchors", lambda: run(params, state, frames, ego,
                                                                       keep_candidates=True),
                                       dict(tracker_step=len(frames), kalman_step=len(frames), plan_step=len(frames),
                                            nms_keep=1))
    tables, cands = outs.pop("detections"), outs.pop("candidates")
    pool = (cands["scores"] > YOLO_F32["score_threshold"]).sum(dim=1)  # live candidates of each frame's pool
    kw = (YOLO_IOU, YOLO_F32["score_threshold"], cfg.detector.max_detections, YOLO_ANCHORS_640)
    with plain_on_card():
        want_card = yolov8.tables_from_candidates(cands, *kw)
    for k, want in want_card.items():
        if not torch.equal(tables[k], want):
            raise AssertionError(f"yolo_all_anchors: the card's {k} table differs from the plain nms on the card")
    t0, n = time.perf_counter(), 0
    while n < len(frames) and (n < WIDE_CPU_MIN_FRAMES or time.perf_counter() - t0 < WIDE_CPU_SECONDS):
        one = {k: v[n:n + 1].cpu() if isinstance(v, torch.Tensor) else v for k, v in cands.items()}
        for k, want in yolov8.tables_from_candidates(one, *kw).items():
            if not torch.equal(tables[k][n:n + 1].cpu(), want):
                raise AssertionError(f"yolo_all_anchors frame {n}: the {k} table differs from the plain nms on the CPU")
        n += 1
    cpu_nms_s = time.perf_counter() - t0
    inputs = {k: v.cpu() for k, v in tables.items()}
    inputs["ego_measurement"] = ego
    _, want = pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"), inputs)
    errs = compare_outputs("yolo_all_anchors", outs, want)
    per_frame = tables["valid"].sum(dim=1)
    return {"frames": len(frames), "pool": YOLO_ANCHORS_640, "max_detections": cfg.detector.max_detections,
            "launches": launches, "cpu_nms_frames": n, "cpu_nms_seconds": cpu_nms_s, "card_plain_nms_frames":
            len(frames), "valid_per_frame": {"mean": float(per_frame.double().mean()), "max": int(per_frame.max())},
            "pool_live": {"mean": float(pool.double().mean()), "min": int(pool.min())}, "max_abs_err": errs}


def wide_tagging_inputs(frames: int = WIDE_TAG_FRAMES, d_cap: int = 1024) -> dict:
    """Path (b)'s stream: `random_dets` tables of 1,024 detections at 60%
    valid a frame (seeded), and the ego stream."""
    rng = np.random.default_rng(4096)
    dets = [random_dets(rng, d_cap, "cpu") for _ in range(frames)]
    out = {k: torch.stack([getattr(x, k) for x in dets]) for k in ("bbox", "class_id", "confidence", "valid")}
    out["ego_measurement"] = torch.as_tensor(ego_motion_stream(frames, dt=1.0 / 30.0, seed=0).astype(np.float32))
    return out


def wide_frames_config():
    """Path (c): the frames path (`frames_config`) on a Hough grid of 360
    thetas."""
    cfg = frames_config()
    return cfg.replace(lanes=dataclasses.replace(cfg.lanes, num_thetas=360))


def check_wide_runner_path(device, label: str, cfg, inputs: dict, frames: int, lanes: bool = False) -> dict:
    """A wide path through `make_sequence_runner` on the card, counted (K1,
    K2 and K3 a frame), against the CPU runner over the frames it finishes
    in WIDE_CPU_SECONDS (`cpu_prefix_run`), and against the runner on the
    card with the kernels' plain versions (`plain_on_card`) over all
    ``frames``: discrete outputs and tags exact, floats within MAIN_ATOL
    (`compare_outputs`; with ``lanes`` the lane observations too)."""
    run = pt.make_sequence_runner(cfg, device=device)
    state = pt.initial_state(cfg, device=device)
    (_, got), launches = _counted_run(label, lambda: run(state, inputs),
                                      dict(tracker_step=frames, kalman_step=frames, tagging_step=frames,
                                           plan_step=frames))
    want, n, cpu_s = cpu_prefix_run(cfg, inputs, frames)
    errs = {"cpu": compare_outputs(f"{label} against the CPU", _first(got, n), want)}
    if lanes:
        errs["cpu_lanes"] = compare_lane_obs(label, _first(got, n)["lane_obs"], want["lane_obs"])
    with plain_on_card():
        _, plain = pt.make_sequence_runner(cfg, device=device)(pt.initial_state(cfg, device=device), inputs)
    errs["card_plain"] = compare_outputs(f"{label} against the plain versions on the card", got, _first(plain, frames))
    if lanes:
        errs["card_plain_lanes"] = compare_lane_obs(label, got["lane_obs"], _first(plain, frames)["lane_obs"])
    live = (got["track_id"] > 0).sum(dim=1)
    return {"frames": frames, "max_tracks": cfg.tracker.max_tracks, "max_detections": cfg.detector.max_detections,
            "launches": launches, "cpu_frames": n, "cpu_seconds": cpu_s, "card_plain_frames": frames,
            "live_slots": {"mean": float(live.double().mean()), "max": int(live.max())},
            "num_confirmed_max": int(got["num_confirmed"].max()), "max_abs_err": errs}


def check_theta_tables() -> dict:
    """On this host: the Hough tables `sincosf` computes at 90 and 180
    thetas equal the carried ones (XLA's, regenerated by
    tests/test_torch_hough.py), bit for bit."""
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import hough

    for n, carried in hough.CARRIED_TABLES.items():
        for got, want in zip(hough.theta_tables(n, torch.device("cpu")), carried):
            if not np.array_equal(got.numpy().view(np.uint32), np.asarray(want, np.float32).view(np.uint32)):
                raise AssertionError(f"the computed {n}-theta tables differ from the carried ones on this host")
    return {"grids": sorted(hough.CARRIED_TABLES), "result": "equal to the carried tables"}


def check_wide_paths(device, params: dict, frames, ego) -> dict:
    """The `wide_paths` phase, the three paths at the new widths: (a)
    `yolo_all_anchors`, (b) `tagging_4096` (the tagging path at 4,096 slots
    and 1,024 detections a frame), (c) `frames_360`, each held to its CPU
    run and to its card run with the plain versions; and the Hough tables
    on this host."""
    out = {"theta_tables": check_theta_tables()}
    t0 = time.perf_counter()
    out["yolo_all_anchors"] = check_yolo_all_anchors(device, params, frames, ego)
    seconds = {"yolo_all_anchors": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["tagging_4096"] = check_wide_runner_path(device, "tagging_4096", large_config(4096, 1024),
                                                 wide_tagging_inputs(), WIDE_TAG_FRAMES)
    if out["tagging_4096"]["live_slots"]["max"] <= 1024:
        raise AssertionError(f"tagging_4096: at most {out['tagging_4096']['live_slots']['max']} slots live")
    seconds["tagging_4096"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["frames_360"] = check_wide_runner_path(device, "frames_360", wide_frames_config(),
                                               frames_inputs(WIDE_FRAMES_FRAMES), WIDE_FRAMES_FRAMES, lanes=True)
    seconds["frames_360"] = time.perf_counter() - t0
    return {**out, "seconds": seconds}


def association_rounds(iou: torch.Tensor, rank: torch.Tensor, thr: float) -> int:
    """The rounds the mutual-max fixpoint takes on this matrix, the last
    (which accepts nothing) included: the plain version's loop, counted."""
    T, D = iou.shape
    key = rank[:, None] * D + torch.arange(D, dtype=torch.int32, device=iou.device)[None, :]
    big = torch.iinfo(torch.int32).max
    live = (iou >= thr) & (iou >= 0.0)
    rounds = 0
    while True:
        rounds += 1
        m = torch.where(live, iou, -1.0)
        at_row = live & (m == m.amax(dim=1, keepdim=True))
        at_col = live & (m == m.amax(dim=0, keepdim=True))
        accept = (at_row & at_col & (key == torch.where(at_row, key, big).amin(dim=1, keepdim=True))
                  & (key == torch.where(at_col, key, big).amin(dim=0, keepdim=True)))
        if not bool(accept.any()):
            return rounds
        live &= ~accept.any(dim=1, keepdim=True) & ~accept.any(dim=0, keepdim=True)


def large_kernel_inputs(device, t: int, d: int) -> dict:
    """Inputs of K1, K3 and K4's general instances at (t, d): the plain
    chain's table after 10 random steps (`random_dets`) and the next
    detections; `tagging_kernel_inputs`; the IoU matrix and ranks of that
    table."""
    cfg = pt.TrackerConfig(iou_threshold=0.3, max_age=30, min_hits=3, max_tracks=t)
    rng = np.random.default_rng(t * d)
    table = TrackTable.empty(t, cfg.trajectory_length, device)
    for _ in range(10):
        table = plain_tracker_step(table, random_dets(rng, d, device), cfg)[0]
    dets = random_dets(rng, d, device)
    return {"cfg": cfg, "table": table, "dets": dets, **tagging_kernel_inputs(device, t, d, rng),
            "association": association_inputs(table, dets)}


SORT_YARDSTICK = (1024, 64)  # K1 ranked by one block's sort, beside WIDE_SHAPES[0] ranked by counting
K1_STAGED_KERNELS = ("tracker_rank_kernel", "tracker_stage_kernel")  # before the cluster, where keys leave smem
K1_CLUSTER_KERNEL = "tracker_step_general"


def k1_kernels(t: int, d: int, length: int) -> tuple:
    """The kernels one launch of K1's general instance at (t, d) runs: the
    cluster kernel, after the rank and stage kernels where the keys leave
    shared memory (the wrapper then allocates their scratch)."""
    staged = tracker_kernel.scratch_words(t, d, length) > 0
    return (K1_STAGED_KERNELS if staged else ()) + (K1_CLUSTER_KERNEL,)


K4_STAGED_KERNELS = ("associate_stage_kernel",)  # before the cluster, where the keys are staged over the card
K4_CLUSTER_KERNEL = "associate_general_kernel"


def k4_kernels(t: int, d: int) -> tuple:
    """The kernels one launch of K4's general instance at (t, d) runs: the
    cluster kernel, after the stage kernel on the staged route (the wrapper
    then allocates its scratch)."""
    return (K4_STAGED_KERNELS if association_kernel.scratch_words(t, d) > 0 else ()) + (K4_CLUSTER_KERNEL,)


def whole_calls(records, names: tuple) -> list:
    """The calls in a trace's ``records`` of a function that launches the
    kernels ``names`` in that order, each the list of its records; a call
    the trace did not show whole is left out."""
    mine = sorted((e for e in records if any(n in e.name for n in names)), key=lambda e: e.time_range.start)
    calls, call = [], []
    for e in mine:
        if names[0] in e.name and call:
            calls.append(call)
            call = []
        call.append(e)
    calls.append(call)
    return [c for c in calls if [next(n for n in names if n in e.name) for e in c] == list(names)]


def call_span_us(calls: list):
    """The mean µs from a call's first kernel's start to its last one's
    end over ``calls`` (`whole_calls`), None where there are none."""
    return sum(c[-1].time_range.end - c[0].time_range.start for c in calls) / len(calls) if calls else None


HOST_AHEAD_CYCLES_PER_CALL = 400_000  # about 200 us of a device sleep a call: the host's enqueue of one call


def kernels_device_ms(run_once, names: tuple, reps: int, tries: int = 3) -> tuple:
    """Each call of ``run_once`` launches the kernels ``names`` in that
    order.  From one profiler trace of ``reps`` calls, enqueued behind a
    device sleep long enough for the host to enqueue them all (so that no
    gap between a call's kernels is the host's): each kernel's mean device
    ms, the mean ms from a call's first kernel's start to its last one's
    end (its device time), and the calls the trace showed whole (at least
    80%, else traced again)."""

    def body():
        torch.cuda._sleep(HOST_AHEAD_CYCLES_PER_CALL * reps)
        for _ in range(reps):
            run_once()

    for attempt in range(tries):
        _, records = card_trace(body)
        whole = whole_calls(records, names)
        if len(whole) >= reps * 4 // 5:
            by_kernel = {n: sum(c[i].time_range.elapsed_us() for c in whole) / len(whole) / 1e3
                         for i, n in enumerate(names)}
            return by_kernel, call_span_us(whole) / 1e3, len(whole)
        print(f"# trace {attempt + 1} of {tries} showed {len(whole)} whole calls of {reps}", file=sys.stderr)
    raise AssertionError(f"the profiler showed fewer than {reps * 4 // 5} whole calls of {names} in {tries} traces")


def measure_large_kernels(device, reps: int = 200) -> dict:
    """K1 and K4's general instances at GENERAL_SHAPES, SORT_YARDSTICK and WIDE_SHAPES,
    K3's at LARGE_SHAPES and at WIDE_TAG_SIZES slots (the first three
    WIDE_SHAPES) in both modes (``tagging_step``, ``tagging_step_frames``)
    and, as its yardstick, K3's small instance at K3_YARDSTICK: ms a call
    by CUDA events over ``reps`` calls (a tenth at 1,024), device ms from
    a profiler trace, the plain version's ms, and the bound, the bytes and
    operations counted on the data as `measure_kernels` counts them; with
    the thread block cluster each launch takes and the association's
    rounds.  The trace names each instance's kernel."""
    out = {}
    for t, d in GENERAL_SHAPES + (SORT_YARDSTICK,) + WIDE_SHAPES:
        n = reps if t < 1024 else reps // 10
        x = large_kernel_inputs(device, t, d)
        cfg, table, dets = x["cfg"], x["table"], x["dets"]

        def k1():
            return tracker_kernel.tracker_step(table, dets, cfg, cfg.min_hits)

        res = k1()
        iou, rank = x["association"]
        # Operations as `measure_kernels` counts them, over the rounds this
        # matrix takes (the plain loop's count): 16 an IoU pair, a row and a
        # column scan a round; two stable ranks.
        rounds = association_rounds(iou, rank, cfg.iou_threshold)
        k1_m = {"bytes": _nbytes(*_table_tensors(table), dets.bbox, dets.class_id, dets.confidence, dets.valid)
                + _nbytes(*_table_tensors(res[0]), res[1], res[2], res[3]),
                "operations": t * d * (16 + 2 * rounds) + 2 * t * t, "rounds": rounds,
                "cluster": tracker_kernel.cluster_size(t, d, cfg.trajectory_length)}

        def k4():
            return association_kernel.greedy_associate(iou, rank, cfg.iou_threshold)

        match = k4()
        k4_m = {"bytes": _nbytes(iou, rank, match), "operations": rounds * (2 * t * d + t), "rounds": rounds,
                "cluster": association_kernel.cluster_size(t, d)}
        plain = {
            "tracker_step": lambda: plain_tracker_step(table, dets, cfg),
            "associate": lambda: _greedy_associate_plain(iou, rank, cfg.iou_threshold),
        }
        launchers = {"tracker_step": (k1, K1_CLUSTER_KERNEL), "associate": (k4, K4_CLUSTER_KERNEL)}
        counted = {"tracker_step": k1_m, "associate": k4_m}
        if (t, d) in LARGE_SHAPES or (t in WIDE_TAG_SIZES and (t, d) != WIDE_SHAPES[-1]):
            k3_timings(x, launchers, counted, plain, "tagging_step_cluster")
        ms = {name: time_cuda(fn, n, warmup=5) for name, (fn, _) in launchers.items()}
        # One trace a kernel, kept when it saw 80% of the launches: a trace
        # of 100 general K1 launches dropped 12 of them on an H100.  K1's
        # and K4's device time is their kernels' (K1: rank, stage and
        # cluster; K4: stage and cluster) together.
        traced = min(n, 100)
        dev = {name: next(iter(device_times({name: launcher}, reps=traced, min_seen=traced * 4 // 5).values()))
               for name, launcher in launchers.items() if name not in ("tracker_step", "associate")}
        for name, fn, names, m in (("tracker_step", k1, k1_kernels(t, d, cfg.trajectory_length), k1_m),
                                   ("associate", k4, k4_kernels(t, d), k4_m)):
            by, span_ms, seen = kernels_device_ms(fn, names, traced)
            dev[name] = (span_ms, seen)
            m["device_ms_by_kernel"] = by
        out[f"{t}x{d}"] = {name: _timed(m, ms[name], dev[name], time_cuda(plain[name], 5, warmup=1))
                           for name, m in counted.items()}
    # The yardstick of K3's general instance: its small instance at T = 128,
    # both modes, timed as above.
    t, d = K3_YARDSTICK
    launchers, counted, plain = {}, {}, {}
    k3_timings(tagging_kernel_inputs(device, t, d, np.random.default_rng(t * d)), launchers, counted, plain,
               "tagging_step_kernel")
    dev = {name: next(iter(device_times({name: launcher}, reps=100, min_seen=80).values()))
           for name, launcher in launchers.items()}
    out[f"{t}x{d}"] = {name: _timed(m, time_cuda(launchers[name][0], reps, warmup=5), dev[name],
                                    time_cuda(plain[name], 5, warmup=1))
                       for name, m in counted.items()}
    return out


PHASE_SHAPES = (SORT_YARDSTICK, (1025, 64), (4096, 1024))
PHASES = ("loads", "id_rank", "staging", "rounds", "ring_copy", "updates", "confirmed_order")
K4_PHASE_SHAPES = ((1024, 1024),) + WIDE_SHAPES
K4_PHASES = ("ranks", "staging", "rounds", "match")
PHASE_BLOCKS, PHASE_MARKS = 16, 8  # block.cuh kPhaseBlocks, kPhaseMarks


def start_phase_build(source: str = "tracker_step.cu"):
    """Starts nvcc on ``source`` with -DMADPP_PHASE_CLOCKS (its cluster
    kernel's clock64() reads, block.cuh `PHASE_MARK`) into the build
    directory as a library of its own, in the background beside the
    kernels' own build; returns the process and the library's path."""
    from torch.utils import cpp_extension

    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = build.BUILD_DIR / f"lib{Path(source).stem}_phases.so"
    cmd = [nvcc, *build.NVCC_FLAGS, "-DMADPP_PHASE_CLOCKS", "-shared", "-Xcompiler", "-fPIC", "-o", str(target),
           str(build.CSRC / source)]
    return subprocess.Popen(cmd), target


def phase_library(job, launcher: str, argtypes: list, marks: str) -> tuple:
    """The phase-clock build of `start_phase_build` once it has finished:
    its C launcher ``launcher``, typed with ``argtypes``, and a function
    that copies the last launch's marks out through ``marks`` (a list of
    PHASE_BLOCKS x PHASE_MARKS clock64() reads)."""
    proc, target = job
    if proc.wait() != 0:
        raise RuntimeError(f"the phase-clock build of {target.name} failed ({proc.returncode})")
    lib = ctypes.CDLL(str(target))
    launch, copy_out = getattr(lib, launcher), getattr(lib, marks)
    launch.argtypes, launch.restype = argtypes, ctypes.c_int
    copy_out.argtypes, copy_out.restype = [ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_longlong * (PHASE_BLOCKS * PHASE_MARKS))()

    def copy():
        if copy_out(ctypes.addressof(buf)) != 0:
            raise RuntimeError(f"{marks} failed")
        return list(buf)

    return launch, copy


def read_phases(run, copy_marks, cluster: int, names: tuple, reps: int) -> dict:
    """Each phase's cycles on the slowest block of the cluster and on block
    0, the mean of ``reps`` calls of ``run`` after one, and each phase's
    share of the slowest block's total; ``copy_marks`` returns the marks of
    the last call (PHASE_BLOCKS x PHASE_MARKS clock64() reads)."""
    runs = []
    for _ in range(reps + 1):
        run()
        torch.cuda.synchronize()
        m = np.array(copy_marks(), dtype=np.int64).reshape(PHASE_BLOCKS, PHASE_MARKS)[:cluster, :len(names) + 1]
        runs.append(np.diff(m, axis=1))
    cycles = np.mean(runs[1:], axis=0)  # (blocks, phases)
    slowest = cycles[int(np.argmax(cycles.sum(axis=1)))]
    return {
        "cluster": int(cycles.shape[0]),
        "cycles_slowest_block": dict(zip(names, slowest.round(1).tolist())),
        "cycles_block0": dict(zip(names, cycles[0].round(1).tolist())),
        "share_slowest_block": dict(zip(names, (slowest / slowest.sum()).round(4).tolist())),
    }


class _Swapped:
    """A kernels library with some of its functions swapped; every other
    name is the library's own."""

    def __init__(self, lib, swap: dict):
        self._lib, self._swap = lib, swap

    def __getattr__(self, name):
        return self._swap[name] if name in self._swap else getattr(self._lib, name)


@contextlib.contextmanager
def kernels_with(**swap):
    """`build.kernels()` with some of its functions swapped (the wrappers
    call through it), restored on exit."""
    lib = build.kernels()
    build._kernels = _Swapped(lib, swap)
    try:
        yield
    finally:
        build._kernels = lib


def measure_phases(device, job, reps: int = 6) -> dict:
    """K1's cluster kernel's phases at PHASE_SHAPES, from the phase-clock
    build of tracker_step.cu (`start_phase_build`) launched through the
    wrapper (`read_phases`)."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    launch, copy = phase_library(job, "madpp_tracker_step", [vp] * 19 + [ci, ci, ci, ci, cf, ci, ci, vp],
                                 "madpp_tracker_phases")
    out = {}
    for t, d in PHASE_SHAPES:
        x = large_kernel_inputs(device, t, d)
        cfg, table, dets = x["cfg"], x["table"], x["dets"]
        with kernels_with(tracker_step=launch):
            out[f"{t}x{d}"] = read_phases(lambda: tracker_kernel.tracker_step(table, dets, cfg, cfg.min_hits), copy,
                                          tracker_kernel.cluster_size(t, d, cfg.trajectory_length), PHASES, reps)
    return out


def measure_k4_phases(device, job, reps: int = 6) -> dict:
    """K4's cluster kernel's phases (rank loads, staging, rounds, match
    write) at K4_PHASE_SHAPES on `large_kernel_inputs`' matrices, from the
    phase-clock build of associate.cu (`start_phase_build`) launched
    through the wrapper (`read_phases`), with the rounds each matrix takes
    (`association_rounds`)."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    launch, copy = phase_library(job, "madpp_associate", [vp] * 3 + [ci, ci, cf, vp, vp], "madpp_associate_phases")
    out = {}
    for t, d in K4_PHASE_SHAPES:
        x = large_kernel_inputs(device, t, d)
        iou, rank = x["association"]
        thr = x["cfg"].iou_threshold
        with kernels_with(associate=launch):
            out[f"{t}x{d}"] = read_phases(lambda: association_kernel.greedy_associate(iou, rank, thr), copy,
                                          association_kernel.cluster_size(t, d), K4_PHASES, reps)
        out[f"{t}x{d}"]["rounds"] = association_rounds(iou, rank, thr)
    return out


def _timed(counted: dict, ms: float, dev: tuple, plain_ms: float) -> dict:
    """A `measure_large_kernels` entry: the counts, the times and the bound."""
    t_bytes = counted["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = counted["operations"] / PEAK_F32_PER_S * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return {**counted, "ms": ms, "device_ms": dev[0], "profiled_launches": dev[1], "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by}


def tagging_kernel_inputs(device, t: int, d: int, rng) -> dict:
    """K3's inputs at (t, d): the tagging state after 10 random frames of
    the plain version, the next frame, and a lane and a feature row."""
    tcfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    tcfg = tcfg.replace(tracker=dataclasses.replace(tcfg.tracker, max_tracks=t))
    rules = TaggingRules.from_config(tcfg)
    state = TaggingState.initial(rules.window, rules.history, t, device, interaction_history=rules.interaction_history)
    for f in range(10):
        state = tagging_step_plain(rules, state, *random_tagging_frame(rng, f, t, d, device))[0]
    return {"rules": rules, "state": state, "tag_frame": random_tagging_frame(rng, 10, t, d, device),
            "rows": frames_rows_of(device)}


def k3_timings(x: dict, launchers: dict, counted: dict, plain: dict, kernel: str) -> None:
    """K3 on `tagging_kernel_inputs` ``x``, in detections mode
    (``tagging_step``) and frames mode (``tagging_step_frames``): into
    ``launchers`` each mode's wrapper call and the kernel's name in a
    trace, into ``plain`` its plain version, into ``counted`` its bytes and
    operations on this data (`tagging_bytes`, the rows' 56 bytes more in
    frames mode) and the thread block cluster a lane it takes."""
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.rules import frames_from_rows

    rules, state, (tdets, ttable, vrow) = x["rules"], x["state"], x["tag_frame"]
    lane_row, feat_row = x["rows"]
    lane_obs, feats = frames_from_rows(lane_row, feat_row)
    t, d = ttable.track_id.shape[-1], tdets.class_id.shape[-1]
    ops = tagging_operations(t, d, rules.window, rules.history, rules.interaction_history)
    for name, rows, extra in (("tagging_step", (), 0), ("tagging_step_frames", (lane_row, feat_row), 56)):
        def k3(rows=rows):
            return tagging_kernel.tagging_step(rules, state, tdets, ttable, vrow, *rows)

        new_state, tag_f, tag_i = k3()
        counted[name] = {"bytes": tagging_bytes(rules, state, tdets, ttable, new_state, tag_f, tag_i) + extra,
                         "operations": ops, "cluster": tagging_kernel.cluster_size(t, d)}
        launchers[name] = (k3, kernel)
    plain["tagging_step"] = lambda: tagging_step_plain(rules, state, tdets, ttable, vrow)
    plain["tagging_step_frames"] = lambda: tagging_step_plain(rules, state, tdets, ttable, vrow, lane_obs, feats)


def measure_round_cost(device, reps: int = 10) -> dict:
    """K4's general instance on the staircase (one pair a round, every live
    line stale in each) at (256, 128) and (1,024, 1,024), beside the
    3-round matrix of `large_kernel_inputs` at (256, 128): device ms from
    a profiler trace (`kernels_device_ms`, the stage kernel's start to the
    cluster kernel's end where it is staged), the rounds, and the device
    us a round the staircase adds over the 3-round matrix at (256, 128)."""
    x = large_kernel_inputs(device, 256, 128)
    iou3, rank3 = x["association"]
    thr = x["cfg"].iou_threshold
    cases = {"large_256x128": (iou3, rank3)}
    for t, d in ((256, 128), (1024, 1024)):
        cases[f"staircase_{t}x{d}"] = (torch.tensor(ladder_iou(t, d, stair_step(t, d)), device=device),
                                      torch.arange(t, dtype=torch.int32, device=device))
    out = {}
    for name, (iou, rank) in cases.items():
        t, d = iou.shape
        _, ms, seen = kernels_device_ms(lambda iou=iou, rank=rank: association_kernel.greedy_associate(iou, rank, thr),
                                        k4_kernels(t, d), reps)
        out[name] = {"rounds": association_rounds(iou, rank, thr), "device_ms": ms, "profiled_launches": seen}
    a, b = out["large_256x128"], out["staircase_256x128"]
    out["us_a_round_256x128"] = (b["device_ms"] - a["device_ms"]) * 1e3 / (b["rounds"] - a["rounds"])
    return out


def measure_wide_nms(device, params: dict) -> dict:
    """K5's large instance (the mask and the scan) at (64, 8,400), the pools
    of `yolo_all_anchors`' chunk (every anchor of the first 64 float32
    frames, as `nms` builds them), and at (2, 33,600), tie-quantized random
    pools: ms a call by CUDA events, device ms (from the mask kernel's
    start to the scan kernel's end, and each kernel's, from a profiler
    trace, `kernels_device_ms`), the plain version's ms, and the bound,
    counted on the data as `measure_nms_kernel` counts it."""
    cands = yolo_chunk_candidates(device, params)
    scores, _, _, boxes = nms_prefilter(cands["boxes"], cands["scores"], cands["classes"],
                                        YOLO_F32["score_threshold"], YOLO_ANCHORS_640)
    b, k = WIDE_NMS[-1]
    rand_boxes, rand_scores = _pools(np.random.default_rng(b * k), b, k)
    pools = {"64x8400": (boxes, scores),
             f"{b}x{k}": (torch.tensor(rand_boxes, device=device), torch.tensor(rand_scores, device=device))}
    out = {}
    for name, (bx, sc) in pools.items():
        def launch(bx=bx, sc=sc):
            return nms_kernel.nms_keep(bx, sc, YOLO_IOU)

        keep = launch()
        if not torch.equal(keep, plain_nms_keep(bx, sc, YOLO_IOU)):
            raise AssertionError(f"K5 {name}: the large instance differs from the plain version")
        alive = (sc > 0).sum(dim=1).long()
        m = {"ms": time_cuda(launch, 20, warmup=3),
             "plain_ms": time_cuda(lambda bx=bx, sc=sc: plain_nms_keep(bx, sc, YOLO_IOU), 1, warmup=1),
             "bytes": _nbytes(bx, sc, keep),
             "operations": int(16 * (alive * (alive - 1) // 2).sum() + math.ceil(sc.shape[1] / 32) * keep.sum()),
             "shape": list(sc.shape), "kept": int(keep.sum()),
             "workspace_bytes": 4 * sum(nms_kernel.workspace_words(*sc.shape))}
        m["device_ms_by_kernel"], m["device_ms"], m["profiled_launches"] = kernels_device_ms(
            launch, ("nms_mask_kernel", "nms_scan_kernel"), 20)
        t_bytes = m["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = m["operations"] / PEAK_F32_PER_S * 1e3
        m["bound_ms"], m["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        out[name] = {"nms_keep": m}
    return out

def _path_trace(run, k1_names: tuple) -> dict:
    """One profiler trace of ``run()``: the wall time, the device's busy
    share, and K1's launches (the calls of its kernels ``k1_names`` the
    trace shows whole) and mean device microseconds a launch, from its
    first kernel's start to its last one's end."""
    wall_s, on_device = card_trace(run)
    busy_us = sum(e.time_range.elapsed_us() for e in on_device)
    k1 = whole_calls(on_device, k1_names)
    return {"wall_us": wall_s * 1e6, "device_busy_us": busy_us, "busy_share": busy_us / (wall_s * 1e6),
            "device_items": len(on_device), "k1_kernels": list(k1_names), "k1_launches": len(k1),
            "k1_device_us": call_span_us(k1)}


def measure_large_paths(device, params: dict, frames, ego, rounds: int = 2, profiled_frames: int = 100) -> dict:
    """The `large_paths` phase: the two full-width paths that launch K1's
    general instance on every frame up to 1,024 lines, each held to its CPU
    run, and all five large-table paths timed.  (a) the YOLO path at
    max_detections=YOLO_MAX_DET (the JAX `nms` default): yolov8n at 640 in
    float32 at score 0.05 over the 300 seeded 480x640 frames in 5 chunks of
    64, K5 and K1 at (64, 300), K2 and the planner (`check_yolo_path`); (b)
    ROADMAP §3's tagging path at max_tracks=160, max_detections=80 over
    LARGE_FRAMES frames, K1 and K3 at T = 160 and K2
    (`check_large_tagging_path`).  The `wide_paths` phase holds the three
    wider ones to their CPU runs: `yolo_all_anchors` (one 64-frame chunk,
    K5 at (64, 8,400)), `tagging_4096` (WIDE_TAG_FRAMES frames, K1 at
    (4,096, 1,024), K3 at T = 4,096) and `frames_360` (WIDE_FRAMES_FRAMES
    road frames).  Then each path's frames/s on the host clock around runs
    that end in a synchronise, in turns (forward, then backward) after a
    warm run of each, the best of 2 ``rounds`` of two counting; its
    launches in one run, counted; and one profiler trace of each over its
    first ``profiled_frames`` frames (at most its run): the busy share and
    its K1 instance's device us a launch."""
    yolo_cfg = wide_yolo_config()
    out = {}
    out["yolo_max_det_300"], _ = check_yolo_path(device, params, frames, ego, YOLO_F32,
                                                 "YOLO path at max_detections=300", cfg=yolo_cfg)
    out["tagging_160x80"] = check_large_tagging_path(device)
    _, yolo_run = make_yolo_sequence_runner(yolo_cfg, batch=YOLO_BATCH, iou_threshold=YOLO_IOU, img_size=YOLO_IMG,
                                            device=device, **YOLO_F32)
    anchors_run = wide_yolo_runner(device)
    tag_cfg = large_config(160, 80)
    wide_cfg = large_config(4096, 1024)
    road_cfg = wide_frames_config()
    on_card = {k: torch.as_tensor(v).to(device) for k, v in large_tagging_inputs().items()}
    wide_inputs = {k: v.to(device) for k, v in wide_tagging_inputs().items()}
    road_inputs = {k: torch.as_tensor(v).to(device) for k, v in frames_inputs(WIDE_FRAMES_FRAMES).items()}
    length = yolo_cfg.tracker.trajectory_length
    runners = {  # name: (config, run(state, n), frames, K1's kernels in a trace)
        "yolo_max_det_300": (yolo_cfg, lambda s, n: yolo_run(params, s, frames[:n], ego[:n]), len(frames),
                             k1_kernels(64, YOLO_MAX_DET, length)),
        "tagging_160x80": (tag_cfg, pt.make_sequence_runner(tag_cfg, device=device), LARGE_FRAMES,
                           k1_kernels(160, 80, tag_cfg.tracker.trajectory_length)),
        "yolo_all_anchors": (yolo_cfg, lambda s, n: anchors_run(params, s, frames[:n], ego[:n]), YOLO_BATCH,
                             k1_kernels(64, YOLO_MAX_DET, length)),
        "tagging_4096": (wide_cfg, pt.make_sequence_runner(wide_cfg, device=device), WIDE_TAG_FRAMES,
                         k1_kernels(4096, 1024, wide_cfg.tracker.trajectory_length)),
        "frames_360": (road_cfg, pt.make_sequence_runner(road_cfg, device=device), WIDE_FRAMES_FRAMES,
                       ("tracker_step_kernel",)),
    }
    inputs = {"tagging_160x80": on_card, "tagging_4096": wide_inputs, "frames_360": road_inputs}

    def call(name, n):
        cfg, run, _, _ = runners[name]
        state = pt.initial_state(cfg, device=device)
        if name in inputs:
            return run(state, {k: v[:n] for k, v in inputs[name].items()})
        return run(state, n)

    def timed(name, n=None):
        n = n or runners[name][2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(name, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    names = tuple(runners)
    for name in names:
        timed(name)
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            times[name].append(timed(name))
    for name in names:
        n, k1_names = runners[name][2], runners[name][3]
        _zero_counts()
        call(name, n)
        torch.cuda.synchronize()
        traced = min(n, profiled_frames if name != "frames_360" else WIDE_FRAMES_PROFILED)
        out.setdefault(name, {}).update(
            frames=n, seconds=times[name], frames_per_s=n / min(times[name]), launches=_read_counts(),
            profiled={"frames": traced, **_path_trace(lambda name=name: timed(name, traced), k1_names)})
    out["clusters"] = {"k1_64x300": tracker_kernel.cluster_size(64, YOLO_MAX_DET, yolo_cfg.tracker.trajectory_length),
                       "k1_160x80": tracker_kernel.cluster_size(160, 80, tag_cfg.tracker.trajectory_length),
                       "k1_4096x1024": tracker_kernel.cluster_size(4096, 1024, wide_cfg.tracker.trajectory_length),
                       "k3_4096": tagging_kernel.cluster_size(4096, 1024)}
    return out


# The host stack: records, the AutoTagger, the tag database and the
# reference-named per-frame facades, on the card.
HOST_FRAMES = 40
HOST_ROAD_FRAMES = 10
HOST_YOLO_FRAMES = 8  # one chunk of ObjectDetector's frontend (batch 8)
HOST_MASKED = {"session_id", "start_time", "end_time", "session_info"}


def same_records(a, b, path: str = "", atol: float = MAIN_ATOL) -> None:
    """Host records, dicts, sequences and arrays equal, floats within
    ``atol``; the keys of HOST_MASKED (ids and times from
    ``datetime.now``) skipped."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.name not in HOST_MASKED:
                same_records(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}", atol)
    elif isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys {sorted(set(a) ^ set(b))} differ")
        for k in a:
            if k not in HOST_MASKED:
                same_records(a[k], b[k], f"{path}[{k!r}]", atol)
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: {len(a)} entries against {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            same_records(x, y, f"{path}[{i}]", atol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{path}: {a.dtype} {a.shape} against {b.dtype} {b.shape}")
        if a.dtype.kind == "f" and not np.allclose(a, b, rtol=0, atol=atol):
            raise AssertionError(f"{path}: off by {float(np.abs(a - b).max())}")
        if a.dtype.kind != "f" and not np.array_equal(a, b):
            raise AssertionError(f"{path}: differs")
    elif isinstance(a, float) or isinstance(b, float):
        if not abs(a - b) <= atol:
            raise AssertionError(f"{path}: {a} against {b}")
    elif a != b:
        raise AssertionError(f"{path}: {a!r} against {b!r}")


def float_gap(a, b) -> float:
    """The largest gap between the floats of two host records of one shape
    (0.0 where they are equal bit for bit)."""
    if dataclasses.is_dataclass(a):
        return max([float_gap(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)
                    if f.name not in HOST_MASKED], default=0.0)
    if isinstance(a, dict):
        return max([float_gap(a[k], b[k]) for k in a if k not in HOST_MASKED], default=0.0)
    if isinstance(a, (list, tuple)):
        return max([float_gap(x, y) for x, y in zip(a, b)], default=0.0)
    if isinstance(a, np.ndarray) and a.dtype.kind == "f" and a.size:
        return float(np.abs(a.astype(np.float64) - b).max())
    if isinstance(a, float):
        return abs(a - b)
    return 0.0


def host_chain(outs: dict, dets: dict, frames: int, db_path: str) -> dict:
    """`extract_frame` on every frame, the AutoTagger over the run's tags and
    a TagDatabase round trip: the records, the tagger and the database's
    statistics and rows."""
    from multimodal_autonomous_driving_perception_and_planning_torch.database import TagDatabase
    from multimodal_autonomous_driving_perception_and_planning_torch.host import extract_frame
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging import AutoTagger

    records = [extract_frame(outs, dets, f) for f in range(frames)]
    tagger = AutoTagger(video_path="synthetic", fps=30.0)
    tagger.ingest_device_tags(outs["tags"], frames)
    tagger.finalize()
    db = TagDatabase(db_path)
    saved = db.save_all_tags(tagger)
    tags = sorted(tagger.tag_counts)
    chain = {
        "records": [(r.detections, r.tracks, r.vehicle_state, r.optimal_trajectory,
                     [c.cost for c in r.candidate_trajectories], r.tags) for r in records],
        "statistics": tagger.get_tag_statistics(), "frame_tags": tagger.frame_tags,
        "search": {t: [f.frame_idx for f in tagger.search_by_tag(t)] for t in tags},
        "segments": {t: tagger.get_event_segments(t, min_duration=2) for t in tags},
        "high_risk": [f.frame_idx for f in tagger.get_high_risk_frames()],
        "saved": saved, "db_statistics": db.get_tag_statistics(),
        "db_rows": {t: db.search_by_tag(t, limit=1000) for t in tags},
        "db_high_risk": db.search_high_risk(limit=10_000),
    }
    db.close()
    return chain


def check_host_stack(device) -> dict:
    """The `host_stack` phase on the card.
    (a) The tagging path over HOST_FRAMES frames, then `extract_frame` on
    every frame, the AutoTagger and a TagDatabase round trip, against the
    same chain on the CPU run (`same_records`).
    (b) The facades one frame at a time on the card (MultiObjectTracker,
    VehicleStateEstimator, MotionPlanner, AutoTagger.tag_frame, and
    LaneDetector on road frames) against the card's sequence runner, as
    tests/test_compat.py holds them: track ids, the ego state and the
    chosen plan exact, the tags' records within MAIN_ATOL, the lane flags
    exact and fits by x within LANE_X_ATOL.
    (c) ObjectDetector(mode="yolo", allow_random_init=True).detect_stream on
    one chunk against `make_yolo_frontend` with its weights on the card.
    The kernels' counts are zeroed before (b) and (c) and read after: the
    facades' own launches of K1-K3 and K5."""
    import tempfile

    from multimodal_autonomous_driving_perception_and_planning_torch import compat
    from multimodal_autonomous_driving_perception_and_planning_torch.host import extract_frame
    from multimodal_autonomous_driving_perception_and_planning_torch.perception.detector import (
        ObjectDetector,
        make_yolo_frontend,
    )
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging import AutoTagger

    n = HOST_FRAMES
    inputs = synthetic_inputs(n)
    dets = {k: inputs[k] for k in ("bbox", "class_id", "confidence", "valid")}
    # All outputs (the records read the trajectories and the candidates), as
    # tests/test_host_stack.py and tests/test_compat.py run them.
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    _, want = pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"), inputs)
    _, got = pt.make_sequence_runner(cfg, device=device)(pt.initial_state(cfg, device=device), inputs)
    with tempfile.TemporaryDirectory() as tmp:
        chain_card = host_chain(got, dets, n, f"{tmp}/card.db")
        chain_cpu = host_chain(want, dets, n, f"{tmp}/cpu.db")
    same_records(chain_card, chain_cpu, "host chain")

    main_cfg = cfg.replace(enable_tagging=False)
    _, fused = pt.make_sequence_runner(main_cfg, device=device)(pt.initial_state(main_cfg, device=device), inputs)
    road = frames_inputs(HOST_ROAD_FRAMES)
    frames_cfg = frames_config()
    _, road_outs = pt.make_sequence_runner(frames_cfg, device=device)(pt.initial_state(frames_cfg, device=device),
                                                                      road)
    base = AutoTagger(video_path="synthetic", fps=30.0)
    base.ingest_device_tags(got["tags"], n)
    records = [extract_frame(got, dets, f) for f in range(n)]
    torch.cuda.synchronize()

    _zero_counts()
    tracker = compat.MultiObjectTracker(device=device)
    estimator = compat.VehicleStateEstimator(device=device)
    planner = compat.MotionPlanner(device=device)
    tagger = compat.AutoTagger("synthetic", 30.0, cfg=cfg, device=device)
    lanes = compat.LaneDetector(device=device)
    vs_fused = {k: getattr(fused["vehicle_state"], k).cpu() for k in ("x", "y", "speed", "heading")}
    for f in range(n):
        tracks = tracker.update(records[f].detections)
        vstate = estimator.step(inputs["ego_measurement"][f])
        optimal, candidates = planner.plan(vstate)
        m = int(fused["num_confirmed"][f])
        want_ids = [int(fused["track_id"][f, s]) for s in fused["confirmed_order"][f][:m].tolist()]
        if [t.track_id for t in tracks] != want_ids:
            raise AssertionError(f"host stack: MultiObjectTracker frame {f} ids differ from the fused run")
        for k, v in vs_fused.items():
            if getattr(vstate, k) != float(v[f]):
                raise AssertionError(f"host stack: VehicleStateEstimator frame {f} {k} differs from the fused run")
        best = int(fused["plan_best"][f])
        if not np.array_equal(optimal.positions, fused["plan_positions"][f, best].cpu().numpy()):
            raise AssertionError(f"host stack: MotionPlanner frame {f} plan differs from the fused run")
        ft = tagger.tag_frame(None, detections=records[f].detections, tracks=records[f].tracks, lanes=None,
                              vehicle_state=records[f].vehicle_state)
        if sorted(ft.all_tags) != sorted(base.frame_tags[f].all_tags):
            raise AssertionError(f"host stack: AutoTagger.tag_frame frame {f} tags differ from the fused run")
        for part in ("scene", "maneuver"):
            same_records(getattr(ft, part), getattr(base.frame_tags[f], part), f"tag_frame {f} {part}")
    lane_found = 0
    for f in range(HOST_ROAD_FRAMES):
        found = lanes.detect(road["frame"][f])
        obs = road_outs["lane_obs"]
        for side, lane in zip(("left", "right"), found):
            if (lane is not None) != bool(getattr(obs, f"{side}_found")[f]):
                raise AssertionError(f"host stack: LaneDetector frame {f} {side} found differs from the fused run")
            if lane is not None:
                lane_found += 1
                fit = getattr(obs, f"{side}_fit")[f].cpu().numpy()
                h = float(frames_cfg.frame_height)
                gap = max(abs(np.polyval(lane.polynomial.astype(np.float64), y) - np.polyval(fit.astype(np.float64), y))
                          for y in (h, 0.8 * h, 0.6 * h))
                if not gap <= LANE_X_ATOL:
                    raise AssertionError(f"host stack: LaneDetector frame {f} {side} fit off by {gap} px")
    detector = ObjectDetector(mode="yolo", allow_random_init=True, device=device)
    chunk = yolo_inputs(HOST_YOLO_FRAMES)[0]
    tables = detector.detect_stream(chunk)
    torch.cuda.synchronize()
    launches = _read_counts()
    _, stream_fn = make_yolo_frontend(detector.cfg, device=device)
    want_tables = stream_fn(detector.variables, chunk)
    for k, v in want_tables.items():
        if not torch.equal(tables[k], v):
            raise AssertionError(f"host stack: ObjectDetector.detect_stream {k} differs from make_yolo_frontend")
    expected = {name: 0 for name in KERNEL_MODULES}
    # K1 a frame in MultiObjectTracker.update, K2 in VehicleStateEstimator.step,
    # K3 in AutoTagger.tag_frame, K6 in MotionPlanner.plan, K5 once for the YOLO chunk.
    expected.update(tracker_step=n, kalman_step=n, tagging_step=n, plan_step=n, nms_keep=1)
    if launches != expected:
        raise AssertionError(f"host stack: the facades' kernel launches {launches}, expected {expected}")
    return {"frames": n, "road_frames": HOST_ROAD_FRAMES, "launches": launches,
            "records": len(chain_card["records"]), "tags": len(chain_card["search"]),
            "db_rows": chain_card["saved"], "high_risk": len(chain_card["high_risk"]),
            "lanes_found": lane_found, "yolo_detections": int(tables["valid"].sum()),
            "result": "records, tagger and database equal the CPU chain; facades equal the fused card run"}


# --- the stream runtime, the device detection stream, the demo and the webview ---
STREAM_FRAMES, STREAM_CHUNK = 300, 64  # benchmarks/suite.py:855-915's stream; the last chunk padded to 320
STREAM_SLOTS, SMALL_RING_SLOTS, SMALL_RING_THREADS, SMALL_RING_FRAMES = 128, 16, 4, 160  # 3 chunks, the last padded
# The feed probe: 6 chunks of 64 frames, each read behind a ~0.1 s sleep
# (2e8 cycles at up to 1.98 GHz) on the compute stream.
PROBE_CHUNKS, PROBE_SLEEP_CYCLES = 6, 200_000_000
WEBVIEW_FRAMES, WEBVIEW_CHUNK = 120, 30
SCAN_COUNTERS = 1_000_000  # the device detections' counters held card against CPU
MULTICAM_CAMERAS, MULTICAM_FRAMES = 4, 30


def _expect(label: str, launches: dict, **counts) -> None:
    expected = {name: 0 for name in KERNEL_MODULES}
    expected.update(counts)
    if launches != expected:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")


def check_device_detections(device) -> dict:
    """`device_detection_stream` of 300 frames at capacity 16 on the card:
    its deterministic part on the card equals the CPU's on the card's
    draws; a chunk from ``start_frame_count=101`` equals that slice of the
    whole stream; and the tagging path's runner fed the card's tables (in
    uncopied) equals the same runner fed their host copies, every output
    exact, the kernels' counts zeroed just before the card-table run."""
    from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic

    n, cap = NUM_FRAMES, 16
    stream = synthetic.device_detection_stream(n, capacity=cap, device=device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()  # a second call, past the first call's set-up of the generator's kernels
    again = synthetic.device_detection_stream(n, capacity=cap, device=device)
    end.record()
    torch.cuda.synchronize()
    if any(not torch.equal(again[k], v) for k, v in stream.items()):
        raise AssertionError("device detections: two calls with one seed differ")
    if any(v.device.type != torch.device(device).type for v in stream.values()):
        raise AssertionError("device detections: the stream is not on the device asked for")
    draws = synthetic.device_detection_draws(cap, 0, device)
    # Counters 1 to 1,000,000 x 16 slots: the angles over which the float64
    # sine (`synthetic._wave`) gives XLA's floor on the CPU
    # (tests/test_torch_device_detections.py); the card's tables there must
    # equal the CPU's, x_base and all.
    counters = torch.arange(1, SCAN_COUNTERS + 1, device=device)
    rows = {k: v.index_select(0, counters % synthetic.DEVICE_STREAM_PERIOD) for k, v in draws.items()}
    card = synthetic._detections_from_draws(counters, **rows)
    cpu = synthetic._detections_from_draws(counters.cpu(), **{k: v.cpu() for k, v in rows.items()})
    for k, v in cpu.items():
        if not (torch.equal(card[k].cpu(), v) and torch.equal(stream[k].cpu(), v[:n])):
            raise AssertionError(f"device detections: {k} on the card differs from the CPU's on the same draws")
    del card, cpu, rows
    chunk = synthetic.device_detection_stream(64, capacity=cap, start_frame_count=101, device=device)
    for k, v in chunk.items():
        if not torch.equal(v, stream[k][100:164]):
            raise AssertionError(f"device detections: the chunk from 101 differs in {k} from the whole stream")
    valid = stream["valid"].sum(1)
    if not (int(valid.min()) >= 3 and int(valid.max()) <= 7):
        raise AssertionError("device detections: a frame outside 3-7 boxes")

    cfg = bench_config(True)
    ego = ego_motion_stream(n, dt=1.0 / 30.0, seed=0).astype(np.float32)
    run = pt.make_sequence_runner(cfg, device=device)
    _, from_host = run(pt.initial_state(cfg, device=device),
                       dict({k: v.cpu().numpy() for k, v in stream.items()}, ego_measurement=ego))
    torch.cuda.synchronize()
    _zero_counts()
    _, from_card = run(pt.initial_state(cfg, device=device), dict(stream, ego_measurement=ego))
    torch.cuda.synchronize()
    launches = _read_counts()
    _expect("device detections", launches, tracker_step=n, kalman_step=n, tagging_step=n, plan_step=n)
    for k in MAIN_DISCRETE + MAIN_FLOAT:
        if not torch.equal(from_card[k], from_host[k]):
            raise AssertionError(f"device detections: {k} differs between the card's tables and their host copy")
    for k, v in from_host["tags"].items():
        if not torch.equal(from_card["tags"][k], v):
            raise AssertionError(f"device detections: tag {k} differs between the card's tables and their host copy")
    return {"frames": n, "capacity": cap, "stream_ms": start.elapsed_time(end), "launches": launches,
            "boxes": int(valid.sum()), "births": int(from_card["track_id"].max()), "scanned_counters": SCAN_COUNTERS,
            "result": "deterministic part equal to the CPU's on the card's draws over counters 1 to "
                      f"{SCAN_COUNTERS:,} x {cap} slots; the chunk from 101 equal to the slice; the runner on the "
                      "card's tables equal to the runner on their host copies"}


def stream_reference(device, cfg, frames):
    """The card's monolithic runner over the stream's frames, with the
    stream's detections and ego rows."""
    dets = simulated_detection_stream(frames.shape[0])
    ego = ego_motion_stream(frames.shape[0], dt=1.0 / 30.0, seed=0).astype(np.float32)
    _, outs = pt.make_sequence_runner(cfg, device=device)(pt.initial_state(cfg, device=device),
                                                          dict(dets, ego_measurement=ego, frame=frames))
    return outs


def compare_stream(label: str, got: dict, want: dict) -> dict:
    """A stream's host outputs against the card's monolithic run: discrete
    outputs, tags and lane flags exact, floats within MAIN_ATOL.  Returns
    the worst float gap and whether every output was bit-identical."""
    for k in MAIN_DISCRETE:
        if not torch.equal(got[k], want[k].cpu()):
            raise AssertionError(f"{label}: {k} differs from the monolithic run")
    floats = [(k, got[k], want[k]) for k in MAIN_FLOAT]
    floats += [(f"vehicle_state.{f}", getattr(got["vehicle_state"], f), getattr(want["vehicle_state"], f))
               for f in VEHICLE_STATE_FIELDS]
    for k, b in want["tags"].items():
        if b.is_floating_point():
            floats.append((f"tags.{k}", got["tags"][k], b))
        elif not torch.equal(got["tags"][k], b.cpu()):
            raise AssertionError(f"{label}: tag {k} differs from the monolithic run")
    for k in LANE_FIELDS:
        a, b = getattr(got["lane_obs"], k), getattr(want["lane_obs"], k)
        if a.is_floating_point():
            floats.append((f"lane_obs.{k}", a, b))
        elif not torch.equal(a, b.cpu()):
            raise AssertionError(f"{label}: lane {k} differs from the monolithic run")
    gap = max(float((a - b.cpu()).abs().max()) for _, a, b in floats)
    if not gap <= MAIN_ATOL:
        raise AssertionError(f"{label}: floats {gap} from the monolithic run")
    exact = all(torch.equal(a, b.cpu()) for _, a, b in floats)
    return {"max_abs_err": gap, "bit_identical": exact}


def feed_race_probe(device, feed_cls=None) -> dict:
    """`runtime.stream.FrameFeed`'s two waits under a consumer that never
    waits on the host: each chunk's device buffer is read by a copy queued
    on the compute stream behind `torch.cuda._sleep`, and the ring is full
    before the first drain, so the host runs chunks ahead of the card.
    Without the wait on the H2D copy's event, the drain of chunk k+2
    overwrites the pinned buffer before chunk k's copy reads it; without the
    side stream's wait on the consumer's event, chunk k+2's copy overwrites
    the device buffer before chunk k is read.  Either way a chunk read on
    the card differs from the ring's bytes.  ``feed_cls`` defaults to
    `FrameFeed`.  Returns the chunks that differ."""
    from multimodal_autonomous_driving_perception_and_planning_torch.runtime import NativeFrameSource
    from multimodal_autonomous_driving_perception_and_planning_torch.runtime.stream import FrameFeed

    feed_cls = feed_cls or FrameFeed
    chunk, chunks = STREAM_CHUNK, PROBE_CHUNKS
    total = chunk * chunks

    def source():
        src = NativeFrameSource(width=640, height=480, slots=total, num_frames=total)
        deadline = time.perf_counter() + 60.0
        while src.produced < total:
            if time.perf_counter() > deadline:
                raise TimeoutError(f"feed probe: the ring produced {src.produced} of {total} frames")
            time.sleep(0.01)
        return src

    with source() as src:
        want = torch.from_numpy(src.next_batch(total))
    seen = torch.empty(want.shape, dtype=torch.uint8, device=device)
    with source() as src:
        feed = feed_cls(src, chunk, device)
        for k in range(chunks):
            feed.fill(k, chunk)
            buf = feed.frames(k)
            torch.cuda._sleep(PROBE_SLEEP_CYCLES)
            seen[k * chunk : (k + 1) * chunk].copy_(buf)
            feed.release(k)
        torch.cuda.synchronize()
    seen = seen.cpu()
    differ = [k for k in range(chunks) if not torch.equal(seen[k * chunk : (k + 1) * chunk],
                                                          want[k * chunk : (k + 1) * chunk])]
    return {"chunks": chunks, "sleep_cycles": PROBE_SLEEP_CYCLES, "chunks_differing": differ}


def check_stream_path(device, measure: bool = True) -> dict:
    """The stream runtime on the card: `NativeFrameSource` (synthetic, 640x480,
    300 frames, 128 slots) into `run_stream` (64-frame chunks, the last
    padded to 320) over the frames path with the serving outputs, against
    the card's monolithic runner on the same 300 frames; then a ring of 16
    slots (fewer than a chunk) with 4 producer threads over the first 160
    frames (3 chunks), whose drains wait on the producers; then
    `feed_race_probe`, which holds the pinned double buffer's two waits.
    The counts are zeroed just before the first stream and read after it:
    K1-K3 once a frame, padded frames included.  With ``measure``, the
    overlapped stream
    and the serial loop of benchmarks/suite.py:888-905 (drain a chunk, run
    it, read ``plan_best`` back, then drain the next) in turns."""
    from multimodal_autonomous_driving_perception_and_planning_torch.runtime import NativeFrameSource
    from multimodal_autonomous_driving_perception_and_planning_torch.runtime.stream import _chunk_inputs, run_stream

    cfg = frames_config()
    w, h, total, chunk = cfg.frame_width, cfg.frame_height, STREAM_FRAMES, STREAM_CHUNK
    padded = -(-total // chunk) * chunk
    runner = pt.make_sequence_runner(cfg, device=device)

    def source(slots=STREAM_SLOTS, threads=0):
        return NativeFrameSource(width=w, height=h, slots=slots, num_frames=total, threads=threads)

    with source() as src:
        frames = src.next_batch(total)
    want = stream_reference(device, cfg, frames)
    torch.cuda.synchronize()
    _zero_counts()
    with source() as src:
        outs, stats = run_stream(cfg, src, total, chunk=chunk, runner=runner, device=device)
    launches = _read_counts()
    _expect("stream path", launches, tracker_step=padded, kalman_step=padded, tagging_step=padded, plan_step=padded)
    if stats["frames"] != total or outs["track_id"].shape[0] != total or outs["track_id"].device.type != "cpu":
        raise AssertionError(f"stream path: {stats['frames']} frames, outputs {tuple(outs['track_id'].shape)}")
    gaps = compare_stream("stream path", outs, want)
    with source(SMALL_RING_SLOTS, SMALL_RING_THREADS) as src:
        small, small_stats = run_stream(cfg, src, SMALL_RING_FRAMES, chunk=chunk, runner=runner, device=device)
    # The outputs are causal: the first 160 frames of the whole run are a
    # 160-frame run's.
    small_gaps = compare_stream(f"stream path, {SMALL_RING_SLOTS} slots and {SMALL_RING_THREADS} threads", small,
                                tree_map(lambda x: x[:SMALL_RING_FRAMES], want))
    probe = feed_race_probe(device)
    if probe["chunks_differing"]:
        raise AssertionError(f"stream path: the feed probe's chunks {probe['chunks_differing']} differ from the ring's")
    summary = {"frames": total, "chunk": chunk, "slots": STREAM_SLOTS, "launches": launches, **gaps,
               "fps": stats["fps"], "decode_s": stats["decode_s"], "wall_s": stats["wall_s"],
               "small_ring": {"frames": SMALL_RING_FRAMES, "slots": SMALL_RING_SLOTS, "threads": SMALL_RING_THREADS,
                              **small_gaps, "fps": small_stats["fps"], "decode_s": small_stats["decode_s"]},
               "feed_probe": probe,
               "lanes_found": int(outs["lane_obs"].left_found.sum())}
    if not measure:
        return summary

    def overlapped():
        with source() as src:
            t0 = time.perf_counter()
            _, st = run_stream(cfg, src, total, chunk=chunk, collect_host=False, runner=runner, device=device)
            return time.perf_counter() - t0, st["decode_s"]

    def serial():
        state = pt.initial_state(cfg, device=device)
        decode = 0.0
        with source() as src:
            t0 = time.perf_counter()
            start = 0
            while start < total:
                t1 = time.perf_counter()
                batch = src.next_batch(chunk)
                decode += time.perf_counter() - t1
                if batch.shape[0] == 0:
                    break
                _, inputs = _chunk_inputs(cfg, torch.from_numpy(batch), start, 1.0 / 30.0)
                state, o = runner(state, inputs)
                o["plan_best"].cpu()  # a readback before the next drain
                start += batch.shape[0]
            return time.perf_counter() - t0, decode

    turns = [("serial", serial()), ("overlapped", overlapped()), ("overlapped", overlapped()), ("serial", serial())]
    best = {kind: min(s for k, (s, _) in turns if k == kind) for kind in ("overlapped", "serial")}
    summary["times"] = {
        "turns": [{"kind": k, "seconds": s, "decode_s": d} for k, (s, d) in turns],
        "overlapped_fps": total / best["overlapped"], "serial_fps": total / best["serial"],
        "overlap_speedup": best["serial"] / best["overlapped"],
    }
    return summary


def demo_npz_weights(path: str) -> str:
    """Seeded yolov8n weights as an ``.npz`` of ultralytics keys."""
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.weights import save_npz_state_dict

    save_npz_state_dict(path, ultralytics_state_from_port(yolo_params("cpu")), variant="n")
    return path


def check_demo_path(device, renders: bool) -> dict:
    """The demo on the card (`apps.demo`): `run_demo` over 300 synthetic
    frames in DEFAULT_CONFIG with the Kalman bank; its host records against
    `extract_frame` of the card's runner on the same inputs (every frame,
    floats within MAIN_ATOL, and whether all are exact); ``--yolo`` on 2
    frames at 640 with seeded weights from an ``.npz`` (the detector runs
    and launches K5); the multi-camera demo over 4 cameras x 30 frames.
    With ``renders`` (cv2 imports on this machine) the whole demo runs, its
    renders written to a video in a temporary directory; otherwise its
    device half (`apps.demo.run_device`, which `run_demo` calls).  Each
    run's counts are zeroed just before it and read after."""
    import tempfile

    from multimodal_autonomous_driving_perception_and_planning_torch.apps import demo
    from multimodal_autonomous_driving_perception_and_planning_torch.host import extract_frame
    from multimodal_autonomous_driving_perception_and_planning_torch.perception.detector import ObjectDetector

    n = NUM_FRAMES
    cfg = pt.DEFAULT_CONFIG
    out = {"renders": "run" if renders else "not run: no cv2 on this machine"}
    # The demos write their videos into the working directory, as the JAX demos do.
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        common = dict(synthetic=True, display=False, use_frames=True, enable_tagging=True, device=device)
        _zero_counts()
        if renders:
            result = demo.run_demo(num_frames=n, smooth_tracks=True, save_video=True, **common)
            records = result["records"]
            import cv2

            cap = cv2.VideoCapture("output_demo.mp4")
            in_file = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
            if not result["frames_written"] == in_file == n:
                raise AssertionError(f"demo: {result['frames_written']} frames written, {in_file} in the file")
            out.update(device_fps=result["device_fps"], render_fps=result["render_fps"], device_s=result["device_s"],
                       render_s=result["render_s"], records_s=result["records_s"], build_s=result["build_s"],
                       warm_s=result["warm_s"], frames_written=in_file)
        else:
            run = demo.run_device(cfg, demo._synthetic_frames(cfg, n, 0, True), n, device=device, smooth_tracks=True)
            records = run.records
            out.update(device_fps=run.device_fps, device_s=run.device_s, records_s=run.records_s,
                       build_s=run.build_s, warm_s=run.warm_s)
        torch.cuda.synchronize()
        launches = _read_counts()
        k = n + demo.WARM_FRAMES
        _expect("demo", launches, tracker_step=k, kalman_step=k, tagging_step=k, plan_step=k)
        frames = demo._synthetic_frames(cfg, n, 0, True)
        _, inputs = demo._build_inputs(frames, n, 1.0 / 30.0, True, cfg)
        _, ref = pt.make_sequence_runner(cfg, device=device)(pt.initial_state(cfg, device=device), inputs)
        dets = {key: inputs[key] for key in ("bbox", "class_id", "confidence", "valid")}
        want = [extract_frame(ref, dets, f) for f in range(n)]
        same_records(records, want, "demo records")
        out.update(frames=n, launches=launches, records_max_abs_err=float_gap(records, want),
                   tracks=sum(len(r.tracks) for r in records), lanes_found=sum(r.lane_left is not None for r in records))

        npz = demo_npz_weights(f"{tmp}/yolov8n_seeded.npz")
        _zero_counts()
        if renders:
            yolo_run = demo.run_demo(num_frames=2, yolo=True, weights=npz, yolo_img_size=640, **common)
            yolo, yolo_s = yolo_run["records"], yolo_run["device_s"]
        else:
            detector = ObjectDetector(mode="yolo", model_path=npz, cfg=cfg, img_size=640, device=device)
            yolo_run = demo.run_device(cfg, demo._synthetic_frames(cfg, 2, 0, True), 2, device=device,
                                       detector=detector)
            yolo, yolo_s = yolo_run.records, yolo_run.device_s
        torch.cuda.synchronize()
        yolo_launches = _read_counts()
        _expect("demo --yolo", yolo_launches, tracker_step=4, kalman_step=4, tagging_step=4, plan_step=4, nms_keep=1)
        out["yolo"] = {"frames": 2, "launches": yolo_launches, "detections": sum(len(r.detections) for r in yolo),
                       "device_s": yolo_s}

        _zero_counts()
        if renders:
            multi = demo.run_multicamera_demo(num_cameras=MULTICAM_CAMERAS, num_frames=MULTICAM_FRAMES, display=False,
                                              save_video=True, device=device)
            fleet, written, multi_s = multi["fleet_counts"], multi["frames_written"], multi["device_s"]
            confirmed = [sum(len(multi["records"][c][f].tracks) for c in range(MULTICAM_CAMERAS))
                         for f in range(MULTICAM_FRAMES)]
            if written != MULTICAM_FRAMES:
                raise AssertionError(f"multi-camera demo: {written} frames written")
        else:
            cfg_m = cfg.replace(use_frames=False)
            multi = demo.run_multicamera_device(cfg_m, MULTICAM_CAMERAS, MULTICAM_FRAMES, device)
            fleet, written, multi_s = multi.fleet_counts, 0, multi.device_s
            confirmed = [sum(int(o["num_confirmed"][f]) for o in multi.outs_per_cam) for f in range(MULTICAM_FRAMES)]
        torch.cuda.synchronize()
        multi_launches = _read_counts()
        m = MULTICAM_FRAMES
        _expect("multi-camera demo", multi_launches, tracker_step=m, kalman_step=m, tagging_step=m, plan_step=m)
        if confirmed != fleet.tolist():
            raise AssertionError("multi-camera demo: the fleet counts differ from the cameras' confirmed tracks")
        out["multicamera"] = {"cameras": MULTICAM_CAMERAS, "frames": m, "launches": multi_launches,
                              "frames_written": written, "fleet_last": int(fleet[-1]), "device_s": multi_s}
    return out


def check_webview_path(device, renders: bool) -> dict:
    """The web dashboard's data on the card (`apps.webview`):
    `build_dashboard_data(num_frames=120)`, whose `process_into` runs
    30-frame chunks and, with ``renders`` (cv2 on this machine), renders
    and encodes each frame as a JPEG, against one 120-frame chunk: tags and
    states equal.  The counts are zeroed just before the chunked build and
    read after.  Returns each chunk's run and render seconds."""
    from multimodal_autonomous_driving_perception_and_planning_torch.apps import webview

    n = WEBVIEW_FRAMES
    _zero_counts()
    t0 = time.perf_counter()
    prog = webview.build_dashboard_data(num_frames=n, device=device)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = _read_counts()
    _expect("webview", launches, tracker_step=n, kalman_step=n, tagging_step=n, plan_step=n)
    mono = webview.DashboardData(total=n)
    webview.process_into(mono, n, chunk=n, device=device)
    if [ft.all_tags for ft in prog.frame_tags] != [ft.all_tags for ft in mono.frame_tags]:
        raise AssertionError("webview: the chunked build's tags differ from one chunk's")
    if prog.states != mono.states:
        raise AssertionError("webview: the chunked build's states differ from one chunk's")
    if len(prog.frames_jpeg) != n or not all(j[:2] == b"\xff\xd8" or not renders for j in prog.frames_jpeg):
        raise AssertionError("webview: a frame is not a JPEG")
    return {"frames": n, "chunk": WEBVIEW_CHUNK, "launches": launches, "seconds": seconds,
            "renders": "run" if renders else "not run: no cv2 on this machine",
            "chunk_seconds": prog.chunk_seconds, "one_chunk_seconds": mono.chunk_seconds,
            "jpeg_bytes": sum(len(j) for j in prog.frames_jpeg) // n,
            "tags": len(prog.tagger.tag_counts), "result": "tags and states equal to one 120-frame chunk's"}


EXPORT_CHUNK, EXPORT_FRAMES, EXPORT_PADDED = 64, NUM_FRAMES, 320  # the server's chunk; 300 frames padded to 5 chunks
# (label, tagging, lanes): the server's configuration at batch 1 and at
# its --batch, and the main path's.
EXPORT_CASES = (("tagging_b1", True, 1), (f"tagging_b{BATCHED_LANES}", True, BATCHED_LANES), ("main_b1", False, 1))
EXPORT_ROUNDS = 2  # eager, exported, exported, eager: twice
EXPORT_FRAMES_MODE = 128  # road frames through the frames-mode artifact: two chunks
# Floats of the CPU-exported artifact loaded on the card against the
# card-exported one (PARITY.md's budget).
MULTI_PLATFORM_ATOL = 1e-4


def export_cpu(directory: str) -> dict:
    """``--export-cpu DIR``, in a process that sees no card: the tagging
    configuration exported for ``("cuda", "cpu")`` on the CPU."""
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.export import (
        export_sequence_runner,
        save_exported,
    )

    if torch.cuda.is_available():
        raise AssertionError("--export-cpu: this process sees a card; run it with CUDA_VISIBLE_DEVICES=")
    t0 = time.perf_counter()
    data = export_sequence_runner(bench_config(True), EXPORT_CHUNK, platforms=("cuda", "cpu"))
    save_exported(str(Path(directory) / "multi_b1.pt2"), data)
    return {"bytes": len(data), "export_s": time.perf_counter() - t0}


def host_reads(fn):
    """``fn()``'s value and the synchronizing CUDA calls (host reads) it
    makes, each by the file of the Python line that made it, as
    ``torch.cuda.set_sync_debug_mode``'s warnings give them."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            value = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return value, [Path(w.filename).name for w in caught if "synchronizing" in str(w.message)]


class CannyRounds(torch.nn.Module):
    """`ops.image.canny_rounds` as a module to export (the thresholds are
    inputs): exported, its hysteresis runs under a while_loop."""

    def forward(self, gray, low, high):
        from multimodal_autonomous_driving_perception_and_planning_torch.ops import image as image_ops

        return image_ops.canny_rounds(gray, low, high)


def hysteresis_rounds(device, frames) -> dict:
    """Both Canny passes of the lane step on each frame, eager (blocks,
    host reads) and exported (the blocks under a while_loop): their maps
    equal, their rounds and reads a frame."""
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import image as image_ops

    out = {"eager_rounds": 0, "eager_reads": 0, "traced_rounds": 0, "traced_reads": 0}
    exported = {}
    for frame in frames:
        st = lane_stage_inputs(device, torch.as_tensor(frame, device=device))
        small = image_ops.downsample2_u8(st["gray"])
        for gray, low, high in ((st["blurred"], st["low"], st["high"]), (small, 50.0, 150.0)):
            args = (gray, torch.as_tensor(low, dtype=torch.float32, device=device),
                    torch.as_tensor(high, dtype=torch.float32, device=device))
            if gray.shape not in exported:
                exported[gray.shape] = torch.export.export(CannyRounds(), args, strict=False).module()
            e, er, ereads = image_ops.canny_rounds(gray, low, high)
            t, tr, treads = exported[gray.shape](*args)
            if not torch.equal(e, t) or int(tr) != er:
                raise AssertionError("export path frames: the exported hysteresis differs from the eager blocks")
            out["eager_rounds"] += er
            out["eager_reads"] += ereads
            out["traced_rounds"] += int(tr)
            out["traced_reads"] += int(treads)
    return {k: v / len(frames) for k, v in out.items()}


def run_frames_artifact(directory: str, device) -> dict:
    """The frames-mode artifact against the eager frames runner over
    `EXPORT_FRAMES_MODE` road frames in 64-frame chunks, bit for bit; the
    launches of the artifact's run; and, from the same two runs, each
    one's seconds and host reads a frame, those of its hysteresis (made in
    ops/image.py by the eager blocks, in the while_loop's own file by the
    artifact's loops) and the eager hysteresis rounds and blocks.  The
    traced form's rounds stay on the card (the program does not return
    them); `hysteresis_rounds` holds them to the eager ones call by call."""
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import image as image_ops
    from multimodal_autonomous_driving_perception_and_planning_torch.types import tree_leaves
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.export import (
        deserialize_runner,
        load_exported,
    )

    cfg = frames_config()
    t0 = time.perf_counter()
    exported = deserialize_runner(load_exported(str(Path(directory) / "frames_b1.pt2")), cfg, EXPORT_CHUNK)
    load_s = time.perf_counter() - t0
    eager = pt.make_sequence_runner(cfg, device=device)
    road = frames_inputs(EXPORT_FRAMES_MODE)
    chunks = [{k: v[c : c + EXPORT_CHUNK] for k, v in road.items()}
              for c in range(0, EXPORT_FRAMES_MODE, EXPORT_CHUNK)]
    n = EXPORT_FRAMES_MODE

    def chained(run):
        t0 = time.perf_counter()
        state, outs = pt.initial_state(cfg, device=device), []
        for chunk in chunks:
            state, out = run(state, chunk)
            outs.append(out)
        torch.cuda.synchronize()
        return state, outs, time.perf_counter() - t0

    _zero_counts()
    (x_state, x_outs, x_s), x_reads = host_reads(lambda: chained(exported))
    launches = _read_counts()
    _expect("export path frames", launches, tracker_step=n, kalman_step=n, tagging_step=n)
    plain, eager_rounds = image_ops.canny_rounds, [0, 0, 0]

    def counted(*args, **kw):
        edges, rounds, blocks = plain(*args, **kw)
        eager_rounds[0] += rounds
        eager_rounds[1] += blocks
        eager_rounds[2] += blocks > 1
        return edges, rounds, blocks

    image_ops.canny_rounds = counted
    try:
        with plain_planner():  # the artifact's planner is the tensor ops
            (e_state, e_outs, e_s), e_reads = host_reads(lambda: chained(eager))
    finally:
        image_ops.canny_rounds = plain
    for c, (g, w) in enumerate(zip(x_outs, e_outs)):
        g, w = _flat_outputs(g), _flat_outputs(w)
        for part in (g, w):
            lane = part.pop("lane_obs")
            part.update({f"lane_obs.{f}": getattr(lane, f) for f in LANE_FIELDS})
        _same_leaves(f"export path frames chunk {c}", g, w)
    _same_leaves("export path frames final state", dict(enumerate(tree_leaves(x_state))),
                 dict(enumerate(tree_leaves(e_state))))
    # torch's while_loop reads its first condition twice when the loop
    # runs: a call past its first block reads once more than the blocks.
    hysteresis = {"eager_rounds": eager_rounds[0] / n, "eager_blocks": eager_rounds[1] / n,
                  "eager_calls_past_one_block": eager_rounds[2] / n,
                  "eager_reads": e_reads.count("image.py") / n, "exported_reads": x_reads.count("while_loop.py") / n}
    return {"frames": n, "load_s": load_s, "launches": launches, "seconds": {"eager": e_s, "exported": x_s},
            "host_reads_per_frame": {"eager": len(e_reads) / n, "exported": len(x_reads) / n},
            "hysteresis_per_frame": hysteresis,
            "result": "every output and the final state bit for bit the eager frames runner's; one launch of "
                      "K1-K3 a frame"}


def run_multi_platform_artifact(directory: str, device) -> dict:
    """The CPU-exported ``("cuda", "cpu")`` artifact loaded on the card
    against the card-exported one of the same configuration over 300
    frames: discrete outputs bit for bit, floats within
    `MULTI_PLATFORM_ATOL`, both runs launching K1-K3 a frame."""
    from multimodal_autonomous_driving_perception_and_planning_torch.types import tree_leaves
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.export import (
        deserialize_runner,
        load_exported,
        load_program,
    )

    cfg = bench_config(True)
    data = load_exported(str(Path(directory) / "multi_b1.pt2"))
    _, meta = load_program(data)
    t0 = time.perf_counter()
    multi = deserialize_runner(data, cfg, EXPORT_CHUNK)  # a multi-platform artifact loads on the card
    load_s = time.perf_counter() - t0
    card = deserialize_runner(load_exported(str(Path(directory) / "tagging_b1.pt2")), cfg, EXPORT_CHUNK)
    chunks = _padded_chunks(lane_streams(1, EXPORT_FRAMES), 1)

    def chained(run):
        state, outs = pt.initial_state(cfg, device=device), []
        for chunk in chunks:
            state, out = run(state, chunk)
            outs.append(_flat_outputs(out))
        torch.cuda.synchronize()
        return state, outs

    chained(multi)
    _zero_counts()
    m_state, m_outs = chained(multi)
    launches = _read_counts()
    steps = len(chunks) * EXPORT_CHUNK
    _expect("export path multi-platform", launches, tracker_step=steps, kalman_step=steps, tagging_step=steps)
    c_state, c_outs = chained(card)
    gap, floats_bitwise = 0.0, True
    pairs = [(f"chunk {c} {k}", g[k], w[k]) for c, (g, w) in enumerate(zip(m_outs, c_outs)) for k in w]
    pairs += [(f"state leaf {i}", a, b) for i, (a, b) in enumerate(zip(tree_leaves(m_state), tree_leaves(c_state)))]
    for label, a, b in pairs:
        if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
            raise AssertionError(f"export path multi-platform: {label} is {a.dtype} {tuple(a.shape)} on {a.device}")
        if a.is_floating_point():
            err = float((a - b).abs().max()) if a.numel() else 0.0
            gap, floats_bitwise = max(gap, err), floats_bitwise and torch.equal(a, b)
            if not err <= MULTI_PLATFORM_ATOL:
                raise AssertionError(f"export path multi-platform: {label} off by {err}")
        elif not torch.equal(a, b):
            raise AssertionError(f"export path multi-platform: {label} differs from the card-exported artifact")
    return {"platforms": meta["platforms"], "exported_on": meta["exported_on"], "load_s": load_s,
            "frames": steps, "launches": launches, "float_max_abs_gap": gap, "floats_bit_for_bit": floats_bitwise,
            "result": f"discrete outputs bit for bit the card-exported artifact's, floats within "
                      f"{MULTI_PLATFORM_ATOL}"}


def _op_routes(device, inputs: dict) -> dict:
    """K1-K3 at the paths' states (`tracker_state`, `kalman_state`,
    `tagging_state`), and K3 at 160 slots (its general instance): for
    each, a call of its wrapper and of the same function through its madpp
    op (ops/library.py)."""
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import library
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.rules import frames_from_rows

    cfg = bench_config(True)
    table, dets = tracker_state(device, inputs)
    ks, model, z, has = kalman_state(device, inputs)
    rules, tstate, tdets, ttable, vrow = tagging_state(device, inputs)
    op_tagging = library.make_packed_tagging_step(cfg)
    big = tagging_kernel_inputs(device, 160, 80, np.random.default_rng(160))
    op_tagging_160 = library.make_packed_tagging_step(large_config(160, 80))
    est, trk = cfg.estimator, cfg.tracker
    lane_row, feat_row = frames_rows_of(device)
    lane_obs, feats = frames_from_rows(lane_row, feat_row)
    return {
        "tracker_step": (lambda: tracker_kernel.tracker_step(table, dets, trk, trk.min_hits),
                         lambda: library.tracker_update_with_order(table, dets, trk, trk.min_hits)),
        "kalman_step": (lambda: kalman_kernel.kalman_step(ks, model, z, has, est.dt, est.speed_heading_hold),
                        lambda: library.estimator_step_row(ks, model, z, has, est)),
        "tagging_step": (lambda: tagging_kernel.tagging_step(rules, tstate, tdets, ttable, vrow),
                         lambda: op_tagging(tstate, tdets, ttable, vrow)),
        "tagging_step_frames": (
            lambda: tagging_kernel.tagging_step(rules, tstate, tdets, ttable, vrow, lane_row, feat_row),
            lambda: op_tagging(tstate, tdets, ttable, vrow, lane_obs, feats)),
        # K3's general instance through the op: ROADMAP §3's 160 slots.
        "tagging_step_160": (
            lambda: tagging_kernel.tagging_step(big["rules"], big["state"], *big["tag_frame"]),
            lambda: op_tagging_160(big["state"], *big["tag_frame"])),
    }


def frames_rows_of(device):
    """A lane row (both lanes found) and a scene-feature row of K3's frames
    mode, seeded: what `tagging.rules.frames_rows` makes of a frame."""
    gen = torch.Generator().manual_seed(3)
    lane_row = torch.cat([torch.randn(6, generator=gen), torch.ones(2)])
    feat_row = torch.rand(6, generator=gen) * torch.tensor([0.1, 8.0, 200.0, 0.2, 120.0, 300.0])
    return lane_row.to(device), feat_row.to(device)


def host_us(fn, reps: int = 2000) -> float:
    """Microseconds a call on the host clock over ``reps`` calls, no
    synchronise inside (the wrappers' host time sets the paths' rate)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def check_madpp_ops(device, inputs: dict) -> dict:
    """Each madpp op on the card against its wrapper on the same inputs
    (``madpp.tagging_step`` in both of K3's modes, and at 160 slots), every
    output bit for bit, and both routes' host microseconds a call, in turns
    (wrapper, op, op, wrapper)."""
    out = {}
    for name, (wrapper, op) in _op_routes(device, inputs).items():
        want, got = _tensors(wrapper()), _tensors(op())
        torch.cuda.synchronize()
        if len(got) != len(want) or any(a.dtype != b.dtype or not torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"export path: madpp.{name} differs from its wrapper on the same inputs")
        w1, o1, o2, w2 = host_us(wrapper), host_us(op), host_us(op), host_us(wrapper)
        out[name] = {"wrapper_host_us": [w1, w2], "op_host_us": [o1, o2]}
    return out


def _padded_chunks(streams: list, lanes: int) -> list:
    """The streams' 300 frames padded to 320 with the last frame, in
    64-frame chunks, with a lane axis when ``lanes > 1``."""
    def pad(a):
        return np.concatenate([a, np.repeat(a[-1:], EXPORT_PADDED - a.shape[0], axis=0)])

    whole = [{k: pad(v) for k, v in s.items()} for s in streams]
    chunks = []
    for c in range(0, EXPORT_PADDED, EXPORT_CHUNK):
        parts = [{k: v[c : c + EXPORT_CHUNK] for k, v in w.items()} for w in whole]
        chunks.append(_stack_streams(parts) if lanes > 1 else parts[0])
    return chunks


def _flat_outputs(outs: dict) -> dict:
    flat = {}
    for k, v in outs.items():
        if k == "tags":
            flat.update({f"tags.{t}": x for t, x in v.items()})
        elif k == "vehicle_state":
            flat.update({f"vehicle_state.{f}": getattr(v, f) for f in VEHICLE_STATE_FIELDS})
        else:
            flat[k] = v
    return flat


def _same_leaves(label: str, got: dict, want: dict) -> None:
    """Every leaf bit for bit; a float that differs names its leaf and gap."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: outputs {sorted(set(got) ^ set(want))} on one side only")
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            gap = float((g.double() - w.double()).abs().max()) if g.shape == w.shape else None
            raise AssertionError(f"{label}: {k} differs from the eager runner's ({g.dtype} against {w.dtype}, "
                                 f"max gap {gap})")


def run_artifacts(directory: str, device="cuda") -> dict:
    """In a fresh process: load each artifact of `check_export_path` from
    ``directory`` and hold it against the eager runner on the card."""
    from multimodal_autonomous_driving_perception_and_planning_torch.types import stack_lanes, tree_leaves
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.export import (
        deserialize_runner,
        load_exported,
    )

    device = torch.device(device)
    results = {}
    for label, tagging, lanes in EXPORT_CASES:
        cfg = bench_config(tagging)
        t0 = time.perf_counter()
        exported = deserialize_runner(load_exported(str(Path(directory) / f"{label}.pt2")), cfg, EXPORT_CHUNK,
                                      batch=lanes)
        load_s = time.perf_counter() - t0
        eager = (pt.make_batched_sequence_runner if lanes > 1 else pt.make_sequence_runner)(cfg, device=device)
        chunks = _padded_chunks(lane_streams(lanes, EXPORT_FRAMES), lanes)

        def initial():
            state = pt.initial_state(cfg, device=device)
            return stack_lanes([state] * lanes) if lanes > 1 else state

        def chained(run):
            state, outs = initial(), []
            for chunk in chunks:
                state, out = run(state, chunk)
                outs.append(out)
            torch.cuda.synchronize()
            return state, outs

        chained(eager)  # the first frames of each runner in this process
        chained(exported)
        _zero_counts()
        x_state, x_outs = chained(exported)
        launches = _read_counts()
        with plain_planner():  # the artifact's planner is the tensor ops
            e_state, e_outs = chained(eager)
        steps = len(chunks) * EXPORT_CHUNK
        _expect(f"export path {label}", launches, tracker_step=steps, kalman_step=steps,
                **({"tagging_step": steps} if tagging else {}))
        for c, (g, w) in enumerate(zip(x_outs, e_outs)):
            _same_leaves(f"export path {label} chunk {c}", _flat_outputs(g), _flat_outputs(w))
        _same_leaves(f"export path {label} final state", dict(enumerate(tree_leaves(x_state))),
                     dict(enumerate(tree_leaves(e_state))))
        short = {k: v[:, :-1] if lanes > 1 else v[:-1] for k, v in chunks[0].items()}
        try:
            exported(initial(), short)
        except ValueError:
            pass
        else:
            raise AssertionError(f"export path {label}: a {EXPORT_CHUNK - 1}-frame chunk was not refused")

        seconds = {"eager": [], "exported": []}
        for _ in range(EXPORT_ROUNDS):
            for name, run in (("eager", eager), ("exported", exported), ("exported", exported), ("eager", eager)):
                t0 = time.perf_counter()
                chained(run)
                seconds[name].append(time.perf_counter() - t0)
        # Where a chunk's host time goes, by function (cProfile's own time;
        # the profiler slows every Python call).
        split = {name: host_split(lambda run=run: run(initial(), chunks[0]), reps=3, top=10)
                 for name, run in (("eager", eager), ("exported", exported))}
        results[label] = {
            "lanes": lanes, "frames": steps, "load_s": load_s, "launches": launches, "seconds": seconds,
            "chunk_host_split": split,
            "frames_per_s": {k: [steps / t for t in v] for k, v in seconds.items()},
            "host_us_per_frame": {k: [t / steps * 1e6 for t in v] for k, v in seconds.items()},
        }
    results["frames_b1"] = run_frames_artifact(directory, device)
    results["multi_b1"] = run_multi_platform_artifact(directory, device)
    return results


def check_export_path(device, inputs: dict) -> dict:
    """The serialized runner (`utils.export`) on the card; see phase 19g."""
    import tempfile

    from multimodal_autonomous_driving_perception_and_planning_torch.utils.export import (
        export_sequence_runner,
        load_program,
        save_exported,
    )

    ops = check_madpp_ops(device, inputs)
    cases = {}
    with tempfile.TemporaryDirectory() as directory:
        for label, tagging, lanes in EXPORT_CASES:
            t0 = time.perf_counter()
            data = export_sequence_runner(bench_config(tagging), EXPORT_CHUNK, platforms=(device.type,), batch=lanes)
            export_s = time.perf_counter() - t0
            program, meta = load_program(data)
            held = sorted({str(n.target) for n in program.graph.nodes if str(n.target).startswith("madpp.")})
            want = sorted(f"madpp.{k}.default" for k in ("tracker_step", "kalman_step")
                          + (("tagging_step",) if tagging else ()))
            if held != want:
                raise AssertionError(f"export path {label}: the program holds {held}, expected {want}")
            save_exported(str(Path(directory) / f"{label}.pt2"), data)
            cases[label] = {"bytes": len(data), "export_s": export_s, "ops": held, "device": meta["device"]}
        # The export on the CPU runs in a process with no card, meanwhile.
        t_cpu = time.perf_counter()
        cpu = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--export-cpu", directory],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                               env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        try:
            cases["frames_b1"] = export_frames_artifact(device, directory)
            out, err = cpu.communicate(timeout=600)
        finally:
            if cpu.poll() is None:
                cpu.kill()
                cpu.communicate()
        if cpu.returncode != 0:
            raise AssertionError(f"export path: the CPU export exited {cpu.returncode}: {err[-3000:]}")
        cases["multi_b1"] = {**json.loads(out.strip().splitlines()[-1]), "process_s": time.perf_counter() - t_cpu}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--run-artifacts", directory],
                              capture_output=True, text=True, timeout=600)
        fresh_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"export path: the fresh process exited {proc.returncode}: {proc.stderr[-3000:]}")
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    for label in cases:
        cases[label].update(loaded[label])
    return {"ops": ops, "cases": cases, "chunk": EXPORT_CHUNK, "fresh_process_s": fresh_s,
            "result": "every output and the final state bit for bit the eager runner's, in frames mode too; one "
                      "launch of each kernel a frame; a short chunk refused; the CPU-exported artifact on the "
                      "card within the bar"}


def export_frames_artifact(device, directory: str) -> dict:
    """`DEFAULT_CONFIG` (frames mode) exported at batch 1 into
    ``directory``: the program holds K1-K3's ops and Canny's two
    while_loops."""
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.export import (
        export_sequence_runner,
        load_program,
        save_exported,
    )

    t0 = time.perf_counter()
    data = export_sequence_runner(frames_config(), EXPORT_CHUNK, platforms=(device.type,))
    export_s = time.perf_counter() - t0
    program, _ = load_program(data)
    held = sorted({str(n.target) for n in program.graph.nodes if str(n.target).startswith("madpp.")})
    loops = sum(n.op == "call_function" and "while_loop" in str(n.target) for n in program.graph.nodes)
    if held != sorted(f"madpp.{k}.default" for k in ("tracker_step", "kalman_step", "tagging_step")):
        raise AssertionError(f"export path frames: the program holds {held}")
    if loops != 2:
        raise AssertionError(f"export path frames: the program holds {loops} while_loops, expected 2 (Canny)")
    save_exported(str(Path(directory) / "frames_b1.pt2"), data)
    return {"bytes": len(data), "export_s": export_s, "ops": held, "while_loops": loops}


# --- across ranks: two ranks on the one card (gloo), then one over NCCL ----

CROSS_CAMERAS = 4  # 2 a rank
CROSS_SERVE_CHUNK, CROSS_SERVE_SEEDS = 3, (0, 7)  # tests/test_serve.py's dp case
CROSS_YOLO_FRAMES, CROSS_YOLO_MAX_DET, CROSS_YOLO_ATOL = 2, 32, 1e-3
CROSS_BLIP_TOKENS = 8
CROSS_BLIP_LOGITS_RTOL = 1e-3  # of the logits' largest magnitude; a misplaced column moves them by about that whole
CROSS_TIMEOUT = 600.0


def _serve_chunk(cfg, start: int, n: int, seed: int) -> dict:
    """tests/test_serve.py `_chunk_arrays`: frames start..start+n of a
    session's stream."""
    dets = simulated_detection_stream(n, height=cfg.frame_height, width=cfg.frame_width,
                                      capacity=cfg.detector.max_detections, start_frame_count=start + 1)
    ego = ego_motion_stream(start + n, dt=1.0 / 30.0, seed=seed)[start:]
    return {**dets, "ego_measurement": ego.astype(np.float32)}


def cross_camera_mesh(device, tagging: bool) -> dict:
    """The camera mesh over the group's ranks, `CROSS_CAMERAS` cameras of
    300 frames: each rank's cameras against their lanes of the one-card
    batched runner (the planner's floats at MAIN_ATOL, the rest bit for
    bit), the fleet count the sum over cameras; gathered and compared
    whole where the backend takes functional collectives (NCCL)."""
    import torch.distributed as dist

    from multimodal_autonomous_driving_perception_and_planning_torch.parallel.mesh import (
        gather_cameras,
        make_camera_mesh,
        make_multicamera_runner,
        stack_states,
    )
    from multimodal_autonomous_driving_perception_and_planning_torch.types import lane_of, tree_map

    cfg = bench_config(tagging)
    inputs = _stack_streams(lane_streams(CROSS_CAMERAS))
    frames = inputs["bbox"].shape[1]
    mesh = make_camera_mesh(device=device)
    runner = make_multicamera_runner(cfg, mesh)
    runner(stack_states(cfg, CROSS_CAMERAS, device=device), inputs)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    _, outs, fleet = runner(stack_states(cfg, CROSS_CAMERAS, device=device), inputs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    label = f"cross_card camera mesh (tagging {tagging}, {mesh.size} ranks)"
    _expect(label, launches, tracker_step=frames, kalman_step=frames, plan_step=frames,
            **({"tagging_step": frames} if tagging else {}))
    _, ref = pt.make_batched_sequence_runner(cfg, device=device)(stack_states(cfg, CROSS_CAMERAS, device=device),
                                                                 inputs)
    n, rank = mesh.size, dist.get_rank()
    lo = rank * CROSS_CAMERAS // n
    local = tree_map(lambda t: t.to_local() if hasattr(t, "to_local") else t, outs)
    gap = max(compare_lane(label, local, c, lane_of(ref, lo + c)) for c in range(CROSS_CAMERAS // n))
    fleet = fleet["fleet_confirmed_per_frame"]
    if not torch.equal(fleet, ref["num_confirmed"].sum(0, dtype=torch.int32)):
        raise AssertionError(f"{label}: the fleet count is not the sum of the cameras' own counts")
    gathered = dist.get_backend() == "nccl"
    if gathered:
        whole = gather_cameras(outs)
        gap = max(gap, max(compare_lane(label, whole, c, lane_of(ref, c)) for c in range(CROSS_CAMERAS)))
    return {"backend": dist.get_backend(), "ranks": n, "cameras": CROSS_CAMERAS, "frames": frames,
            "tagging": tagging, "launches": launches, "seconds": seconds, "planner_max_abs_gap": gap,
            "fleet_confirmed_last": int(fleet[-1]), "gathered_whole": gathered}


def cross_dp_server(device) -> dict:
    """The dp server over the group's ranks at --batch 4: rank 0 drives two
    sessions of two chained chunks each, concurrently, and holds every
    served output to the batch-4 server's (floats within 1e-6, the rest
    bit for bit); the other ranks serve their lanes until rank 0 closes."""
    import threading

    import torch.distributed as dist

    from multimodal_autonomous_driving_perception_and_planning_torch.apps.serve import PipelineServer

    cfg = bench_config(False)
    n, rank = CROSS_SERVE_CHUNK, dist.get_rank()
    chunks = {s: [_serve_chunk(cfg, 0, n, s), _serve_chunk(cfg, n, n, s)] for s in CROSS_SERVE_SEEDS}
    expected = {}
    if rank == 0:
        ref = PipelineServer(cfg=cfg, chunk=n, max_sessions=2, batch=4, batch_window_ms=1.0, device=device)
        try:
            for s in CROSS_SERVE_SEEDS:
                sid = ref.create_session()
                expected[s] = [ref.infer(sid, c) for c in chunks[s]]
        finally:
            ref.close()
    t0 = time.perf_counter()
    ps = PipelineServer(cfg=cfg, chunk=n, max_sessions=2, batch=4, batch_window_ms=100.0, dp=dist.get_world_size(),
                        device=device)
    start_s = time.perf_counter() - t0
    _zero_counts()
    if rank != 0:
        ps.serve_worker()
        return {"rank": rank, "launches": _read_counts(), "start_s": start_s}
    got, errors = {s: [None, None] for s in CROSS_SERVE_SEEDS}, []
    sids = {s: ps.create_session() for s in CROSS_SERVE_SEEDS}

    def drive(seed):
        try:
            for c in range(2):
                got[seed][c] = ps.infer(sids[seed], chunks[seed][c])
        except Exception as e:  # noqa: BLE001 -- raised below
            errors.append(e)

    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=drive, args=(s,)) for s in CROSS_SERVE_SEEDS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=CROSS_TIMEOUT)
        seconds = time.perf_counter() - t0
        batching = ps.metrics()["batching"]
    finally:
        ps.close()
    launches = _read_counts()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"cross_card dp server: {errors or 'a session did not finish'}")
    for s in CROSS_SERVE_SEEDS:
        for c in range(2):
            exp, act = expected[s][c], got[s][c]
            if sorted(exp) != sorted(act):
                raise AssertionError(f"cross_card dp server: seed {s} chunk {c} serves other keys")
            for k, e in exp.items():
                ok = (np.allclose(act[k], e, rtol=0, atol=1e-6) if e.dtype.kind == "f"
                      else np.array_equal(act[k], e))
                if not ok:
                    raise AssertionError(f"cross_card dp server: seed {s} chunk {c} {k} differs from the batch server")
    return {"rank": 0, "dp": batching["dp"], "batch": batching["batch"], "dispatches": batching["dispatches"],
            "lanes_served": batching["lanes_served"], "launches": launches, "seconds": seconds, "start_s": start_s}


def cross_tp_yolo(device) -> dict:
    """yolov8n at 640 in float32 over a (data=1, model=ranks) mesh against
    the unsharded detector on the same seeded weights and frames: the
    tables' floats within `CROSS_YOLO_ATOL`, the rest equal, K5 launched."""
    import torch.distributed as dist

    from multimodal_autonomous_driving_perception_and_planning_torch.parallel.tp import (
        make_sharded_yolo_detector,
        make_tp_mesh,
    )

    frames, _ = yolo_inputs(CROSS_YOLO_FRAMES)
    kw = dict(img_size=YOLO_IMG, max_det=CROSS_YOLO_MAX_DET, **YOLO_F32)
    mesh = make_tp_mesh(n_data=1, n_model=dist.get_world_size(), device=device)
    init_fn, detect = make_sharded_yolo_detector(mesh, **kw)
    variables = init_fn(torch.Generator().manual_seed(0))
    init_raw, detect_raw = yolov8.make_yolo_detector(device=device, **kw)
    want = detect_raw(init_raw(torch.Generator().manual_seed(0)), frames)
    detect(variables, frames)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    got = detect(variables, frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    if launches["nms_keep"] < 1:
        raise AssertionError(f"cross_card tensor-parallel YOLO: K5 was not launched ({launches})")
    gaps = {}
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"cross_card tensor-parallel YOLO: {k} is {g.dtype} {tuple(g.shape)}")
        if w.is_floating_point():
            gaps[k] = float((g - w).abs().max())
            if not gaps[k] <= CROSS_YOLO_ATOL:
                raise AssertionError(f"cross_card tensor-parallel YOLO: {k} off by {gaps[k]}")
        elif not torch.equal(g, w):
            raise AssertionError(f"cross_card tensor-parallel YOLO: {k} differs from the unsharded detector")
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "frames": CROSS_YOLO_FRAMES, "launches": launches,
            "seconds": seconds, "max_abs_gap": gaps, "valid": int(got["valid"].sum())}


def _blip_prompt_logits(model, px, prompt) -> torch.Tensor:
    """The decoder's logits at every position of the prompt buffer: the
    first decode step's, before any argmax."""
    from multimodal_autonomous_driving_perception_and_planning_torch.models import blip

    with torch.inference_mode(), float32_matmuls():
        return model.decode(prompt.to(px.device)[None], model.encode_cross(px))[0]


def cross_tp_blip(device, cfg=None) -> dict:
    """The full-width BlipConfig() sharded over (data=1, model=ranks): its
    greedy decode of `CROSS_BLIP_TOKENS` tokens equal to the unsharded
    model's on the same seeded weights and frame, and its first step's
    logits at every prompt position within `CROSS_BLIP_LOGITS_RTOL` of the
    unsharded model's largest logit (the seeded weights repeat one token,
    so the tokens alone hardly depend on the hidden states)."""
    import torch.distributed as dist

    from multimodal_autonomous_driving_perception_and_planning_torch.models import blip
    from multimodal_autonomous_driving_perception_and_planning_torch.parallel.tp import (
        make_tp_mesh,
        shard_blip_variables,
    )

    cfg = cfg or blip.BlipConfig()
    init_fn, caption = blip.make_caption_fn(cfg, max_new_tokens=CROSS_BLIP_TOKENS, device=device)
    params = init_fn(torch.Generator().manual_seed(0), prompt_capacity=4)
    frame = np.random.default_rng(0).integers(0, 255, (480, 640, 3)).astype(np.uint8)
    px = blip.preprocess_bgr(torch.as_tensor(frame, device=device), cfg.image_size)
    prompt = torch.tensor([cfg.bos_token_id, 2000, 3000, 0], dtype=torch.int32)
    want_ids, want_len = caption(params, px, prompt, 3)
    want_logits = _blip_prompt_logits(blip.model_from_state_dict(params, cfg), px, prompt)
    mesh = make_tp_mesh(n_data=1, n_model=dist.get_world_size(), device=device)
    model = shard_blip_variables(params, mesh, cfg=cfg)
    t0 = time.perf_counter()
    got_ids, got_len = caption(model, px, prompt, 3)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not torch.equal(got_ids, want_ids) or int(got_len) != int(want_len):
        raise AssertionError(f"cross_card BLIP: sharded tokens {got_ids.tolist()} against {want_ids.tolist()}")
    got_logits = _blip_prompt_logits(model, px, prompt)
    scale = float(want_logits.abs().max())
    logits_gap = float((got_logits - want_logits).abs().max())
    if got_logits.shape != want_logits.shape or not logits_gap <= CROSS_BLIP_LOGITS_RTOL * max(scale, 1.0):
        raise AssertionError(f"cross_card BLIP: the sharded first-step logits are off by {logits_gap} "
                             f"(largest logit {scale})")
    sharded = sum(isinstance(m, torch.nn.Linear) and m.weight.shape[0] < m.out_features for m in model.modules())
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "new_tokens": CROSS_BLIP_TOKENS,
            "tokens": got_ids.tolist(), "length": int(got_len), "sharded_linears": sharded, "seconds": seconds,
            "logits_shape": list(got_logits.shape), "logits_max_abs": scale, "logits_max_abs_gap": logits_gap}


def _cross_card_rank(device, directory: str) -> dict:
    """One rank of `check_cross_card`'s gloo group: every case in turn;
    then the group ends and rank 0 runs the camera mesh again as the one
    rank of an NCCL group."""
    import torch.distributed as dist

    from multimodal_autonomous_driving_perception_and_planning_torch.parallel.distributed import init_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.kernels()
    out = {}
    for name, case in (("camera_mesh", lambda: [cross_camera_mesh(device, t) for t in (False, True)]),
                       ("dp_server", lambda: cross_dp_server(device)),
                       ("tp_yolo", lambda: cross_tp_yolo(device)),
                       ("tp_blip", lambda: cross_tp_blip(device))):
        t0 = time.perf_counter()
        out[name] = case()
        out[f"{name}_s"] = time.perf_counter() - t0
    rank = dist.get_rank()
    dist.destroy_process_group()
    if rank == 0:
        t0 = time.perf_counter()
        init_ranks(device, backend="nccl", init_method="file://" + str(Path(directory) / "nccl-rendezvous"),
                   rank=0, world_size=1, timeout=CROSS_TIMEOUT)
        out["nccl_world_1"] = cross_camera_mesh(device, True)
        out["nccl_s"] = time.perf_counter() - t0
    return out


def check_cross_card(device) -> dict:
    """Phase 19h: two ranks on the one card over gloo with CUDA tensors
    (NCCL refuses two ranks on one card), then one rank over NCCL.  Not a
    run across cards: the machine has one."""
    import tempfile

    from multimodal_autonomous_driving_perception_and_planning_torch.parallel.distributed import spawn

    device = pt.utils.device.resolve_device(device)
    with tempfile.TemporaryDirectory() as directory:
        t0 = time.perf_counter()
        ranks = spawn(_cross_card_rank, 2, directory, directory, backend="gloo", devices=[device, device],
                      timeout=CROSS_TIMEOUT)
        ranks_s = time.perf_counter() - t0
    nccl, nccl_s = ranks[0].pop("nccl_world_1"), ranks[0].pop("nccl_s")
    return {"gloo_ranks_on_one_card": ranks, "ranks_s": ranks_s, "nccl_world_1": nccl, "nccl_s": nccl_s,
            "result": "each rank's cameras equal their lanes of the batched runner, the fleet the sum; the dp "
                      "server answers as the batch server; the tensor-parallel YOLO within 1e-3 of the unsharded "
                      "with K5 launched; the sharded BLIP's tokens equal; the NCCL rank's gathered cameras equal"}


def main(argv) -> int:
    if argv[:1] == ["--export-cpu"]:  # export_path's process without a card
        print(json.dumps(export_cpu(argv[1])), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card only", file=sys.stderr)
        return 1
    if argv[:1] == ["--run-artifacts"]:  # export_path's fresh process
        print(json.dumps(run_artifacts(argv[1])), flush=True)
        return 0
    if argv[:1] == ["--yolo-default-flags"]:  # yolo_default_flags' fresh process
        print(json.dumps(yolo_default_flags()), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(smi, flush=True)
    emit({"phase": "device", "name": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    phase_job, k4_phase_job = start_phase_build(), start_phase_build("associate.cu")
    lib = build.kernels()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "binding": type(lib).__name__})

    emit({"phase": "tracker_kernel", "cases": check_tracker_kernel(device), "result": "exact"})
    k2 = check_kalman_kernel(device)
    emit({"phase": "kalman_kernel", **k2})

    k3 = check_tagging_kernel(device)
    emit({"phase": "tagging_kernel", "cases": k3, "result": "discrete exact, floats within bounds"})
    emit({"phase": "association_kernel", "cases": check_association_kernel(device), "result": "exact"})
    emit({"phase": "nms_kernel", "cases": check_nms_kernel(device), "result": "exact"})
    k6 = check_planner_kernel(device)
    emit({"phase": "planner_kernel", "cases": k6,
          "result": "within hold_plan's bars of the plain version; each lane bit for bit its B = 1 launch"})

    inputs = synthetic_inputs()
    main_path, _ = check_main_path(device, inputs)
    emit({"phase": "main_path", **main_path})
    tagging_path, tagged = check_main_path(device, inputs, enable_tagging=True)
    emit({"phase": "tagging_path", **tagging_path})
    association_path = check_association_path(device, inputs, tagged)
    emit({"phase": "association_path", **association_path})
    road = frames_inputs()
    frames_path, frames_out = check_frames_path(device, road)
    emit({"phase": "frames_path", **frames_path})

    frames, ego = yolo_inputs()
    params = yolo_params(device)
    tower, f32_heads = check_yolo_tower(device, params, frames)
    yolo_path, yolo_cands = check_yolo_path(device, params, frames, ego, YOLO_F32, "YOLO path float32")
    emit({"phase": "yolo_path_float32", "tower": tower, **yolo_path})
    bf16_gaps = relative_gaps(head_outputs(params, frames[:YOLO_BATCH], device, torch.bfloat16), f32_heads)
    if not max(bf16_gaps) <= BF16_LOGIT_REL:
        raise AssertionError(f"YOLO path bf16: head logits stand {bf16_gaps} from the float32 run's")
    yolo_bf16, _ = check_yolo_path(device, params, frames, ego, YOLO_BF16, "YOLO path bf16")
    emit({"phase": "yolo_path_bf16", "head_vs_float32": {"relative_gaps": bf16_gaps, "bound": BF16_LOGIT_REL},
          **yolo_bf16})
    emit({"phase": "yolo_with_frames", **check_yolo_frames(device, params, road, frames_out)})
    emit({"phase": "yolo_default_flags", **check_yolo_default_flags(),
          "result": "float32 tower within the bar under torch's default TF32 flags, the flags left as they were"})
    del frames_out

    emit({"phase": "lane_kernels", "cases": check_lane_kernels(device),
          "result": "each lane bit for bit its B = 1 launch; K1 exact, K2 and K3 within bounds of the plain version"})
    streams = lane_streams(BATCHED_LANES)
    emit({"phase": "batched_path", **check_batched_path(device, streams)})
    emit({"phase": "multicamera_path", **check_multicamera_path(device, streams)})
    emit({"phase": "serve_path", **check_serve_path(device)})
    emit({"phase": "kalman_bank", **check_kalman_bank(device)})
    emit({"phase": "large_tables", **check_large_tables(device),
          "result": "K1 and K4 exact, K3 discrete exact and floats within bounds"})
    emit({"phase": "wide_tables", **check_wide_tables(device),
          "result": "K1, K3, K4 and K5's wide instances bit for bit their plain versions"})
    emit({"phase": "wide_paths", **check_wide_paths(device, params, frames, ego),
          "result": "the three paths equal their CPU runs and their card runs with the plain versions"})
    emit({"phase": "host_stack", **check_host_stack(device)})

    from multimodal_autonomous_driving_perception_and_planning_torch.models.blip import BlipConfig

    blip_weights = blip_params(BlipConfig())
    emit({"phase": "blip_model", **check_blip_model(device, road["frame"][0], blip_weights)})
    emit({"phase": "vlm_path", **check_vlm_path(device, blip_weights)})

    t0 = time.perf_counter()
    times = measure_kernels(device, inputs)
    pools = nms_pools_from(yolo_cands)
    times["nms_keep"] = measure_nms_kernel(device, pools)
    planner_times = measure_planner_kernel(device)
    times["plan_step"] = planner_times["lanes_1"]
    split = measure_split(device, inputs, pools)
    kernel_s = time.perf_counter() - t0
    paths = measure_paths(device, inputs, frames=road)
    lane_split = measure_lane_split(device, road["frame"])
    paths_s = time.perf_counter() - t0 - kernel_s
    emit({"phase": "lane_split", "card": smi, **lane_split})
    yolo_times = measure_yolo(device, params, frames, ego)
    yolo_s = time.perf_counter() - t0 - kernel_s - paths_s
    blip_times = measure_blip(device, blip_weights, road["frame"][0])
    emit({"phase": "times", "card": smi, "floor_ms": split.pop("floor_ms"), "kernels": times, "split": split,
          **paths, "yolo": yolo_times, "blip_times": blip_times,
          "seconds": {"kernels": kernel_s, "paths": paths_s, "yolo": yolo_s,
                      "blip": time.perf_counter() - t0 - kernel_s - paths_s - yolo_s}})
    t0 = time.perf_counter()
    emit({"phase": "lane_times", "card": smi, "kernels": measure_lane_kernels(device, inputs),
          "planner": planner_times, "paths": measure_batched_paths(device), "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    large_times = measure_large_kernels(device)
    wide_nms = measure_wide_nms(device, params)
    emit({"phase": "large_times", "card": smi, "kernels": {**large_times, **wide_nms},
          "round_cost": measure_round_cost(device), "k1_phases": measure_phases(device, phase_job),
          "k4_phases": measure_k4_phases(device, k4_phase_job),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit({"phase": "large_paths", "card": smi, **measure_large_paths(device, params, frames, ego),
          "result": "both paths equal their CPU runs", "seconds": time.perf_counter() - t0})

    # The apps' phases run after every timed phase, so that their ring
    # threads, pinned buffers and renders leave the timed phases' process as
    # it was.  Renders run where cv2 imports: decided here, before the
    # phases, by an import check and not by a failure.
    renders = importlib.util.find_spec("cv2") is not None
    for name, check in (("device_detections", lambda: check_device_detections(device)),
                        ("stream_path", lambda: check_stream_path(device)),
                        ("demo_path", lambda: check_demo_path(device, renders)),
                        ("webview_path", lambda: check_webview_path(device, renders)),
                        ("export_path", lambda: check_export_path(device, inputs)),
                        ("cross_card", lambda: check_cross_card(device))):
        t0 = time.perf_counter()
        result = check()
        emit({"phase": name, "card": smi, **result, "phase_seconds": time.perf_counter() - t0})

    k3_err = max(v for case in k3 for v in case["max_abs_err"].values())
    sources = {
        "tracker_step": (f"{PKG}/kernels/csrc/tracker_step.cu", f"{JAX_PKG}/ops/tracker_pallas.py:51",
                         0.0, main_path),
        "kalman_step": (f"{PKG}/kernels/csrc/kalman_step.cu", f"{JAX_PKG}/ops/kalman_pallas.py:43",
                        max(k2["max_abs_err"].values()), main_path),
        "tagging_step": (f"{PKG}/kernels/csrc/tagging_step.cu", f"{JAX_PKG}/ops/tagging_pallas.py:109",
                         k3_err, tagging_path),
        "associate": (f"{PKG}/kernels/csrc/associate.cu", f"{JAX_PKG}/ops/association_pallas.py:33",
                      0.0, association_path),
        "nms_keep": (f"{PKG}/kernels/csrc/nms_keep.cu", f"{JAX_PKG}/ops/nms_pallas.py:39",
                     0.0, yolo_path),
        "plan_step": (f"{PKG}/kernels/csrc/plan_step.cu", "none: the JAX planner is tensor ops that XLA fuses",
                      max(c["worst"]["costs"] for c in k6), main_path),
    }
    kernels = []
    for name, (source, replaces, err, path) in sources.items():
        m = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path["launches"][name], "max_abs_err": err,
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None,
        })
        if name in ("tracker_step", "associate", "tagging_step"):  # their general instances (large_times)
            kernels[-1]["general_device_ms"] = {
                shape + mode: k[name + mode]["device_ms"] for shape, k in large_times.items()
                for mode in ("", "_frames") if name + mode in k and shape != "{}x{}".format(*K3_YARDSTICK)}
        if name == "nms_keep":  # its large instance beyond 1,024 candidates (large_times)
            kernels[-1]["large_device_ms"] = {shape: k[name]["device_ms"] for shape, k in wide_nms.items()}
    emit({"phase": "total", "seconds": time.perf_counter() - _START})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
