"""Kernels K1-K6 against their plain versions on a CUDA card (K1, K3 and
K4 beyond 128 slots and 64 detections too, up to 4,096; K5 up to 33,600
candidates), the paths that run them, the
host stack and its per-frame facades, and the BLIP captioner (no kernel of
its own) on the card against the CPU.

The kernels are CUDA C++ for sm_90a and have no CPU mode, so every test
here needs the card: on a machine without one they skip.  Run them on the
card with ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
This file imports no JAX: the card's machine has none.
"""

import dataclasses

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_tracker_kernel_matches_plain(device):
    """Every output exact at every step: churn at (64, 16) and (128, 64),
    saturated tables at (64, 16) and (128, 64), the staircase and
    all-equal ladders and the (128, 64) staircase, IoUs exactly at the
    threshold and +0 IoUs all tied, 32 and 33 eligible pairs, IoUs within
    2 ulps of the threshold (the union contracted as compiled XLA rounds
    it), and the 300-frame synthetic stream."""
    cases = chip_smoke.check_tracker_kernel(device, steps=20)
    assert [c["case"] for c in cases] == [
        "churn_64x16", "churn_128x64", "saturated_64x16", "saturated_128x64", "staircase_64x16",
        "all_equal_64x16", "staircase_128x64", "threshold_ties_64x16", "zero_iou_ties_64x16",
        "eligible_32_64x16", "eligible_33_64x16",
    ] + [f"near_threshold_{seed}_128x64" for seed in chip_smoke.NEAR_THRESHOLD_SEEDS] + [
        "synthetic_64x16", "odd_ring_63x16", "long_ring_64x16",
    ]
    torch.cuda.synchronize()


def test_kalman_kernel_matches_plain(device):
    result = chip_smoke.check_kalman_kernel(device, frames=100)
    assert result["unmeasured"] > 0
    assert result["corners"] == [
        "speed_below_hold", "speed_above_hold", "heading_wrap", "unmeasured", "large_P", "ill_conditioned_P"
    ]
    assert list(result["float32_plain_gap"]) == list(chip_smoke.KALMAN_FLOAT64_CASES)
    torch.cuda.synchronize()


def test_main_path_on_card_matches_cpu(device):
    result, _ = chip_smoke.check_main_path(device, chip_smoke.synthetic_inputs())
    assert result["launches"] == {"tracker_step": 300, "kalman_step": 300, "tagging_step": 0, "associate": 0,
                                  "nms_keep": 0, "plan_step": 300}


def test_tagging_kernel_matches_plain(device):
    """Discrete tags and state exact, floats within 1e-5 (state 1e-6), the
    state threaded through each side: detections mode, frames mode, T=128,
    and the crafted stream that reaches every corner of the aggregates."""
    cases = chip_smoke.check_tagging_kernel(device, frames=(40, 30, 20, 40))
    assert [c["case"] for c in cases] == [
        "detections_64x16", "frames_64x16", "detections_128x64", "crafted_64x16", "crafted_frames_128x64",
        "odd_ring_63x16", "long_ring_64x16",
    ]
    torch.cuda.synchronize()


def test_association_kernel_matches_plain(device):
    cases = chip_smoke.check_association_kernel(device, trials=3)
    names = [c["case"] for c in cases]
    assert names[8:13] == [
        "empty_full_and_tied_pair_16x16", "staircase_64x16", "all_equal_64x16", "staircase_128x64", "full_128x64"
    ]
    assert names[13:] == [f"key_corners_{t}x{d}" for t, d in chip_smoke.KEY_CORNER_SHAPES] + [
        "key_corners_few_64x16", "key_corners_few_128x64", "eligible_32_33_64x16", "eligible_32_33_128x64"
    ]
    assert "tied_ranks_64x16" in names
    torch.cuda.synchronize()


def test_tagging_and_association_paths_on_card(device):
    """The tagging path on the card equals the CPU run, K1-K3 launched once a
    frame; the public greedy_associate (K4) reproduces K1's matches."""
    inputs = chip_smoke.synthetic_inputs()
    result, outs = chip_smoke.check_main_path(device, inputs, enable_tagging=True)
    assert result["launches"] == {"tracker_step": 300, "kalman_step": 300, "tagging_step": 300, "associate": 0,
                                  "nms_keep": 0, "plan_step": 300}
    assoc = chip_smoke.check_association_path(device, inputs, outs)
    assert assoc["launches"]["associate"] == 300


def test_nms_kernel_matches_plain(device):
    """K5 exact: tie-quantized pools at K = 16 ... 1024, the chain, all dead,
    all kept, and every case of `chip_smoke.nms_cases` (sizes either side
    of a word, chains across words, thresholds at and near the IoU,
    degenerate, NaN and inf boxes, dead entries between live ones,
    subnormal IoUs, batches of 1 to 200 pools, 64 of 256 among them), and
    boxes that are not 16-byte aligned (the kernel's scalar loads)."""
    cases = chip_smoke.check_nms_kernel(device, trials=3)
    assert [c["case"] for c in cases] == [
        "fuzz_K16", "fuzz_K64", "fuzz_K256", "fuzz_K1024", "chain_all_kept_all_dead"
    ] + list(chip_smoke.nms_cases()) + ["misaligned_boxes"]
    torch.cuda.synchronize()


def test_planner_kernel_matches_plain(device):
    """K6 against its plain version: the default grid from headings near
    +-pi, rest, backing up and far off (and from K2's vehicle row, bit for
    bit the state's launch), a NaN start, the reference path with none,
    some and all points valid, obstacles in the hard and soft bands, all
    costs equal, two equal minima, a 55 x 81 grid, and B = 1, 8 and 64
    random lanes, each lane bit for bit its B = 1 launch
    (chip_smoke.py `hold_plan` gives the bars and their reasons)."""
    cases = chip_smoke.check_planner_kernel(device)
    assert [c["case"] for c in cases] == list(chip_smoke.PLANNER_STATES) + [
        "nan_start", "ref_none", "ref_some", "ref_all", "obstacles", "all_costs_equal", "two_equal_minima",
        "wide_55x81", "lanes_1", "lanes_8", "lanes_64"]
    torch.cuda.synchronize()


def test_segment_spans_count_one_k6_launch_a_frame(device):
    """Two segments of the YOLO runner on the card with the span recorder
    on: each `segment` span counts one K6 launch a frame, as it counts K1's
    and K2's."""
    import numpy as np

    import multimodal_autonomous_driving_perception_and_planning_torch as pt
    from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn
    from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import SyntheticRoadGenerator
    from multimodal_autonomous_driving_perception_and_planning_torch.perception.detector import (
        make_yolo_sequence_runner,
    )
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.profiler import SPANS

    T = 6  # two chunks of 4, the second padded
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True, emit_candidates=False,
                                    emit_trajectories=False)
    frames = SyntheticRoadGenerator().generate_frames(T)
    ego = syn.ego_motion_stream(T, seed=0).astype(np.float32)
    init_fn, run = make_yolo_sequence_runner(cfg, batch=4, score_threshold=0.05, img_size=64, device=device)
    params = init_fn(torch.Generator().manual_seed(0))
    state = pt.initial_state(cfg, device=device)
    SPANS.enable()
    try:
        for _ in range(2):
            state, _ = run(params, state, frames, ego)
        torch.cuda.synchronize()
        spans, dropped, _ = SPANS.drain()
    finally:
        SPANS.enable(False)
    segments = [s.counts for s in spans if s.name == "segment"]
    assert dropped == 0 and len(segments) == 2
    for counts in segments:
        assert counts["frames"] == counts["k6_launches"] == counts["k1_launches"] == counts["k2_launches"] == T


def test_yolo_path_on_card_matches_cpu(device):
    """The YOLO path on 100 frames in float32: the first chunk's tower
    against the CPU's, the tables against the plain nms on the card's own
    candidates, the pipeline against the CPU's; K5 once a chunk."""
    frames, ego = chip_smoke.yolo_inputs(100)
    params = chip_smoke.yolo_params(device)
    tower, _ = chip_smoke.check_yolo_tower(device, params, frames)
    assert max(tower["relative_gaps"]) <= chip_smoke.F32_LOGIT_REL
    result, _ = chip_smoke.check_yolo_path(device, params, frames, ego, chip_smoke.YOLO_F32, "YOLO path")
    assert result["launches"]["nms_keep"] == 2 and result["launches"]["tracker_step"] == 100
    assert result["frames_with_detections"] == 100 and result["track_births"] > 0


def test_frames_path_on_card_matches_cpu(device):
    """The frames path (DEFAULT_CONFIG) over 300 road frames on the card
    against the CPU, K1-K3 once a frame; then a 64-frame YOLO chunk with
    frames, against the frames runner on its tables and the frames path's
    lanes."""
    road = chip_smoke.frames_inputs()
    result, outs = chip_smoke.check_frames_path(device, road)
    assert result["launches"] == {"tracker_step": 300, "kalman_step": 300, "tagging_step": 300, "associate": 0,
                                  "nms_keep": 0, "plan_step": 300}
    assert result["lanes_found"]["offset"] > 0
    yolo = chip_smoke.check_yolo_frames(device, chip_smoke.yolo_params(device), road, outs)
    assert yolo["launches"]["nms_keep"] == 1 and yolo["launches"]["tagging_step"] == 64


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    from multimodal_autonomous_driving_perception_and_planning_torch import TrackerConfig
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import tracker_kernel
    from multimodal_autonomous_driving_perception_and_planning_torch.types import TrackTable

    import numpy as np

    dets = chip_smoke.random_dets(np.random.default_rng(0), 4097, device)
    table = TrackTable.empty(16, 4, device)
    with pytest.raises(ValueError, match="1..4096 detections"):
        tracker_kernel.tracker_step(table, dets, TrackerConfig(), 3)
    with pytest.raises(ValueError, match="1..4096 slots"):
        tracker_kernel.tracker_step(TrackTable.empty(4097, 4, device), dets, TrackerConfig(), 3)

    from multimodal_autonomous_driving_perception_and_planning_torch.ops import association_kernel

    iou = torch.zeros((4097, 4), device=device)
    with pytest.raises(ValueError, match="1..4096 rows"):
        association_kernel.greedy_associate(iou, torch.zeros(4097, dtype=torch.int32, device=device), 0.3)
    with pytest.raises(TypeError, match="expected torch.int32"):
        association_kernel.greedy_associate(iou[:4], torch.zeros(4, dtype=torch.int64, device=device), 0.3)

    from multimodal_autonomous_driving_perception_and_planning_torch.ops import nms_kernel

    with pytest.raises(ValueError, match="1..33600 candidates"):
        nms_kernel.nms_keep(torch.zeros((2, 33601, 4), device=device), torch.zeros((2, 33601), device=device), 0.45)
    with pytest.raises(TypeError, match="expected torch.float32"):
        nms_kernel.nms_keep(torch.zeros((2, 8, 4), device=device), torch.zeros((2, 8), dtype=torch.float64,
                                                                                device=device), 0.45)


def test_first_launch_near_the_default_shared_memory_limit(device):
    """In a fresh process, the first launch of K1 at (64, 32) with a
    50-point ring (the facade's default table: 43 KB of dynamic shared
    memory beside 12 KB of static arrays) and of K3 at T = 128 with rings of
    42 centers (43 KB beside 6 KB): each needs the kernel's dynamic limit
    raised although it asks for less than 48 KB, which no earlier launch
    has done here.  Both equal their plain versions."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import dataclasses, numpy as np, torch, chip_smoke as cs\n"
        "import multimodal_autonomous_driving_perception_and_planning_torch as pt\n"
        "dev = torch.device('cuda')\n"
        "rng = np.random.default_rng(0)\n"
        "cs._tracker_case('first_64x32', pt.TrackerConfig(max_tracks=64), lambda s: cs.random_dets(rng, 32, dev), 3, dev)\n"
        "cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)\n"
        "cfg = cfg.replace(tracker=dataclasses.replace(cfg.tracker, max_tracks=128),\n"
        "                  tagging=dataclasses.replace(cfg.tagging, interaction_history=42))\n"
        "cs._tagging_case('first_128x64', cfg, 3, 1, 64, False, dev)\n"
        "torch.cuda.synchronize()\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=Path(chip_smoke.__file__).parent, timeout=300)


def test_large_tables_match_plain(device):
    """K1, K3 and K4's general instances, beyond 128 slots and 64
    detections, against their plain versions (chip_smoke's `large_tables`
    but the partition's edges): K1 and K4 at (64, 300), (160, 80), (256,
    128) and (1,024, 1,024), the staircase at each (1,025 rounds at
    1,024), and K1 at 8 lanes, each lane equal to its B = 1 launch."""
    tracker = chip_smoke.check_large_tracker(device)
    assert {c["case"] for c in tracker} >= {"churn_1024x1024", "near_threshold_256x128", "staircase_160x80",
                                            "staircase_1024x1024", "churn_64x300"}
    assert next(c for c in tracker if c["case"] == "staircase_1024x1024")["max_matched"] == 1024
    association = chip_smoke.check_large_association(device, trials=2)
    assert len(association) == 24
    assert {"case": "staircase_1024x1024", "matched": 1024} in association
    assert len(chip_smoke.check_large_tagging(device)) == 8
    lanes = chip_smoke.check_large_lanes(device)
    assert [c["case"] for c in lanes if c["case"].startswith("churn")] == ["churn_256x128", "churn_64x300", "churn_1024x1024"]


def test_general_instances_at_partition_edges(device):
    """K1 and K4's general instances at every (T, D) of 65, 129, 300 and
    1,024 (slices of 32 rows and columns, clusters of 4 to 16 blocks, the
    last block's part short or empty), bit for bit their plain versions."""
    cases = chip_smoke.check_partition_edges(device)
    assert len(cases) == 16
    assert {c["k4_cluster"] for c in cases} == {4, 8, 16}


def test_tagging_general_instance_at_partition_edges(device):
    """K3's general instance either side of its warps' and its cluster's
    edges (T = 129, 255, 256, 257, 511, 513, 993 and 1,024, clusters of 2
    to 8 blocks), in both modes, and its rings off the fast path (29
    centers a slot at 1 and 3 lanes, 500 centers): every tag and the state
    bit for bit its plain version's."""
    cases = chip_smoke.check_tagging_partition_edges(device)
    assert len(cases) == 2 * len(chip_smoke.TAG_PARTITION_SIZES) + 3
    assert {c["cluster"] for c in cases if "cluster" in c} == {2, 3, 4, 5, 8}
    assert all(c["bitwise"] for c in cases if "bitwise" in c)
    torch.cuda.synchronize()


def test_yolo_float32_tower_under_default_tf32_flags(device):
    """yolov8n's float32 tower in a fresh process that leaves torch's TF32
    flags at their defaults (cuDNN's on): on the card within 1e-4 of each
    head output's scale of the CPU, and the flags as they were after the
    forward."""
    result = chip_smoke.check_yolo_default_flags()
    assert max(result["relative_gaps"]) <= chip_smoke.F32_LOGIT_REL
    assert result["flags_before"] == result["flags_after"] == [False, True]


def test_large_paths_on_card(device):
    """ROADMAP §3's tagging path (160 slots, 80 detections, 300 frames) and
    the YOLO path at max_detections=300 (64 slots against 300 detections,
    300 frames) on the card against their CPU runs, each launching K1's
    general instance every frame."""
    tagging = chip_smoke.check_large_tagging_path(device)
    assert tagging["launches"]["tracker_step"] == tagging["launches"]["tagging_step"] == chip_smoke.LARGE_FRAMES
    frames, ego = chip_smoke.yolo_inputs()
    cfg = chip_smoke.bench_config()
    cfg = cfg.replace(detector=dataclasses.replace(cfg.detector, max_detections=chip_smoke.YOLO_MAX_DET))
    result, _ = chip_smoke.check_yolo_path(device, chip_smoke.yolo_params(device), frames, ego, chip_smoke.YOLO_F32,
                                           "YOLO path at max_detections=300", cfg=cfg)
    assert result["launches"]["tracker_step"] == 300 and result["launches"]["nms_keep"] == 5
    assert result["valid_per_frame"]["max"] > 128


def test_wide_instances_match_plain(device):
    """K1 and K4's general instances at (1,025, 64), (2,048, 300), (4,096,
    1,024) and (4,096, 4,096), the ladders 4,097 rounds long at the last
    (K1 there through its rank and stage kernels before the cluster
    kernel); K3's at 1,025, 2,048 and 4,096 slots in both modes and on the
    crafted stream; K5's large instance (its mask and tiled scan kernels)
    at (64, 1,025), (64, 8,400) and (2, 33,600); K1 at 8 lanes at (2,048,
    300): each bit for bit its plain version (chip_smoke's
    `wide_tables`)."""
    result = chip_smoke.check_wide_tables(device)
    assert {c["case"] for c in result["tracker"]} >= {"staircase_4096x4096", "all_equal_4096x4096", "churn_2048x300"}
    assert {"case": "staircase_4096x4096", "matched": 4096} in result["association"]
    assert {c["cluster"] for c in result["tagging"] if "cluster" in c} == {5, 8, 16}
    assert any(c["case"] == "sparse_chain_2x33600" for c in result["nms"])
    torch.cuda.synchronize()


def test_wide_instances_launch_their_kernels(device):
    """One call of K1's wrapper beyond 1,024 slots runs the rank, stage and
    cluster kernels and counts one launch; at (1,024, 64), where its keys
    stay in shared memory, the cluster kernel alone; one call of K5's
    beyond 1,024 candidates runs the mask and scan kernels and counts one;
    each equal to its plain version."""
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import nms_kernel, tracker_kernel

    for (t, d), kernels in (((1025, 64), chip_smoke.K1_STAGED_KERNELS + (chip_smoke.K1_CLUSTER_KERNEL,)),
                            ((1024, 64), (chip_smoke.K1_CLUSTER_KERNEL,))):
        x = chip_smoke.large_kernel_inputs(device, t, d)
        cfg, table, dets = x["cfg"], x["table"], x["dets"]
        assert chip_smoke.k1_kernels(t, d, cfg.trajectory_length) == kernels
        before = tracker_kernel.launches
        got, records = chip_smoke.card_trace(lambda: tracker_kernel.tracker_step(table, dets, cfg, cfg.min_hits))
        assert tracker_kernel.launches == before + 1
        every = chip_smoke.K1_STAGED_KERNELS + (chip_smoke.K1_CLUSTER_KERNEL,)
        assert {k for k in every if any(k in e.name for e in records)} == set(kernels)
        want = chip_smoke.plain_tracker_step(table, dets, cfg)
        for a, b in zip(chip_smoke._tensors(got), chip_smoke._tensors(want)):
            assert torch.equal(a, b)
    case = chip_smoke.wide_nms_cases(2, 2048)["random_2x2048"]
    bx, sc = torch.tensor(case.boxes, device=device), torch.tensor(case.scores, device=device)
    before = nms_kernel.launches
    keep, records = chip_smoke.card_trace(lambda: nms_kernel.nms_keep(bx, sc, case.thr))
    assert nms_kernel.launches == before + 1
    assert all(any(k in e.name for e in records) for k in ("nms_mask_kernel", "nms_scan_kernel"))
    assert torch.equal(keep, chip_smoke.plain_nms_keep(bx, sc, case.thr))


def _assoc_plan_words(t: int, d: int) -> int:
    """association.cuh `assoc_plan` at (t, d), its blocks' key words, and the
    staged route's scratch (associate.cu `staged_words`): every block's
    key lines, then 2 words a row chunk best, 3 a column chunk best and
    its row, rounded up to 4 words."""
    c = 1
    while c < (t + d + 63) // 64 and c < 16:
        c *= 2
    rows = 32 * ((-(-t // 32) + c - 1) // c)
    cols = 32 * ((-(-d // 32) + c - 1) // c)
    key_words = rows * (-(-d // 4) * 4) + cols * (-(-t // 4) * 4)
    n = c * key_words + 2 * t * -(-d // 32) + 3 * d * -(-t // 32)
    return -(-n // 4) * 4


def test_k4_staged_route_on_tied_and_wrapping_ranks(device, monkeypatch):
    """K4's staged route (the stage kernel over the card, then the cluster
    kernel) at (1,024, 1,024) and (4,096, 4,096), on tied ranks and on the
    key-order corners (ranks at int32's ends whose tie-break keys rank * D
    + column wrap), bit for bit its plain version; each call counts one
    launch and runs both kernels; the scratch the wrapper allocates is
    every block's key lines and the chunk bests, as the launcher sizes
    it."""
    import numpy as np

    from multimodal_autonomous_driving_perception_and_planning_torch.ops import association_kernel
    from multimodal_autonomous_driving_perception_and_planning_torch.ops.association import _greedy_associate_plain

    sizes = []
    empty = torch.empty

    def recording_empty(*args, **kwargs):
        out = empty(*args, **kwargs)
        if out.dtype == torch.int32 and out.dim() == 1:
            sizes.append(out.numel())
        return out

    for t, d in ((1024, 1024), (4096, 4096)):
        assert chip_smoke.k4_kernels(t, d) == chip_smoke.K4_STAGED_KERNELS + (chip_smoke.K4_CLUSTER_KERNEL,)
        assert association_kernel.scratch_words(t, d) == _assoc_plan_words(t, d)
        rng = np.random.default_rng(t + d)
        for name, (iou, rank) in (("tied", chip_smoke.random_association(rng, t, d, tied=True)),
                                  ("wrapping", chip_smoke.key_corner_association(rng, t, d, 0.3))):
            iou_t, rank_t = torch.tensor(iou, device=device), torch.tensor(rank, device=device)
            before, sizes[:] = association_kernel.launches, []
            with monkeypatch.context() as m:
                m.setattr(torch, "empty", recording_empty)
                got, records = chip_smoke.card_trace(
                    lambda: association_kernel.greedy_associate(iou_t, rank_t, 0.3))
            assert association_kernel.launches == before + 1
            assert sizes == [t, _assoc_plan_words(t, d)]  # the matches, then the scratch
            assert all(any(k in e.name for e in records) for k in chip_smoke.k4_kernels(t, d))
            want = _greedy_associate_plain(iou_t, rank_t, 0.3)
            assert torch.equal(got, want), f"K4 {name} {t}x{d}: {int((got != want).sum())} rows differ"
            assert (want >= 0).any()


def test_wide_paths_on_card(device):
    """`yolo_all_anchors` (K5 at (64, 8,400)), `tagging_4096` (K1 at (4,096,
    1,024) and K3 at 4,096 slots a frame, more than 1,024 of them live) and
    `frames_360` (a Hough grid of 360 thetas) on the card against their CPU
    runs and their card runs with the plain versions; the Hough tables on
    this host equal the carried ones."""
    frames, ego = chip_smoke.yolo_inputs(chip_smoke.YOLO_BATCH)
    result = chip_smoke.check_wide_paths(device, chip_smoke.yolo_params(device), frames, ego)
    assert result["yolo_all_anchors"]["launches"]["nms_keep"] == 1
    assert result["tagging_4096"]["live_slots"]["max"] > 1024
    assert result["frames_360"]["launches"]["tagging_step"] == chip_smoke.WIDE_FRAMES_FRAMES
    assert min(r["cpu_frames"] for r in (result["tagging_4096"], result["frames_360"])) >= 8


def test_reference_path_on_the_card_by_default(device):
    """`make_reference_path` puts its buffers on the card unless asked for
    the CPU."""
    from multimodal_autonomous_driving_perception_and_planning_torch.planning import make_reference_path

    buf, valid = make_reference_path([(0.0, 1.0), (2.0, 3.0)], 8)
    assert buf.device.type == valid.device.type == "cuda"
    assert buf[:2].tolist() == [[0.0, 1.0], [2.0, 3.0]] and valid.tolist() == [True] * 2 + [False] * 6


def test_host_stack_on_card(device):
    """chip_smoke's `host_stack` phase: the records, AutoTagger and
    TagDatabase of a card run equal the CPU chain's, and the facades on the
    card equal the card's runner, each launching its kernel."""
    result = chip_smoke.check_host_stack(device)
    n = chip_smoke.HOST_FRAMES
    assert result["launches"] == {"tracker_step": n, "kalman_step": n, "tagging_step": n, "associate": 0,
                                  "nms_keep": 1, "plan_step": n}


@pytest.mark.parametrize("B", [1, 8, 64])
def test_lane_kernels_match_per_lane_launches(device, B):
    """K1, K2 and K3 at B lanes a launch, each lane on its own stream: every
    lane bit for bit its B = 1 launch, and its plain version's result (K1
    exact, K2 and K3 within their bounds); at B = 8 also rings of 63 slots
    and K3 in frames mode at (128, 64)."""
    cases = chip_smoke.check_lane_kernels(device, lane_counts=(B,), steps={B: 4})
    names = ["churn_64x16", "ego_streams", "detections_64x16", "frames_64x16"]
    if B == 8:
        names += ["odd_ring_63x16", "odd_ring_63x16", "frames_128x64"]
    assert [c["case"] for c in cases] == names and all(c["B"] == B for c in cases)
    torch.cuda.synchronize()


def test_batched_and_multicamera_paths_match_unbatched_card_runs(device):
    """8 lanes over 60 frames: the batched tagging path and the multi-camera
    main path each equal to their lanes' unbatched card runs, one launch of
    each kernel a frame for all lanes."""
    streams = chip_smoke.lane_streams(8, 60)
    batched = chip_smoke.check_batched_path(device, streams)
    assert batched["launches"]["tracker_step"] == batched["launches"]["tagging_step"] == 60
    assert batched["launches"]["plan_step"] == 60 and batched["planner_max_abs_gap"] == 0.0
    cams = chip_smoke.check_multicamera_path(device, streams)
    assert cams["launches"]["kalman_step"] == cams["launches"]["plan_step"] == 60
    assert cams["launches"]["tagging_step"] == 0


def test_serve_path_and_kalman_bank_on_card(device):
    served = chip_smoke.check_serve_path(device)
    assert served["loadgen"]["completed_requests"] == 32 and served["device"] == "cuda"
    bank = chip_smoke.check_kalman_bank(device)
    assert bank["frames"] == 300 and bank["agents"] == 64


def test_blip_short_decode_on_card_matches_cpu(device):
    """chip_smoke's `blip_model` phase: the full-width BLIP with seeded
    weights on a road frame, the card against the CPU: the pixels, states,
    cross K/V and logits within bounds, and the greedy and beam-3 decodes
    at 8 new tokens equal but after a decision within the measured gap."""
    from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import SyntheticRoadGenerator
    from multimodal_autonomous_driving_perception_and_planning_torch.models.blip import BlipConfig

    frame = SyntheticRoadGenerator().generate_frames(1)[0]
    result = chip_smoke.check_blip_model(device, frame, chip_smoke.blip_params(BlipConfig()))
    for mode in ("greedy", "beam3"):
        assert result["prompt_len"] <= result[mode]["length"] <= result["prompt_len"] + chip_smoke.BLIP_SHORT_NEW


def test_stream_path_pinned_double_buffer(device):
    """chip_smoke's `stream_path` without its timings: the native ring
    drained into two pinned host buffers, each copied to the card on a side
    stream, into `run_stream` over the frames path, against the card's
    monolithic runner; then a ring of 16 slots with 4 producer threads
    (drains that wait on the producers), and the feed probe."""
    result = chip_smoke.check_stream_path(device, measure=False)
    padded = 320
    assert result["launches"] == {"tracker_step": padded, "kalman_step": padded, "tagging_step": padded,
                                  "associate": 0, "nms_keep": 0, "plan_step": padded}
    assert result["max_abs_err"] <= chip_smoke.MAIN_ATOL and result["small_ring"]["max_abs_err"] <= chip_smoke.MAIN_ATOL
    assert result["feed_probe"]["chunks_differing"] == []


def test_frame_feed_reuses_no_buffer_early(device):
    """The pinned double buffer under a consumer that never waits on the
    host (the runner's host reads would hide a race): a host buffer drained
    into before its copy completes, or a device buffer copied into before
    its chunk is read, makes a chunk read on the card differ from the
    ring's bytes."""
    probe = chip_smoke.feed_race_probe(device)
    assert probe["chunks"] == chip_smoke.PROBE_CHUNKS and probe["chunks_differing"] == []


def test_device_detection_stream_on_card(device):
    result = chip_smoke.check_device_detections(device)
    assert result["launches"]["tracker_step"] == 300 and result["boxes"] > 900


def test_demo_and_webview_on_card(device):
    """chip_smoke's `demo_path` (the demo over 300 frames, --yolo with seeded
    weights, the multi-camera demo) and `webview_path`, renders included
    where cv2 imports."""
    import importlib.util

    renders = importlib.util.find_spec("cv2") is not None
    demo = chip_smoke.check_demo_path(device, renders)
    assert demo["yolo"]["launches"]["nms_keep"] == 1 and demo["multicamera"]["launches"]["tracker_step"] == 30
    web = chip_smoke.check_webview_path(device, renders)
    assert web["launches"]["tagging_step"] == 120 and len(web["chunk_seconds"]) == 4


def test_madpp_ops_equal_their_wrappers(device):
    """Each madpp op (ops/library.py) on the card against its wrapper on the
    same inputs at the paths' states, ``madpp.tagging_step`` in both of
    K3's modes and at 160 slots (its general instance), every output bit
    for bit."""
    result = chip_smoke.check_madpp_ops(device, chip_smoke.synthetic_inputs())
    assert sorted(result) == ["kalman_step", "tagging_step", "tagging_step_160", "tagging_step_frames", "tracker_step"]
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["tracker_step", "kalman_step", "tagging_step"])
def test_madpp_op_raises_when_its_kernel_cannot_build(device, monkeypatch, name):
    """No fallback: with the kernels' build failing, the op on CUDA tensors
    raises and never runs the plain version."""
    from multimodal_autonomous_driving_perception_and_planning_torch.kernels import build

    wrapper, op = chip_smoke._op_routes(device, chip_smoke.synthetic_inputs())[name]

    def no_build():
        raise RuntimeError("the kernels did not build")

    monkeypatch.setattr(build, "kernels", no_build)
    with pytest.raises(RuntimeError, match="did not build"):
        op()


def test_export_path_on_card(device):
    """The serialized runner on the card (chip_smoke's `export_path`): the
    programs hold the madpp ops, and loaded in a fresh process they run
    300 frames bit for bit the eager runner's at batch 1 and 8, one launch
    of each kernel a frame."""
    result = chip_smoke.check_export_path(device, chip_smoke.synthetic_inputs())
    labels = [label for label, _, _ in chip_smoke.EXPORT_CASES]
    assert sorted(result["cases"]) == sorted(labels + ["frames_b1", "multi_b1"])
    for label in labels:
        assert result["cases"][label]["bytes"] > 0 and result["cases"][label]["device"] == "cuda"
    frames = result["cases"]["frames_b1"]
    assert frames["while_loops"] == 2 and frames["launches"]["tagging_step"] == chip_smoke.EXPORT_FRAMES_MODE
    h = frames["hysteresis_per_frame"]
    assert h["eager_reads"] == h["eager_blocks"]
    assert h["exported_reads"] == h["eager_blocks"] + h["eager_calls_past_one_block"]
    multi = result["cases"]["multi_b1"]
    assert multi["exported_on"] == "cpu" and multi["float_max_abs_gap"] <= chip_smoke.MULTI_PLATFORM_ATOL


def test_frames_mode_tagging_op_on_card(device):
    """``madpp.tagging_step`` with its lane and feature rows (K3's frames
    mode) on the card against the wrapper on the same inputs, bit for
    bit, with and without a lane axis."""
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import library, tagging_kernel
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.rules import frames_from_rows
    from multimodal_autonomous_driving_perception_and_planning_torch.types import stack_lanes

    rules, state, dets, table, vrow = chip_smoke.tagging_state(device, chip_smoke.synthetic_inputs())
    gen = torch.Generator().manual_seed(3)
    lane_row = torch.cat([torch.randn(6, generator=gen), torch.tensor([1.0, 0.0])]).to(device)
    feat_row = (torch.rand(6, generator=gen) * torch.tensor([0.1, 8.0, 200.0, 0.2, 120.0, 300.0])).to(device)
    step = library.make_packed_tagging_step(chip_smoke.bench_config(True))
    for lanes in (None, 3):
        args = (state, dets, table, vrow, lane_row, feat_row)
        if lanes is not None:
            args = tuple(stack_lanes([a] * lanes) for a in args)
        lane_obs, feats = frames_from_rows(args[4], args[5])
        want = tagging_kernel.tagging_step(rules, *args)
        got = step(*args[:4], lane_obs, feats)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(chip_smoke._tensors(got), chip_smoke._tensors(want)))


def test_traced_hysteresis_on_card(device):
    """The Canny hysteresis's while_loop form on the card: the eager
    blocks' maps and rounds on road frames."""
    result = chip_smoke.hysteresis_rounds(device, chip_smoke.frames_inputs(4)["frame"])
    assert result["traced_rounds"] == result["eager_rounds"] > 0


def test_cross_card_on_one_card(device):
    """chip_smoke's `cross_card`: two gloo ranks sharing the card (camera
    mesh, dp server, tensor-parallel YOLO and BLIP), then one NCCL rank."""
    result = chip_smoke.check_cross_card(device)
    ranks = result["gloo_ranks_on_one_card"]
    assert len(ranks) == 2 and ranks[0]["dp_server"]["dp"] == 2
    assert ranks[0]["tp_yolo"]["launches"]["nms_keep"] >= 1
    assert result["nccl_world_1"]["gathered_whole"]
