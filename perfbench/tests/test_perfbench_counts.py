"""The yardstick's counts against published and recorded figures."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import counts

# Ultralytics' README table: YOLOv8 scales at 640, GFLOPs to one decimal.
PUBLISHED = {
    "n": (0.33, 0.25, 1024, 8.7),
    "s": (0.33, 0.50, 1024, 28.6),
    "m": (0.67, 0.75, 768, 78.9),
    "l": (1.00, 1.00, 512, 165.2),
    "x": (1.00, 1.25, 512, 257.8),
}


@pytest.mark.parametrize("scale", sorted(PUBLISHED))
def test_tower_flops_match_the_published_gflops(scale):
    depth, width, max_ch, gflops = PUBLISHED[scale]
    cfg = {"depth_multiple": depth, "width_multiple": width, "max_channels": max_ch, "num_classes": 80,
           "img_size": 640}
    assert round(counts.tower_flops(cfg) / 1e9, 1) == gflops


def test_kernel_bytes_match_the_recorded_bounds():
    """K1 at (64, 16) with a 50-point ring, K2, and K5 at (64, 256): the
    bytes PERF.md's kernel table records for each bound."""
    assert counts.tracker_bytes(64, 16, 50) == 59_292
    assert counts.kalman_bytes() == 769
    assert counts.nms_bytes(64, 256) == 344_064


def test_tagging_bytes_match_the_recorded_bound():
    """K3 on the detections-mode tagging path's state after 100 synthetic
    frames, with frame 101's detections (the state PERF.md's bound of
    36,864 B was counted on): the port's plain path on the CPU."""
    import torch

    import multimodal_autonomous_driving_perception_and_planning_torch as pt
    from multimodal_autonomous_driving_perception_and_planning_torch.data.synthetic import (
        ego_motion_stream, simulated_detection_stream,
    )

    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True, emit_candidates=False,
                                    emit_trajectories=False)
    dets = simulated_detection_stream(300)
    ego = ego_motion_stream(300, dt=1.0 / 30.0, seed=0).astype(np.float32)
    inputs = {k: v[:100] for k, v in dict(dets, ego_measurement=ego).items()}
    st, _ = pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"), inputs)
    valid = torch.as_tensor(dets["valid"][100])
    cls = torch.as_tensor(dets["class_id"][100])
    table, tag = st.tracks, st.tagging
    alive = table.track_id > 0
    tg = cfg.tagging
    nbytes = counts.tagging_bytes(
        64, 16, tg.scene_smoothing_window, tg.maneuver_history, tg.interaction_history,
        n_valid=int(valid.sum()), n_signs=int((valid & ((cls == 6) | (cls == 7))).sum()),
        alive=int(alive.sum()), with_velocity=int((table.vel_count > 0).sum()),
        kept=int((tag.int_track_id == table.track_id).sum()),
        confirmed=int((alive & (table.hits >= cfg.tracker.min_hits)).sum()))
    assert nbytes == 36_864


def test_nms_ops_count_live_pairs():
    import torch

    assert counts.nms_ops(torch.tensor([256, 0, 1, 3])) == 16 * (256 * 255 // 2 + 3)
