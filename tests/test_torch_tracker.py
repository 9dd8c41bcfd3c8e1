"""The port's tracker step (kernel K1's plain version) against the JAX
package's, bit for bit.

Each case makes its detections with numpy from a seed and feeds them to
the port's `tracker_update_with_order` on CPU tensors, to the JAX
`_tracker_update_xla` + `confirmed_order`, and to the TPU kernel
`tracker_update_pallas` through the Pallas interpreter.  Every table field,
`match`, the confirmed order and its count must be equal at every step.
The cases are those of tests/test_tracker_pallas.py: tie-heavy quantized
boxes, churn that forces misses and deaths, and a saturated table.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from multimodal_autonomous_driving_perception_and_planning_torch.config import (
    TrackerConfig as TrackerConfigT,
)
from multimodal_autonomous_driving_perception_and_planning_torch.ops import tracker_kernel
from multimodal_autonomous_driving_perception_and_planning_torch.tracking import (
    tracker as tracker_t,
)
from multimodal_autonomous_driving_perception_and_planning_torch.types import (
    Detections as DetectionsT,
    TrackTable as TrackTableT,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.config import TrackerConfig
from multimodal_autonomous_driving_perception_and_planning_tpu.ops.tracker_pallas import (
    tracker_update_pallas,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.tracking.tracker import (
    _tracker_update_xla,
    confirmed_order,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.types import (
    Detections,
    TrackTable,
)

FIELDS = (
    "track_id", "bbox", "class_id", "confidence", "age", "hits", "misses",
    "trajectory", "traj_len", "velocity", "vel_count", "next_id",
)


def _random_dets(rng, d_cap, p_valid=0.6, quantize=True):
    cx = rng.uniform(0, 600, d_cap)
    cy = rng.uniform(0, 400, d_cap)
    w = rng.uniform(30, 150, d_cap)
    h = rng.uniform(30, 150, d_cap)
    if quantize:  # coordinate ties -> exact IoU ties
        cx, cy, w, h = (np.round(v / 20) * 20 for v in (cx, cy, w, h))
    bbox = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)
    return {
        "bbox": bbox.astype(np.float32),
        "class_id": rng.integers(0, 8, d_cap).astype(np.int32),
        "confidence": rng.uniform(0.5, 1.0, d_cap).astype(np.float32),
        "valid": rng.random(d_cap) < p_valid,
    }


def _dets_jax(d):
    return Detections(**{k: jnp.asarray(v) for k, v in d.items()})


def _dets_torch(d):
    return DetectionsT(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


class _Trio:
    """The port, the JAX XLA path and the Pallas interpreter, stepped
    together and compared after every step."""

    def __init__(self, t_cap, traj_len, table=None, **cfg):
        """``table``: numpy arrays of the fields that differ from an empty
        table, the same start on every side."""
        self.cfg_j = TrackerConfig(max_tracks=t_cap, trajectory_length=traj_len, **cfg)
        self.cfg_t = TrackerConfigT(max_tracks=t_cap, trajectory_length=traj_len, **cfg)
        table = table or {}
        jax_fields = {k: jnp.asarray(v) for k, v in table.items()}
        self.xla = dataclasses.replace(TrackTable.empty(t_cap, traj_len), **jax_fields)
        self.pal = dataclasses.replace(TrackTable.empty(t_cap, traj_len), **jax_fields)
        self.port = dataclasses.replace(
            TrackTableT.empty(t_cap, traj_len, "cpu"), **{k: torch.tensor(v) for k, v in table.items()}
        )

        def xla(table, dets):
            table, match = _tracker_update_xla(table, dets, self.cfg_j, "cpu")
            return (table, match, *confirmed_order(table, self.cfg_j.min_hits))

        self.step_xla = jax.jit(xla)
        self.step_pal = jax.jit(
            lambda table, dets: tracker_update_pallas(table, dets, self.cfg_j, interpret=True)
        )

    def step(self, d, msg=""):
        self.xla, m_x, o_x, n_x = self.step_xla(self.xla, _dets_jax(d))
        self.pal, m_p, o_p, n_p = self.step_pal(self.pal, _dets_jax(d))
        self.port, m_t, o_t, n_t = tracker_t.tracker_update_with_order(
            self.port, _dets_torch(d), self.cfg_t
        )
        for name, ref, pal, got in (
            ("match", m_x, m_p, m_t), ("order", o_x, o_p, o_t), ("n_confirmed", n_x, n_p, n_t)
        ):
            assert got.dtype == torch.int32, name
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f"{msg} {name}")
            np.testing.assert_array_equal(got.numpy(), np.asarray(pal), err_msg=f"{msg} {name}")
        for f in FIELDS:
            got = getattr(self.port, f).numpy()
            for ref in (getattr(self.xla, f), getattr(self.pal, f)):
                ref = np.asarray(ref)
                assert got.dtype == ref.dtype and got.shape == ref.shape, f
                np.testing.assert_array_equal(got, ref, err_msg=f"{msg} field {f}")


@pytest.mark.parametrize("t_cap,d_cap", [(16, 8), (64, 16), (128, 64)])
def test_tracker_matches_jax_stream(t_cap, d_cap):
    """12 steps: births, matches, misses and deaths (max_age=2 forces deaths
    quickly; p_valid churn forces misses), on tie-heavy quantized boxes."""
    trio = _Trio(t_cap, 6, iou_threshold=0.1, max_age=2, min_hits=3)
    rng = np.random.default_rng(t_cap + d_cap)
    for step in range(12):
        trio.step(_random_dets(rng, d_cap), msg=f"step {step}")


@pytest.mark.parametrize("case", ["staircase_64x16", "all_equal_64x16", "saturated_128x64", "staircase_128x64"])
def test_tracker_matches_jax_adversarial(case):
    """The cases chip_smoke.py holds K1 to its plain version on, here held to
    the JAX tracker and its TPU kernel in the interpreter: the staircase
    and the all-equal ladder from a full table (one pair a round, 17
    rounds), a (128, 64) table filled by fully valid detections, and the
    (128, 64) staircase (65 rounds)."""
    if case == "saturated_128x64":
        trio = _Trio(128, 6, iou_threshold=0.3, max_age=30, min_hits=3)
        rng = np.random.default_rng(4)
        for step in range(4):
            trio.step(_random_dets(rng, 64, p_valid=1.0), msg=f"step {step}")
        assert int((trio.port.track_id > 0).sum()) == 128
        return
    if case == "staircase_128x64":
        table, dets = chip_smoke.ladder_arrays(128, 64, 0.5)
        trio = _Trio(128, 6, table=table, iou_threshold=0.3, max_age=30, min_hits=3)
        trio.step(dets)
        assert int((trio.port.hits > 3).sum()) == 64
        return
    table, dets = chip_smoke.ladder_arrays(64, 16, 1.0 if case.startswith("staircase") else 0.0)
    trio = _Trio(64, 6, table=table, iou_threshold=0.3, max_age=30, min_hits=3)
    for step in range(2):
        trio.step(dets, msg=f"step {step}")


@pytest.mark.parametrize("zero_iou", [False, True], ids=["threshold_ties", "zero_iou_ties"])
def test_tracker_matches_jax_on_key_order_corners(zero_iou):
    """The key-order corners chip_smoke.py holds K1 to its plain version on,
    here held to the JAX tracker and its TPU kernel in the interpreter: a
    full table with permuted ids, every track at IoU 0.3 exactly (the
    threshold) with every even detection; and every pair at IoU +0 under a
    threshold of 0, all tied, so that the id rank and the column decide."""
    table, dets = chip_smoke.corner_arrays(64, 16, zero_iou)
    trio = _Trio(64, 6, table=table, iou_threshold=0.0 if zero_iou else 0.3, max_age=30, min_hits=3)
    for step in range(2):
        trio.step(dets, msg=f"step {step}")
    assert int((trio.port.track_id > 0).sum()) == 64


@pytest.mark.parametrize("live,at_threshold", chip_smoke.BOUNDARY_CASES, ids=["eligible_32", "eligible_33"])
def test_tracker_matches_jax_either_side_of_the_sparse_limit(live, at_threshold):
    """Exactly 32 and 33 eligible pairs (chip_smoke.py `boundary_arrays`:
    ``live`` tracks with permuted ids, ``at_threshold`` detections at IoU
    0.3 exactly, all tied), held to the JAX tracker and its TPU kernel in
    the interpreter; the id rank gives one detection a round."""
    table, dets = chip_smoke.boundary_arrays(live, at_threshold)
    trio = _Trio(64, 6, table=table, iou_threshold=0.3, max_age=30, min_hits=3)
    trio.step(dets)
    assert int((trio.port.hits > 3).sum()) == at_threshold


def test_tracker_tracks_persist():
    """A stationary stream gives a confirmed, aging track whose trajectory
    ring wraps while its length counter keeps counting."""
    trio = _Trio(16, 4, iou_threshold=0.3, max_age=30, min_hits=3)
    bbox = np.zeros((8, 4), np.float32)
    bbox[0] = [100, 100, 200, 200]
    bbox[1] = [300, 50, 380, 120]
    d = {
        "bbox": bbox,
        "class_id": np.zeros(8, np.int32),
        "confidence": np.full((8,), 0.9, np.float32),
        "valid": np.array([True, True] + [False] * 6),
    }
    for step in range(7):
        trio.step(d, msg=f"step {step}")
    assert int(trio.port.track_id[0]) == 1
    assert int(trio.port.hits[0]) == 7
    assert int(trio.port.traj_len[0]) == 7


def test_tracker_saturated_table():
    """More wanted births than free slots: births clamp to the free count
    and next_id advances by the clamped amount."""
    t_cap, d_cap = 8, 16
    trio = _Trio(t_cap, 4, iou_threshold=0.3, max_age=30, min_hits=3)
    rng = np.random.default_rng(0)
    bbox = np.stack(
        [np.arange(d_cap) * 300.0, np.zeros(d_cap),
         np.arange(d_cap) * 300.0 + 100, np.full(d_cap, 100.0)], axis=1
    ).astype(np.float32)
    d = {
        "bbox": bbox,
        "class_id": rng.integers(0, 8, d_cap).astype(np.int32),
        "confidence": np.full((d_cap,), 0.8, np.float32),
        "valid": np.ones(d_cap, bool),
    }
    trio.step(d)
    assert int(trio.port.next_id) == 1 + t_cap
    # The next frame shifts every box: no matches, so all eight slots miss
    # and the eight new detections find no free slot.
    d["bbox"] = d["bbox"] + np.float32(150.0)
    trio.step(d)
    assert int(trio.port.next_id) == 1 + t_cap


def test_cpu_path_launches_no_kernel():
    """CPU tensors take the plain version; the launch counter stays put,
    and the kernel's wrapper refuses CPU tensors outright."""
    cfg = TrackerConfigT(max_tracks=16, trajectory_length=4)
    table = TrackTableT.empty(16, 4, "cpu")
    dets = _dets_torch(_random_dets(np.random.default_rng(1), 8))
    before = tracker_kernel.launches
    tracker_t.tracker_update_with_order(table, dets, cfg)
    assert tracker_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tracker_kernel.tracker_step(table, dets, cfg, cfg.min_hits)


@pytest.mark.parametrize("seed", chip_smoke.NEAR_THRESHOLD_SEEDS)
def test_tracker_matches_jax_near_the_threshold(seed):
    """64 track-detection pairs of unequal sizes whose IoU stands within 2
    ulps of the threshold 0.3 (`chip_smoke.near_threshold_arrays`), held to
    the jitted JAX tracker and its TPU kernel in the Pallas interpreter.
    Both compute the union as fma(w_det, h_det, area_track) - inter, one
    rounding for the fma, and so does the port; the union op for op decides
    some of these pairs the other way."""
    table, dets = chip_smoke.near_threshold_arrays(seed)
    trio = _Trio(128, 6, table=table, iou_threshold=0.3, max_age=30, min_hits=3)
    trio.step(dets)
    a, b = table["bbox"][:64], dets["bbox"]
    t = np.float32(0.3)
    contracted = chip_smoke._iou32(a, b) >= t
    np.testing.assert_array_equal(trio.port.hits.numpy()[:64] > 3, contracted)
    assert (contracted != (chip_smoke._iou32(a, b, contracted=False) >= t)).any()
