"""The port's runner at tables larger than the card kernels' fast
instances (128 track slots, 64 detections) against the JAX package's.

The JAX package runs any table size; the port's kernels K1 and K3 take up
to 1,024 slots and detections on the card, through a general instance
beyond the fast one.  Here the port runs its kernels' plain versions
(``device="cpu"``) against the jitted JAX runner in detections mode with
tagging on, at max_tracks=160, max_detections=80 (ROADMAP §3's input) and
at (256, 128): discrete outputs and every discrete tag bit for bit, floats
within atol 1e-4 (PARITY.md).  `chip_smoke.py`'s `large_tables` phase
holds the kernels to these plain versions on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn_t
from multimodal_autonomous_driving_perception_and_planning_torch.ops import (
    association_kernel,
    tagging_kernel,
    tracker_kernel,
)
from multimodal_autonomous_driving_perception_and_planning_torch.ops.association import _greedy_associate_plain
from multimodal_autonomous_driving_perception_and_planning_torch.pipeline import check_card_limits
from multimodal_autonomous_driving_perception_and_planning_tpu.ops.association import (
    greedy_associate as jax_greedy_associate,
)

ATOL = 1e-4
TTC_RTOL = 1e-5
_DISCRETE = ("track_id", "match", "confirmed_order", "num_confirmed", "track_hits", "track_misses",
             "track_age", "track_class_id", "plan_best")
_FLOAT = ("track_bbox", "track_confidence", "track_velocity", "plan_costs")


def _config(pkg, tracks, dets):
    cfg = pkg.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    return cfg.replace(
        tracker=dataclasses.replace(cfg.tracker, max_tracks=tracks),
        detector=dataclasses.replace(cfg.detector, max_detections=dets),
    )


def _inputs(frames, capacity):
    dets = syn_t.simulated_detection_stream(frames, capacity=capacity)
    ego = syn_t.ego_motion_stream(frames, dt=1.0 / 30.0, seed=0).astype(np.float32)
    return dict(dets, ego_measurement=ego)


@pytest.mark.parametrize("tracks,dets,frames", [(160, 80, 20), (256, 128, 12)], ids=["160x80", "256x128"])
def test_runner_matches_jax_beyond_the_fast_instances(tracks, dets, frames):
    inputs = _inputs(frames, dets)
    cfg_j = _config(pj, tracks, dets)
    _, outs_j = pj.make_sequence_runner(cfg_j, donate=False)(
        pj.initial_state(cfg_j), {k: jnp.asarray(v) for k, v in inputs.items()}
    )
    cfg_t = _config(pt, tracks, dets)
    _, outs_t = pt.make_sequence_runner(cfg_t, device="cpu")(pt.initial_state(cfg_t, device="cpu"), inputs)
    assert outs_t["track_id"].shape == (frames, tracks) and outs_t["match"].shape == (frames, tracks)
    assert int(outs_t["num_confirmed"].max()) > 0
    for k in _DISCRETE:
        a, b = outs_t[k].numpy(), np.asarray(outs_j[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in _FLOAT:
        np.testing.assert_allclose(outs_t[k].numpy(), np.asarray(outs_j[k]), rtol=0, atol=ATOL, err_msg=k)
    tags_t, tags_j = outs_t["tags"], outs_j["tags"]
    assert set(tags_t) == set(tags_j) and len(tags_j) == 43
    for k in sorted(tags_j):
        a, b = tags_t[k].numpy(), np.asarray(tags_j[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=TTC_RTOL if "ttc" in k else 0.0, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize(
    "field,kw",
    [("tracker.max_tracks", dict(tracks=1025, dets=16)), ("detector.max_detections", dict(tracks=64, dets=1025))],
)
def test_card_runners_refuse_tables_beyond_the_kernels_when_built(field, kw):
    """The card's runners refuse a table the kernels do not take when they
    are built, naming the limit and the config field; at the limit, and on
    the CPU at any size, they build."""
    with pytest.raises(ValueError, match=rf"{field} = 1025: the card's kernels take at most 1024"):
        check_card_limits(_config(pt, **kw), torch.device("cuda"))
    check_card_limits(_config(pt, 1024, 1024), torch.device("cuda"))
    check_card_limits(_config(pt, **kw), torch.device("cpu"))


def test_wrapper_limits_are_the_general_instances():
    """The wrappers take what the kernels' general instances take (the
    kernels' launchers check the same limits), and the card runners'
    build-time check refuses what they do not."""
    assert tracker_kernel.MAX_TRACKS == tagging_kernel.MAX_TRACKS == 1024
    assert tracker_kernel.MAX_DETECTIONS == association_kernel.MAX_ROWS == association_kernel.MAX_COLS == 1024


@pytest.mark.parametrize("shape", chip_smoke.LARGE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_association_matches_jax_at_large_tables(shape):
    """The matrices chip_smoke's `large_tables` holds K4's general instance
    to its plain version on (random, tied ranks, full, and the key-order
    corners, whose ranks' tie-break keys rank * D + column wrap in int32 at
    these D), here the plain version held to the JAX XLA fixpoint."""
    t, d = shape
    rng = np.random.default_rng(t * 7 + d)
    cases = [
        (*chip_smoke.random_association(rng, t, d), 0.3),
        (*chip_smoke.random_association(rng, t, d, tied=True), 0.3),
        (*chip_smoke.full_association(rng, t, d), 0.3),
    ] + [(*chip_smoke.key_corner_association(rng, t, d, thr), thr) for thr in chip_smoke.KEY_CORNER_THRESHOLDS]
    for i, (iou, rank, thr) in enumerate(cases):
        want = np.asarray(jax_greedy_associate(jnp.asarray(iou), jnp.asarray(rank), thr, backend="cpu"))
        got = _greedy_associate_plain(torch.tensor(iou), torch.tensor(rank), thr).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"case {i}")
        assert (got >= 0).any()
