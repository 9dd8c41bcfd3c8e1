"""The port's runner at tables larger than the card kernels' fast
instances (128 track slots, 64 detections) against the JAX package's.

The JAX package runs any table size; the port's kernels K1 and K3 take up
to 4,096 slots and detections on the card, through a general instance
beyond the fast one, and K5 pools of up to 33,600 candidates.  Here the
port runs its kernels' plain versions (``device="cpu"``) against the
jitted JAX runner in detections mode with tagging on, at max_tracks=160,
max_detections=80 (ROADMAP §3's input), at (256, 128) and at (1,040, 24):
discrete outputs and every discrete tag bit for bit, floats within atol
1e-4 (PARITY.md); and the general instances' and K5's large instance's
schedules, modelled in plain torch, against the plain versions and JAX.
`chip_smoke.py`'s `large_tables` and `wide_tables` phases hold the kernels
to these plain versions on the card.
"""

import dataclasses
import functools
from pathlib import Path

import jax
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
    nms_kernel,
    tagging_kernel,
    tracker_kernel,
)
from multimodal_autonomous_driving_perception_and_planning_torch.ops.association import _greedy_associate_plain
from multimodal_autonomous_driving_perception_and_planning_torch.ops.geometry import pairwise_iou
from multimodal_autonomous_driving_perception_and_planning_torch.ops.nms import _nms_keep_plain
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


@pytest.mark.parametrize("tracks,dets,frames", [(160, 80, 20), (256, 128, 12), (1040, 24, 3)],
                         ids=["160x80", "256x128", "1040x24"])
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
    [("tracker.max_tracks", dict(tracks=4097, dets=16)), ("detector.max_detections", dict(tracks=64, dets=4097))],
)
def test_card_runners_refuse_tables_beyond_the_kernels_when_built(field, kw):
    """The card's runners refuse a table the kernels do not take when they
    are built, naming the limit and the config field; at the limit, and on
    the CPU at any size, they build."""
    with pytest.raises(ValueError, match=rf"{field} = 4097: the card's kernels take at most 4096"):
        check_card_limits(_config(pt, **kw), torch.device("cuda"))
    check_card_limits(_config(pt, 4096, 4096), torch.device("cuda"))
    check_card_limits(_config(pt, **kw), torch.device("cpu"))


def test_wrapper_limits_are_the_general_instances():
    """The wrappers take what the kernels' general instances take (the
    kernels' launchers check the same limits), and the card runners'
    build-time check refuses what they do not; K5 takes every anchor of
    yolov8 at 1,280."""
    assert tracker_kernel.MAX_TRACKS == tagging_kernel.MAX_TRACKS == 4096
    assert tracker_kernel.MAX_DETECTIONS == association_kernel.MAX_ROWS == association_kernel.MAX_COLS == 4096
    assert nms_kernel.MAX_K == 160**2 + 80**2 + 40**2 == 33_600 and nms_kernel.FAST_MAX_K == 1024
    assert nms_kernel.workspace_words(64, 8400) == (64 * 8400 * 263, 64 * 263)


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


_MASK32 = 0xFFFFFFFF
MODEL_PARTS = (1, 2, 8, 16)
MODEL_CASES = ("random", "tied_ranks", "full", "key_corners_thr0", "key_corners_thr0.3")


def _split(n: int, parts: int) -> list:
    """The kernel's partition (`assoc_plan`): each block owns 32 ceil(ceil(n
    / 32) / parts) consecutive lines, the last ones fewer or none."""
    per = 32 * -(-(-(-n // 32)) // parts)
    return [(min(p * per, n), min((p + 1) * per, n)) for p in range(parts)]


def cluster_rounds_model(iou: torch.Tensor, rank: torch.Tensor, thr: float, parts: int,
                         threads: int | None = None) -> torch.Tensor:
    """The cluster schedule of association.cuh's general instance in plain
    torch.  Each entry is the kernel's 64-bit key, (IoU key << 32) | ~(rank
    * D + d + 2^31) in 32-bit arithmetic that wraps, the IoU key its bits
    with the sign cleared, plus one (0: not eligible), so -0 ties +0 and NaN
    never enters.  Each round every part recomputes the stale bests of its
    rows (over the columns not taken) and of its columns (over the rows not
    matched, keeping the row that holds it), carries the others over, and
    the exchange hands every part every row's and column's best; each part
    then accepts every live row whose best is its column's best, in passes
    of ``threads`` rows (a thread a row each pass; all rows in one pass by
    default), and the loop ends at the first round that accepts nothing."""
    T, D = iou.shape
    eligible = (iou >= thr) & (iou >= 0.0)
    key = torch.where(eligible, (iou.view(torch.int32).to(torch.int64) & 0x7FFFFFFF) + 1, 0)
    base = (rank.to(torch.int64) * D + 2**31) & _MASK32  # each row's tie-break base
    tie = (base[:, None] + torch.arange(D, dtype=torch.int64)[None, :]) & _MASK32
    entry = torch.where(key != 0, (key << 32) | (~tie & _MASK32), 0)  # int64: every key < 2^63
    rows, cols = _split(T, parts), _split(D, parts)
    matched = torch.zeros(T, dtype=torch.bool)
    taken = torch.zeros(D, dtype=torch.bool)
    rowbest = torch.zeros(T, dtype=torch.int64)
    colbest = torch.zeros(D, dtype=torch.int64)
    colrow = torch.zeros(D, dtype=torch.int64)
    match = torch.full((T,), -1, dtype=torch.int32)

    def column_of(best, b):  # the column of a row's best key
        return ((~best & _MASK32) - b) & _MASK32

    first = True
    while True:
        for (r0, r1), (c0, c1) in zip(rows, cols):
            rb, cb = rowbest[r0:r1], colbest[c0:c1]
            stale = ~matched[r0:r1] & (rb != 0)
            stale &= taken[column_of(rb, base[r0:r1]).clamp(max=D - 1)]
            stale |= first
            if stale.any():
                live = torch.where(taken[None, :], 0, entry[r0:r1][stale])
                rowbest[r0:r1][stale] = live.amax(dim=1)
            stale = ~taken[c0:c1] & (cb != 0) & matched[colrow[c0:c1]]
            stale |= first
            if stale.any():
                live = torch.where(matched[:, None], 0, entry[:, c0:c1][:, stale])
                best, arg = live.max(dim=0)
                colbest[c0:c1][stale] = best
                colrow[c0:c1][stale] = arg
        first = False
        # The exchange hands every part every row's and column's best, so
        # each part makes this same decision.
        d = column_of(rowbest, base)
        ok = ~matched & (rowbest != 0)
        accept = torch.zeros(T, dtype=torch.bool)
        for t0 in range(0, T, threads or T):
            t = slice(t0, t0 + (threads or T))
            accept[t] = ok[t] & (colbest[torch.where(ok[t], d[t], 0)] == rowbest[t])
        if not accept.any():
            return match
        match[accept] = d[accept].to(torch.int32)
        matched |= accept
        taken[d[accept]] = True


@pytest.fixture
def one_thread():
    """One intra-op thread for the model's small tensor ops: under xdist the
    default, a thread a core in every worker, made each case several times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model_cases(t: int, d: int) -> dict:
    """`test_plain_association_matches_jax_at_large_tables`'s matrices at
    (t, d), drawn in its order, each with JAX's XLA fixpoint and the plain
    version's matches."""
    rng = np.random.default_rng(t * 7 + d)
    drawn = [
        (*chip_smoke.random_association(rng, t, d), 0.3),
        (*chip_smoke.random_association(rng, t, d, tied=True), 0.3),
        (*chip_smoke.full_association(rng, t, d), 0.3),
    ] + [(*chip_smoke.key_corner_association(rng, t, d, thr), thr) for thr in chip_smoke.KEY_CORNER_THRESHOLDS]
    return {
        kind: (iou, rank, thr,
               np.asarray(jax_greedy_associate(jnp.asarray(iou), jnp.asarray(rank), thr, backend="cpu")),
               _greedy_associate_plain(torch.tensor(iou), torch.tensor(rank), thr).numpy())
        for kind, (iou, rank, thr) in zip(MODEL_CASES, drawn)
    }


@pytest.mark.parametrize("parts", MODEL_PARTS)
@pytest.mark.parametrize("kind", MODEL_CASES)
@pytest.mark.parametrize("shape", chip_smoke.LARGE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cluster_round_model_matches_plain_and_jax(shape, kind, parts, one_thread):
    """The cluster schedule over ``parts`` blocks equals the plain version
    and JAX's fixpoint, bit for bit, on the matrices of
    `test_plain_association_matches_jax_at_large_tables`: random, tied
    ranks, full, and the key-order corners (-0 and +0, the threshold, NaN,
    tied IoUs, ranks at int32's ends whose rank * D + d wraps)."""
    iou, rank, thr, want, plain = _model_cases(*shape)[kind]
    got = cluster_rounds_model(torch.tensor(iou), torch.tensor(rank), thr, parts).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)
    assert (got >= 0).any()


@pytest.mark.parametrize("parts", MODEL_PARTS)
def test_cluster_round_model_on_the_staircase(parts, one_thread):
    """The staircase at (160, 80): one pair a round, 81 rounds, every live
    line stale in each, against the plain version and JAX's fixpoint."""
    iou, rank = chip_smoke.ladder_iou(160, 80, 0.25), np.arange(160, dtype=np.int32)
    want = np.asarray(jax_greedy_associate(jnp.asarray(iou), jnp.asarray(rank), 0.3, backend="cpu"))
    got = cluster_rounds_model(torch.tensor(iou), torch.tensor(rank), 0.3, parts).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _greedy_associate_plain(torch.tensor(iou), torch.tensor(rank), 0.3).numpy())
    np.testing.assert_array_equal(got, np.arange(160) * (np.arange(160) < 80) - (np.arange(160) >= 80))


# --- K3's general instance: the partitioned aggregates -----------------------

AGG_PARTS = (1, 2, 4, 8)
AGG_STREAMS = {"random": (chip_smoke.random_tagging_frame, 8), "crafted": (chip_smoke.crafted_tagging_frame, 14)}
_INF_BITS = 0x7F800000
_KEY_NONE = (_MASK32, _MASK32, _MASK32, _MASK32)  # the primary's key of no interaction
# tagging_step.cu `type_conf`: an interaction's confidence, one constant a
# type (tagging/rules.py's rule table); the types no rule gives have 0.
TYPE_CONF = {9: 0.9, 6: 0.8, 7: 0.6, 8: 0.7, 1: 0.75, 4: 0.7}
# The aggregate tags: the SF and SI entries and the per-type rows the slot
# records feed (everything else of the rows is a slot's own or the scene's
# and maneuver's).
AGG_TAGS = ("closest_agent_distance", "min_ttc", "primary_interaction", "overall_risk", "agent_count",
            "pedestrian_count", "cyclist_count", "vehicle_count", "has_min_ttc", "interaction_confidence",
            "interaction_present")


def _f32_bits(x) -> int:
    return int(np.float32(x).view(np.uint32))


def warp_record(tags: dict, table, min_hits: int, w0: int, T: int) -> dict:
    """tagging_step.cu `warp_record` over the slots [w0, w0 + 32) (those
    below T): each aggregate's part from the plain version's per-slot
    tags, with the kernel's keys: the type bits, and the primary
    interaction's key (3 - risk rank, confidence bits, id, slot) and its
    type.  Every typed slot's confidence must be its type's `TYPE_CONF`,
    which lets the kernel carry no per-type key."""
    sl = slice(w0, min(w0 + 32, T))
    conf = ((table.track_id[sl] > 0) & (table.hits[sl] >= min_hits)).tolist()
    cls, ids = table.class_id[sl].tolist(), table.track_id[sl].tolist()
    itype, irisk = tags["track_interaction_type"][sl].tolist(), tags["track_interaction_risk"][sl].tolist()
    iconf = tags["track_interaction_confidence"][sl].numpy()
    dist, ttc = tags["track_distance"][sl].numpy(), tags["track_ttc"][sl].numpy()
    httc = tags["track_has_ttc"][sl].tolist()
    rec = {"types": 0, "n_conf": 0, "peds": 0, "cycs": 0, "vehs": 0, "dmin": _INF_BITS, "tmin": _INF_BITS,
           "max_risk": 0, "primary": (*_KEY_NONE, -1)}
    for j, t in enumerate(range(sl.start, sl.stop)):
        if conf[j]:
            rec["n_conf"] += 1
            rec["peds"] += cls[j] == 2
            rec["cycs"] += cls[j] == 3
            rec["vehs"] += cls[j] in (0, 1, 4, 5)
            rec["dmin"] = min(rec["dmin"], _f32_bits(dist[j]))
            if httc[j]:
                rec["tmin"] = min(rec["tmin"], _f32_bits(ttc[j]))
        k = itype[j]
        if k < 0:
            continue
        assert iconf[j] == np.float32(TYPE_CONF[k]), (t, k, iconf[j])
        rec["types"] |= 1 << k
        rec["max_risk"] = max(rec["max_risk"], irisk[j])
        key = (3 - (2, 3, 1, 0)[irisk[j]], _f32_bits(iconf[j]), ids[j], t)
        rec["primary"] = min(rec["primary"], (*key, k))
    return rec


def combine_records(a: dict, b: dict) -> dict:
    """Two records as one, with the keys of tagging_step.cu
    `combine_records`: the type bits' union, sums, minima and maxima, the
    primary's lowest key."""
    return {"types": a["types"] | b["types"], "n_conf": a["n_conf"] + b["n_conf"],
            "peds": a["peds"] + b["peds"], "cycs": a["cycs"] + b["cycs"], "vehs": a["vehs"] + b["vehs"],
            "dmin": min(a["dmin"], b["dmin"]), "tmin": min(a["tmin"], b["tmin"]),
            "max_risk": max(a["max_risk"], b["max_risk"]),
            "primary": min(a["primary"], b["primary"], key=lambda p: p[:4])}


def cluster_aggregates_model(tags: dict, table, min_hits: int, ttc_critical: float, T: int, parts: int,
                             order) -> dict:
    """K3's general instance's aggregates in plain Python: the slots split
    over ``parts`` blocks as `tag_plan` splits them (32 ceil(ceil(T / 32) /
    parts) slots a block), each warp's 32 slots reduced to a record, each
    block's records combined into a block record, then the block records
    combined, both levels in the order ``order(n)`` gives (a permutation
    of range(n)).  Returns the aggregate tags, as the kernel writes them."""
    per = 32 * -(-(-(-T // 32)) // parts)
    blocks = []
    for r in range(parts):
        recs = [warp_record(tags, table, min_hits, w0, T) for w0 in range(r * per, min((r + 1) * per, T), 32)]
        if recs:
            idx = order(len(recs))
            block = recs[idx[0]]
            for i in idx[1:]:
                block = combine_records(block, recs[i])
            blocks.append(block)
    idx = order(len(blocks))
    rec = blocks[idx[0]]
    for i in idx[1:]:
        rec = combine_records(rec, blocks[i])
    return _aggregate_tags(rec, ttc_critical)


def _aggregate_tags(rec: dict, ttc_critical: float) -> dict:
    """The aggregate tags of the combined record, as the kernel writes them."""
    any_int = rec["primary"][0] != _MASK32
    tmin = np.uint32(rec["tmin"]).view(np.float32)
    critical = rec["tmin"] < _INF_BITS and tmin < np.float32(ttc_critical)
    return {
        "closest_agent_distance": np.uint32(rec["dmin"] if rec["dmin"] < _INF_BITS else 0).view(np.float32),
        "min_ttc": tmin if rec["tmin"] < _INF_BITS else np.float32(0),
        "primary_interaction": rec["primary"][4] if any_int else -1,
        "overall_risk": (3 if critical else rec["max_risk"]) if any_int else 0,
        "agent_count": rec["n_conf"], "pedestrian_count": rec["peds"], "cyclist_count": rec["cycs"],
        "vehicle_count": rec["vehs"], "has_min_ttc": rec["tmin"] < _INF_BITS,
        "interaction_confidence": np.array([np.float32(TYPE_CONF.get(k, 0.0) if rec["types"] >> k & 1 else 0.0)
                                            for k in range(tagging_kernel.NUM_INTERACTIONS)]),
        "interaction_present": np.array([bool(rec["types"] >> k & 1) and TYPE_CONF.get(k, 0.0) > 0.5
                                         for k in range(tagging_kernel.NUM_INTERACTIONS)]),
    }


def _jax_frame(dets, table, vrow, lane, feats):
    """A tagging frame of `chip_smoke`'s streams (CPU tensors) as the JAX
    package's inputs."""
    from multimodal_autonomous_driving_perception_and_planning_tpu import types as tj

    def j(x):
        return jnp.asarray(x.numpy())

    vs = tj.VehicleState(**{f: j(vrow[i]) for i, f in enumerate(chip_smoke.VEHICLE_STATE_FIELDS)})
    return (tj.Detections(**{f.name: j(getattr(dets, f.name)) for f in dataclasses.fields(dets)}),
            tj.TrackTable(**{f.name: j(getattr(table, f.name)) for f in dataclasses.fields(table)}),
            None, None, vs,
            None if lane is None else tj.LaneObservation(**{f.name: j(getattr(lane, f.name))
                                                            for f in dataclasses.fields(lane)}),
            None if feats is None else {k: j(v) for k, v in feats.items()})


@functools.lru_cache(maxsize=None)
def _aggregate_stream(t: int, d: int, stream: str, frames_mode: bool) -> tuple:
    """A stream of `AGG_STREAMS` at (t, d) through the plain version and
    the JAX package's tagging step (XLA rules), each threading its own
    state: per frame the table, the plain version's tags and JAX's."""
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.rules import (
        TaggingRules,
        make_packed_tagging_step,
        unpack_tags,
    )
    from multimodal_autonomous_driving_perception_and_planning_torch.types import TaggingState
    from multimodal_autonomous_driving_perception_and_planning_tpu import types as tj
    from multimodal_autonomous_driving_perception_and_planning_tpu.tagging.rules import make_tagging_step

    cfg_t = _config(pt, t, d).replace(use_frames=frames_mode)
    cfg_j = _config(pj, t, d).replace(use_frames=frames_mode)
    rules = TaggingRules.from_config(cfg_t)
    step_t = make_packed_tagging_step(cfg_t)
    step_j = jax.jit(make_tagging_step(cfg_j, backend="cpu"))
    state_t = TaggingState.initial(rules.window, rules.history, t, "cpu", interaction_history=rules.interaction_history)
    state_j = tj.TaggingState.initial(rules.window, rules.history, t)
    frame_fn, n = AGG_STREAMS[stream]
    rng = np.random.default_rng(t + 17 * d + frames_mode)
    out = []
    for f in range(n):
        dets, table, vrow = frame_fn(rng, f, t, d, "cpu")
        lane, feats = chip_smoke.random_lane_feats(rng, "cpu") if frames_mode else (None, None)
        state_t, tag_f, tag_i = step_t(state_t, dets, table, vrow, lane, feats)
        state_j, tags_j = step_j(state_j, *_jax_frame(dets, table, vrow, lane, feats))
        out.append((table, unpack_tags(tag_f, tag_i, t), {k: np.asarray(tags_j[k]) for k in AGG_TAGS},
                    chip_smoke.aggregate_corners(unpack_tags(tag_f, tag_i, t), table, state_t.int_len,
                                                 rules.interaction_history)))
    return rules, out


def _same_bits(got, want, where: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, where
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(got.astype(np.float32).view(np.uint32), want.astype(np.float32).view(np.uint32),
                                      err_msg=where)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=where)


@pytest.mark.parametrize("parts", AGG_PARTS)
@pytest.mark.parametrize("frames_mode", [False, True], ids=["detections", "frames"])
@pytest.mark.parametrize("stream", sorted(AGG_STREAMS))
@pytest.mark.parametrize("shape", chip_smoke.LARGE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_partitioned_aggregates_model_matches_plain_and_jax(shape, stream, frames_mode, parts, one_thread):
    """K3's general instance's aggregates (tagging_step.cu `warp_record`,
    `combine_records`) in plain Python, the slots split over ``parts``
    blocks and the records combined forward, reversed and shuffled at both
    levels: every aggregate tag bit for bit the plain version's and the JAX
    package's, on random streams and on the crafted stream (every
    aggregate corner, which it must reach), in both modes."""
    t, d = shape
    rules, frames = _aggregate_stream(t, d, stream, frames_mode)
    ttc_critical = float(rules.params[list(tagging_kernel.PARAM_NAMES).index("ttc_critical")])
    shuffle = np.random.default_rng(parts)
    orders = {"forward": lambda n: list(range(n)), "reversed": lambda n: list(range(n))[::-1],
              "shuffled": lambda n: shuffle.permutation(n).tolist()}
    corners = dict.fromkeys(("all_types", "primary_tie", "equal_min_ttc", "ring_wrap"), 0)
    for f, (table, tags, tags_j, reached) in enumerate(frames):
        for name, order in orders.items():
            got = cluster_aggregates_model(tags, table, rules.min_hits, ttc_critical, t, parts, order)
            for k in AGG_TAGS:
                _same_bits(got[k], tags[k].numpy(), f"frame {f} {name}: {k} against the plain version")
                _same_bits(got[k], tags_j[k], f"frame {f} {name}: {k} against JAX")
        corners = {k: n + reached[k] for k, n in corners.items()}
    if stream == "crafted":
        assert corners["all_types"] and corners["primary_tie"] and corners["equal_min_ttc"], corners


def test_type_conf_is_the_kernels_table():
    """`TYPE_CONF`, the model's per-type confidences, is tagging_step.cu's
    `type_conf` read from the kernel's source: every type a rule gives,
    its constant, and no other type."""
    import re

    src = (Path(tagging_kernel.__file__).parent.parent / "kernels" / "csrc" / "tagging_step.cu").read_text()
    enum = re.search(r"enum \{ (kFollowing = 1[^}]*)\}", src).group(1)
    codes = {name: int(v) for name, v in re.findall(r"(k\w+) = (\d+)", enum)}
    body = re.search(r"constexpr float type_conf\(int k\) \{(.*?)\n\}", src, re.S).group(1)
    table = {codes[name]: float(np.float32(v)) for name, v in re.findall(r"k == (k\w+) \? ([0-9.]+)f", body)}
    assert table == {k: float(np.float32(v)) for k, v in TYPE_CONF.items()}
    assert all(v > 0.5 for v in TYPE_CONF.values())  # so a type present is a type some slot has


# --- beyond 1,024 lines: the wide partitions, modelled card-free -------------

# (T, D) either side of the 16-block partition's edges: a block owns 96
# rows at T = 1,025 (the last block one), 128 at 1,537 (13 blocks' worth),
# 256 at 4,096 (every block full); D = 513 gives blocks of 64 columns.
WIDE_MODEL_SHAPES = ((1025, 513), (1537, 64), (4096, 160))
WIDE_MODEL_CASES = ("random", "tied_ranks", "key_corners_thr0.3")
CLUSTER_THREADS = 1024  # association.cuh kAssocClusterThreads: the rows a pass of the accept


@functools.lru_cache(maxsize=None)
def _wide_model_case(t: int, d: int, kind: str) -> tuple:
    """A matrix of ``kind`` at (t, d), seeded by the three, with JAX's XLA
    fixpoint and the plain version's matches."""
    rng = np.random.default_rng(t * 7 + d + WIDE_MODEL_CASES.index(kind))
    iou, rank = {"random": lambda: chip_smoke.random_association(rng, t, d),
                 "tied_ranks": lambda: chip_smoke.random_association(rng, t, d, tied=True),
                 "key_corners_thr0.3": lambda: chip_smoke.key_corner_association(rng, t, d, 0.3)}[kind]()
    return (iou, rank, 0.3, np.asarray(jax_greedy_associate(jnp.asarray(iou), jnp.asarray(rank), 0.3, backend="cpu")),
            _greedy_associate_plain(torch.tensor(iou), torch.tensor(rank), 0.3).numpy())


@pytest.mark.parametrize("kind", WIDE_MODEL_CASES)
@pytest.mark.parametrize("shape", WIDE_MODEL_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_wide_cluster_round_model_matches_plain_and_jax(shape, kind, one_thread):
    """The cluster schedule at 16 blocks of more than 64 lines each, its
    accept in passes of 1,024 rows (a thread a row each pass, as
    association.cuh `cluster_associate` decides beyond 1,024 rows), bit
    for bit the plain version and JAX's fixpoint on random, tied-rank and
    key-order-corner matrices (ranks whose rank * D + column wraps in
    int32).  A copy of the model whose accept runs only its first pass
    (rows 0-1,023, the one-pass accept of the 1,024-line kernel) fails 7
    of the 10 cases of this test and the next: every one at 1,537 and
    4,096 slots and one at 1,025."""
    t, d = shape
    assert max(r1 - r0 for r0, r1 in _split(t, 16)) > 64
    iou, rank, thr, want, plain = _wide_model_case(t, d, kind)
    got = cluster_rounds_model(torch.tensor(iou), torch.tensor(rank), thr, 16, threads=CLUSTER_THREADS).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)
    assert (got >= 0).any() and (t < 1100 or (got[CLUSTER_THREADS:] >= 0).any())


def test_wide_cluster_round_model_on_the_staircase(one_thread):
    """The staircase at (1,100, 40), one pair a round, every live line
    stale each round, over 16 blocks of 96 rows and passes of 1,024 rows:
    the plain version's and JAX's matches."""
    iou, rank = chip_smoke.ladder_iou(1100, 40, 0.25), np.arange(1100, dtype=np.int32)
    want = np.asarray(jax_greedy_associate(jnp.asarray(iou), jnp.asarray(rank), 0.3, backend="cpu"))
    got = cluster_rounds_model(torch.tensor(iou), torch.tensor(rank), 0.3, 16, threads=CLUSTER_THREADS).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _greedy_associate_plain(torch.tensor(iou), torch.tensor(rank), 0.3).numpy())
    np.testing.assert_array_equal(got, np.arange(1100) * (np.arange(1100) < 40) - (np.arange(1100) >= 40))


def tag_plan(T: int) -> tuple[int, int]:
    """tagging_step.cu `tag_plan`: (blocks, slots a block), blocks of at
    most 128 slots up to 1,024 slots and of 256 beyond, the warps split
    evenly."""
    warps = -(-T // 32)
    per = (256 if T > 1024 else 128) // 32
    c = -(-warps // per)
    return c, 32 * -(-warps // c)


def wide_aggregates_model(tags: dict, table, min_hits: int, ttc_critical: float, T: int, order) -> dict:
    """K3's general instance beyond 32 warp records in plain Python: every
    slot warp of every block of `tag_plan` makes its record (records in
    block-major order, a warp past T the empty record), block 0's combine
    warp folds records l, l + 32, ... into lane l's in turn, and the lanes'
    records combine in the order ``order(n)`` gives.  Returns the aggregate
    tags as `cluster_aggregates_model` does."""
    blocks, rows = tag_plan(T)
    recs = [warp_record(tags, table, min_hits, r * rows + w0, T) for r in range(blocks) for w0 in range(0, rows, 32)]
    lanes = []
    for lane in range(min(32, len(recs))):
        rec = recs[lane]
        for k in range(lane + 32, len(recs), 32):
            rec = combine_records(rec, recs[k])
        lanes.append(rec)
    idx = order(len(lanes))
    return _aggregate_tags(functools.reduce(combine_records, [lanes[i] for i in idx]), ttc_critical)


@pytest.mark.parametrize("frames_mode", [False, True], ids=["detections", "frames"])
@pytest.mark.parametrize("stream", sorted(AGG_STREAMS))
def test_wide_plan_aggregates_match_plain_and_jax(stream, frames_mode, one_thread):
    """K3's 16-block plan of 256 slots a block at T = 4,096 (128 warp
    records, four a lane of the combine warp): every aggregate tag bit for
    bit the plain version's and the JAX package's, the lanes' records
    combined forward, reversed and shuffled, on the random and the crafted
    streams, in both modes.  A copy whose combine warp takes one record a
    lane (the first 32, as the 1,024-slot kernel did) fails all four."""
    t, d = 4096, 80
    assert tag_plan(t) == (16, 256) and tag_plan(1024) == (8, 128) and tag_plan(1025) == (5, 224)
    rules, frames = _aggregate_stream(t, d, stream, frames_mode)
    ttc_critical = float(rules.params[list(tagging_kernel.PARAM_NAMES).index("ttc_critical")])
    shuffle = np.random.default_rng(t)
    orders = {"forward": lambda n: list(range(n)), "reversed": lambda n: list(range(n))[::-1],
              "shuffled": lambda n: shuffle.permutation(n).tolist()}
    for f, (table, tags, tags_j, _) in enumerate(frames):
        for name, order in orders.items():
            got = wide_aggregates_model(tags, table, rules.min_hits, ttc_critical, t, order)
            for k in AGG_TAGS:
                _same_bits(got[k], tags[k].numpy(), f"frame {f} {name}: {k} against the plain version")
                _same_bits(got[k], tags_j[k], f"frame {f} {name}: {k} against JAX")


# --- K5's large instance: the mask and the scan, modelled card-free ----------

NMS_MODEL_CASES = ("three_level_next_word", "early_box_every_word", "iou_at_threshold", "iou_above_threshold",
                   "near_threshold_0.45", "thr_zero_touching", "thr_negative", "thr_above_one", "class_offset_79",
                   "degenerate_boxes_thr0", "nan_inf_coords", "dead_between_live", "K255_B3")


def mask_and_scan_model(boxes: torch.Tensor, scores: torch.Tensor, thr: float) -> torch.Tensor:
    """nms_keep.cu's large instance in plain torch and numpy, image by
    image: the mask, word w of row i bit k set where iou(i, 32 w + k) >
    thr and 32 w + k > i (the port's contracted `pairwise_iou`), and `nz`,
    the rows with a bit in a word past their own; then the scan, a word at
    a time: the word's candidates (not removed: dead ones and those past K
    start removed), their own suppressions solved by the fixpoint keep =
    cand & ~OR_{b kept} diag_b, and every kept row with a later bit ORed
    into the later words."""
    B, K = scores.shape
    W = -(-K // 32)
    keep = np.zeros((B, K), bool)
    idx = torch.arange(K)
    for b in range(B):
        S = (pairwise_iou(boxes[b], boxes[b]) > thr) & (idx[None, :] > idx[:, None])
        bits = np.zeros((32 * W, 32 * W), bool)
        bits[:K, :K] = S.numpy()
        mask = np.packbits(bits.reshape(32 * W, W, 32), axis=-1, bitorder="little").view("<u4")[..., 0]
        later = np.array([mask[i, i // 32 + 1:].any() for i in range(32 * W)])
        nz = np.packbits(later.reshape(W, 32), axis=-1, bitorder="little").view("<u4")[:, 0]
        alive = np.zeros(32 * W, bool)
        alive[:K] = (scores[b] > 0).numpy()
        removed = ~np.packbits(alive.reshape(W, 32), axis=-1, bitorder="little").view("<u4")[:, 0]
        for w in range(W):
            cand = int(~removed[w] & 0xFFFFFFFF)
            diag = [int(v) for v in mask[32 * w:32 * w + 32, w]]
            kept = cand
            while True:
                hit = 0
                for lane in range(32):
                    if kept >> lane & 1:
                        hit |= diag[lane]
                nxt = cand & ~hit
                if nxt == kept:
                    break
                kept = nxt
            keep[b, 32 * w:min(32 * w + 32, K)] = [(kept >> lane) & 1 for lane in range(min(32, K - 32 * w))]
            for lane in range(32):
                if (kept & int(nz[w])) >> lane & 1:
                    removed[w + 1:] |= mask[32 * w + lane, w + 1:]
    return torch.from_numpy(keep)


@functools.lru_cache(maxsize=None)
def _jax_keep(thr):
    from multimodal_autonomous_driving_perception_and_planning_tpu.ops.nms import nms_keep_xla

    return jax.jit(jax.vmap(lambda b, s: nms_keep_xla(b, s, thr)))


@pytest.mark.parametrize("k", (1100, 2500))
@pytest.mark.parametrize("name", NMS_MODEL_CASES)
def test_mask_and_scan_model_matches_plain_and_jax(name, k, one_thread):
    """K5's large instance, modelled (`mask_and_scan_model`), on
    `chip_smoke.nms_cases`' corners scaled past 1,024 candidates
    (`chip_smoke.scale_nms_case`: each pool tiled to K, every copy a twin
    of the first, so kept boxes suppress their twins across many words):
    bit for bit the plain fixpoint and JAX's XLA fixpoint, jitted.  A copy
    of the model whose scan keeps every candidate of a word (no in-word
    fixpoint) fails 20 of these 26 cases; one that ORs a kept row into the
    next word only fails 24."""
    case = chip_smoke.nms_cases()[name]
    case = chip_smoke.scale_nms_case(case, case.scores.shape[0], k)
    boxes, scores = torch.tensor(case.boxes), torch.tensor(case.scores)
    got = mask_and_scan_model(boxes, scores, case.thr)
    plain = _nms_keep_plain(boxes, scores, case.thr)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax_keep(case.thr)(jnp.asarray(case.boxes),
                                                                              jnp.asarray(case.scores))))
