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
                         threads: int | None = None, staged: tuple | None = None) -> torch.Tensor:
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
    default), and the loop ends at the first round that accepts nothing.
    With ``staged`` (row bests, column bests, column rows, row and column
    chunk masks, as bool (T, ceil(D / 32)) and (D, ceil(T / 32))), the
    first round takes those bests as they are, and a recomputed best reads
    only the chunks its line's mask marks, as the masked rounds do."""
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
    row_entry = col_entry = entry
    if staged is not None:
        rowbest, colbest, colrow = (torch.as_tensor(np.asarray(x, np.int64)).clone() for x in staged[:3])
        rmask, cmask = (torch.as_tensor(np.asarray(m, bool)) for m in staged[3:])
        row_entry = torch.where(rmask[:, torch.arange(D) // 32], entry, 0)
        col_entry = torch.where(cmask[:, torch.arange(T) // 32].T, entry, 0)

    def column_of(best, b):  # the column of a row's best key
        return ((~best & _MASK32) - b) & _MASK32

    first = staged is None  # the first round's bests are to compute
    while True:
        for (r0, r1), (c0, c1) in zip(rows, cols):
            rb, cb = rowbest[r0:r1], colbest[c0:c1]
            stale = ~matched[r0:r1] & (rb != 0)
            stale &= taken[column_of(rb, base[r0:r1]).clamp(max=D - 1)]
            stale |= first
            if stale.any():
                live = torch.where(taken[None, :], 0, row_entry[r0:r1][stale])
                rowbest[r0:r1][stale] = live.amax(dim=1)
            stale = ~taken[c0:c1] & (cb != 0) & matched[colrow[c0:c1]]
            stale |= first
            if stale.any():
                live = torch.where(matched[:, None], 0, col_entry[:, c0:c1][:, stale])
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


# --- K1's wide instance: the ranks by counting ---------------------------------

I32_MAX = 2**31 - 1
_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)
RANK_SIZES = (1025, 2048, 4096)
RANK_CASES = ("random_ties", "dead_slots", "all_equal")
WIDE_PARTS = 16  # association.cuh `assoc_plan`'s cluster beyond 1,024 slots


def sort_pairs_model(values: np.ndarray) -> np.ndarray:
    """tracker_step.cu `sort_pairs` step for step: the bitonic network over
    n uint64 values, a value a thread (n a power of two from 32 to 1,024);
    each step every thread i keeps the smaller or the larger of its value
    and thread i ^ j's, the run of k sorted up where i & k is 0.  Steps of j
    under 32 are the kernel's shuffles, the others its shared-memory steps:
    every k up to 32 by shuffles, then for each k from 64 the steps of j
    from k / 2 down to 32 through shared memory and j = 16 .. 1 by
    shuffles."""
    v = values.copy()
    n = v.shape[0]
    i = np.arange(n)

    def step(j, k):
        o = v[i ^ j]
        up = ((i & j) == 0) == ((i & k) == 0)
        v[:] = np.where(up, np.minimum(v, o), np.maximum(v, o))

    for k in (2, 4, 8, 16, 32):
        j = k >> 1
        while j > 0:
            step(j, k)
            j >>= 1
    k = 64
    while k <= n:
        j = k >> 1
        while j >= 32:
            step(j, k)
            j >>= 1
        for j in (16, 8, 4, 2, 1):
            step(j, k)
        k <<= 1
    return v


def rank_pairs(keys: np.ndarray) -> np.ndarray:
    """tracker_step.cu `rank_pair` of every slot: its key's bits with the
    sign flipped (signed order as unsigned) above the slot."""
    flipped = (keys.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000
    return (flipped.astype(np.uint64) << np.uint64(32)) | np.arange(keys.shape[0], dtype=np.uint64)


def _sort_size(n: int) -> int:
    p = 32
    while p < n:
        p <<= 1
    return p


def lower_count_model(lists: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The binary search of tracker_step.cu `cluster_places` over each row
    of ``lists`` (sorted) for its value in ``x``: the entries below it,
    step by step from the largest power of two within the list's length."""
    n = lists.shape[1]
    pos = np.zeros(lists.shape[0], np.int64)
    step = 1 << (n.bit_length() - 1)
    rows = np.arange(lists.shape[0])
    while step > 0:
        at = np.minimum(pos + step - 1, n - 1)
        pos += np.where((pos + step <= n) & (lists[rows, at] < x), step, 0)
        step >>= 1
    return pos


def cluster_places_model(keys: np.ndarray) -> np.ndarray:
    """tracker_step.cu `cluster_places` over `WIDE_PARTS` blocks of the
    association's partition: each block sorts its slots' pairs (padded with
    ~0 to `sort_size`) by `sort_pairs_model` and keeps the first ``rows``
    as its list; the place of its s-th pair is s plus, for every other
    block, the pairs below it in that block's list (`lower_count_model`).
    Returns each slot's place."""
    T = keys.shape[0]
    rows = _split(T, WIDE_PARTS)
    per = rows[0][1] - rows[0][0]
    pairs = rank_pairs(keys)
    lists = np.full((WIDE_PARTS, per), _U64, np.uint64)
    for b, (r0, r1) in enumerate(rows):
        v = np.full(_sort_size(per), _U64, np.uint64)
        v[:r1 - r0] = pairs[r0:r1]
        lists[b] = sort_pairs_model(v)[:per]
    place = np.full(T, -1, np.int64)
    for b in range(WIDE_PARTS):
        live = lists[b] != _U64
        x = lists[b][live]
        total = np.flatnonzero(live).astype(np.int64)
        for o in range(WIDE_PARTS):
            if o != b:
                total += lower_count_model(np.broadcast_to(lists[o], (x.shape[0], per)), x)
        place[(x & np.uint64(0xFFFFFFFF)).astype(np.int64)] = total
    return place


def rank_kernel_model(keys: np.ndarray) -> np.ndarray:
    """tracker_step.cu `tracker_rank_kernel`'s count: the keys padded with
    I32_MAX to a multiple of 4, each slot's rank the keys below it and the
    equal keys at lower slots."""
    T = keys.shape[0]
    padded = np.full(-(-T // 4) * 4, I32_MAX, np.int64)
    padded[:T] = keys
    j = np.arange(padded.shape[0])
    kt = keys.astype(np.int64)[:, None]
    return ((padded[None, :] < kt) | ((padded[None, :] == kt) & (j[None, :] < np.arange(T)[:, None]))).sum(axis=1)


def _rank_keys(T: int, case: str) -> np.ndarray:
    """Ranked keys as the kernel ranks them: an id where the slot is live
    (confirmed), else I32_MAX."""
    rng = np.random.default_rng(T + RANK_CASES.index(case))
    if case == "random_ties":
        ids = rng.integers(-3, T // 8, T)  # about an eighth of the values each, some dead
    elif case == "dead_slots":
        ids = np.where(rng.random(T) < 0.5, rng.integers(1, 2**31 - 1, T), rng.integers(-5, 1, T))
    else:
        ids = np.full(T, 7)
    return np.where(ids > 0, ids, I32_MAX).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _jax_rank():
    from multimodal_autonomous_driving_perception_and_planning_tpu.tracking.tracker import _rank_by_count

    return jax.jit(_rank_by_count)


@pytest.mark.parametrize("case", RANK_CASES)
@pytest.mark.parametrize("T", RANK_SIZES)
def test_wide_ranks_by_counting_match_plain_and_jax(T, case, one_thread):
    """K1's ranks beyond 1,024 slots, modelled: the rank kernel's count
    (`rank_kernel_model`) and the cluster's placement (`cluster_places_model`:
    16 blocks' `sort_pairs` networks, then binary searches in the other
    blocks' lists) both equal a stable argsort of (key, slot), the port's
    `_rank_by_count` and JAX's, jitted, on tied keys, I32_MAX dead slots
    and all-equal keys at 1,025, 2,048 and 4,096 slots.  A copy whose
    `sort_pairs_model` drops the last merge's shuffle stage (j = 16 .. 1 at
    k = n) fails all 9 of these cases and all 6 sort-network cases
    below."""
    from multimodal_autonomous_driving_perception_and_planning_torch.tracking.tracker import _rank_by_count

    keys = _rank_keys(T, case)
    want = np.empty(T, np.int64)
    want[np.argsort(keys, kind="stable")] = np.arange(T)
    np.testing.assert_array_equal(cluster_places_model(keys), want)
    np.testing.assert_array_equal(rank_kernel_model(keys), want)
    k32 = keys.astype(np.int32)
    np.testing.assert_array_equal(_rank_by_count(torch.tensor(k32)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(_jax_rank()(jnp.asarray(k32))), want)


@pytest.mark.parametrize("n", (32, 64, 128, 256, 512, 1024))
def test_sort_pairs_network_sorts(n):
    """`sort_pairs_model` sorts n pairs of tied keys, dead slots and ~0
    padding, as `np.sort` does."""
    rng = np.random.default_rng(n)
    keys = np.where(rng.random(n) < 0.3, I32_MAX, rng.integers(0, n // 4 + 1, n))
    v = rank_pairs(keys)
    v[rng.random(n) < 0.1] = _U64
    np.testing.assert_array_equal(sort_pairs_model(v), np.sort(v))


# --- K5's large instance: the mask's layout and decision, the tiled scan -------

TILE_WORDS = 8  # nms_keep.cu kTileWords
CHUNK_WORDS = 64  # nms_keep.cu kChunkWords
LAYOUT_K = (1025, 1056, 1100, 2500, 4097, 8400, 33_600)


def ceil_sum(n, m: int):
    """nms_keep.cu `ceil_sum`: sum_{u = 1 .. n} ceil(u / m), m even."""
    q, r = n // m, n % m
    return (q + 1) * (m // 2 * q + r)


def row_base_model(i, W: int):
    """nms_keep.cu `row_base`: row i's segment of its image's mask, the
    groups' segments of 8 ceil((W - g) / 8) words side by side."""
    g = i >> 5
    return 256 * (ceil_sum(W, 8) - ceil_sum(W - g, 8)) + (i & 31) * 8 * ((W - g + 7) >> 3)


@pytest.mark.parametrize("K", LAYOUT_K)
def test_large_nms_mask_layout(K):
    """The large instance's packed mask: every row's segment (its words from
    its own on, padded to a sector) starts on a 32-byte sector, the
    segments of an image follow one another without overlap, an image fits
    in the K W words a image of the wrapper's workspace takes (rounded
    down to a sector), and the mask kernel's grid (`tri_group`) takes each
    (row group, 64-word chunk) of the upper triangle exactly once."""
    W = -(-K // 32)
    rows = np.arange(32 * W)
    base = row_base_model(rows, W)
    seg = 8 * ((W - (rows >> 5) + 7) >> 3)
    assert (base % 8 == 0).all() and base[0] == 0
    np.testing.assert_array_equal(base[1:], base[:-1] + seg[:-1])
    image = 256 * ceil_sum(W, 8)
    assert base[-1] + seg[-1] == image <= (K * W) & ~7
    assert nms_kernel.workspace_words(1, K)[0] == K * W
    total = ceil_sum(W, CHUNK_WORDS)
    before = total - ceil_sum(W - np.arange(W), CHUNK_WORDS)  # blocks before group g
    L = np.arange(total)
    g = np.searchsorted(before, L, side="right") - 1  # the kernel's binary search: the last g with before <= L
    chunk = L - before[g]
    got = set(zip(g.tolist(), chunk.tolist()))
    want = {(gg, c) for gg in range(W) for c in range(-(-(W - gg) // CHUNK_WORDS))}
    assert got == want and len(got) == total


def mask_decision_model(boxes: torch.Tensor, thr: float) -> torch.Tensor:
    """nms_keep.cu's large mask kernel's decision of iou(i, j) > thr for
    every pair of one image's (K, 4) boxes: with the threshold in [2^-20,
    2^20] and both areas in [2^-38, 2^38], inter > union hi (above) or
    inter < union lo (below), hi and lo thr (1 +- 2^-19) and the
    intersection max(iw, 0) max(ih, 0); the pairs between the two, or
    outside those ranges, by the exact `pairwise_iou` (0 where the boxes
    do not overlap)."""
    f32 = torch.float32
    a, b = boxes[:, None, :], boxes[None, :, :]
    iw = torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])
    ih = torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])
    wh = boxes[:, 2:] - boxes[:, :2]
    area = wh[:, 0] * wh[:, 1]
    ok = (area >= 2.0**-38) & (area <= 2.0**38)
    t = torch.tensor(thr, dtype=f32)
    hi, lo = t * torch.tensor(1 + 2.0**-19, dtype=f32), t * torch.tensor(1 - 2.0**-19, dtype=f32)
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
    from multimodal_autonomous_driving_perception_and_planning_torch.ops.geometry import fma32

    uni = fma32(*torch.broadcast_tensors(wh[None, :, 0], wh[None, :, 1], area[:, None])) - inter
    above, below = inter > uni * hi, inter < uni * lo
    fast = (2.0**-20 <= thr <= 2.0**20) & ok[:, None] & ok[None, :] & (above | below)
    overlap = (iw > 0) & (ih > 0)
    exact = torch.where(overlap, pairwise_iou(boxes, boxes) > thr, torch.tensor(0.0 > thr))
    return torch.where(fast, above, exact)


def tiled_scan_model(S: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """nms_keep.cu's scan over one image's suppression bits S[i, j] (i < j),
    tile by tile of TILE_WORDS words: warp 0 solves the tile's words from
    its diagonal block alone, each word's candidates (not removed) all kept
    where none suppresses another, else kept in score order, a kept one at
    a time removing those it suppresses (the fixpoint keep = cand &
    ~OR_{b kept} diag_b, solved greedily), then ORs the kept rows' later
    words inside the tile into their removed bits; then the tile's
    kept rows with a later bit (`nz`) are ORed into every word past the
    tile.  Returns the keep bits."""
    K = S.shape[0]
    W = -(-K // 32)
    bits = np.zeros((32 * W, 32 * W), bool)
    bits[:K, :K] = np.triu(S, 1)
    mask = np.packbits(bits.reshape(32 * W, W, 32), axis=-1, bitorder="little").view("<u4")[..., 0].astype(np.int64)
    own = np.arange(32 * W) // 32
    nz = np.array([mask[i, own[i] + 1:].any() for i in range(32 * W)])
    live = np.zeros(32 * W, bool)
    live[:K] = alive
    removed = (~np.packbits(live.reshape(W, 32), axis=-1, bitorder="little").view("<u4")[:, 0]).astype(np.int64)
    removed &= 0xFFFFFFFF
    keep = np.zeros(32 * W, bool)
    for t in range(-(-W // TILE_WORDS)):
        words = range(TILE_WORDS * t, min(TILE_WORDS * (t + 1), W))
        rem = {w: int(removed[w]) for w in words}
        listed = []
        for w in words:
            cand = ~rem[w] & 0xFFFFFFFF
            diag = [int(x) for x in mask[32 * w:32 * w + 32, w]]
            kept = cand
            if any(cand >> b & 1 and diag[b] & cand for b in range(32)):
                kept, left = 0, cand
                while left:
                    b = (left & -left).bit_length() - 1
                    kept |= 1 << b
                    left &= ~(diag[b] | 1 << b)
            rows = [32 * w + lane for lane in range(32) if kept >> lane & 1]
            keep[rows] = True
            for v in words:
                if v > w:
                    for r in rows:
                        rem[v] |= int(mask[r, v])
            listed += [r for r in rows if nz[r]]
        past = TILE_WORDS * (t + 1)
        for r in listed:
            removed[past:] |= mask[r, past:]
    return keep[:K]


def _tile_chain(k: int) -> "chip_smoke.NmsCase":
    """A chain of 40 boxes 5 apart (each suppresses only the next) at
    candidates 236 .. 275, across word 8, the first tile's end, the others
    disjoint: every other link kept, the chain's suppression carried from
    one tile into the next."""
    boxes = chip_smoke._far_boxes(k)
    x = np.arange(40) * 5.0
    boxes[236:276] = np.stack([x, np.zeros(40), x + 10.0, np.full(40, 10.0)], 1)
    return chip_smoke.NmsCase(boxes[None], chip_smoke._descending(k)[None], 0.3)


@pytest.mark.parametrize("k", (1100, 2500))
@pytest.mark.parametrize("name", NMS_MODEL_CASES + ("tile_chain",))
def test_tiled_scan_model_matches_plain_and_jax(name, k, one_thread):
    """K5's large instance, modelled: the mask kernel's division-free
    decision (`mask_decision_model`) and the tiled scan
    (`tiled_scan_model`) on `chip_smoke.nms_cases`' corners scaled past
    1,024 candidates and on a chain across the first tile's end: bit for
    bit the plain fixpoint and JAX's XLA fixpoint, jitted.  A copy of the
    scan that ORs a tile's rows into the later words before the tile's own
    fixpoint (its candidates, not its kept rows) fails 8 of these 28 cases
    (the tile chain, dead entries between live ones, degenerate boxes at
    threshold 0, NaN and inf coordinates, at both sizes)."""
    if name == "tile_chain":
        case = _tile_chain(k)
    else:
        case = chip_smoke.nms_cases()[name]
        case = chip_smoke.scale_nms_case(case, case.scores.shape[0], k)
    boxes, scores = torch.tensor(case.boxes), torch.tensor(case.scores)
    got = np.stack([tiled_scan_model(mask_decision_model(boxes[b], case.thr).numpy(), (scores[b] > 0).numpy())
                    for b in range(boxes.shape[0])])
    np.testing.assert_array_equal(got, _nms_keep_plain(boxes, scores, case.thr).numpy())
    np.testing.assert_array_equal(got, np.asarray(_jax_keep(case.thr)(jnp.asarray(case.boxes),
                                                                      jnp.asarray(case.scores))))


# --- K1's wide instance: the key lines staged over the card -------------------

STAGE_SHAPES = ((1025, 64), (1024, 1024), (2048, 300), (4096, 160))
STAGE_TILES = ((128, 64), (32, 64))  # tracker_step.cu `launch_stage`: a stage block's tile, large and small tables


def assoc_keys(iou: torch.Tensor, thr: float) -> np.ndarray:
    """association.cuh `assoc_key`: the IoU's bits with the sign cleared,
    plus one, where iou >= thr and iou >= 0; else 0 (int64)."""
    bits = iou.view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    return torch.where((iou >= thr) & (iou >= 0), bits + 1, 0).numpy()


def _stage_inputs(t: int, d: int, thr: float):
    """`random_dets` boxes for a table of t slots (ids with ties, about a
    third dead) and d detections, and the keys of every pair: 0 where the
    slot is dead or the detection invalid."""
    rng = np.random.default_rng(t * 3 + d)
    slots = chip_smoke.random_dets(rng, t, "cpu", p_valid=0.65)
    dets = chip_smoke.random_dets(rng, d, "cpu")
    ids = np.where(slots.valid.numpy(), rng.integers(1, t // 3 + 2, t), 0)
    keys = assoc_keys(pairwise_iou(slots.bbox, dets.bbox), thr)
    keys = np.where((ids > 0)[:, None] & dets.valid.numpy()[None, :], keys, 0)
    return slots.bbox, dets.bbox, ids, keys


def line_firsts(keys: np.ndarray, rank: np.ndarray):
    """`stage_general_keys`' first round, line by line: each row's best
    entry (key << 32 | ~(rank D + d + 2^31), the largest), each column's
    and the row holding it (the least such row: entries never tie)."""
    T, D = keys.shape
    tie = (rank[:, None] * D + np.arange(D)[None, :] + 2**31) & _MASK32
    entry = np.where(keys != 0, (keys << 32) | (~tie & _MASK32), 0)
    return entry.max(axis=1), entry.max(axis=0), np.where(entry.max(axis=0) != 0, entry.argmax(axis=0), 0)


def stage_kernel_model(keys: np.ndarray, rank: np.ndarray, tile: tuple):
    """tracker_step.cu `tracker_stage_kernel` over ``tile`` (rows,
    columns) blocks: each key computed once, its row's and its column's best within
    the tile packed as the kernel packs them for its atomicMax (a row's
    (key, 2^32 - 1 - column), a column's (key, 2^32 - 1 - rank)), the
    maximum over tiles, then unpacked by the cluster kernel into the
    rounds' entries (a column's row through the inverse of the rank); and
    each line's chunk mask, bit c set where entries 32 c .. 32 c + 31 hold
    a key.  Returns (row bests, column bests, column rows, row masks,
    column masks)."""
    T, D = keys.shape
    by_rank = np.empty(T, np.int64)
    by_rank[rank] = np.arange(T)
    rowbest = np.zeros(T, np.int64)
    colbest = np.zeros(D, np.int64)
    rows_per, cols_per = tile
    for t0 in range(0, T, rows_per):
        for d0 in range(0, D, cols_per):
            k = keys[t0:t0 + rows_per, d0:d0 + cols_per]
            d = np.arange(d0, d0 + k.shape[1])
            r = rank[t0:t0 + k.shape[0]]
            rowbest[t0:t0 + k.shape[0]] = np.maximum(
                rowbest[t0:t0 + k.shape[0]], np.where(k != 0, (k << 32) | (_MASK32 - d[None, :]), 0).max(axis=1))
            colbest[d0:d0 + k.shape[1]] = np.maximum(
                colbest[d0:d0 + k.shape[1]], np.where(k != 0, (k << 32) | (_MASK32 - r[:, None]), 0).max(axis=0))
    rkey, rd = rowbest >> 32, _MASK32 - (rowbest & _MASK32)
    rows = np.where(rowbest != 0, (rkey << 32) | (~((rank * D + rd + 2**31) & _MASK32) & _MASK32), 0)
    ckey, cr = colbest >> 32, _MASK32 - (colbest & _MASK32)
    cols = np.where(colbest != 0, (ckey << 32) | (~((cr * D + np.arange(D) + 2**31) & _MASK32) & _MASK32), 0)
    colrow = np.where(colbest != 0, by_rank[np.where(colbest != 0, cr, 0)], 0)
    pad = lambda n: -(-n // 32) * 32  # noqa: E731
    rk = np.zeros((T, pad(D)), bool)
    rk[:, :D] = keys != 0
    ck = np.zeros((D, pad(T)), bool)
    ck[:, :T] = keys.T != 0
    return rows, cols, colrow, rk.reshape(T, -1, 32).any(axis=2), ck.reshape(D, -1, 32).any(axis=2)


def masked_best(line_keys: np.ndarray, ties: np.ndarray, dead: np.ndarray, chunks: np.ndarray) -> int:
    """association.cuh `row_line_best_masked` (and its column twin): the
    best live entry over the chunks whose mask bit is set and whose 32
    lines are not all dead."""
    n = line_keys.shape[0]
    best = 0
    for c in np.flatnonzero(chunks):
        span = slice(32 * c, min(32 * c + 32, n))
        if dead[span].all() and span.stop - span.start == 32:
            continue
        k, tie, gone = line_keys[span], ties[span], dead[span]
        e = np.where((k != 0) & ~gone, (k << 32) | (~tie & _MASK32), 0)
        best = max(best, int(e.max(initial=0)))
    return best


@pytest.mark.parametrize("thr", (0.3, 0.0))
@pytest.mark.parametrize("shape", STAGE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_staged_key_lines_match_the_per_line_staging(shape, thr, one_thread):
    """K1's keys staged over the card, modelled (`stage_kernel_model`):
    each key computed once gives every row's and every column's first-round
    best, and the column's row, bit for bit as `stage_general_keys`
    computes them twice, line by line (`line_firsts`), on tied IoUs (boxes
    quantized to 20 px), dead slots, invalid detections and tied ids, at
    thresholds 0.3 and 0 (where IoUs of 0 are eligible); the keys are the
    port's `pairwise_iou` and JAX's, jitted; and a best taken over the
    chunks the masks mark (`masked_best`), with random columns taken,
    equals the best over the whole line; both of the kernel's tile shapes.  A copy that packs a column's best
    with its slot instead of its id rank fails 8 of these 8 cases."""
    from multimodal_autonomous_driving_perception_and_planning_tpu.ops.geometry import pairwise_iou as jax_iou
    from multimodal_autonomous_driving_perception_and_planning_torch.tracking.tracker import _rank_by_count

    t, d = shape
    tb, db, ids, keys = _stage_inputs(t, d, thr)
    jax_keys = assoc_keys(torch.from_numpy(np.array(jax.jit(jax_iou)(jnp.asarray(tb.numpy()),
                                                                        jnp.asarray(db.numpy())))), thr)
    np.testing.assert_array_equal(np.where(keys != 0, jax_keys, 0), keys)
    rank = _rank_by_count(torch.tensor(np.where(ids > 0, ids, I32_MAX).astype(np.int32))).numpy().astype(np.int64)
    want_rows, want_cols, want_colrow = line_firsts(keys, rank)
    for tile in STAGE_TILES:
        rows, cols, colrow, rmask, cmask = stage_kernel_model(keys, rank, tile)
        np.testing.assert_array_equal(rows, want_rows)
        np.testing.assert_array_equal(cols, want_cols)
        np.testing.assert_array_equal(colrow, want_colrow)
    assert (keys != 0).any()
    rng = np.random.default_rng(t + d)
    taken = rng.random(d) < 0.5
    taken[: 32 * (d // 64)] = True  # whole words of taken columns, as the rounds leave them
    tie_row = (rank[:, None] * d + np.arange(d)[None, :] + 2**31) & _MASK32
    for i in rng.choice(t, 64, replace=False):
        dense = np.where((keys[i] != 0) & ~taken, (keys[i] << 32) | (~tie_row[i] & _MASK32), 0).max()
        assert masked_best(keys[i], tie_row[i], taken, rmask[i]) == dense


# --- K4's staged route: the keys staged over the card from the matrix --------

K4_STAGE_CASES = ("tied_ranks", "key_corners")


def k4_stage_kernel_model(keys: np.ndarray, rank: np.ndarray, tile: tuple):
    """associate.cu `associate_stage_kernel` over ``tile`` (rows, columns)
    blocks of 8 warps, 4 row groups of rows / 4 by 2 column groups of 32,
    then the cluster kernel's `staged_firsts`.  Each entry is the rounds'
    own 64-bit key (IoU key << 32 | ~(rank * D + d + 2^31), the tie-break
    key wrapping in 32 bits).  A warp keeps each of its rows' best over its
    32 columns (one chunk of the row line) and each of its columns' best
    over its rows with the first row at it; a chunk of a column line is a
    warp's 32 rows in big tiles, the block's 4 row groups of 8 combined in
    order in small ones.  The cluster kernel takes a line's first best as
    the maximum of its chunk bests, lane c reading chunks c, c + 32, ...
    and keeping the first it finds greater, a column's row the least row
    of the lanes at the maximum, and a mask bit where a chunk best is not
    0.  Returns (row bests, column bests, column rows, row masks, column
    masks)."""
    T, D = keys.shape
    tie = (rank[:, None].astype(np.int64) * D + np.arange(D)[None, :] + 2**31) & _MASK32
    entry = np.where(keys != 0, (keys << 32) | (~tie & _MASK32), 0)
    rch, cch = -(-D // 32), -(-T // 32)
    rowpart = np.zeros((T, rch), np.int64)
    colpart = np.zeros((D, cch), np.int64)
    colrow = np.zeros((D, cch), np.int64)
    rows_per, cols_per = tile
    k_rows = rows_per // 4
    for t_blk in range(0, T, rows_per):
        for d_blk in range(0, D, cols_per):
            groups = []  # the block's row groups' column bests and rows
            for rg in range(4):
                t0 = t_blk + k_rows * rg
                best, at = np.zeros(cols_per, np.int64), np.zeros(cols_per, np.int64)
                for cg in range(2):
                    d0 = d_blk + 32 * cg
                    e = entry[t0:t0 + k_rows, d0:d0 + 32]
                    if e.size == 0:
                        continue
                    rowpart[t0:t0 + e.shape[0], d0 // 32] = e.max(axis=1)
                    best[32 * cg:32 * cg + e.shape[1]] = e.max(axis=0)
                    at[32 * cg:32 * cg + e.shape[1]] = t0 + e.argmax(axis=0)  # the first row at the maximum
                groups.append((t0, best, at))
            d = np.arange(d_blk, min(d_blk + cols_per, D))
            if k_rows == 32:
                for t0, best, at in groups:
                    if t0 < T:
                        colpart[d, t0 // 32], colrow[d, t0 // 32] = best[:d.size], at[:d.size]
            else:
                best, at = groups[0][1].copy(), groups[0][2].copy()
                for _, b, a in groups[1:]:
                    better = b > best
                    best, at = np.where(better, b, best), np.where(better, a, at)
                colpart[d, t_blk // 32], colrow[d, t_blk // 32] = best[:d.size], at[:d.size]

    def firsts(part, rows):
        lanes = np.zeros((part.shape[0], 32), np.int64)
        lane_rows = np.zeros((part.shape[0], 32), np.int64)
        for c in range(part.shape[1]):
            better = part[:, c] > lanes[:, c % 32]
            lanes[:, c % 32] = np.where(better, part[:, c], lanes[:, c % 32])
            lane_rows[:, c % 32] = np.where(better, rows[:, c], lane_rows[:, c % 32])
        best = lanes.max(axis=1)
        return best, np.where(lanes == best[:, None], lane_rows, np.iinfo(np.int64).max).min(axis=1)

    rows, _ = firsts(rowpart, np.zeros_like(rowpart))
    cols, col_rows = firsts(colpart, colrow)
    return rows, cols, col_rows, rowpart != 0, colpart != 0


def _k4_stage_case(t: int, d: int, thr: float, kind: str):
    """K4's inputs for the stage model: tied ranks (`random_association`) or
    the key-order corners (`key_corner_association`: ranks at int32's ends
    whose tie-break keys wrap, -0 and +0, the threshold, NaN, tied IoUs)."""
    rng = np.random.default_rng(t * 11 + d + int(thr * 10) + K4_STAGE_CASES.index(kind))
    if kind == "tied_ranks":
        return chip_smoke.random_association(rng, t, d, tied=True)
    return chip_smoke.key_corner_association(rng, t, d, thr)


@pytest.mark.parametrize("kind", K4_STAGE_CASES)
@pytest.mark.parametrize("thr", (0.3, 0.0))
@pytest.mark.parametrize("shape", STAGE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k4_staged_bests_match_the_per_line_bests(shape, thr, kind, one_thread):
    """K4's staged route, modelled (`k4_stage_kernel_model`) on both of the
    stage kernel's tiles: every row's and column's first-round best and
    chunk masks equal the per-line bests (`line_firsts`, with K4's own
    ranks) and the chunks that hold an eligible key, and each column's row
    holds its best entry; through the masked rounds
    (`cluster_rounds_model` over 16 parts with those bests and masks, in
    passes of 1,024 rows) the matches equal the plain version and JAX's
    jitted fixpoint, bit for bit, on tied ranks and on the key-order
    corners.  Mutations counted on copies of this file outside the
    repository: a copy that packs a column's chunk best as K1 does, (key,
    2^32 - 1 - rank) with the rank unwrapped, and names the row by it
    fails 8 of these 16 cases (every key-corner case: ranks whose keys
    wrap); one that drops a chunk's mask bit where its best's key is the
    threshold's fails 6 (the key corners at all but (4,096, 160)); one that
    names the last row at a column's chunk maximum, another holding row,
    fails none, as any holding row gives the same matches."""
    t, d = shape
    iou, rank = _k4_stage_case(t, d, thr, kind)
    keys = assoc_keys(torch.tensor(iou), thr)
    rank64 = rank.astype(np.int64)
    want_rows, want_cols, want_colrow = line_firsts(keys, rank64)
    tie = (rank64[:, None] * d + np.arange(d)[None, :] + 2**31) & _MASK32
    entry = np.where(keys != 0, (keys << 32) | (~tie & _MASK32), 0)
    for tile in STAGE_TILES:
        rows, cols, colrow, rmask, cmask = k4_stage_kernel_model(keys, rank, tile)
        np.testing.assert_array_equal(rows, want_rows)
        np.testing.assert_array_equal(cols, want_cols)
        eligible = cols != 0
        np.testing.assert_array_equal(entry[colrow[eligible], np.flatnonzero(eligible)], cols[eligible])
        pad = lambda n: -(-n // 32) * 32  # noqa: E731
        rk = np.zeros((t, pad(d)), bool)
        rk[:, :d] = keys != 0
        ck = np.zeros((d, pad(t)), bool)
        ck[:, :t] = keys.T != 0
        np.testing.assert_array_equal(rmask, rk.reshape(t, -1, 32).any(axis=2))
        np.testing.assert_array_equal(cmask, ck.reshape(d, -1, 32).any(axis=2))
    assert (keys != 0).any() and (cols != 0).any()
    want = np.asarray(jax_greedy_associate(jnp.asarray(iou), jnp.asarray(rank), thr, backend="cpu"))
    got = cluster_rounds_model(torch.tensor(iou), torch.tensor(rank), thr, 16, threads=CLUSTER_THREADS,
                               staged=(rows, cols, colrow, rmask, cmask)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _greedy_associate_plain(torch.tensor(iou), torch.tensor(rank), thr).numpy())
