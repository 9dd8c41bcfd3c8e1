"""The port's host stack against the JAX package's, on the same run.

tests/test_host_stack.py's cases but `test_viz_renders` (the renderers
come with the apps): the detections-mode tagging runner over 40 synthetic
frames in both packages (the port's plain versions on the CPU), then
`extract_frame` on each frame, the AutoTagger's statistics, search and
segments, and a TagDatabase round trip, each held field by field to the
JAX chain's: ints and strings equal, floats within 1e-4 (PARITY.md), the
session ids and timestamps that ``datetime.now`` makes masked.  The
candidate trajectories are compared by cost order: mirror-image candidates
tie to about 1e-9 and may sort either way (ROADMAP §3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch import host as host_t
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn_t
from multimodal_autonomous_driving_perception_and_planning_torch.database import TagDatabase as DbT
from multimodal_autonomous_driving_perception_and_planning_torch.tagging.auto_tagger import (
    AutoTagger as TaggerT,
    get_maneuver_summary as summary_t,
)
from multimodal_autonomous_driving_perception_and_planning_tpu import host as host_j
from multimodal_autonomous_driving_perception_and_planning_tpu.data import synthetic as syn_j
from multimodal_autonomous_driving_perception_and_planning_tpu.database import TagDatabase as DbJ
from multimodal_autonomous_driving_perception_and_planning_tpu.tagging.auto_tagger import (
    AutoTagger as TaggerJ,
    get_maneuver_summary as summary_j,
)

T = 40
ATOL = 1e-4
MASKED = {"session_id", "start_time", "end_time", "session_info", "created_at"}


@pytest.fixture(scope="module")
def runs():
    """The same 40 frames through the jitted JAX runner and the port's."""
    dets = syn_t.simulated_detection_stream(T)
    ego = syn_t.ego_motion_stream(T, seed=0).astype(np.float32)
    cfg_j = pj.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    _, outs_j = pj.make_sequence_runner(cfg_j, donate=False)(
        pj.initial_state(cfg_j), {**{k: jnp.asarray(v) for k, v in dets.items()}, "ego_measurement": jnp.asarray(ego)}
    )
    cfg_t = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    _, outs_t = pt.make_sequence_runner(cfg_t, device="cpu")(
        pt.initial_state(cfg_t, device="cpu"), dict(dets, ego_measurement=ego)
    )
    return cfg_t, dets, outs_t, outs_j


def assert_same(a, b, path="", atol=ATOL):
    """Records, dicts, sequences and arrays equal, floats within ``atol``,
    keys in MASKED skipped."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if f.name not in MASKED:
                assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}", atol)
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            if k not in MASKED:
                assert_same(a[k], b[k], f"{path}[{k!r}]", atol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]", atol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=0, abs=atol), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _frames(runs):
    cfg, dets, outs_t, outs_j = runs
    return [(host_t.extract_frame(outs_t, dets, f), host_j.extract_frame(outs_j, dets, f)) for f in range(T)]


def test_extract_frame_records(runs):
    """Every frame's record equals JAX's field by field; the reference
    contract of tests/test_host_stack.py holds on the port's."""
    cfg = runs[0]
    for got, want in _frames(runs):
        assert_same(got.detections, want.detections, "detections")
        assert_same(got.tracks, want.tracks, "tracks")
        assert_same(got.vehicle_state, want.vehicle_state, "vehicle_state")
        assert_same(got.optimal_trajectory, want.optimal_trajectory, "optimal")
        assert_same([c.cost for c in got.candidate_trajectories], [c.cost for c in want.candidate_trajectories])
        assert sorted(c.trajectory_type for c in got.candidate_trajectories) == sorted(
            c.trajectory_type for c in want.candidate_trajectories
        )
        assert_same(got.tags, want.tags, "tags")
        assert (got.lane_left, got.lane_right, got.lane_offset) == (None, None, None)
    res = host_t.extract_frame(runs[2], runs[1], 20)
    assert len(res.detections) == int(runs[1]["valid"][20].sum())
    assert all(t.hits >= cfg.tracker.min_hits for t in res.tracks)
    ids = [t.track_id for t in res.tracks]
    assert ids == sorted(ids) and len(res.candidate_trajectories) == 21
    costs = [t.cost for t in res.candidate_trajectories]
    assert costs == sorted(costs) and res.optimal_trajectory.cost == costs[0]
    tr = res.tracks[0]
    assert len(tr.trajectory) <= cfg.tracker.trajectory_length
    np.testing.assert_allclose(tr.trajectory[-1], tr.center, atol=1e-4)


def _taggers(runs):
    _, _, outs_t, outs_j = runs
    tag_t, tag_j = TaggerT(video_path="synthetic", fps=30.0), TaggerJ(video_path="synthetic", fps=30.0)
    tag_t.ingest_device_tags(outs_t["tags"], T)
    tag_j.ingest_device_tags(outs_j["tags"], T)
    return tag_t, tag_j


def test_auto_tagger_aggregation(runs):
    """Statistics, frame records, search, segments and exports equal
    JAX's."""
    tag_t, tag_j = _taggers(runs)
    assert tag_t.frame_count == T
    assert_same(tag_t.get_tag_statistics(), tag_j.get_tag_statistics(), "statistics")
    assert_same(tag_t.frame_tags, tag_j.frame_tags, "frame_tags")
    for tag in sorted(tag_j.tag_counts):
        assert [f.frame_idx for f in tag_t.search_by_tag(tag)] == [f.frame_idx for f in tag_j.search_by_tag(tag)]
        assert tag_t.get_event_segments(tag, min_duration=2) == tag_j.get_event_segments(tag, min_duration=2)
    road = tag_t.frame_tags[0].scene["road_type"]
    lateral = tag_t.frame_tags[0].maneuver["lateral"]
    for tags, match_all in (([road, "nonexistent"], True), ([road, lateral], True), (["turn_left", road], False)):
        assert [f.frame_idx for f in tag_t.search_by_tags(tags, match_all)] == [
            f.frame_idx for f in tag_j.search_by_tags(tags, match_all)
        ]
    assert tag_t.search_by_tags([road, "nonexistent"], match_all=True) == []
    assert_same(tag_t.export_tags("csv"), tag_j.export_tags("csv"), "csv")
    assert '"session"' in tag_t.export_tags("json")


def test_tag_database_roundtrip(runs, tmp_path):
    """The same taggers saved to two databases give the same rows, search
    results and statistics; export and delete work on the port's."""
    tag_t, tag_j = _taggers(runs)
    tag_t.finalize()
    tag_j.finalize()
    db_t, db_j = DbT(str(tmp_path / "t.db")), DbJ(str(tmp_path / "j.db"))
    assert db_t.save_all_tags(tag_t) == db_j.save_all_tags(tag_j) == T
    assert_same(db_t.get_tag_statistics(), db_j.get_tag_statistics(), "db statistics")
    road = tag_t.frame_tags[0].scene["road_type"]
    lateral = tag_t.frame_tags[0].maneuver["lateral"]
    for tag in sorted(tag_j.tag_counts):
        assert_same(db_t.search_by_tag(tag, limit=100), db_j.search_by_tag(tag, limit=100), f"search {tag}")
    assert_same(db_t.search_by_multiple_tags([road, lateral]), db_j.search_by_multiple_tags([road, lateral]))
    assert_same(db_t.get_sessions(), db_j.get_sessions(), "sessions")
    assert db_t.get_sessions()[0]["session_id"] == tag_t.session.session_id
    assert '"frames"' in db_t.export_session(tag_t.session.session_id, "json")
    db_t.delete_session(tag_t.session.session_id)
    assert db_t.get_tag_statistics()["frame_count"] == 0
    db_t.close()
    db_j.close()


def test_high_risk_search_matches_tagger(runs, tmp_path):
    tag_t, tag_j = _taggers(runs)
    db = DbT(str(tmp_path / "risk.db"))
    db.save_all_tags(tag_t)
    want = [f.frame_idx for f in tag_j.get_high_risk_frames()]
    assert [f.frame_idx for f in tag_t.get_high_risk_frames()] == want
    assert len(db.search_high_risk(limit=10_000)) == len(want)
    db.close()


def test_parity_helper_surface(runs):
    """predict_next_position, get_all_trajectories, get_lane_center_offset,
    get_maneuver_summary, set_initial_state and the numpy streams against
    JAX's, bit for bit where the JAX package's are numpy."""
    from multimodal_autonomous_driving_perception_and_planning_torch.estimation import set_initial_state as init_t
    from multimodal_autonomous_driving_perception_and_planning_tpu.estimation import set_initial_state as init_j

    cfg, dets, outs_t, outs_j = runs
    got, want = host_t.extract_frame(outs_t, dets, 20), host_j.extract_frame(outs_j, dets, 20)
    for a, b in zip(got.tracks, want.tracks):
        assert_same(a.predict_next_position(), b.predict_next_position())
    assert_same(host_t.get_all_trajectories(got.tracks), host_j.get_all_trajectories(want.tracks))
    left = np.array([[100.0, 0.0], [110.0, 480.0]])
    right = np.array([[500.0, 0.0], [530.0, 480.0]])
    assert host_t.get_lane_center_offset(640, left, right) == host_j.get_lane_center_offset(640, left, right)
    assert host_t.get_lane_center_offset(640, None, right) is None
    fit = np.array([1e-4, -0.2, 300.0])
    np.testing.assert_array_equal(host_t.lane_points(fit, 480), host_j.lane_points(fit, 480))

    vs_t, vs_j = outs_t["vehicle_state"], outs_j["vehicle_state"]
    args_t = (vs_t.speed.numpy(), vs_t.acceleration.numpy(), np.stack([vs_t.x.numpy(), vs_t.y.numpy()], 1))
    args_j = (np.asarray(vs_j.speed), np.asarray(vs_j.acceleration), np.stack([vs_j.x, vs_j.y], 1))
    assert_same(summary_t(*args_t), summary_j(*args_j))
    assert summary_t(*(a[:4] for a in args_t)) == {}
    # The host helper on the same arrays: bit for bit.
    assert summary_t(*args_j) == summary_j(*args_j)

    ks_t = init_t(pt.initial_state(cfg, device="cpu").kalman, 1.0, 2.0, 3.0, 4.0)
    ks_j = init_j(pj.initial_state(pj.DEFAULT_CONFIG).kalman, 1.0, 2.0, 3.0, 4.0)
    for f in ("x", "P", "time", "prev_heading", "prev_speed"):
        np.testing.assert_array_equal(getattr(ks_t, f).numpy(), np.asarray(getattr(ks_j, f)), err_msg=f)
    assert float(ks_t.prev_speed) == 5.0

    assert syn_t.generate_agent_trajectories(3, 10, dt=0.1, seed=7) == syn_j.generate_agent_trajectories(
        3, 10, dt=0.1, seed=7
    )
    for a, b in zip(syn_t.simulated_vehicle_motion_stream(50, seed=3), syn_j.simulated_vehicle_motion_stream(50, seed=3)):
        np.testing.assert_array_equal(a, b)
    inc_t, inc_j = syn_t.IncrementalEgoMotion(seed=5), syn_j.IncrementalEgoMotion(seed=5)
    for n in (7, 1, 30):
        np.testing.assert_array_equal(inc_t.take(n), inc_j.take(n))
    np.testing.assert_array_equal(
        np.concatenate([syn_t.IncrementalEgoMotion(seed=0).take(n) for n in (10,)]), syn_t.ego_motion_stream(10)
    )


def test_ego_state_history_getters(runs):
    """EgoStateHistory over the port's stacked states equals JAX's over
    its own, the 1,000-entry cap and the small cap included."""
    _, _, outs_t, outs_j = runs
    for cap in (1000, 10):
        h_t, h_j = host_t.EgoStateHistory(cap=cap), host_j.EgoStateHistory(cap=cap)
        h_t.extend_from_outputs(outs_t["vehicle_state"])
        h_j.extend_from_outputs(outs_j["vehicle_state"])
        assert len(h_t.get_state_history()) == min(cap, T)
        assert_same(h_t.get_state_history(5), h_j.get_state_history(5))
        for getter in ("get_trajectory", "get_velocity_history", "get_speed_history", "get_heading_history"):
            assert_same(getattr(h_t, getter)(), getattr(h_j, getter)(), getter)
    h_t.reset()
    assert h_t.get_trajectory().size == 0
    assert torch.is_tensor(outs_t["vehicle_state"].x)
