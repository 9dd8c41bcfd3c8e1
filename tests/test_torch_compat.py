"""The port's reference-named per-frame facades (compat.py, and
perception/detector.py's ObjectDetector) against the JAX package's.

tests/test_compat.py's six cases, each facade on the CPU (its kernel's
plain version), held both to the port's own sequence runner (as the JAX
test holds the JAX facades to the JAX runner) and to the JAX facades or
runner on the same inputs: discrete outputs equal, floats within 1e-4
(PARITY.md), lane fits by the x they give within 1e-3 px.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch import compat as ct
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn_t
from multimodal_autonomous_driving_perception_and_planning_torch.host import CLASS_NAMES, HostDetection
from multimodal_autonomous_driving_perception_and_planning_tpu import compat as cj
from multimodal_autonomous_driving_perception_and_planning_tpu.data.frames import SyntheticRoadGenerator

N = 40
ATOL = 1e-4
CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stream():
    return syn_t.simulated_detection_stream(N), syn_t.ego_motion_stream(N, seed=0)


def _runs(enable_tagging):
    dets, ego = _stream()
    cfg_t = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=enable_tagging)
    cfg_j = pj.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=enable_tagging)
    _, outs_t = pt.make_sequence_runner(cfg_t, **CPU)(
        pt.initial_state(cfg_t, **CPU), dict(dets, ego_measurement=ego.astype(np.float32))
    )
    _, outs_j = pj.make_sequence_runner(cfg_j, donate=False)(
        pj.initial_state(cfg_j),
        {**{k: jnp.asarray(v) for k, v in dets.items()}, "ego_measurement": jnp.asarray(ego, jnp.float32)},
    )
    return cfg_t, dets, ego, outs_t, outs_j


def _frame_dets(dets, f):
    return [
        HostDetection(
            bbox=tuple(dets["bbox"][f, j].tolist()),
            class_id=int(dets["class_id"][f, j]),
            class_name=CLASS_NAMES[int(dets["class_id"][f, j])],
            confidence=float(dets["confidence"][f, j]),
        )
        for j in np.flatnonzero(dets["valid"][f])
    ]


def test_per_frame_facades_match_fused_runner():
    """The facades one frame at a time give the port runner's tracks, ego
    states and chosen plans exactly, and the JAX runner's ids and floats
    within 1e-4."""
    _, dets, ego, outs_t, outs_j = _runs(False)
    tracker, estimator, planner = ct.MultiObjectTracker(**CPU), ct.VehicleStateEstimator(**CPU), ct.MotionPlanner(**CPU)
    for f in range(N):
        tracks = tracker.update(_frame_dets(dets, f))
        vstate = estimator.step(ego[f])
        optimal, candidates = planner.plan(vstate)
        n = int(outs_t["num_confirmed"][f])
        want_ids = [int(outs_t["track_id"][f, s]) for s in outs_t["confirmed_order"][f][:n]]
        assert [t.track_id for t in tracks] == want_ids, f
        assert want_ids == [int(np.asarray(outs_j["track_id"])[f, s])
                            for s in np.asarray(outs_j["confirmed_order"])[f][:n]], f
        for k in ("speed", "x", "y", "heading"):
            assert getattr(vstate, k) == float(getattr(outs_t["vehicle_state"], k)[f]), (f, k)
            assert getattr(vstate, k) == pytest.approx(float(np.asarray(getattr(outs_j["vehicle_state"], k))[f]),
                                                       rel=0, abs=ATOL), (f, k)
        best = int(outs_t["plan_best"][f])
        assert best == int(np.asarray(outs_j["plan_best"])[f])
        np.testing.assert_array_equal(optimal.positions, outs_t["plan_positions"][f, best].numpy())
        np.testing.assert_allclose(optimal.positions, np.asarray(outs_j["plan_positions"])[f, best], atol=ATOL)
        assert len(candidates) == 21
    trajs = tracker.get_all_trajectories()
    assert set(trajs) == {t.track_id for t in tracks}
    assert estimator.get_trajectory().shape == (N, 2)
    tracker.reset()
    assert tracker.update([]) == []


def test_lane_detector_facade_finds_lanes():
    """The port's LaneDetector on the JAX generator's frames: the found
    flags, confidences and offsets of the JAX LaneDetector, the fits by
    their x at three rows within 1e-3 px, and the reference contract."""
    cfg = pt.DEFAULT_CONFIG
    gen = SyntheticRoadGenerator(cfg.frame_width, cfg.frame_height)
    det_t, det_j = ct.LaneDetector(**CPU), cj.LaneDetector()
    h = cfg.frame_height
    for f in gen.generate_frames(3):
        got, want = det_t.detect(f), det_j.detect(f)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is None:
                continue
            assert a.side == b.side and a.confidence == pytest.approx(b.confidence, abs=ATOL)
            for y in (h, 0.8 * h, 0.6 * h):
                assert np.polyval(a.polynomial, y) == pytest.approx(np.polyval(b.polynomial, y), abs=1e-3)
            assert np.abs(a.points.astype(np.int64) - b.points).max() <= 1
    left, right = got
    assert left is not None and right is not None and left.points.shape == (50, 2)
    for side, lane in (("left", left), ("right", right)):
        assert abs(np.polyval(lane.polynomial, h * 0.8) - gen.lane_x_at(side, h * 0.8)) < 8.0, side
    off = det_t.get_lane_center_offset(cfg.frame_width, left, right)
    assert off == det_j.get_lane_center_offset(cfg.frame_width, *want) and abs(off) < 12.0
    assert det_t.get_lane_center_offset(cfg.frame_width, None, right) is None
    det_t.reset()


def test_simulated_vehicle_motion_matches_stream():
    """The port's simulator equals its stream and the JAX simulator, bit
    for bit."""
    sim_t, sim_j = ct.SimulatedVehicleMotion(dt=0.033, seed=0), cj.SimulatedVehicleMotion(dt=0.033, seed=0)
    got = np.stack([sim_t.step() for _ in range(25)])
    np.testing.assert_array_equal(got, np.stack([sim_j.step() for _ in range(25)]))
    want, truth = syn_t.simulated_vehicle_motion_stream(25, dt=0.033, seed=0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sim_t.get_ground_truth(), truth[-1])
    sim_t.reset()
    np.testing.assert_array_equal(sim_t.get_ground_truth(), [0.0, 0.0, 10.0, 0.0])


def test_planner_obstacle_penalty_changes_choice():
    """A wall of obstacles ahead forces a detour; the port's choice and
    costs equal the JAX facades'."""
    est_t, est_j = ct.VehicleStateEstimator(**CPU), cj.VehicleStateEstimator()
    z = np.asarray([0.0, 0.0, 10.0, 0.0])
    vs_t, vs_j = est_t.step(z), est_j.step(z)
    plan_t, plan_j = ct.MotionPlanner(**CPU), cj.MotionPlanner()
    wall = [(x, vs_t.y, 1.0) for x in range(5, 45, 5)]
    for obstacles in (None, wall):
        (a, cands_a), (b, cands_b) = plan_t.plan(vs_t, obstacles), plan_j.plan(vs_j, obstacles)
        assert a.trajectory_type == b.trajectory_type and a.cost == pytest.approx(b.cost, rel=1e-6, abs=ATOL)
        np.testing.assert_allclose([c.cost for c in cands_a], [c.cost for c in cands_b], rtol=1e-6, atol=ATOL)
    free, _ = plan_t.plan(vs_t)
    blocked, _ = plan_t.plan(vs_t, obstacles=wall)
    assert blocked.cost > free.cost
    with pytest.raises(ValueError, match="capacity"):
        plan_t.plan(vs_t, obstacles=[(1.0, 1.0, 1.0)] * (plan_t.cfg.max_obstacles + 1))


def _approx(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _approx(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for j, (x, y) in enumerate(zip(a, b)):
            _approx(x, y, f"{path}[{j}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-4, abs=1e-4), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _canon(i):
    i = dict(i)
    i["interactions"] = sorted(i["interactions"], key=lambda d: (d["type"], d["distance"]))
    return i


def test_auto_tagger_facade_matches_fused_pipeline():
    """compat.AutoTagger.tag_frame, one frame at a time with the reference
    signature, reproduces the port runner's tags (the cross-frame smoothing
    and history state included) and the JAX facade's records.  The
    interaction list is ordered by table slot, which the facade assigns its
    own way, so it is compared by type and distance."""
    from multimodal_autonomous_driving_perception_and_planning_torch.host import extract_frame
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.auto_tagger import AutoTagger

    cfg, dets, _, outs_t, outs_j = _runs(True)
    base = AutoTagger(video_path="synthetic", fps=30.0)
    base.ingest_device_tags(outs_t["tags"], N)
    cfg_j = pj.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    facade, facade_j = ct.AutoTagger("synthetic", 30.0, cfg=cfg, **CPU), cj.AutoTagger("synthetic", 30.0, cfg=cfg_j)
    for f in range(N):
        res = extract_frame(outs_t, dets, f)
        ft = facade.tag_frame(None, detections=res.detections, tracks=res.tracks, lanes=None,
                              vehicle_state=res.vehicle_state)
        ft_j = facade_j.tag_frame(None, detections=res.detections, tracks=res.tracks, lanes=None,
                                  vehicle_state=res.vehicle_state)
        for want in (base.frame_tags[f], ft_j):
            assert sorted(ft.all_tags) == sorted(want.all_tags), (f, ft.all_tags, want.all_tags)
            _approx(_canon(ft.interaction), _canon(want.interaction), "interaction")
            _approx(ft.scene, want.scene, "scene")
            _approx(ft.maneuver, want.maneuver, "maneuver")
        assert ft.all_tags == ft_j.all_tags and ft.tag_confidences == pytest.approx(ft_j.tag_confidences, abs=ATOL)
    assert facade.get_tag_statistics()["total_frames"] == N
    assert [t.frame_idx for t in facade.get_high_risk_frames()] == [t.frame_idx for t in base.get_high_risk_frames()]
    facade.reset()
    assert facade.frame_tags == []


def test_object_detector_reference_surface():
    """detector.py:39-60,171-222: the class attributes, the simulated
    detections and the drawn pixels equal the JAX ObjectDetector's; YOLO
    without weights falls back to the simulator, as the reference does."""
    from multimodal_autonomous_driving_perception_and_planning_torch.perception.detector import ObjectDetector
    from multimodal_autonomous_driving_perception_and_planning_tpu.perception.detector import ObjectDetector as OdJ

    d, dj = ObjectDetector(**CPU), OdJ()
    assert d.CLASSES == dj.CLASSES and d.CLASS_COLORS == dj.CLASS_COLORS
    assert d.CLASSES[0] == "car" and d.CLASSES[2] == "pedestrian" and d.CLASS_COLORS[0] == (0, 255, 0)
    frame = np.zeros((480, 640, 3), np.uint8)
    for _ in range(3):
        dets, want = d.detect(frame), dj.detect(frame)
        assert [dataclasses.astuple(x) for x in dets] == [dataclasses.astuple(x) for x in want]
        assert 3 <= len(dets) <= 7  # detector.py:137
    out = d.draw_detections(frame, dets)
    assert out.shape == frame.shape and out.sum() > 0
    np.testing.assert_array_equal(out, dj.draw_detections(frame, dets))
    stream = d.detect_stream(np.zeros((4, 480, 640, 3), np.uint8))
    stream_j = dj.detect_stream(np.zeros((4, 480, 640, 3), np.uint8))
    for k, v in stream_j.items():
        np.testing.assert_array_equal(stream[k].numpy(), np.asarray(v), err_msg=k)
    d.reset()
    assert d.frame_count == 0
    fallback = ObjectDetector(mode="yolo", model_path="no_such_weights.npz", **CPU)
    assert fallback.mode == "simulated" and fallback.variables is None
