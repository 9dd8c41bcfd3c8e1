"""The port's renderers against the JAX package's, pixel for pixel.

A jitted JAX run of DEFAULT_CONFIG (frames, lanes, tagging, candidates)
over 8 road frames gives host records through JAX's `extract_frame`; the
records are carried over to the port's record types field by field, and
every renderer draws the same records in both packages:
`BEVRenderer.render` (with and without grid, candidates, tracks and ego),
`OverlayRenderer`'s five methods and the three draw helpers must give
identical images.  The port's own run on the same inputs must give the
JAX records (ints and strings equal, floats within atol 1e-4, PARITY.md;
the candidates by cost, as tests/test_torch_host_stack.py compares them;
the lane fits by their x at three rows within 1e-3 px).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch import host as host_t
from multimodal_autonomous_driving_perception_and_planning_torch import viz as viz_t
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn_t
from multimodal_autonomous_driving_perception_and_planning_tpu import host as host_j
from multimodal_autonomous_driving_perception_and_planning_tpu import viz as viz_j
from multimodal_autonomous_driving_perception_and_planning_tpu.data.frames import SyntheticRoadGenerator as RoadJ

N = 8
X_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def carry(obj):
    """A JAX host record (or a list, tuple or dict of them) as the port's
    record of the same name, field by field."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(host_t, type(obj).__name__)
        return cls(**{f.name: carry(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(carry(x) for x in obj)
    if isinstance(obj, dict):
        return {k: carry(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj.copy()
    return obj


@pytest.fixture(scope="module")
def runs():
    frames = RoadJ().generate_frames(N)
    dets = syn_t.simulated_detection_stream(N)
    ego = syn_t.ego_motion_stream(N, seed=0).astype(np.float32)
    cfg_j = pj.DEFAULT_CONFIG
    _, outs_j = pj.make_sequence_runner(cfg_j, donate=False)(
        pj.initial_state(cfg_j),
        {**{k: jnp.asarray(v) for k, v in dets.items()}, "ego_measurement": jnp.asarray(ego),
         "frame": jnp.asarray(frames)},
    )
    cfg_t = pt.DEFAULT_CONFIG
    _, outs_t = pt.make_sequence_runner(cfg_t, device="cpu")(
        pt.initial_state(cfg_t, device="cpu"), dict(dets, ego_measurement=ego, frame=frames)
    )
    recs_j = [host_j.extract_frame(outs_j, dets, f) for f in range(N)]
    recs_t = [host_t.extract_frame(outs_t, dets, f) for f in range(N)]
    return frames, recs_j, recs_t


def _pairs(runs):
    frames, recs_j, _ = runs
    return [(frames[f], r, carry(r)) for f, r in enumerate(recs_j) if f >= 3]


def same_image(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_records_carry_over_and_have_content(runs):
    recs_j = runs[1]
    r = carry(recs_j[-1])
    assert isinstance(r, host_t.FrameResult) and isinstance(r.tracks[0], host_t.HostTrack)
    assert r.tracks and r.detections and r.lane_left is not None and r.lane_right is not None
    assert r.lane_offset is not None and len(r.candidate_trajectories) == 21


def test_draw_helpers_match_jax(runs):
    for frame, rj, rt in _pairs(runs):
        same_image(viz_t.draw_detections(frame.copy(), rt.detections),
                   viz_j.draw_detections(frame.copy(), rj.detections))
        same_image(viz_t.draw_detections(frame.copy(), rt.detections, show_confidence=False),
                   viz_j.draw_detections(frame.copy(), rj.detections, show_confidence=False))
        same_image(viz_t.draw_lanes(frame.copy(), rt.lane_left, rt.lane_right),
                   viz_j.draw_lanes(frame.copy(), rj.lane_left, rj.lane_right))
        same_image(viz_t.draw_lanes(frame.copy(), rt.lane_left, None, fill_lane=False),
                   viz_j.draw_lanes(frame.copy(), rj.lane_left, None, fill_lane=False))
        same_image(viz_t.draw_tracks(frame.copy(), rt.tracks, draw_velocities=True),
                   viz_j.draw_tracks(frame.copy(), rj.tracks, draw_velocities=True))


def test_overlay_renderer_matches_jax(runs):
    ot, oj = viz_t.OverlayRenderer(), viz_j.OverlayRenderer()
    for f, (frame, rj, rt) in enumerate(_pairs(runs)):
        same_image(ot.draw_info_panel(frame.copy(), rt.vehicle_state, fps=29.7, frame_num=f),
                   oj.draw_info_panel(frame.copy(), rj.vehicle_state, fps=29.7, frame_num=f))
        same_image(ot.draw_info_panel(frame.copy()), oj.draw_info_panel(frame.copy()))
        for pos in ("top_right", "bottom_left"):
            same_image(ot.draw_detection_summary(frame.copy(), rt.detections, pos),
                       oj.draw_detection_summary(frame.copy(), rj.detections, pos))
        for off in (rt.lane_offset, None, 35.0, -80.0, 250.0):
            same_image(ot.draw_lane_offset_indicator(frame.copy(), off),
                       oj.draw_lane_offset_indicator(frame.copy(), off))
        for pos in ("bottom_left", "bottom_right"):
            same_image(ot.draw_tracking_stats(frame.copy(), rt.tracks, pos),
                       oj.draw_tracking_stats(frame.copy(), rj.tracks, pos))
        same_image(ot.draw_tracking_stats(frame.copy(), []), oj.draw_tracking_stats(frame.copy(), []))
        bev = np.full((600, 600, 3), 40, np.uint8)
        same_image(ot.create_side_by_side(frame, bev), oj.create_side_by_side(frame, bev))
        same_image(ot.create_side_by_side(frame[:200], bev, ("a", "b")),
                   oj.create_side_by_side(frame[:200], bev, ("a", "b")))


def test_bev_renderer_matches_jax(runs):
    bt, bj = viz_t.BEVRenderer(pt.DEFAULT_CONFIG.bev), viz_j.BEVRenderer(pj.DEFAULT_CONFIG.bev)
    same_image(bt.render(), bj.render())
    for frame, rj, rt in _pairs(runs):
        kw_t = dict(ego_state=rt.vehicle_state, tracks=rt.tracks, planned_trajectory=rt.optimal_trajectory,
                    candidate_trajectories=rt.candidate_trajectories[:10])
        kw_j = dict(ego_state=rj.vehicle_state, tracks=rj.tracks, planned_trajectory=rj.optimal_trajectory,
                    candidate_trajectories=rj.candidate_trajectories[:10])
        img = bt.render(**kw_t, show_grid=True)
        same_image(img, bj.render(**kw_j, show_grid=True))
        same_image(bt.render(**kw_t), bj.render(**kw_j))
        assert img.shape == (600, 600, 3)
    for xy in ((0.0, 0.0), (-29.5, 49.0), (12.3, -4.4)):
        assert bt.world_to_pixel(*xy) == bj.world_to_pixel(*xy)
        assert bt.pixel_to_world(*bt.world_to_pixel(*xy)) == bj.pixel_to_world(*bj.world_to_pixel(*xy))


def test_port_records_equal_jax_records(runs):
    """The port's run gives JAX's records: the renderers' inputs."""
    _, recs_j, recs_t = runs
    for got, want in zip(recs_t, recs_j):
        for part in ("detections", "tracks", "vehicle_state", "optimal_trajectory", "tags"):
            chip_smoke.same_records(getattr(got, part), carry(getattr(want, part)), part)
        chip_smoke.same_records([c.cost for c in got.candidate_trajectories],
                                [c.cost for c in want.candidate_trajectories], "candidates")
        assert got.lane_offset == want.lane_offset
        for side in ("lane_left", "lane_right"):
            a, b = getattr(got, side), getattr(want, side)
            assert (a is None) == (b is None), side
            if a is not None:
                for y in (480.0, 384.0, 288.0):
                    assert abs(np.polyval(a.astype(np.float64), y) - np.polyval(b.astype(np.float64), y)) <= X_ATOL
