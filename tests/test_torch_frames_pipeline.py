"""The frames path, the JAX package's default configuration, end to end.

The port's `make_sequence_runner(DEFAULT_CONFIG)` (camera frames -> lanes
and scene features -> track -> estimate -> plan -> tag) against the JAX
package's, jitted, on 40 frames at 640x480 from each generator (the JAX
package's cv2 one, and the port's numpy one with the scrolling dashes),
with the synthetic detections and ego stream.  Every discrete output must
be equal: track ids, matches, the confirmed order, ``plan_best``, the lane
flags, the offset and every discrete tag.  Floats: the track and plan
outputs and the float tags within atol 1e-4 (TTC within rtol 1e-5); the
lane fits by the x they give at rows h, 0.8h and 0.6h within 1e-3 px, the
linear and constant coefficients within rtol 1e-4, and the curvature
coefficient within rtol 1e-3 and by its share of x at the bottom row
within 1e-3 px: it is about 1e-6 to 1e-5 on these nearly straight lanes,
where float32 rounding at the scale of x moves it by up to 7e-4 relative
(tests/test_torch_lanes.py::test_curvature_gap_follows_its_conditioning).

Also here: the per-frame step against the runner, the port's numpy
generator against the JAX package's cv2 one, and the YOLO runner with
``use_frames=True`` against the frames runner fed the YOLO tables (port
against port, at the YOLO tests' 160-pixel letterbox).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn_t
from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import (
    SyntheticRoadGenerator as RoadT,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.data.frames import (
    SyntheticRoadGenerator as RoadJ,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.perception.lanes import make_lane_step as lane_step_j
from multimodal_autonomous_driving_perception_and_planning_tpu.types import LaneState as LaneStateJ

N = 40
H = 480
ATOL = 1e-4
TTC_RTOL = 1e-5
X_ATOL = 1e-3
FIT_RTOL = 1e-4
CURVATURE_RTOL = 1e-3
DISCRETE = ("track_id", "track_class_id", "track_hits", "track_misses", "track_age", "track_vel_count",
            "confirmed_order", "num_confirmed", "match", "plan_best")
FLOAT = ("track_bbox", "track_confidence", "track_velocity", "plan_costs", "plan_best_positions",
         "plan_best_velocities")
VS_FIELDS = ("x", "y", "vx", "vy", "heading", "speed", "acceleration", "yaw_rate", "timestamp",
             "pos_uncertainty", "vel_uncertainty")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the same
    cores, and torch's default of one thread a core each makes them wait
    on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(pkg):
    return pkg.DEFAULT_CONFIG.replace(emit_candidates=False, emit_trajectories=False)


def _inputs(frames):
    n = len(frames)
    dets = syn_t.simulated_detection_stream(n)
    ego = syn_t.ego_motion_stream(n, dt=1.0 / 30.0, seed=0).astype(np.float32)
    return dict(dets, ego_measurement=ego, frame=frames)


FRAME_SETS = {
    "cv2_frames": lambda: RoadJ().generate_frames(N),
    "numpy_frames_dashed": lambda: RoadT(draw_adjacent_dash=True).generate_frames(N),
}


@pytest.fixture(scope="module")
def jax_runner():
    """One jitted JAX runner for the module (both frame sets share its
    shapes, so it compiles once)."""
    cfg = _config(pj)
    run = pj.make_sequence_runner(cfg, donate=False)
    return lambda inputs: run(pj.initial_state(cfg), {k: jnp.asarray(v) for k, v in inputs.items()})


def _run_port(inputs, cfg=None):
    cfg = cfg or _config(pt)
    return pt.make_sequence_runner(cfg, device="cpu")(pt.initial_state(cfg, device="cpu"), inputs)


def _at_bottom(fit):
    """The fit at the bottom row before the truncation, in float32 as the
    step computes it."""
    fit = np.asarray(fit, np.float32)
    yb = np.float32(H)
    return fit[..., 0] * yb * yb + fit[..., 1] * yb + fit[..., 2]


def assert_lane_obs_match(got, want):
    """The lane observations, stacked over frames, under the parity
    contract of the module docstring."""
    for k in ("left_found", "right_found", "has_offset"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype == bool, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("left_confidence", "right_confidence"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)
    off_t, off_j = got.offset_px.numpy(), np.asarray(want.offset_px)
    flipped = off_t != off_j
    if flipped.any():  # a truncation flipped: its value stands within 1e-3 of an integer
        for k in ("left_fit", "right_fit"):
            v = _at_bottom(np.asarray(getattr(want, k)))[flipped]
            assert (np.abs(v - np.round(v)) <= 1e-3).all(), (k, v)
    for k in ("left_fit", "right_fit"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        for y in (H, 0.8 * H, 0.6 * H):
            xa = a[:, 0].astype(np.float64) * y * y + a[:, 1].astype(np.float64) * y + a[:, 2]
            xb = b[:, 0].astype(np.float64) * y * y + b[:, 1].astype(np.float64) * y + b[:, 2]
            np.testing.assert_allclose(xa, xb, rtol=0, atol=X_ATOL, err_msg=f"{k} x at row {y}")
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=FIT_RTOL, atol=0, err_msg=f"{k} b, c")
        np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=CURVATURE_RTOL, atol=0, err_msg=f"{k} a")
        np.testing.assert_allclose(a[:, 0] * H * H, b[:, 0] * H * H, rtol=0, atol=X_ATOL, err_msg=f"{k} a h^2")


def assert_outs_match(outs_t, outs_j):
    for k in DISCRETE:
        a, b = outs_t[k].numpy(), np.asarray(outs_j[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in FLOAT:
        np.testing.assert_allclose(outs_t[k].numpy(), np.asarray(outs_j[k]), rtol=0, atol=ATOL, err_msg=k)
    for f in VS_FIELDS:
        np.testing.assert_allclose(getattr(outs_t["vehicle_state"], f).numpy(),
                                   np.asarray(getattr(outs_j["vehicle_state"], f)), rtol=0, atol=ATOL, err_msg=f)
    assert_lane_obs_match(outs_t["lane_obs"], outs_j["lane_obs"])
    tags_t, tags_j = outs_t["tags"], outs_j["tags"]
    assert set(tags_t) == set(tags_j) and len(tags_j) == 43
    for k in sorted(tags_j):
        a, b = tags_t[k].numpy(), np.asarray(tags_j[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if b.dtype.kind == "f":
            rtol = TTC_RTOL if "ttc" in k else 0.0
            np.testing.assert_allclose(a, b, rtol=rtol, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("frames", list(FRAME_SETS))
def test_runner_matches_jax(jax_runner, frames):
    """40 frames of DEFAULT_CONFIG, the port against jitted JAX."""
    inputs = _inputs(FRAME_SETS[frames]())
    _, outs_j = jax_runner(inputs)
    _, outs_t = _run_port(inputs)
    assert_outs_match(outs_t, outs_j)
    lane = outs_t["lane_obs"]
    assert lane.left_found.all() and lane.right_found.all() and lane.left_fit.shape == (N, 3)
    assert outs_t["tags"]["lane_count"].shape == (N,)


def test_pipeline_step_matches_runner():
    """`make_pipeline_step` over 5 frames gives the runner's lane
    observations and tags, frame by frame; the runner takes int32 frames
    as it takes uint8 ones."""
    frames = RoadT(draw_adjacent_dash=True).generate_frames(5)
    inputs = _inputs(frames)
    cfg = _config(pt)
    _, outs = _run_port(inputs)
    _, outs32 = _run_port(dict(inputs, frame=frames.astype(np.int32)))
    np.testing.assert_array_equal(outs32["lane_obs"].left_fit.numpy(), outs["lane_obs"].left_fit.numpy())
    step = pt.make_pipeline_step(cfg, device="cpu")
    state = pt.initial_state(cfg, device="cpu")
    for f in range(5):
        frame_in = {
            "detections": pt.detections_from_arrays({k: inputs[k][f] for k in ("bbox", "class_id", "confidence",
                                                                              "valid")}, device="cpu"),
            "ego_measurement": torch.as_tensor(inputs["ego_measurement"][f]),
            "frame": torch.as_tensor(frames[f]),
        }
        state, out = step(state, frame_in)
        for k in ("left_fit", "right_fit", "left_found", "right_found", "offset_px", "has_offset"):
            np.testing.assert_array_equal(getattr(out["lane_obs"], k).numpy(),
                                          getattr(outs["lane_obs"], k)[f].numpy(), err_msg=k)
        for k, v in out["tags"].items():
            np.testing.assert_array_equal(v.numpy(), outs["tags"][k][f].numpy(), err_msg=k)
    with pytest.raises(TypeError, match="uint8 or int32"):
        _run_port(dict(inputs, frame=frames.astype(np.float32)))


def test_generator_stands_close_to_cv2():
    """The port's numpy drawing against the JAX package's cv2 drawing:
    over 99% of the pixels equal (the rest on line and polygon borders),
    and the JAX lane step recovers `lane_x_at` on the port's frames, as
    tests/test_lanes.py:70 does on its own."""
    for dash in (False, True):
        a = RoadT(draw_adjacent_dash=dash).generate_frames(8)
        b = RoadJ(draw_adjacent_dash=dash).generate_frames(8)
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        assert (a == b).all(-1).mean() > 0.99, dash
    gen = RoadT()
    _, obs, _ = jax.jit(lane_step_j(pj.DEFAULT_CONFIG))(LaneStateJ.initial(),
                                                        jnp.asarray(gen.generate_frame_with_vehicles()))
    assert bool(obs.left_found) and bool(obs.right_found)
    for side, fit in (("left", np.asarray(obs.left_fit)), ("right", np.asarray(obs.right_fit))):
        for y in (H * 0.99, H * 0.62):
            got = fit[0] * y * y + fit[1] * y + fit[2]
            assert abs(got - gen.lane_x_at(side, y)) < 15.0, (side, y)


def test_yolo_runner_with_frames_equals_frames_runner():
    """`make_yolo_sequence_runner` with ``use_frames=True`` on 6 road frames
    (yolov8n, seeded random weights, 160-pixel letterbox, chunks of 4):
    the frames go into the pipeline, so its outputs, lane observations and
    tags included, equal the frames runner's fed the same detection
    tables, and its lanes equal the frames runner's on the synthetic
    detections (lanes do not depend on detections)."""
    from multimodal_autonomous_driving_perception_and_planning_torch.perception.detector import (
        make_yolo_sequence_runner,
    )

    cfg = _config(pt)
    frames = RoadT(draw_adjacent_dash=True).generate_frames(6)
    ego = syn_t.ego_motion_stream(6, dt=1.0 / 30.0, seed=0).astype(np.float32)
    init_fn, run = make_yolo_sequence_runner(cfg, batch=4, score_threshold=0.05, img_size=160, device="cpu")
    params = init_fn(torch.Generator().manual_seed(0))
    _, outs_y = run(params, pt.initial_state(cfg, device="cpu"), frames, ego, keep_candidates=True)
    _, outs_f = _run_port(dict(outs_y["detections"], ego_measurement=ego, frame=frames))
    _, outs_s = _run_port(_inputs(frames))
    for k in DISCRETE + FLOAT:
        np.testing.assert_array_equal(outs_y[k].numpy(), outs_f[k].numpy(), err_msg=k)
    for k, v in outs_f["tags"].items():
        np.testing.assert_array_equal(outs_y["tags"][k].numpy(), v.numpy(), err_msg=k)
    for lane in (outs_f["lane_obs"], outs_s["lane_obs"]):
        for k in ("left_fit", "right_fit", "left_found", "right_found", "left_confidence", "right_confidence",
                  "offset_px", "has_offset"):
            np.testing.assert_array_equal(getattr(outs_y["lane_obs"], k).numpy(), getattr(lane, k).numpy(), err_msg=k)
    assert outs_y["lane_obs"].left_found.all()
