"""tests/test_config_sweep.py's six non-default configurations, the port
against the JAX package.

Each case changes capacities, windows or knobs away from their defaults
(the five detections-mode mutations, and the frames case at 96x128 with a
90-theta Hough grid, scene refinement and other lane knobs) and runs the
same numpy inputs through the jitted JAX runner and the port's runner on
the CPU.  Every discrete output and tag must be equal; floats within atol
1e-4 (TTC tags rtol 1e-5 on top); ``plan_order`` sorts JAX's costs within
1e-4 (mirror-image candidates tie to about 1e-9, ROADMAP §3); the lane
fits by the x they give at three rows within 1e-3 px.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn_t
from multimodal_autonomous_driving_perception_and_planning_tpu.data.frames import SyntheticRoadGenerator

ATOL = 1e-4
TTC_RTOL = 1e-5
X_ATOL = 1e-3
LANE_FITS = ("left_fit", "right_fit")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _replace(node, **kw):
    return dataclasses.replace(node, **kw)


SWEEP = {
    "tracker": lambda c: c.replace(
        tracker=_replace(c.tracker, max_tracks=24, trajectory_length=7, min_hits=1, max_age=2)
    ),
    "detector": lambda c: c.replace(detector=_replace(c.detector, max_detections=9)),
    "tagging": lambda c: c.replace(
        tagging=_replace(c.tagging, interaction_history=12, maneuver_history=18, scene_smoothing_window=3,
                         fps=25.0)
    ),
    "planner": lambda c: c.replace(
        planner=_replace(c.planner, num_samples=5, target_velocities=(9.0, 11.0), max_obstacles=4,
                         max_reference_points=16)
    ),
    "estimator": lambda c: c.replace(
        estimator=_replace(c.estimator, dt=0.04, process_noise=0.2, measurement_noise=0.5)
    ),
}


def _frames_config(pkg, h, w):
    cfg = pkg.DEFAULT_CONFIG.replace(use_frames=True, enable_tagging=True, frame_height=h, frame_width=w)
    return cfg.replace(
        lanes=_replace(cfg.lanes, num_thetas=90, max_lines=12, lane_edge_capacity=512, scene_edge_capacity=768,
                       roi_top_y_frac=0.5, roi_bottom_frac=0.05, min_abs_slope=0.25, scene_downsample=1,
                       scene_refine=True, num_lane_points=20),
        tagging=_replace(cfg.tagging, interaction_history=10),
    )


def _inputs(cfg, num_frames, frames=None):
    dets = syn_t.simulated_detection_stream(num_frames, height=cfg.frame_height, width=cfg.frame_width,
                                            capacity=cfg.detector.max_detections)
    inputs = dict(dets, ego_measurement=syn_t.ego_motion_stream(num_frames, seed=0).astype(np.float32))
    if frames is not None:
        inputs["frame"] = frames
    return inputs


def _run_both(cfg_j, cfg_t, inputs):
    _, outs_j = pj.make_sequence_runner(cfg_j, donate=False)(
        pj.initial_state(cfg_j), {k: jnp.asarray(v) for k, v in inputs.items()}
    )
    _, outs_t = pt.make_sequence_runner(cfg_t, device="cpu")(pt.initial_state(cfg_t, device="cpu"), inputs)
    return outs_t, outs_j


def _assert_close(a, b, key):
    assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
    if b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=TTC_RTOL if "ttc" in key else 0.0, atol=ATOL, err_msg=key)
    else:
        np.testing.assert_array_equal(a, b, err_msg=key)


def _assert_outs_match(outs_t, outs_j, height):
    assert set(outs_t) == set(outs_j)
    for k in sorted(outs_j):
        if k == "tags":
            assert set(outs_t[k]) == set(outs_j[k]) and len(outs_j[k]) == 43
            for tag in outs_j[k]:
                _assert_close(outs_t[k][tag].numpy(), np.asarray(outs_j[k][tag]), f"tags.{tag}")
        elif k in ("vehicle_state", "lane_obs"):
            for f in dataclasses.fields(outs_t[k]):
                a, b = getattr(outs_t[k], f.name).numpy(), np.asarray(getattr(outs_j[k], f.name))
                if f.name not in LANE_FITS:
                    _assert_close(a, b, f"{k}.{f.name}")
                    continue
                for y in (height, 0.8 * height, 0.6 * height):
                    xa = (a[:, 0].astype(np.float64) * y + a[:, 1]) * y + a[:, 2]
                    xb = (b[:, 0].astype(np.float64) * y + b[:, 1]) * y + b[:, 2]
                    np.testing.assert_allclose(xa, xb, rtol=0, atol=X_ATOL, err_msg=f"{f.name} x at row {y}")
        elif k == "plan_order":
            order_t, order_j = outs_t[k].numpy(), np.asarray(outs_j[k])
            assert order_t.dtype == order_j.dtype
            np.testing.assert_array_equal(np.sort(order_t, axis=1), np.sort(order_j, axis=1))
            costs = np.asarray(outs_j["plan_costs"])
            np.testing.assert_allclose(np.take_along_axis(costs, order_t, axis=1),
                                       np.take_along_axis(costs, order_j, axis=1), rtol=0, atol=ATOL,
                                       err_msg="plan_order")
        else:
            _assert_close(outs_t[k].numpy(), np.asarray(outs_j[k]), k)


@pytest.mark.parametrize("mutate", list(SWEEP))
def test_detections_mode_nondefault_configs(mutate):
    cfg_j = SWEEP[mutate](pj.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True))
    cfg_t = SWEEP[mutate](pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True))
    outs_t, outs_j = _run_both(cfg_j, cfg_t, _inputs(cfg_t, 20))
    assert outs_t["plan_best"].shape == (20,)
    _assert_outs_match(outs_t, outs_j, cfg_t.frame_height)


def test_frames_mode_nondefault_configs():
    """The lane and scene knobs (pool caps, the 90-theta grid, ROI
    fractions, downsample, refinement) through the whole image stack."""
    h, w, n = 96, 128, 6
    frames = np.ascontiguousarray(SyntheticRoadGenerator(width=w, height=h).generate_frames(n))
    cfg_t = _frames_config(pt, h, w)
    outs_t, outs_j = _run_both(_frames_config(pj, h, w), cfg_t, _inputs(cfg_t, n, frames))
    assert "lane_obs" in outs_t and outs_t["lane_obs"].left_fit.shape == (n, 3)
    _assert_outs_match(outs_t, outs_j, h)
