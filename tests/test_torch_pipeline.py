"""The PyTorch port's detections-mode runner against the JAX package's.

Both packages run the 300-frame synthetic stream (bench.py's
configuration) from the same numpy inputs.  Discrete outputs must be
bit-identical; floats agree at atol 1e-4, the PARITY.md budget.  The port
runs its kernels' plain versions here (``device="cpu"``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn_t
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import (
    state_from_numpy,
    state_to_numpy,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.data import synthetic as syn_j

_DISCRETE = (
    "track_id", "track_class_id", "track_hits", "track_misses", "track_age",
    "track_vel_count", "confirmed_order", "num_confirmed", "match", "plan_best",
    "track_traj_len",
)
_FLOAT = (
    "track_bbox", "track_confidence", "track_velocity", "plan_costs",
    "plan_best_positions", "plan_best_velocities", "track_trajectory",
    "plan_positions", "plan_velocities", "plan_lateral_offsets",
)
_VS_FIELDS = (
    "x", "y", "vx", "vy", "heading", "speed", "acceleration", "yaw_rate",
    "timestamp", "pos_uncertainty", "vel_uncertainty",
)
ATOL = 1e-4


def _config(pkg, **kw):
    return pkg.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=False, **kw)


def _inputs(num_frames, start_frame_count=1):
    dets = syn_t.simulated_detection_stream(num_frames, start_frame_count=start_frame_count)
    ego = syn_t.ego_motion_stream(num_frames, dt=1.0 / 30.0, seed=0).astype(np.float32)
    return dict(dets, ego_measurement=ego)


def _run_jax(inputs, state=None, **cfg_kw):
    cfg = _config(pj, **cfg_kw)
    run = pj.make_sequence_runner(cfg, donate=False)
    state = pj.initial_state(cfg) if state is None else state
    final, outs = run(state, {k: jnp.asarray(v) for k, v in inputs.items()})
    return final, outs


def _run_torch(inputs, state=None, **cfg_kw):
    cfg = _config(pt, **cfg_kw)
    run = pt.make_sequence_runner(cfg, device="cpu")
    state = pt.initial_state(cfg, device="cpu") if state is None else state
    return run(state, inputs)


def _assert_outs_match(outs_t, outs_j, cost_rtol=0.0):
    assert outs_t["tags"] == {} and outs_j["tags"] == {}
    assert set(outs_t) == set(outs_j)
    for k in _DISCRETE:
        if k in outs_j:
            got, want = outs_t[k].numpy(), np.asarray(outs_j[k])
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
    for k in _FLOAT:
        if k in outs_j:
            got, want = outs_t[k].numpy(), np.asarray(outs_j[k])
            assert got.dtype == want.dtype and got.shape == want.shape, k
            rtol = cost_rtol if k == "plan_costs" else 0.0
            np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL, err_msg=k)
    if "plan_order" in outs_j:
        # Mirror-image candidates (+d and -d lateral offset) cost the same up
        # to float rounding (gaps near 1e-9), so the stable sort may order
        # such a pair either way: the port's order must sort the JAX costs
        # to within the tolerance, and be a permutation.
        order_t, order_j = outs_t["plan_order"].numpy(), np.asarray(outs_j["plan_order"])
        assert order_t.dtype == order_j.dtype
        np.testing.assert_array_equal(np.sort(order_t, axis=1), np.sort(order_j, axis=1))
        costs_j = np.asarray(outs_j["plan_costs"])
        np.testing.assert_allclose(
            np.take_along_axis(costs_j, order_t, axis=1),
            np.take_along_axis(costs_j, order_j, axis=1),
            rtol=0, atol=ATOL, err_msg="plan_order",
        )
    for f in _VS_FIELDS:
        np.testing.assert_allclose(
            getattr(outs_t["vehicle_state"], f).numpy(),
            np.asarray(getattr(outs_j["vehicle_state"], f)),
            rtol=0, atol=ATOL, err_msg=f"vehicle_state.{f}",
        )


@pytest.mark.parametrize("emit", [False, True], ids=["serving_outputs", "all_outputs"])
def test_runner_matches_jax_300_frames(emit):
    inputs = _inputs(300)
    kw = dict(emit_candidates=emit, emit_trajectories=emit)
    _, outs_j = _run_jax(inputs, **kw)
    _, outs_t = _run_torch(inputs, **kw)
    _assert_outs_match(outs_t, outs_j)


def test_resume_from_jax_state_through_convert():
    """100 frames in the JAX package, the state handed over through
    utils/convert.py, the next 50 frames in the port."""
    inputs = _inputs(150)
    first = {k: v[:100] for k, v in inputs.items()}
    rest = {k: v[100:] for k, v in inputs.items()}
    mid_j, _ = _run_jax(first)
    final_j, outs_j = _run_jax(rest, state=mid_j)

    mid_np = jax.tree_util.tree_map(np.asarray, mid_j)
    final_t, outs_t = _run_torch(rest, state=state_from_numpy(mid_np, "cpu"))
    _assert_outs_match(outs_t, outs_j)

    got = state_to_numpy(final_t)
    want = jax.tree_util.tree_map(np.asarray, final_j)
    for table in ("tracks", "kalman", "lanes", "tagging"):
        for name, value in got[table].items():
            ref = np.asarray(getattr(getattr(want, table), name))
            assert value.dtype == ref.dtype, (table, name)
            if np.issubdtype(ref.dtype, np.floating):
                np.testing.assert_allclose(value, ref, rtol=0, atol=ATOL, err_msg=name)
            else:
                np.testing.assert_array_equal(value, ref, err_msg=name)
    assert int(got["frame_idx"]) == int(want.frame_idx) == 150


def test_state_round_trips_through_numpy():
    cfg = _config(pt)
    state, _ = _run_torch(_inputs(5))
    back = state_from_numpy(state_to_numpy(state), "cpu")
    for a, b in zip(
        jax.tree_util.tree_leaves(state_to_numpy(state)),
        jax.tree_util.tree_leaves(state_to_numpy(back)),
    ):
        np.testing.assert_array_equal(a, b)
    assert back.tracks.track_id.shape == (cfg.tracker.max_tracks,)


def test_optional_inputs_forwarded_and_unknown_keys_raise():
    """has_measurement and obstacles reach the step in both packages (with
    the same results), and unknown keys raise."""
    T = 6
    base = _inputs(T)
    O = pt.DEFAULT_CONFIG.planner.max_obstacles
    obstacles = np.zeros((T, O, 3), np.float32)
    obstacles[:, 0] = (3.0, 0.0, 2.0)
    valid = np.zeros((T, O), bool)
    valid[:, 0] = True
    has = np.array([True, False, True, False, False, True])
    ref = np.zeros((T, 64, 2), np.float32)
    ref[:, :20, 0] = np.arange(20)
    ref[:, :20, 1] = 1.0
    ref_valid = np.zeros((T, 64), bool)
    ref_valid[:, :20] = True
    full = dict(base, obstacles=obstacles, obstacles_valid=valid, has_measurement=has,
                reference_positions=ref, reference_valid=ref_valid)
    _, outs_j = _run_jax(full)
    _, outs_t = _run_torch(full)
    # Reference-path costs reach 3e4, where float32 spacing is 2e-3: they
    # are held at 1e-6 relative (8 float32 steps) beside the 1e-4 budget.
    _assert_outs_match(outs_t, outs_j, cost_rtol=1e-6)
    _, plain = _run_torch(base)
    assert not np.allclose(plain["plan_costs"].numpy(), outs_t["plan_costs"].numpy())
    assert not np.allclose(plain["vehicle_state"].x.numpy(), outs_t["vehicle_state"].x.numpy())

    run = pt.make_sequence_runner(_config(pt), device="cpu")
    with pytest.raises(ValueError, match="unknown sequence inputs"):
        run(pt.initial_state(_config(pt), device="cpu"), dict(base, bogus=np.zeros(T)))


def test_other_configurations_refused():
    """Frames mode (the default configuration) builds, with tagging on or
    off, and so does detections mode; so does any Hough theta grid (60
    thetas: the port computes XLA's tables of every grid), and a grid of
    no theta is refused."""
    for tagging in (False, True):
        cfg = pt.DEFAULT_CONFIG.replace(enable_tagging=tagging)
        pt.make_sequence_runner(cfg, device="cpu")
        pt.make_pipeline_step(cfg, device="cpu")
        odd = cfg.replace(lanes=dataclasses.replace(cfg.lanes, num_thetas=60))
        pt.make_sequence_runner(odd, device="cpu")
        pt.make_pipeline_step(odd, device="cpu")
        empty = cfg.replace(lanes=dataclasses.replace(cfg.lanes, num_thetas=0))
        with pytest.raises(ValueError, match=r"num_thetas=0: the grid needs at least one theta"):
            pt.make_sequence_runner(empty, device="cpu")
    pt.make_sequence_runner(pt.DEFAULT_CONFIG.replace(use_frames=False), device="cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    """The default device is the card; with none they raise rather than
    carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(pt)
    for call in (
        lambda: pt.make_sequence_runner(cfg),
        lambda: pt.make_pipeline_step(cfg),
        lambda: pt.initial_state(cfg),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("start", [1, 998])
def test_synthetic_streams_bit_identical(start):
    """The port's numpy-only fixtures draw from a private RandomState and
    still equal the JAX package's global-RNG streams bit for bit (start 998
    crosses the reference's frame_count % 1000 reseed)."""
    got = syn_t.simulated_detection_stream(40, start_frame_count=start)
    want = syn_j.simulated_detection_stream(40, start_frame_count=start)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for seed in (0, 3):
        np.testing.assert_array_equal(
            syn_t.ego_motion_stream(120, seed=seed), syn_j.ego_motion_stream(120, seed=seed)
        )


def test_config_is_a_copy():
    """The port keeps its own copy of config.py; every default agrees."""
    assert dataclasses.asdict(pt.DEFAULT_CONFIG) == dataclasses.asdict(pj.DEFAULT_CONFIG)
