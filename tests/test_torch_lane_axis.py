"""The lane axis through kernels K1, K2 and K3, the planner and the runner,
on the CPU.

On the card each of the three kernels runs B lanes in one launch of B
blocks, every field (B, ...) contiguous; the wrappers carve the outputs
field by field, each field B lanes long, so that the kernels' per-lane
offsets (b times a field's size a lane) land inside it.  These tests hold
that host side, and hold the plain versions with a lane axis (what the CPU
runs) equal to B unbatched calls bit for bit; the card's runs in
chip_smoke.py and tests/test_torch_cuda_kernels.py hold the kernels to the
same.
"""

import math

import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn
from multimodal_autonomous_driving_perception_and_planning_torch.estimation.ego import estimator_step_row
from multimodal_autonomous_driving_perception_and_planning_torch.ops import kalman_kernel, tagging_kernel, tracker_kernel
from multimodal_autonomous_driving_perception_and_planning_torch.ops.kalman import make_constant_accel_model
from multimodal_autonomous_driving_perception_and_planning_torch.planning.planner import plan
from multimodal_autonomous_driving_perception_and_planning_torch.tagging.rules import make_packed_tagging_step
from multimodal_autonomous_driving_perception_and_planning_torch.tracking.tracker import tracker_update_with_order
from multimodal_autonomous_driving_perception_and_planning_torch.types import (
    Detections,
    lane_of,
    stack_lanes,
    tree_leaves,
    vehicle_row,
)
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import kalman_model_from_numpy

CFG = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True, emit_candidates=False, emit_trajectories=False)


def _check_lane_fields(buf, names, shapes, fields, B):
    """Field k starts at the sum of the earlier fields' B-lane sizes, each
    rounded up to 4 elements (the kernels' `carve`), and holds B lanes."""
    at = 0
    for name, shape in zip(names, shapes):
        t = fields[name]
        assert tuple(t.shape) == (B, *shape) and t.is_contiguous(), name
        assert t.data_ptr() - buf.data_ptr() == at * buf.element_size(), name
        at += -(-B * math.prod(shape) // 4) * 4
    assert at <= buf.numel()


@pytest.mark.parametrize("B", [1, 3, 8, 64])
def test_lane_output_fields(B):
    T, L = 64, 50
    fbuf, ibuf, out = tracker_kernel.output_fields(T, L, "cpu", (B,))
    f_shapes, i_shapes = tracker_kernel.output_shapes(T, L)
    _check_lane_fields(fbuf, tracker_kernel.FLOAT_FIELDS, f_shapes, out, B)
    _check_lane_fields(ibuf, tracker_kernel.INT_FIELDS, i_shapes, out, B)

    W, H, HI = 5, 30, 30
    fbuf, ibuf, out = tagging_kernel.output_fields(T, W, H, HI, "cpu", (B,))
    f_shapes, i_shapes = tagging_kernel.output_shapes(T, W, H, HI)
    _check_lane_fields(fbuf, tagging_kernel.FLOAT_FIELDS, f_shapes, out, B)
    _check_lane_fields(ibuf, tagging_kernel.INT_FIELDS, i_shapes, out, B)

    buf, fields = kalman_kernel.output_fields("cpu", (B,))
    names = ("x", "P", "vs", "time", "heading", "speed")
    _check_lane_fields(buf, names, kalman_kernel.OUTPUT_SHAPES, dict(zip(names, fields)), B)


def _lane_inputs(B, frames, seed=0):
    """B distinct synthetic streams stepped ``frames`` times through the
    plain runner: per-lane tables, detections and vehicle rows to feed the
    three stages."""
    run = pt.make_sequence_runner(CFG, device="cpu")
    states, dets, rows = [], [], []
    for b in range(B):
        d = syn.simulated_detection_stream(frames + 1, start_frame_count=1 + 5 * b + seed)
        e = syn.ego_motion_stream(frames + 1, seed=b + seed).astype(np.float32)
        state, outs = run(pt.initial_state(CFG, device="cpu"), dict({k: v[:frames] for k, v in d.items()},
                                                                    ego_measurement=e[:frames]))
        states.append(state)
        dets.append(Detections(**{k: torch.from_numpy(v[frames]) for k, v in d.items()}))
        rows.append(torch.from_numpy(e[frames]))
    return states, dets, rows


def _assert_lane_equal(batched, b, single):
    for got, want in zip(tree_leaves(lane_of(batched, b)), tree_leaves(single)):
        assert got.dtype == want.dtype and torch.equal(got, want), b


def _assert_lanes_equal(batched, singles):
    for b, single in enumerate(singles):
        _assert_lane_equal(batched, b, single)


def test_plain_stages_with_a_lane_axis_equal_unbatched_calls():
    """K1's, K2's and K3's plain versions over (B, ...) inputs give each
    lane exactly its unbatched call's result."""
    B = 3
    states, dets, zs = _lane_inputs(B, 15)
    tables = [s.tracks for s in states]
    got = tracker_update_with_order(stack_lanes(tables), stack_lanes(dets), CFG.tracker)
    want = [tracker_update_with_order(t, d, CFG.tracker) for t, d in zip(tables, dets)]
    for i in range(4):
        _assert_lanes_equal(got[i], [w[i] for w in want])

    model = kalman_model_from_numpy(*make_constant_accel_model(CFG.estimator.dt), device="cpu")
    ks = [s.kalman for s in states]
    has = torch.tensor([True, False, True])
    got_k, got_row = estimator_step_row(stack_lanes(ks), model, torch.stack(zs), has, CFG.estimator)
    for b in range(B):
        want_k, want_row = estimator_step_row(ks[b], model, zs[b], has[b], CFG.estimator)
        _assert_lane_equal(got_k, b, want_k)
        assert torch.equal(got_row[b], want_row)
    # A scalar has-measurement flag applies to every lane.
    _, all_rows = estimator_step_row(stack_lanes(ks), model, torch.stack(zs), True, CFG.estimator)
    assert all_rows.shape == (B, 11)

    step = make_packed_tagging_step(CFG)
    tagging = [s.tagging for s in states]
    got_t = step(stack_lanes(tagging), stack_lanes(dets), stack_lanes(tables), got_row)
    for b in range(B):
        want_t = step(tagging[b], dets[b], tables[b], got_row[b])
        for g, w in zip(got_t, want_t):
            _assert_lane_equal(g, b, w)


def test_vehicle_row_keeps_a_lane_axis():
    rows = torch.arange(33, dtype=torch.float32).reshape(3, 11)
    vs = pt.pipeline.vehicle_state_from_row(rows)
    assert vs.x.shape == (3,) and torch.equal(vehicle_row(vs), rows)


def test_planner_with_a_lane_axis_equals_unbatched_plans():
    """The planner's tensor ops over (B, 4) start states: each lane's costs
    equal its unbatched plan's, and its best candidate too."""
    rng = np.random.default_rng(5)
    starts = torch.from_numpy(
        np.stack([rng.uniform(-50, 50, 6), rng.uniform(-50, 50, 6), rng.uniform(-3, 3, 6), rng.uniform(0, 20, 6)],
                 axis=-1).astype(np.float32)
    )
    obstacles = torch.from_numpy(rng.uniform(0, 30, (6, 4, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(6, 4)) > 0.3)
    got = plan(starts, CFG.planner, obstacles=obstacles, obstacles_valid=valid)
    assert got.costs.shape == (6, CFG.planner.num_candidates) and got.positions.shape[:2] == got.costs.shape
    for b in range(6):
        want = plan(starts[b], CFG.planner, obstacles=obstacles[b], obstacles_valid=valid[b])
        assert torch.equal(got.best[b], want.best)
        np.testing.assert_allclose(got.costs[b].numpy(), want.costs.numpy(), rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(got.positions[b].numpy(), want.positions.numpy(), rtol=0, atol=1e-4)


def test_batched_runner_equals_unbatched_runs():
    """`make_batched_sequence_runner` over 3 distinct streams: each lane's
    outputs, tags and final state are its unbatched run's, bit for bit."""
    B, F = 3, 10
    streams = []
    for b in range(B):
        d = syn.simulated_detection_stream(F, start_frame_count=1 + 9 * b)
        streams.append(dict(d, ego_measurement=syn.ego_motion_stream(F, seed=b).astype(np.float32)))
    run = pt.make_sequence_runner(CFG, device="cpu")
    brun = pt.make_batched_sequence_runner(CFG, device="cpu")
    state = stack_lanes([pt.initial_state(CFG, device="cpu")] * B)
    final, outs = brun(state, {k: np.stack([s[k] for s in streams]) for k in streams[0]})
    assert outs["track_id"].shape == (B, F, CFG.tracker.max_tracks)
    for b in range(B):
        final_b, want = run(pt.initial_state(CFG, device="cpu"), streams[b])
        _assert_lane_equal(final, b, final_b)
        for k, v in want.items():
            if k == "tags":
                for tk, tv in v.items():
                    assert torch.equal(outs["tags"][tk][b], tv), tk
            elif k == "vehicle_state":
                _assert_lane_equal(outs[k], b, v)
            else:
                assert torch.equal(outs[k][b], v), k


def test_batched_runner_refuses_mismatched_lanes():
    brun = pt.make_batched_sequence_runner(CFG, device="cpu")
    d = syn.simulated_detection_stream(2)
    inputs = {k: np.stack([v, v]) for k, v in dict(d, ego_measurement=np.zeros((2, 4), np.float32)).items()}
    with pytest.raises(ValueError, match="lane axis"):
        brun(pt.initial_state(CFG, device="cpu"), inputs)
    with pytest.raises(ValueError, match="leading lane axis of 3"):
        brun(stack_lanes([pt.initial_state(CFG, device="cpu")] * 3), inputs)
    with pytest.raises(ValueError, match="unbatched state"):
        pt.make_sequence_runner(CFG, device="cpu")(stack_lanes([pt.initial_state(CFG, device="cpu")] * 2),
                                                     {k: v[0] for k, v in inputs.items()})
