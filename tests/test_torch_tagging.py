"""The PyTorch port's tagging stage against the JAX package's.

The same numpy inputs go through the JAX tagging step (its XLA rule engines,
and its Pallas kernel K3 in the interpreter) and the port's plain version,
with the state threaded through each side on its own, so that one
divergence compounds and cannot hide.  Discrete tags must be equal, floats
within 1e-5 and the state within 1e-6 (tests/test_tagging_pallas.py's
bars).  The runner with tagging on is held to the JAX runner over the
300-frame synthetic stream: every tag key and dtype, discrete tags exact,
floats within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch import types as tt
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn_t
from multimodal_autonomous_driving_perception_and_planning_torch.ops import tagging_kernel
from multimodal_autonomous_driving_perception_and_planning_torch.tagging import rules as rules_t
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import (
    state_from_numpy,
    state_to_numpy,
)
from multimodal_autonomous_driving_perception_and_planning_tpu import types as tj
from multimodal_autonomous_driving_perception_and_planning_tpu.tagging.rules import (
    make_tagging_step as make_jax_tagging_step,
)

_T = pt.DEFAULT_CONFIG.tracker.max_tracks
_D = 16
_STATE_FIELDS = (
    "scene_votes", "scene_count", "man_history", "man_count",
    "int_centers", "int_len", "int_track_id", "frame_count",
)


def _rand_frame(rng, f):
    """tests/test_tagging_pallas.py `_rand_frame`, as numpy arrays."""
    n = int(rng.integers(0, _D))
    valid = np.zeros(_D, bool)
    valid[:n] = True
    x1, y1 = rng.uniform(0, 600, _D), rng.uniform(0, 440, _D)
    bw, bh = rng.uniform(5, 80, _D), rng.uniform(5, 80, _D)
    dets = dict(
        bbox=np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32),
        class_id=rng.integers(0, 8, _D).astype(np.int32),
        confidence=rng.uniform(0.3, 1.0, _D).astype(np.float32),
        valid=valid,
    )
    alive = rng.random(_T) < 0.4
    tx1, ty1 = rng.uniform(0, 600, _T), rng.uniform(0, 440, _T)
    tw, th = rng.uniform(5, 120, _T), rng.uniform(1, 120, _T)
    table = dict(
        track_id=np.where(alive, np.arange(1, _T + 1), 0).astype(np.int32),
        bbox=np.stack([tx1, ty1, tx1 + tw, ty1 + th], 1).astype(np.float32),
        class_id=rng.integers(0, 8, _T).astype(np.int32),
        hits=rng.integers(0, 6, _T).astype(np.int32),
        velocity=rng.normal(0, 3, (_T, 2)).astype(np.float32),
        vel_count=rng.integers(0, 3, _T).astype(np.int32),
    )
    vs = dict(
        x=rng.uniform(-50, 50), y=rng.uniform(-50, 50), vx=0.0, vy=0.0,
        heading=rng.uniform(-3.1, 3.1), speed=rng.uniform(0, 20),
        acceleration=rng.uniform(-4, 2), yaw_rate=rng.uniform(-0.4, 0.4),
        timestamp=f / 30.0, pos_uncertainty=1.0, vel_uncertainty=1.0,
    )
    vs = {k: np.float32(v) for k, v in vs.items()}
    return dets, table, vs


def _rand_lane_feats(rng):
    """tests/test_tagging_pallas.py `_rand_lane_feats`, as numpy arrays."""
    lf, rf = bool(rng.random() < 0.7), bool(rng.random() < 0.7)
    lane = dict(
        left_fit=rng.normal(0, [1e-4, 0.3, 200]).astype(np.float32),
        right_fit=rng.normal([0, 0, 450], [1e-4, 0.3, 100]).astype(np.float32),
        left_found=np.bool_(lf),
        right_found=np.bool_(rf),
        left_confidence=np.float32(rng.uniform(0, 1)),
        right_confidence=np.float32(rng.uniform(0, 1)),
        offset_px=np.float32(rng.normal(0, 10)),
        has_offset=np.bool_(lf and rf),
    )
    feats = {
        "center_edge_density": np.float32(rng.uniform(0, 0.4)),
        "num_long_lines": np.int32(rng.integers(0, 12)),
        "avg_line_length": np.float32(rng.uniform(50, 300)),
        "green_ratio": np.float32(rng.uniform(0, 0.3)),
        "brightness": np.float32(rng.uniform(30, 200)),
        "laplacian_var": np.float32(rng.uniform(20, 2000)),
    }
    return lane, feats


def _jax_inputs(dets, table, vs, lane, feats):
    jtable = dataclasses.replace(
        tj.TrackTable.empty(_T, pj.DEFAULT_CONFIG.tracker.trajectory_length),
        **{k: jnp.asarray(v) for k, v in table.items()},
    )
    return (
        tj.Detections(**{k: jnp.asarray(v) for k, v in dets.items()}),
        jtable,
        tj.VehicleState(**{k: jnp.asarray(v) for k, v in vs.items()}),
        None if lane is None else tj.LaneObservation(**{k: jnp.asarray(v) for k, v in lane.items()}),
        None if feats is None else {k: jnp.asarray(v) for k, v in feats.items()},
    )


def _torch_inputs(dets, table, vs, lane, feats):
    ttable = dataclasses.replace(
        tt.TrackTable.empty(_T, pt.DEFAULT_CONFIG.tracker.trajectory_length, "cpu"),
        **{k: torch.tensor(v) for k, v in table.items()},
    )
    return (
        tt.Detections(**{k: torch.tensor(v) for k, v in dets.items()}),
        ttable,
        tt.VehicleState(**{k: torch.tensor(v) for k, v in vs.items()}),
        None if lane is None else tt.LaneObservation(**{k: torch.tensor(v) for k, v in lane.items()}),
        None if feats is None else {k: torch.tensor(v) for k, v in feats.items()},
    )


def _assert_tags_match(tags_t, tags_j, atol, where):
    assert set(tags_t) == set(tags_j), set(tags_t) ^ set(tags_j)
    for k in sorted(tags_j):
        got, want = tags_t[k].numpy(), np.asarray(tags_j[k])
        assert got.dtype == want.dtype and got.shape == want.shape, (where, k, got.dtype, want.dtype)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"{where}: {k}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{where}: {k}")


def _assert_states_match(st_t, st_j, where):
    for fld in _STATE_FIELDS:
        got, want = getattr(st_t, fld).numpy(), np.asarray(getattr(st_j, fld))
        assert got.dtype == want.dtype, (where, fld)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"{where}: {fld}")


def _run_stream(jax_step, frames, seed, frames_mode, frame=_rand_frame, corners=None):
    cfg_t = pt.DEFAULT_CONFIG.replace(use_frames=frames_mode, enable_tagging=True)
    step_t = rules_t.make_tagging_step(cfg_t)
    state_j = tj.TaggingState.initial(
        pj.DEFAULT_CONFIG.tagging.scene_smoothing_window, pj.DEFAULT_CONFIG.tagging.maneuver_history, _T
    )
    state_t = tt.TaggingState.initial(
        cfg_t.tagging.scene_smoothing_window, cfg_t.tagging.maneuver_history, _T, "cpu"
    )
    seen = {"road_type_raw": set(), "turning": set(), "primary_interaction": set()}
    rng = np.random.default_rng(seed)
    for f in range(frames):
        dets, table, vs = frame(rng, f)
        lane, feats = _rand_lane_feats(rng) if frames_mode else (None, None)
        dj, tab_j, vj, lj, fj = _jax_inputs(dets, table, vs, lane, feats)
        dt, tab_t, vt, lt, ft = _torch_inputs(dets, table, vs, lane, feats)
        state_j, tags_j = jax_step(state_j, dj, tab_j, None, None, vj, lj, fj)
        state_t, tags_t = step_t(state_t, dt, tab_t, None, None, vt, lt, ft)
        _assert_tags_match(tags_t, tags_j, 1e-5, f"frame {f}")
        _assert_states_match(state_t, state_j, f"frame {f}")
        for k in seen:
            seen[k].add(int(tags_t[k]))
        if corners is not None:
            hits = chip_smoke.aggregate_corners(tags_t, tab_t, state_t.int_len, cfg_t.tagging.interaction_history)
            for k, hit in hits.items():
                corners[k] = corners.get(k, 0) + hit
    return seen


@pytest.mark.parametrize("frames_mode", [False, True], ids=["detections", "frames"])
def test_plain_step_matches_jax_rules(frames_mode):
    """The plain version against the JAX XLA rule engines: 120 random frames
    in detections mode, 60 in frames mode."""
    cfg_j = pj.DEFAULT_CONFIG.replace(use_frames=frames_mode, enable_tagging=True)
    jax_step = jax.jit(make_jax_tagging_step(cfg_j, backend="cpu"))
    seen = _run_stream(jax_step, 60 if frames_mode else 120, 11 if frames_mode else 7, frames_mode)
    # The random streams reach the branches the synthetic stream leaves
    # untested: other road types, turning, more interaction types.
    assert len(seen["road_type_raw"]) >= 2 and len(seen["turning"]) >= 4
    assert len(seen["primary_interaction"]) >= 4


@pytest.mark.parametrize("frames_mode", [False, True], ids=["detections", "frames"])
def test_plain_step_matches_jax_rules_on_crafted_stream(frames_mode):
    """chip_smoke.py's crafted stream, which K3 is held to its plain version
    on: all six interaction types the cascade gives in one frame, ties on
    (risk, confidence) decided by id, equal minimum TTC in several slots,
    center rings past their wrap.  Here the plain version against the JAX
    XLA rule engines over 40 frames; every corner must be reached."""
    cfg_j = pj.DEFAULT_CONFIG.replace(use_frames=frames_mode, enable_tagging=True)
    jax_step = jax.jit(make_jax_tagging_step(cfg_j, backend="cpu"))
    corners = {}
    _run_stream(jax_step, 40, 17, frames_mode,
                frame=lambda rng, f: chip_smoke.crafted_tagging_arrays(rng, f, _T, _D), corners=corners)
    assert all(corners.values()) and len(corners) == 4, corners


def test_plain_step_matches_jax_kernel_interpreted():
    """The plain version against the JAX package's K3 itself, run through the
    Pallas interpreter, over 30 random frames in detections mode."""
    cfg_j = pj.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    jax_step = jax.jit(make_jax_tagging_step(cfg_j, backend="cpu", interpret=True))
    _run_stream(jax_step, 30, 5, False)


def _runner_inputs(num_frames):
    dets = syn_t.simulated_detection_stream(num_frames)
    ego = syn_t.ego_motion_stream(num_frames, dt=1.0 / 30.0, seed=0).astype(np.float32)
    return dict(dets, ego_measurement=ego)


def _tagging_config(pkg):
    """apps/serve.py:731-732's configuration with serving outputs."""
    return pkg.DEFAULT_CONFIG.replace(
        use_frames=False, enable_tagging=True, emit_candidates=False, emit_trajectories=False
    )


def _run_jax(inputs, state=None):
    cfg = _tagging_config(pj)
    state = pj.initial_state(cfg) if state is None else state
    return pj.make_sequence_runner(cfg, donate=False)(state, {k: jnp.asarray(v) for k, v in inputs.items()})


def _run_torch(inputs, state=None):
    cfg = _tagging_config(pt)
    state = pt.initial_state(cfg, device="cpu") if state is None else state
    return pt.make_sequence_runner(cfg, device="cpu")(state, inputs)


def test_runner_with_tagging_matches_jax_300_frames():
    """The 43 tag keys with the JAX dtypes; discrete tags exact, floats at the
    runner's 1e-4 budget; the tracks as before."""
    inputs = _runner_inputs(300)
    _, outs_j = _run_jax(inputs)
    _, outs_t = _run_torch(inputs)
    assert len(outs_j["tags"]) == 43
    _assert_tags_match(outs_t["tags"], outs_j["tags"], 1e-4, "runner")
    for k in ("track_id", "match", "confirmed_order", "num_confirmed", "plan_best"):
        np.testing.assert_array_equal(outs_t[k].numpy(), np.asarray(outs_j[k]), err_msg=k)
    assert outs_t["tags"]["agent_count"].max() > 0


def test_resume_with_tagging_through_convert():
    """100 frames in the JAX package with tagging on, the state handed over
    through utils/convert.py, the next 50 frames in the port."""
    inputs = _runner_inputs(150)
    first = {k: v[:100] for k, v in inputs.items()}
    rest = {k: v[100:] for k, v in inputs.items()}
    mid_j, _ = _run_jax(first)
    final_j, outs_j = _run_jax(rest, state=mid_j)
    mid_np = jax.tree_util.tree_map(np.asarray, mid_j)
    assert int(mid_np.tagging.frame_count) == 100
    final_t, outs_t = _run_torch(rest, state=state_from_numpy(mid_np, "cpu"))
    _assert_tags_match(outs_t["tags"], outs_j["tags"], 1e-4, "resumed")
    got = state_to_numpy(final_t)["tagging"]
    for fld in _STATE_FIELDS:
        want = np.asarray(getattr(final_j.tagging, fld))
        assert got[fld].dtype == want.dtype, fld
        np.testing.assert_allclose(got[fld], want, rtol=0, atol=1e-4, err_msg=fld)


def test_pipeline_step_tags_equal_the_runner():
    """`make_pipeline_step` unpacks each frame's tags; they equal the
    runner's, which unpacks once after the loop."""
    cfg = _tagging_config(pt)
    inputs = _runner_inputs(12)
    _, outs = _run_torch(inputs)
    step = pt.make_pipeline_step(cfg, device="cpu")
    state = pt.initial_state(cfg, device="cpu")
    for f in range(12):
        frame = {
            "detections": pt.detections_from_arrays(
                {k: inputs[k][f] for k in ("bbox", "class_id", "confidence", "valid")}, "cpu"
            ),
            "ego_measurement": torch.tensor(inputs["ego_measurement"][f]),
        }
        state, out = step(state, frame)
        assert set(out["tags"]) == set(outs["tags"])
        for k, v in out["tags"].items():
            assert v.dtype == outs["tags"][k].dtype, k
            assert torch.equal(v, outs["tags"][k][f]), (f, k)
    assert int(state.tagging.frame_count) == 12


def test_packed_layout_covers_every_tag_once():
    names = [n for n, _ in tagging_kernel.FLOAT_TAGS + tagging_kernel.INT_TAGS]
    assert len(names) == len(set(names)) == 43
    assert tagging_kernel.FLOAT_TAGS[:12] == tuple((k, 1) for k in tagging_kernel.SF)
    assert tagging_kernel.INT_TAGS[:21] == tuple((k, 1) for k in tagging_kernel.SI)
    assert tagging_kernel.BOOL_TAGS <= set(names)
    rules = rules_t.TaggingRules.from_config(pt.DEFAULT_CONFIG)
    assert rules.params.shape == (len(tagging_kernel.PARAM_NAMES),)
    assert rules["inv_frame_height"] == float(np.float32(1) / np.float32(480))


def test_mixed_frames_inputs_raise():
    """A lane observation without scene features (or the reverse) never
    comes from the pipeline; the step refuses it."""
    step = rules_t.make_tagging_step(pt.DEFAULT_CONFIG)
    dets, table, vs = _rand_frame(np.random.default_rng(0), 0)
    lane, feats = _rand_lane_feats(np.random.default_rng(1))
    dt, tab_t, vt, lt, ft = _torch_inputs(dets, table, vs, lane, feats)
    state = tt.TaggingState.initial(5, 30, _T, "cpu")
    with pytest.raises(ValueError, match="come together"):
        step(state, dt, tab_t, None, None, vt, lt, None)
    with pytest.raises(ValueError, match="come together"):
        step(state, dt, tab_t, None, None, vt, None, ft)


def test_kernel_wrapper_refuses_cpu_tensors():
    dets, table, vs = _rand_frame(np.random.default_rng(0), 0)
    dt, tab_t, vt, _, _ = _torch_inputs(dets, table, vs, None, None)
    rules = rules_t.TaggingRules.from_config(pt.DEFAULT_CONFIG)
    state = tt.TaggingState.initial(5, 30, _T, "cpu")
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        tagging_kernel.tagging_step(rules, state, dt, tab_t, tt.vehicle_row(vt))


def test_vehicle_state_row_round_trip():
    """The pipeline carries K2's (11,) row as it is: its VehicleState holds
    views of the row, and `vehicle_row` stacks any state into such a row."""
    row = torch.arange(11, dtype=torch.float32)
    vs = tt.vehicle_state_from_row(row)
    assert vs.speed.data_ptr() == row[5].data_ptr()
    assert torch.equal(tt.vehicle_row(vs), row)
    loose = tt.VehicleState(*[torch.tensor(float(i)) for i in range(11)])
    assert torch.equal(tt.vehicle_row(loose), row)
