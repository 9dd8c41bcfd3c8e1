"""Checkpoint and resume (utils/checkpoint.py) and the state's leaves in
the JAX package's order (types.tree_leaves, utils.convert.state_from_leaves),
on the CPU.

The case of tests/test_utils.py `test_checkpoint_resume_is_exact`: 40
frames straight against 20, a save and a restore, then 20 more.  The leaf
order is held to ``jax.tree_util.tree_leaves`` of the same state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn
from multimodal_autonomous_driving_perception_and_planning_torch.types import tree_leaves, tree_unflatten
from multimodal_autonomous_driving_perception_and_planning_torch.utils.checkpoint import (
    restore_pipeline_state,
    save_pipeline_state,
)
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import (
    state_from_leaves,
    state_from_numpy,
)

CFG = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)


def _inputs(start, n):
    dets = syn.simulated_detection_stream(n, start_frame_count=start + 1)
    ego = syn.ego_motion_stream(start + n, seed=0)[start:]
    return dict(dets, ego_measurement=ego.astype(np.float32))


def _run(state, start, n):
    return pt.make_sequence_runner(CFG, device="cpu")(state, _inputs(start, n))


def test_checkpoint_resume_is_exact(tmp_path):
    """40 frames straight against 20 + checkpoint/restore + 20: identical."""
    final_a, outs_a = _run(pt.initial_state(CFG, device="cpu"), 0, 40)
    mid, _ = _run(pt.initial_state(CFG, device="cpu"), 0, 20)
    ckpt = tmp_path / "ckpt"
    save_pipeline_state(str(ckpt), mid)
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt"]  # no temporary file left
    restored = restore_pipeline_state(str(ckpt), pt.initial_state(CFG, device="cpu"))
    for a, b in zip(tree_leaves(mid), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    final_b, outs_b = _run(restored, 20, 20)
    assert torch.equal(outs_a["track_id"][20:], outs_b["track_id"])
    assert torch.equal(outs_a["plan_costs"][20:], outs_b["plan_costs"])
    for k, v in outs_b["tags"].items():
        assert torch.equal(outs_a["tags"][k][20:], v), k
    for a, b in zip(tree_leaves(final_a), tree_leaves(final_b)):
        assert torch.equal(a, b)


def test_checkpoint_overwrites_and_refuses_another_template(tmp_path):
    ckpt = tmp_path / "state.pt"
    save_pipeline_state(str(ckpt), pt.initial_state(CFG, device="cpu"))
    mid, _ = _run(pt.initial_state(CFG, device="cpu"), 0, 5)
    save_pipeline_state(str(ckpt), mid)  # replaces the file in one step
    restored = restore_pipeline_state(str(ckpt), pt.initial_state(CFG, device="cpu"))
    assert int(restored.frame_idx) == 5
    other = pt.DEFAULT_CONFIG.replace(tracker=pt.TrackerConfig(max_tracks=32))
    with pytest.raises(ValueError, match="expected shape"):
        restore_pipeline_state(str(ckpt), pt.initial_state(other, device="cpu"))


def test_state_leaves_follow_jax_order():
    """The port's leaves of a state are JAX's leaves of the same state, one
    for one (a state past 12 frames, so that the leaves' values differ)."""
    cfg_j = pj.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
    run = pj.make_sequence_runner(cfg_j, donate=False)
    state_j, _ = run(pj.initial_state(cfg_j), {k: jnp.asarray(v) for k, v in _inputs(0, 12).items()})
    leaves_j = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(state_j)]
    state_t = state_from_numpy(jax.tree_util.tree_map(np.asarray, state_j), "cpu")
    leaves_t = tree_leaves(state_t)
    assert len(leaves_t) == len(leaves_j) == 30
    for i, (a, b) in enumerate(zip(leaves_t, leaves_j)):
        assert a.numpy().dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"leaf{i}")
    # And back: JAX's leaves into the port's state, and the port's into JAX's.
    again = state_from_leaves(leaves_j, pt.initial_state(CFG, device="cpu"))
    for a, b in zip(tree_leaves(again), leaves_t):
        assert torch.equal(a, b)
    treedef = jax.tree_util.tree_structure(state_j)
    back = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a.numpy()) for a in leaves_t])
    for a, b in zip(jax.tree_util.tree_leaves(back), leaves_j):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_tree_unflatten_refuses_extra_leaves():
    template = pt.initial_state(CFG, device="cpu")
    leaves = tree_leaves(template)
    assert tree_unflatten(template, leaves) == template
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(template, leaves + [torch.zeros(())])
    with pytest.raises(ValueError, match="expected 30 state leaves"):
        state_from_leaves(leaves[:-1], template)
