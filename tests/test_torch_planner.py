"""The port's planner against the JAX package's.

The constant vectors (time grid, lateral grid, quintic blend) must equal
the JAX planner's bit for bit, as XLA computes them under ``jit``; costs
agree at atol 1e-4 (and 1e-6 relative where obstacle or reference-path
terms push them into the thousands), and the chosen candidate and the
cost order agree.  Cases from tests/test_planner.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_autonomous_driving_perception_and_planning_torch.config import (
    PlannerConfig as PlannerConfigT,
)
from multimodal_autonomous_driving_perception_and_planning_torch.ops import quintic as quintic_t
from multimodal_autonomous_driving_perception_and_planning_torch.planning.planner import (
    make_reference_path as make_reference_path_t,
    plan as plan_t,
    trajectory_type as trajectory_type_t,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.config import PlannerConfig
from multimodal_autonomous_driving_perception_and_planning_tpu.planning.planner import (
    make_reference_path,
    plan,
    trajectory_type,
)

ATOL = 1e-4


def _plan_jax(state, cfg=None, **kw):
    cfg = cfg or PlannerConfig()
    return jax.jit(lambda s, kw: plan(s, cfg, **kw))(jnp.asarray(state, jnp.float32), kw)


def test_constant_vectors_bit_identical():
    cfg = PlannerConfig()
    pr = _plan_jax((1.0, 2.0, 0.1, 9.0))
    t = quintic_t.linspace_f32(0.0, cfg.planning_horizon, cfg.num_waypoints)
    np.testing.assert_array_equal(t, np.asarray(pr.timestamps))
    lat, tv = quintic_t.candidate_grid(
        cfg.num_samples, cfg.lateral_range, cfg.target_velocities, torch.device("cpu")
    )
    np.testing.assert_array_equal(lat.numpy(), np.asarray(pr.lateral_offsets))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(pr.target_velocities))

    # The blend as the jitted quintic.py:74-75 computes it ...
    blend = quintic_t.quintic_blend(t, cfg.planning_horizon)
    blend_j = jax.jit(
        lambda t: (lambda tau: 10.0 * tau**3 - 15.0 * tau**4 + 6.0 * tau**5)(
            jnp.clip(t / cfg.planning_horizon, 0.0, 1.0)
        )
    )(jnp.asarray(t))
    np.testing.assert_array_equal(blend, np.asarray(blend_j))
    # ... and as the jitted planner applies it: from the origin, heading 0,
    # a unit lateral offset's y coordinate is the blend itself.
    unit = PlannerConfig(lateral_range=1.0, num_samples=3, target_velocities=(10.0,))
    pr_unit = _plan_jax((0.0, 0.0, 0.0, 9.0), unit)
    np.testing.assert_array_equal(blend, np.asarray(pr_unit.positions)[2, :, 1])


def test_fma_f32_rounds_once():
    a = np.array([1 + 2.0**-23, 3.0, 0.1], np.float32)
    b = np.array([1 - 2.0**-23, 7.0, 10.0], np.float32)
    c = np.array([-1.0, 0.5, -1.0], np.float32)
    got = quintic_t._fma_f32(a, b, c)
    want = [np.float32(-(2.0**-46)), np.float32(21.5),
            np.float32(float(np.float64(np.float32(0.1)) * 10.0 - 1.0))]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def _assert_plans_match(pr_t, pr_j, cost_rtol=0.0):
    costs_j = np.asarray(pr_j.costs)
    np.testing.assert_allclose(pr_t.costs.numpy(), costs_j, rtol=cost_rtol, atol=ATOL)
    for name in ("positions", "velocities", "curvatures", "headings"):
        np.testing.assert_allclose(
            getattr(pr_t, name).numpy(), np.asarray(getattr(pr_j, name)),
            rtol=0, atol=ATOL, err_msg=name,
        )
    assert pr_t.best.dtype == torch.int32 and pr_t.order.dtype == torch.int32
    assert int(pr_t.best) == int(pr_j.best)
    # Mirror-image candidates cost the same up to rounding: where the JAX
    # order and the port's differ, they differ only among such near-ties.
    order_t, order_j = pr_t.order.numpy(), np.asarray(pr_j.order)
    np.testing.assert_array_equal(np.sort(order_t), np.arange(order_t.size))
    np.testing.assert_allclose(
        costs_j[order_t], costs_j[order_j], rtol=cost_rtol, atol=ATOL
    )


@pytest.mark.parametrize(
    "state", [(3.2, -1.5, 0.12, 9.3), (0.0, 0.0, 0.0, 10.0), (-40.0, 7.0, -2.9, 0.05)]
)
def test_plan_matches_jax(state):
    pr_j = _plan_jax(state)
    pr_t = plan_t(torch.tensor(state, dtype=torch.float32), PlannerConfigT())
    _assert_plans_match(pr_t, pr_j)


def test_plan_obstacle_penalty_matches_jax():
    state = (0.0, 0.0, 0.0, 10.0)
    obs = np.asarray([(20.0, 0.0, 2.0), (12.0, 3.0, 1.0)], np.float32)
    valid = np.asarray([True, False])
    pr_j = _plan_jax(state, obstacles=jnp.asarray(obs), obstacles_valid=jnp.asarray(valid))
    pr_t = plan_t(
        torch.tensor(state), PlannerConfigT(),
        obstacles=torch.from_numpy(obs), obstacles_valid=torch.from_numpy(valid),
    )
    _assert_plans_match(pr_t, pr_j, cost_rtol=1e-6)
    assert abs(float(pr_t.lateral_offsets[pr_t.best])) > 0.4


@pytest.mark.parametrize("n_valid", [20, 0])
def test_plan_reference_path_matches_jax(n_valid):
    """A reference path, and one with no valid point (the term is skipped)."""
    cfg = PlannerConfig()
    state = (0.0, 0.0, 0.0, 10.0)
    buf, valid = make_reference_path_t([(float(i), 1.0) for i in range(20)], cfg.max_reference_points, device="cpu")
    valid = valid & (torch.arange(cfg.max_reference_points) < n_valid)
    pr_j = _plan_jax(state, reference_positions=jnp.asarray(buf.numpy()), reference_valid=jnp.asarray(valid.numpy()))
    pr_t = plan_t(torch.tensor(state), PlannerConfigT(), reference_positions=buf, reference_valid=valid)
    _assert_plans_match(pr_t, pr_j, cost_rtol=1e-6)


@pytest.mark.parametrize("n", [20, 3, 0])
def test_make_reference_path_matches_jax(n):
    """The port's padded reference buffer equals the JAX package's, and both
    refuse a path longer than the capacity."""
    cap = PlannerConfig().max_reference_points
    pts = [(float(i) * 1.5, 1.0 - i) for i in range(n)]
    buf_t, valid_t = make_reference_path_t(pts, cap, device="cpu")
    buf_j, valid_j = make_reference_path(pts if n else np.zeros((0, 2)), cap)
    assert buf_t.dtype == torch.float32 and valid_t.dtype == torch.bool
    np.testing.assert_array_equal(buf_t.numpy(), np.asarray(buf_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    with pytest.raises(ValueError, match="capacity"):
        make_reference_path_t([(0.0, 0.0)] * (cap + 1), cap)


def test_make_reference_path_runs_on_the_card_by_default(monkeypatch):
    """`make_reference_path` puts its buffers on the card unless the caller
    asks for the CPU: without a card the default and ``"cuda"`` refuse with
    `resolve_device`'s error, never falling back to the CPU; ``"cpu"``
    builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in ((), ("cuda",)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_reference_path_t([(0.0, 1.0)], 8, *args)
    with pytest.raises(ValueError, match="unsupported device"):
        make_reference_path_t([(0.0, 1.0)], 8, "meta")
    buf, valid = make_reference_path_t([(0.0, 1.0)], 8, device="cpu")
    assert buf.device.type == valid.device.type == "cpu" and int(valid.sum()) == 1


@pytest.mark.parametrize("offset", [0.0, 0.49, -0.5, 0.5, -3.0, 3.0])
def test_trajectory_type_matches_jax(offset):
    assert trajectory_type_t(offset) == trajectory_type(offset)


def test_best_is_first_min_on_ties():
    pr = plan_t(torch.tensor([0.0, 0.0, 0.0, 10.0]), PlannerConfigT())
    costs = pr.costs.numpy()
    assert int(pr.best) == int(np.flatnonzero(costs == costs.min())[0])
    assert int(pr.order[0]) == int(pr.best)
