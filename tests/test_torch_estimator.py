"""The port's ego estimator (kernel K2's plain version) against the JAX
package's XLA step and its TPU kernel run through the Pallas interpreter.

A 200-frame chain of the synthetic ego stream, with every seventh frame
unmeasured (the measurement-skip branch), runs through all three
independently; every reported field and the carried (x, P) stay within
the PARITY.md budget, atol 1e-4 (the acceleration is a finite difference
over dt = 0.033 s, which amplifies float32 rounding about thirtyfold).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from multimodal_autonomous_driving_perception_and_planning_torch.config import (
    DEFAULT_CONFIG as CFG_T,
)
from multimodal_autonomous_driving_perception_and_planning_torch.data.synthetic import (
    ego_motion_stream,
)
from multimodal_autonomous_driving_perception_and_planning_torch.estimation import ego as ego_t
from multimodal_autonomous_driving_perception_and_planning_torch.ops import kalman as kalman_t
from multimodal_autonomous_driving_perception_and_planning_torch.ops import kalman_kernel
from multimodal_autonomous_driving_perception_and_planning_torch.types import (
    KalmanState as KalmanStateT,
)
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import (
    kalman_model_from_numpy,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.config import DEFAULT_CONFIG
from multimodal_autonomous_driving_perception_and_planning_tpu.estimation.ego import (
    _estimator_step_fused,
    _estimator_step_xla,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.ops.kalman import (
    make_constant_accel_model,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.types import KalmanState

_FIELDS = (
    "x", "y", "vx", "vy", "heading", "speed", "acceleration", "yaw_rate",
    "timestamp", "pos_uncertainty", "vel_uncertainty",
)
ATOL = 1e-4


def _models():
    cfg = DEFAULT_CONFIG.estimator
    args = (cfg.dt, cfg.process_noise, cfg.measurement_noise, cfg.accel_noise_scale)
    model_j = make_constant_accel_model(*args)
    model_np = kalman_t.make_constant_accel_model(*args)
    for a, b in zip(model_j, model_np):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    return model_j, kalman_model_from_numpy(*model_np, device="cpu")


def test_estimator_chain_matches_jax_200_frames():
    cfg_j, cfg_t = DEFAULT_CONFIG.estimator, CFG_T.estimator
    model_j, model_t = _models()
    ego = ego_motion_stream(200, seed=0).astype(np.float32)

    ks_x = KalmanState.initial(cfg_j.initial_covariance)
    ks_p = KalmanState.initial(cfg_j.initial_covariance)
    ks_t = KalmanStateT.initial(cfg_t.initial_covariance, "cpu")
    step_x = jax.jit(lambda ks, z, h: _estimator_step_xla(ks, model_j, z, h, cfg_j))
    step_p = jax.jit(
        lambda ks, z, h: _estimator_step_fused(ks, model_j, z, h, cfg_j, interpret=True)
    )
    before = kalman_kernel.launches
    worst = {k: 0.0 for k in _FIELDS}
    for f in range(200):
        has = f % 7 != 3
        z = ego[f]
        ks_x, vx = step_x(ks_x, jnp.asarray(z), jnp.asarray(has))
        ks_p, vp = step_p(ks_p, jnp.asarray(z), jnp.asarray(has))
        ks_t, vt = ego_t.estimator_step(ks_t, model_t, torch.from_numpy(z), has, cfg_t)
        for k in _FIELDS:
            got = float(getattr(vt, k))
            for ref in (vx, vp):
                worst[k] = max(worst[k], abs(got - float(getattr(ref, k))))
    assert kalman_kernel.launches == before  # CPU tensors: the plain version
    for k, v in worst.items():
        assert v < ATOL, (k, v)
    for ref in (ks_x, ks_p):
        np.testing.assert_allclose(ks_t.x.numpy(), np.asarray(ref.x), rtol=0, atol=ATOL)
        np.testing.assert_allclose(ks_t.P.numpy(), np.asarray(ref.P), rtol=0, atol=ATOL)
        for name in ("time", "prev_heading", "prev_speed"):
            np.testing.assert_allclose(
                float(getattr(ks_t, name)), float(getattr(ref, name)), rtol=0, atol=ATOL
            )


def test_unmeasured_frame_keeps_the_prediction():
    """has_measurement=False skips the update: (x, P) is the prediction."""
    cfg = CFG_T.estimator
    _, model = _models()
    ks = KalmanStateT.initial(cfg.initial_covariance, "cpu")
    ks = KalmanStateT(
        x=torch.tensor([1.0, 2.0, 9.0, 0.5, 0.1, 0.0]), P=ks.P, time=ks.time,
        prev_heading=ks.prev_heading, prev_speed=ks.prev_speed,
    )
    z = torch.tensor([5.0, 5.0, 5.0, 5.0])
    x_pred, P_pred = kalman_t.kalman_predict(model, ks.x, ks.P)
    skipped, _ = ego_t.estimator_step(ks, model, z, False, cfg)
    measured, _ = ego_t.estimator_step(ks, model, z, True, cfg)
    torch.testing.assert_close(skipped.x, x_pred, rtol=0, atol=0)
    torch.testing.assert_close(skipped.P, P_pred, rtol=0, atol=0)
    assert not torch.allclose(measured.x, x_pred)


_CORNERS = chip_smoke.kalman_corner_states(
    CFG_T.estimator.speed_heading_hold, CFG_T.estimator.initial_covariance
)


@pytest.mark.parametrize("case", list(_CORNERS))
def test_single_step_matches_jax_on_crafted_states(case):
    """One step from each crafted state of chip_smoke.py's K2 check (speed
    0.1% below and above the heading hold, a heading wrapping across +-pi
    between the predicted and the updated state, an unmeasured step, P at
    1e4 on the diagonal, and an ill-conditioned innovation covariance)
    through the port's plain step and JAX's XLA step: the reported fields
    and the carried state within atol 1e-4."""
    cfg_j, cfg_t = DEFAULT_CONFIG.estimator, CFG_T.estimator
    model_j, model_t = _models()
    x, P, time0, heading, speed, z, has = _CORNERS[case]
    ks_j = KalmanState(*(jnp.asarray(a) for a in (x, P, time0, heading, speed)))
    ks_t = KalmanStateT(*(torch.tensor(a) for a in (x, P, time0, heading, speed)))
    new_j, vs_j = _estimator_step_xla(ks_j, model_j, jnp.asarray(z), jnp.asarray(has), cfg_j)
    new_t, vs_t = ego_t._estimator_step_xla(ks_t, model_t, torch.tensor(z), torch.tensor(has), cfg_t)
    for k in _FIELDS:
        np.testing.assert_allclose(float(getattr(vs_t, k)), float(getattr(vs_j, k)), rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(new_t.x.numpy(), np.asarray(new_j.x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(new_t.P.numpy(), np.asarray(new_j.P), rtol=0, atol=ATOL)
    for name in ("time", "prev_heading", "prev_speed"):
        np.testing.assert_allclose(float(getattr(new_t, name)), float(getattr(new_j, name)), rtol=0, atol=ATOL)
    if case.startswith("speed"):  # the side of the hold decides the heading
        below = case == "speed_below_hold"
        assert (float(vs_t.heading) == float(heading)) == below
    if case == "heading_wrap":  # across +-pi, yet a small yaw rate
        assert float(vs_t.heading) < -3.0 and abs(float(vs_t.yaw_rate)) < 1.0
    if case == "unmeasured":
        x_pred, _ = kalman_t.kalman_predict(model_t, ks_t.x, ks_t.P)
        torch.testing.assert_close(new_t.x, x_pred, rtol=0, atol=0)


@pytest.mark.parametrize("case", list(_CORNERS))
def test_float64_plain_step_is_the_reference_only_where_float32_falls_short(case):
    """chip_smoke.py holds K2, whose algebra is in double, to the plain step
    evaluated in float64 (`plain_step_float64`) on the crafted states of
    `KALMAN_FLOAT64_CASES`, and to the float32 plain step elsewhere.  Both
    steps return float32; the float32 step stands within K2's bars of the
    float64 one on every crafted state but those, where the innovation
    covariance is ill-conditioned (condition number about 3.9e4)."""
    cfg = CFG_T.estimator
    _, model = _models()
    x, P, time0, heading, speed, z, has = _CORNERS[case]
    ks = KalmanStateT(*(torch.tensor(a) for a in (x, P, time0, heading, speed)))
    z, has = torch.tensor(z), torch.tensor(has)
    exact_ks, exact_vs = chip_smoke.plain_step_float64(ks, model, z, has, cfg)
    plain_ks, plain_vs = ego_t._estimator_step_xla(ks, model, z, has, cfg)
    pairs = [(exact_ks.x, plain_ks.x, 1.0), (exact_ks.P, plain_ks.P, 1.0)]
    for name in _FIELDS:
        scale = cfg.dt if name in ("acceleration", "yaw_rate") else 1.0
        pairs.append((getattr(exact_vs, name), getattr(plain_vs, name), scale))
    assert all(a.dtype == torch.float32 for a, _, _ in pairs)
    close = all(chip_smoke._kalman_close(b, a, scale)[0] for a, b, scale in pairs)
    assert close == (case not in chip_smoke.KALMAN_FLOAT64_CASES)
