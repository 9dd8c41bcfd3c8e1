"""The port's per-agent Kalman bank (tracking/kalman_bank.py) and its
batched filter algebra (ops/kalman.py) against the JAX package, on the CPU.

The cases of tests/test_tracker.py's bank tests (one continuing track
against an eager predict/update loop; jitter smoothed and a reset at an id
change) and the 300-frame, 64-agent workload of benchmarks/suite.py
`bench_kalman_bank`, each held to JAX's bank: ``valid`` exact, positions
and velocities within 1e-4.  Also: the batched predict and update equal
the unbatched ones slot by slot.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch.ops import kalman as kt
from multimodal_autonomous_driving_perception_and_planning_torch.tracking.kalman_bank import make_kalman_bank
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import kalman_model_from_numpy
from multimodal_autonomous_driving_perception_and_planning_tpu.tracking import kalman_bank as bank_j

ATOL = 1e-4


def _bank_outs(T, N, tids, centers, vels, vcount):
    bbox = np.zeros((T, N, 4), np.float32)
    bbox[..., 0] = centers[..., 0] - 10
    bbox[..., 2] = centers[..., 0] + 10
    bbox[..., 1] = centers[..., 1] - 10
    bbox[..., 3] = centers[..., 1] + 10
    return {"track_id": tids, "track_bbox": bbox, "track_velocity": vels, "track_vel_count": vcount}


def _smooth_both(outs, max_tracks=None):
    cfg_j, cfg_t = pj.DEFAULT_CONFIG, pt.DEFAULT_CONFIG
    if max_tracks is not None:
        cfg_j = cfg_j.replace(tracker=dataclasses.replace(cfg_j.tracker, max_tracks=max_tracks))
        cfg_t = cfg_t.replace(tracker=dataclasses.replace(cfg_t.tracker, max_tracks=max_tracks))
    want = bank_j.make_kalman_bank(cfg_j)({k: jnp.asarray(v) for k, v in outs.items()})
    got = make_kalman_bank(cfg_t, device="cpu")(outs)
    assert got["valid"].dtype == torch.bool
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    for k in ("positions", "velocities"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL, err_msg=k)
    return got


def test_kalman_bank_matches_sequential_filter():
    """One continuing track: the bank equals an eager predict/update loop
    and JAX's bank."""
    N, T = pt.DEFAULT_CONFIG.tracker.max_tracks, 12
    rng = np.random.default_rng(0)
    centers = np.zeros((T, N, 2), np.float32)
    path = np.cumsum(rng.normal(3.0, 0.5, (T, 2)), axis=0).astype(np.float32) + 100
    centers[:, 0] = path
    vels = np.zeros((T, N, 2), np.float32)
    vels[1:, 0] = path[1:] - path[:-1]
    vcount = np.zeros((T, N), np.int32)
    vcount[1:, 0] = np.arange(1, T)
    tids = np.zeros((T, N), np.int32)
    tids[:, 0] = 7
    got = _smooth_both(_bank_outs(T, N, tids, centers, vels, vcount))

    model = kalman_model_from_numpy(*kt.make_constant_accel_model(1.0, 1.0, 4.0, 10.0), device="cpu")
    x = torch.cat([torch.from_numpy(centers[0, 0]), torch.zeros(4)])
    P = torch.eye(6) * 100.0
    want = [x[:2]]
    for t in range(1, T):
        xp, Pp = kt.kalman_predict(model, x, P)
        x, P = kt.kalman_update(model, xp, Pp, torch.from_numpy(np.concatenate([centers[t, 0], vels[t, 0]])))
        want.append(x[:2])
    np.testing.assert_allclose(got["positions"][:, 0].numpy(), torch.stack(want).numpy(), rtol=1e-5, atol=1e-4)
    assert bool(got["valid"][:, 0].all()) and not got["valid"][:, 1:].any()


def test_kalman_bank_smooths_jitter_and_resets_on_id_change():
    N, T = pt.DEFAULT_CONFIG.tracker.max_tracks, 40
    rng = np.random.default_rng(1)
    true_x = 50.0 + 4.0 * np.arange(T, dtype=np.float32)
    noisy = true_x + rng.normal(0, 3.0, T).astype(np.float32)
    centers = np.zeros((T, N, 2), np.float32)
    centers[:, 0, 0] = noisy
    centers[:, 0, 1] = 200.0
    vels = np.zeros((T, N, 2), np.float32)
    vels[1:, 0, 0] = noisy[1:] - noisy[:-1]
    vcount = np.zeros((T, N), np.int32)
    vcount[1:, 0] = 1
    tids = np.zeros((T, N), np.int32)
    tids[:, 0] = 3
    tids[25:, 0] = 9  # a new track reuses slot 0 at t = 25: a reset
    sm = _smooth_both(_bank_outs(T, N, tids, centers, vels, vcount))["positions"][:, 0, 0].numpy()
    seg = slice(10, 25)
    assert np.abs(sm[seg] - true_x[seg]).mean() < np.abs(noisy[seg] - true_x[seg]).mean()
    np.testing.assert_allclose(sm[25], noisy[25], atol=1e-4)


def test_kalman_bank_64_agents_300_frames():
    """benchmarks/suite.py `bench_kalman_bank`'s workload."""
    T, N = 300, 64
    rng = np.random.default_rng(0)
    path = np.cumsum(rng.normal(2.0, 0.5, (T, N, 2)), axis=0).astype(np.float32)
    tids = np.tile(np.arange(1, N + 1, dtype=np.int32), (T, 1))
    outs = _bank_outs(T, N, tids, path, np.zeros((T, N, 2), np.float32), np.ones((T, N), np.int32))
    got = _smooth_both(outs, max_tracks=N)
    assert got["positions"].shape == (T, N, 2) and bool(got["valid"].all())


def test_bank_refuses_another_slot_count():
    outs = {"track_id": np.zeros((2, 8), np.int32), "track_bbox": np.zeros((2, 8, 4), np.float32),
            "track_velocity": np.zeros((2, 8, 2), np.float32), "track_vel_count": np.zeros((2, 8), np.int32)}
    with pytest.raises(ValueError, match="track slots"):
        make_kalman_bank(pt.DEFAULT_CONFIG, device="cpu")(outs)


@pytest.mark.parametrize("lead", [(1,), (64,), (3, 5)])
def test_batched_predict_and_update_equal_the_unbatched(lead):
    """Over leading batch dimensions the filter gives each state what the
    unbatched call gives it, up to the rounding of the batched matrix
    products (bmm against gemm): within 2e-6 relative to each value."""
    model = kalman_model_from_numpy(*kt.make_constant_accel_model(1.0 / 30.0, 0.1, 1.0, 10.0), device="cpu")
    rng = np.random.default_rng(3)
    n = int(np.prod(lead))
    x = rng.normal(0, 50, (n, 6)).astype(np.float32)
    A = rng.normal(0, 3, (n, 6, 6)).astype(np.float32)
    P = (A @ A.transpose(0, 2, 1) + np.eye(6, dtype=np.float32)).astype(np.float32)
    z = rng.normal(0, 50, (n, 4)).astype(np.float32)
    xs, Ps, zs = (torch.from_numpy(a.reshape(*lead, *a.shape[1:])) for a in (x, P, z))
    xp, Pp = kt.kalman_predict(model, xs, Ps)
    xu, Pu = kt.kalman_update(model, xp, Pp, zs)
    assert xu.shape == (*lead, 6) and Pu.shape == (*lead, 6, 6)
    flat = [t.reshape(n, *t.shape[len(lead):]) for t in (xp, Pp, xu, Pu)]
    for i in range(n):
        xp1, Pp1 = kt.kalman_predict(model, torch.from_numpy(x[i]), torch.from_numpy(P[i]))
        xu1, Pu1 = kt.kalman_update(model, xp1, Pp1, torch.from_numpy(z[i]))
        for got, want in zip((f[i] for f in flat), (xp1, Pp1, xu1, Pu1)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6, atol=2e-6 * float(want.abs().max()))
