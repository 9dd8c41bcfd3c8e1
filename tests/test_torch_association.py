"""The PyTorch port's greedy association against the JAX package's.

`_greedy_associate_plain` (kernel K4's plain version, which the plain
tracker calls) is held bit for bit to the JAX XLA fixpoint on the cases of
tests/test_association_pallas.py: tie-quantized IoUs at the pipeline's
shapes, and the empty and saturated matrices.  `greedy_associate` takes
the plain version for CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from multimodal_autonomous_driving_perception_and_planning_torch.ops import (
    association_kernel,
    greedy_associate,
)
from multimodal_autonomous_driving_perception_and_planning_torch.ops.association import (
    _greedy_associate_plain,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.ops.association import (
    greedy_associate as jax_greedy_associate,
)
from multimodal_autonomous_driving_perception_and_planning_tpu.ops.association_pallas import (
    greedy_associate_pallas,
)


def _random_case(rng, t, d):
    """tests/test_association_pallas.py `_random_case`."""
    iou = rng.random((t, d), np.float32)
    q = int(rng.integers(1, 6))
    iou = np.round(iou * q) / q  # quantized: exact ties
    alive = rng.random(t) < 0.7
    valid = rng.random(d) < 0.8
    iou = np.where(alive[:, None] & valid[None, :], iou, -1.0).astype(np.float32)
    rank = np.argsort(np.argsort(rng.random(t))).astype(np.int32)
    return iou, rank


def _both(iou, rank, thr):
    want = np.asarray(jax_greedy_associate(jnp.asarray(iou), jnp.asarray(rank), thr, backend="cpu"))
    got = _greedy_associate_plain(torch.tensor(iou), torch.tensor(rank), thr).numpy()
    assert got.dtype == want.dtype == np.int32
    return got, want


@pytest.mark.parametrize("shape", [(64, 16), (64, 64), (128, 64), (16, 16)])
def test_plain_matches_jax(shape):
    t, d = shape
    rng = np.random.default_rng(t * 1000 + d)
    for trial in range(10):
        iou, rank = _random_case(rng, t, d)
        thr = float(rng.choice([0.0, 0.3, 0.5]))
        got, want = _both(iou, rank, thr)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(
            greedy_associate(torch.tensor(iou), torch.tensor(rank), thr).numpy(), got
        )


def test_plain_empty_and_full():
    """No eligible pair: every row unmatched.  Identical IoUs: the row-major
    tie-break fills the diagonal."""
    t = d = 16
    rank = np.arange(t, dtype=np.int32)
    got, want = _both(np.full((t, d), -1.0, np.float32), rank, 0.3)
    np.testing.assert_array_equal(got, want)
    assert (got == -1).all()
    got, want = _both(np.ones((t, d), np.float32), rank, 0.3)
    np.testing.assert_array_equal(got, want)
    assert (got == np.arange(t)).all()


@pytest.mark.parametrize("shape", [(16, 16), (64, 16)])
def test_plain_matches_jax_on_tied_ranks(shape):
    """Ranks that are not a permutation: rows of equal rank that share a
    column's best IoU all take that column, in the JAX package's XLA
    fixpoint and its K4 (interpreted) as in the port's plain version, which
    kernel K4 is held to on the card."""
    t, d = shape
    rng = np.random.default_rng(t + d)
    for trial in range(4):
        iou, _ = _random_case(rng, t, d)
        rank = rng.integers(0, max(t // 4, 1), t).astype(np.int32)
        got, want = _both(iou, rank, 0.3)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        kernel = greedy_associate_pallas(jnp.asarray(iou), jnp.asarray(rank), 0.3, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(kernel), err_msg=f"trial {trial}")
    # Two rows of rank 0 with the same best IoU in column 0 both take it.
    iou = np.full((t, d), -1.0, np.float32)
    iou[0, 0] = iou[1, 0] = 0.9
    rank = np.zeros(t, np.int32)
    got, want = _both(iou, rank, 0.3)
    np.testing.assert_array_equal(got, want)
    assert list(got[:2]) == [0, 0] and (got[2:] == -1).all()


@pytest.mark.parametrize("case", ["staircase_64x16", "all_equal_64x16", "full_128x64", "staircase_128x64"])
def test_plain_matches_jax_on_adversarial_matrices(case):
    """The matrices chip_smoke.py holds K4 to its plain version on, here held
    to the JAX XLA fixpoint and JAX's K4 in the interpreter: the staircase
    and the all-equal ladder (one pair a round, 17 rounds, the diagonal),
    (128, 64) matrices with every row alive and every column valid, and
    the (128, 64) staircase (65 rounds)."""
    if case == "full_128x64":
        rng = np.random.default_rng(128064)
        matrices = [chip_smoke.full_association(rng, 128, 64) for _ in range(2)]
    elif case == "staircase_128x64":
        matrices = [(chip_smoke.ladder_iou(128, 64, 0.5), np.arange(128, dtype=np.int32))]
    else:
        step = 1 if case.startswith("staircase") else 0
        matrices = [(chip_smoke.ladder_iou(64, 16, step), np.arange(64, dtype=np.int32))]
    for iou, rank in matrices:
        got, want = _both(iou, rank, 0.3)
        np.testing.assert_array_equal(got, want)
        kernel = greedy_associate_pallas(jnp.asarray(iou), jnp.asarray(rank), 0.3, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(kernel))
        if case != "full_128x64":
            d = iou.shape[1]
            assert list(got[:d]) == list(range(d)) and (got[d:] == -1).all()


def test_kernel_wrapper_refuses_what_k4_does_not_take():
    iou, rank = torch.zeros((4, 4)), torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        association_kernel.greedy_associate(iou, rank, 0.3)


@pytest.mark.parametrize("thr", chip_smoke.KEY_CORNER_THRESHOLDS)
@pytest.mark.parametrize("shape", chip_smoke.KEY_CORNER_SHAPES)
def test_plain_matches_jax_on_key_order_corners(shape, thr):
    """The key-order corners chip_smoke.py holds K4 to its plain version
    on, here held to the JAX XLA fixpoint and JAX's K4 in the interpreter:
    -0.0 and +0.0 entries (tied as IoU 0), IoUs exactly at the threshold
    and just below it, NaN (never eligible), and ranks at INT32_MIN,
    negative and INT32_MAX in tied groups, whose tie-break keys
    rank * D + column wrap in int32 alike in all three; with D not a power
    of two the wrap falls inside a row.  Dense draws, and draws with few
    entries left (the kernel's list of at most 32 eligible ones)."""
    t, d = shape
    rng = np.random.default_rng(7 * t + d)
    for trial, keep in enumerate((None, None, 24)):
        iou, rank = chip_smoke.key_corner_association(rng, t, d, thr, keep=keep)
        got, want = _both(iou, rank, thr)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        kernel = greedy_associate_pallas(jnp.asarray(iou), jnp.asarray(rank), thr, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(kernel), err_msg=f"trial {trial}")


@pytest.mark.parametrize("n", [32, 33])
@pytest.mark.parametrize("shape", [(64, 16), (128, 64)])
def test_plain_matches_jax_either_side_of_the_sparse_limit(shape, n):
    """Exactly 32 and 33 eligible entries (chip_smoke.py
    `eligible_association`: key-order corners, K4's limit of the sparse
    rounds either side), held to the JAX XLA fixpoint and JAX's K4 in the
    interpreter, under both thresholds."""
    t, d = shape
    rng = np.random.default_rng(13 * t + d)
    for thr in chip_smoke.KEY_CORNER_THRESHOLDS:
        iou, rank = chip_smoke.eligible_association(rng, t, d, thr, n)
        assert int(((iou >= thr) & (iou >= 0)).sum()) == n
        got, want = _both(iou, rank, thr)
        np.testing.assert_array_equal(got, want, err_msg=f"thr {thr}")
        kernel = greedy_associate_pallas(jnp.asarray(iou), jnp.asarray(rank), thr, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(kernel), err_msg=f"thr {thr}")


def test_tie_break_key_wraps_in_int32():
    """The tie-break key is rank * D + column in int32 arithmetic: a row of
    rank INT32_MAX at D = 16 has key -16 + column and so comes before a row
    of rank 0 in a column where both hold the best IoU, in JAX and in the
    port alike."""
    iou = np.full((2, 16), -1.0, np.float32)
    iou[:, 0] = 0.5
    rank = np.array([np.iinfo(np.int32).max, 0], np.int32)
    got, want = _both(iou, rank, 0.3)
    np.testing.assert_array_equal(got, want)
    assert list(got) == [0, -1]
