"""The port's NMS against the JAX package's, bit for bit.

The port's plain keep mask (`_nms_keep_plain`, kernel K5's reference on
the CPU) against JAX's XLA fixpoint (`nms_keep_xla`) and JAX's Pallas
kernel in the interpreter (`nms_keep_pallas(..., interpret=True)`), on the
cases of tests/test_nms_pallas.py and on kernel K5's cases
(`chip_smoke.nms_cases`, built with numpy); and the port's `nms` against JAX's
`nms(..., backend="cpu")` on boxes, scores, classes and valid, tied scores
included.  Inputs are made with numpy and handed to both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_autonomous_driving_perception_and_planning_torch.ops import nms as nms_t
from multimodal_autonomous_driving_perception_and_planning_tpu.ops.nms import nms as nms_j
from multimodal_autonomous_driving_perception_and_planning_tpu.ops.nms import nms_keep_xla
from multimodal_autonomous_driving_perception_and_planning_tpu.ops.nms_pallas import nms_keep_pallas
from test_nms_pallas import _random_case
from test_yolo_nms import oracle_nms


def _keep_three_ways(boxes, scores, thr):
    """The port's plain keep mask, JAX's XLA fixpoint and JAX's interpreted
    kernel on one (K, 4) case."""
    port = nms_t._nms_keep_plain(torch.tensor(boxes), torch.tensor(scores), thr).numpy()
    xla = np.asarray(nms_keep_xla(jnp.asarray(boxes), jnp.asarray(scores), thr))
    pallas = np.asarray(nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(scores), thr, interpret=True))
    return port, xla, pallas


@pytest.mark.parametrize("k", [16, 64, 256])
def test_plain_keep_matches_jax_fuzz(k):
    """Tie-heavy coordinates, dead entries, four thresholds."""
    rng = np.random.default_rng(k)
    for trial in range(8):
        boxes, scores = _random_case(rng, k)
        thr = float(rng.choice([0.1, 0.3, 0.45, 0.7]))
        port, xla, pallas = _keep_three_ways(boxes, scores, thr)
        np.testing.assert_array_equal(port, xla, err_msg=f"k={k} trial {trial}")
        np.testing.assert_array_equal(port, pallas, err_msg=f"k={k} trial {trial}")


def test_plain_keep_suppression_chain():
    """A chain a > b > c ... forces one fixpoint round per level."""
    n = 24
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        boxes[i] = [i * 5.0, 0.0, i * 5.0 + 10.0, 10.0]
    scores = np.linspace(0.95, 0.5, n).astype(np.float32)
    port, xla, pallas = _keep_three_ways(boxes, scores, 0.3)
    np.testing.assert_array_equal(port, xla)
    np.testing.assert_array_equal(port, pallas)
    assert port.sum() == (n + 1) // 2


def test_plain_keep_all_dead_and_all_kept():
    k = 32
    boxes = np.stack(
        [np.arange(k) * 100.0, np.zeros(k), np.arange(k) * 100.0 + 10, np.full(k, 10.0)], axis=1
    ).astype(np.float32)
    scores = np.linspace(0.9, 0.3, k).astype(np.float32)
    for s, want in ((scores, True), (np.zeros(k, np.float32), False)):
        port, xla, pallas = _keep_three_ways(boxes, s, 0.45)
        np.testing.assert_array_equal(port, xla)
        np.testing.assert_array_equal(port, pallas)
        assert (port == want).all()


def test_plain_keep_batched():
    """The batch dimension written out, against JAX per image (the JAX
    frontend vmaps the kernel over frames)."""
    rng = np.random.default_rng(5)
    cases = [_random_case(rng, 64) for _ in range(3)]
    boxes = torch.tensor(np.stack([c[0] for c in cases]))
    scores = torch.tensor(np.stack([c[1] for c in cases]))
    got = nms_t.nms_keep(boxes, scores, 0.45).numpy()
    assert got.shape == (3, 64) and got.dtype == bool
    for i, (b, s) in enumerate(cases):
        np.testing.assert_array_equal(got[i], np.asarray(nms_keep_xla(jnp.asarray(b), jnp.asarray(s), 0.45)))


@functools.lru_cache(maxsize=None)
def _jax_keeps(thr):
    """JAX's XLA fixpoint and its interpreted Pallas kernel over a batch of
    images, jitted at one threshold (the JAX frontend vmaps the kernel)."""
    xla = jax.jit(jax.vmap(lambda b, s: nms_keep_xla(b, s, thr)))
    pallas = jax.jit(jax.vmap(lambda b, s: nms_keep_pallas(b, s, thr, interpret=True)))
    return xla, pallas


def _case_ids(mode):
    return [name for name, case in chip_smoke.nms_cases().items() if case.jax == mode]


@pytest.mark.parametrize("name", _case_ids("compiled"))
def test_plain_keep_matches_jax_on_kernel_cases(name):
    """K5's card cases on the CPU: the port's plain keep mask bit for bit
    against JAX's XLA fixpoint and JAX's Pallas kernel in the interpreter,
    jitted over the batch, as the JAX frontend runs them, and the kept
    count a case is built to give.  The near-threshold cases are among
    them: compiled XLA contracts a multiply-add of the union, and the port
    computes the union the same way
    (`test_port_contracts_the_union_like_compiled_jax`).  The subnormal
    case is left out: XLA on the CPU flushes subnormal IoUs and
    intersections to 0, the port does not (ROADMAP.md, faults); the card
    check holds K5 to the plain version there."""
    case = chip_smoke.nms_cases()[name]
    port = nms_t._nms_keep_plain(torch.tensor(case.boxes), torch.tensor(case.scores), case.thr).numpy()
    xla, pallas = _jax_keeps(case.thr)
    boxes, scores = jnp.asarray(case.boxes), jnp.asarray(case.scores)
    np.testing.assert_array_equal(port, np.asarray(xla(boxes, scores)), err_msg=f"{name}: XLA")
    np.testing.assert_array_equal(port, np.asarray(pallas(boxes, scores)), err_msg=f"{name}: Pallas")
    if case.kept is not None:
        assert int(port.sum()) == case.kept


def _keep_model(boxes, scores, thr, contracted):
    """The greedy keep mask over `chip_smoke._iou32`, in numpy: the union
    fma(w_b, h_b, area_a) - inter with one rounding for the multiply-add
    (``contracted``), or op for op."""
    k = len(scores)
    a, b = np.repeat(boxes[:, None], k, 1), np.repeat(boxes[None], k, 0)
    iou = chip_smoke._iou32(a, b, contracted=contracted)
    S = (iou > np.float32(thr)) & (np.arange(k)[:, None] < np.arange(k)[None, :])
    keep = np.zeros(k, bool)
    for j in range(k):
        keep[j] = scores[j] > 0 and not (S[:j, j] & keep[:j]).any()
    return keep


@pytest.mark.parametrize("thr", chip_smoke.NMS_NEAR_THRESHOLDS)
def test_port_contracts_the_union_like_compiled_jax(thr):
    """Under jit, XLA's CPU compiler computes `pairwise_iou`'s union as
    fma(w_b, h_b, area_a) - inter, one rounding for the multiply-add, and
    so does the Pallas interpreter; the port's `pairwise_iou` (and K1 and
    K5) compute it the same way.  On IoUs within 2 ulps of the threshold
    the port, compiled JAX and the numpy model of the contracted union give
    one keep mask, and the union op for op gives another."""
    case = chip_smoke.nms_cases()[f"near_threshold_{thr}"]
    boxes, scores = case.boxes[0], case.scores[0]
    port = nms_t._nms_keep_plain(torch.tensor(boxes), torch.tensor(scores), case.thr).numpy()
    xla, pallas = _jax_keeps(case.thr)
    compiled = [np.asarray(f(jnp.asarray(case.boxes), jnp.asarray(case.scores)))[0] for f in (xla, pallas)]
    contracted = _keep_model(boxes, scores, case.thr, contracted=True)
    np.testing.assert_array_equal(port, contracted)
    np.testing.assert_array_equal(compiled[0], contracted)
    np.testing.assert_array_equal(compiled[1], contracted)
    assert (_keep_model(boxes, scores, case.thr, contracted=False) != contracted).any()


def test_fma32_rounds_once():
    """`ops.geometry.fma32` against the exactly rounded a * b + c (Python
    fractions), on random float32 triples and on ones whose float64 sum is
    inexact (c far below or far above the product), where a plain float64
    sum rounded again to float32 can round twice."""
    from fractions import Fraction

    from multimodal_autonomous_driving_perception_and_planning_torch.ops.geometry import fma32

    rng = np.random.default_rng(3)
    n = 4000
    a = rng.uniform(-100, 100, n).astype(np.float32)
    b = rng.uniform(-100, 100, n).astype(np.float32)
    c = (rng.uniform(-1, 1, n) * 10.0 ** rng.integers(-30, 30, n)).astype(np.float32)
    # Halfway cases: c is the product's rounding error plus half a float32 ulp.
    p = a.astype(np.float64) * b
    half = np.spacing(p.astype(np.float32)).astype(np.float64) / 2
    c[: n // 4] = ((p - p.astype(np.float32)) + half)[: n // 4].astype(np.float32)
    got = fma32(torch.tensor(a), torch.tensor(b), torch.tensor(c)).numpy()
    want = np.array([_round32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)


def _round32(q):
    """The float32 nearest to the rational ``q``, ties to even."""
    from fractions import Fraction

    lo = np.float32(float(q))  # rounded twice: at most one ulp off
    cands = [lo, np.nextafter(lo, np.float32(-np.inf)), np.nextafter(lo, np.float32(np.inf))]
    best = min(cands, key=lambda v: (abs(Fraction(float(v)) - q), int(np.array(v).view(np.int32)) & 1))
    return best


def _nms_both(boxes, scores, classes, **kw):
    got = nms_t.nms(torch.tensor(boxes), torch.tensor(scores), torch.tensor(classes), **kw)
    want = nms_j(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), backend="cpu", **kw)
    for name in ("boxes", "scores", "classes", "valid"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    return got


def _random_pool(rng, n, n_classes=4):
    cx, cy = rng.uniform(0, 600, n), rng.uniform(0, 400, n)
    w, h = rng.uniform(20, 120, n), rng.uniform(20, 120, n)
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1).astype(np.float32)
    return boxes, rng.uniform(0, 1, n).astype(np.float32), rng.integers(0, n_classes, n).astype(np.int32)


def test_nms_tied_scores():
    """Exactly tied positive scores, above and below the pool's cut and
    among the survivors: both top-K selections must keep index order, as
    jax.lax.top_k does (torch.topk promises no order among ties)."""
    rng = np.random.default_rng(9)
    boxes, _, classes = _random_pool(rng, 200)
    scores = rng.choice(np.float32([0.3, 0.5, 0.7, 0.9]), 200)
    got = _nms_both(boxes, scores, classes, max_det=40, pre_topk=64)
    assert got.valid.sum() > 20
    assert len(set(got.scores[got.valid].tolist())) < int(got.valid.sum())  # ties survive


def test_nms_class_aware_pair():
    """tests/test_yolo_nms.py:64: overlapping boxes of two classes both
    stay; of one class one goes."""
    boxes = np.float32([[0, 0, 10, 10], [1, 1, 11, 11]])
    scores = np.float32([0.9, 0.8])
    assert int(_nms_both(boxes, scores, np.int32([0, 1]), pre_topk=2, max_det=4).valid.sum()) == 2
    assert int(_nms_both(boxes, scores, np.int32([0, 0]), pre_topk=2, max_det=4).valid.sum()) == 1


def test_nms_1024_candidate_pool():
    """tests/test_yolo_nms.py:282: 1,024 candidates in one pool, the most
    kernel K5 takes, against JAX and the sequential oracle."""
    rng = np.random.default_rng(11)
    boxes, scores, classes = _random_pool(rng, 1024)
    got = _nms_both(boxes, scores, classes, max_det=1024, pre_topk=1024)
    want = oracle_nms(boxes.astype(np.float64), scores.astype(np.float64), classes)
    np.testing.assert_allclose(got.boxes.numpy()[got.valid.numpy()], boxes[want], atol=1e-3)


@pytest.mark.parametrize("trial", range(3))
def test_nms_matches_oracle(trial):
    """tests/test_yolo_nms.py:38: random pools against JAX and oracle_nms."""
    rng = np.random.default_rng(7 + trial)
    boxes, scores, classes = _random_pool(rng, 200)
    got = _nms_both(boxes, scores, classes, max_det=200, pre_topk=200)
    want = oracle_nms(boxes, scores, classes)
    np.testing.assert_allclose(got.boxes.numpy()[got.valid.numpy()], boxes[want], atol=1e-3)


def test_nms_batched_and_padded():
    """Leading batch dims: each image as JAX computes it alone; max_det
    above the pool pads with invalid zeros."""
    rng = np.random.default_rng(13)
    pools = [_random_pool(rng, 40) for _ in range(3)]
    got = nms_t.nms(*(torch.tensor(np.stack([p[i] for p in pools])) for i in range(3)), max_det=48, pre_topk=32)
    assert got.boxes.shape == (3, 48, 4) and not got.valid[:, 32:].any()
    for i, (b, s, c) in enumerate(pools):
        want = nms_j(jnp.asarray(b), jnp.asarray(s), jnp.asarray(c), max_det=48, pre_topk=32, backend="cpu")
        np.testing.assert_array_equal(got.boxes[i].numpy(), np.asarray(want.boxes))
        np.testing.assert_array_equal(got.classes[i].numpy(), np.asarray(want.classes))
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want.valid))


def test_keep_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on the card or raises: no quiet plain
    path behind it."""
    from multimodal_autonomous_driving_perception_and_planning_torch.ops import nms_kernel

    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        nms_kernel.nms_keep(torch.zeros((1, 4, 4)), torch.zeros((1, 4)), 0.45)
