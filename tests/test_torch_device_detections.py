"""The port's `device_detection_stream` against the JAX package's.

Threefry's bits cannot be reproduced with a ``torch.Generator``, so the
stream is held to JAX in two halves.  The deterministic half
(`_detections_from_draws`: sizes, positions, clamps, ``valid``) is fed
JAX's own draws, computed here with ``jax.random`` from the same
``fold_in``/``split`` keys, and must give JAX's tables bit for bit.  The
torch draws must follow JAX's distribution: over 10,000 frames (10 seeds x
the 1,000 keys), chi-square tests at p >= 1e-3 for the box count and the
class against their weights and against JAX's own draws, and the ranges of
every draw.  The stream has period 1,000 and a chunk equals the slice of
one whole stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from multimodal_autonomous_driving_perception_and_planning_torch.data import synthetic as syn_t
from multimodal_autonomous_driving_perception_and_planning_tpu.data import synthetic as syn_j

CAP = 16
P_MIN = 1e-3  # the chi-square tests' p-value floor, fixed seeds
SEEDS = range(10)  # 10 seeds x 1,000 keys = 10,000 frames of draws


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_draws(seed: int, counters: np.ndarray, cap: int = CAP) -> dict:
    """The draws JAX's `device_detection_stream` makes for each counter,
    from the same keys, as numpy arrays."""
    key = jax.random.PRNGKey(seed)
    weights = jnp.asarray(syn_j.CLASS_WEIGHTS)

    def one(frame_count):
        ks = jax.random.split(jax.random.fold_in(key, frame_count % 1000), 6)
        return {
            "num": jax.random.randint(ks[0], (), 3, 8),
            "df": jax.random.uniform(ks[1], (cap,), minval=0.3, maxval=1.0),
            "jx": jax.random.randint(ks[2], (cap,), -10, 10),
            "jy": jax.random.randint(ks[3], (cap,), -5, 5),
            "cls": jax.random.choice(ks[4], 8, (cap,), p=weights),
            "conf": jax.random.uniform(ks[5], (cap,), minval=0.75, maxval=0.98),
        }

    return {k: np.array(v) for k, v in jax.vmap(one)(jnp.asarray(counters)).items()}


def tables_from_jax_draws(seed, start, n, height=480, width=640):
    counters = np.arange(start, start + n)
    draws = jax_draws(seed, counters)
    got = syn_t._detections_from_draws(
        torch.from_numpy(counters), height=height, width=width, **{k: torch.from_numpy(v) for k, v in draws.items()}
    )
    want = syn_j.device_detection_stream(n, height=height, width=width, capacity=CAP, seed=seed,
                                         start_frame_count=start)
    return got, want


@pytest.mark.parametrize("seed,start,n,hw", [(0, 1, 2000, (480, 640)), (3, 7001, 300, (120, 160))])
def test_deterministic_part_on_jax_draws_is_bit_exact(seed, start, n, hw):
    got, want = tables_from_jax_draws(seed, start, n, *hw)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
        assert got[k].numpy().dtype == np.asarray(v).dtype, k


def test_sin_in_float64_matches_jax_at_counter_100802():
    """At frame counter 100,802 (and 100,852) the angle of slot 15 (14) is
    t + i = 2031.04f, where XLA's float32 sine gives 0.99999994 and
    PyTorch's CPU sine 1.0, which moved floor(50 sin) from JAX's 49 to 50
    and x1 by a pixel.  The port takes the sine in float64 and rounds it
    to float32, so its tables equal JAX's there."""
    angle = np.float32(np.float32(100802) * np.float32(0.02)) + np.float32(15)
    assert float(angle) == 2031.0399169921875
    assert float(jnp.sin(jnp.float32(angle))) == np.float32(0.99999994)
    assert float(torch.sin(torch.tensor(angle))) == 1.0
    assert float(syn_t._wave(torch.tensor([angle]))[0]) == 49.0
    got, want = tables_from_jax_draws(0, 100802, 51)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_wave_floor_matches_xla_over_a_million_counters():
    """floor(50 sin(t + i)) at counters 1 to 1,000,000 x 16 slots, the
    angles made in float32 by numpy as both packages make them: the port's
    `_wave` against JAX's jitted CPU float32 arithmetic, 0 differences
    (PyTorch's float32 sine moves the floor at some of them, counter
    100,802's slot 15 among them)."""
    counters = np.arange(1, 1_000_001, dtype=np.int64)
    angle = (counters.astype(np.float32) * np.float32(0.02))[:, None] + np.arange(CAP, dtype=np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.floor(50 * jnp.sin(a)))(angle))
    got = syn_t._wave(torch.from_numpy(angle)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert int((got != want).sum()) == 0


@pytest.fixture(scope="module")
def draws():
    """The torch draws of 10 seeds (10,000 frames) and JAX's of the same."""
    t = [syn_t.device_detection_draws(CAP, seed, device="cpu") for seed in SEEDS]
    j = [jax_draws(seed, np.arange(1000)) for seed in SEEDS]
    cat_t = {k: torch.cat([d[k] for d in t]).numpy() for k in t[0]}
    cat_j = {k: np.concatenate([d[k] for d in j]) for k in j[0]}
    return cat_t, cat_j


def test_box_count_is_uniform_on_3_to_7(draws):
    num_t, num_j = draws[0]["num"], draws[1]["num"]
    assert num_t.shape == (10_000,) and set(np.unique(num_t)) == {3, 4, 5, 6, 7}
    counts_t = np.bincount(num_t, minlength=8)[3:]
    counts_j = np.bincount(num_j, minlength=8)[3:]
    assert stats.chisquare(counts_t).pvalue >= P_MIN
    assert stats.chi2_contingency(np.stack([counts_t, counts_j]))[1] >= P_MIN


def test_class_frequencies_follow_the_weights(draws):
    cls_t, cls_j = draws[0]["cls"].ravel(), draws[1]["cls"].ravel()
    weights = np.asarray(syn_j.CLASS_WEIGHTS)
    counts_t = np.bincount(cls_t, minlength=8)
    counts_j = np.bincount(cls_j, minlength=8)
    assert counts_t.sum() == 10_000 * CAP and len(counts_t) == 8
    assert stats.chisquare(counts_t, weights / weights.sum() * counts_t.sum()).pvalue >= P_MIN
    assert stats.chi2_contingency(np.stack([counts_t, counts_j]))[1] >= P_MIN


def test_draw_ranges_match_jax(draws):
    d_t, d_j = draws
    for k, lo, hi in (("df", 0.3, 1.0), ("conf", 0.75, 0.98)):
        for d in (d_t, d_j):
            assert d[k].dtype == np.float32 and d[k].min() >= lo and d[k].max() < hi, k
        assert stats.ks_2samp(d_t[k].ravel()[:20_000], d_j[k].ravel()[:20_000]).pvalue >= P_MIN, k
    for k, lo, hi in (("jx", -10, 10), ("jy", -5, 5)):
        assert set(np.unique(d_t[k])) == set(range(lo, hi)) == set(np.unique(d_j[k])), k


def test_stream_has_period_1000_and_chunks_equal_the_whole():
    whole = syn_t.device_detection_stream(1300, seed=2, device="cpu")
    chunk = syn_t.device_detection_stream(64, seed=2, start_frame_count=101, device="cpu")
    late = syn_t.device_detection_stream(10, seed=2, start_frame_count=1001, device="cpu")
    for k, v in whole.items():
        assert torch.equal(chunk[k], v[100:164]), k
        assert torch.equal(late[k], v[1000:1010]), k
    # Keys repeat with period 1,000; the positions move with the counter.
    draws = syn_t.device_detection_draws(CAP, 2, device="cpu")
    assert torch.equal(whole["class_id"][0], draws["cls"][1]) and torch.equal(whole["class_id"][999], draws["cls"][0])
    assert torch.equal(whole["valid"][5], whole["valid"][1005])
    assert torch.equal(whole["confidence"][5], whole["confidence"][1005])
    other = syn_t.device_detection_stream(10, seed=3, start_frame_count=1001, device="cpu")
    assert not torch.equal(other["confidence"], late["confidence"])


def test_stream_tables_feed_the_runner():
    """The tables are the runner's detection inputs: 3-7 valid boxes a
    frame inside the frame, classes 0-7, confidences in [0.75, 0.98)."""
    s = syn_t.device_detection_stream(200, height=120, width=160, device="cpu")
    n = s["valid"].sum(1)
    assert s["bbox"].dtype == torch.float32 and s["class_id"].dtype == torch.int32
    assert int(n.min()) >= 3 and int(n.max()) <= 7
    assert torch.equal(s["valid"], torch.arange(CAP) < n[:, None])
    b = s["bbox"]
    assert bool((b[..., 0] >= 0).all() & (b[..., 2] <= 160).all() & (b[..., 1] >= 0).all() & (b[..., 3] <= 120).all())
