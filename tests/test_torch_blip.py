"""The port's BLIP captioner (models/blip.py) against the JAX package's, at
``BlipConfig.tiny()`` on the CPU.

Weights come from one jitted Flax ``BlipForCaptioning.init``, with the
leaves Flax initializes to constants (the class token, both position
embeddings, LayerNorm scales and biases, Dense biases) replaced by seeded
noise so that every parameter counts, and are carried to the port with
`utils.convert.blip_state_from_flax`.  Tolerances, with the maxima
measured on a CPU:

- vision states: atol 1e-5 (measured 2.0e-6 on states up to 3.1);
- logits: atol 1e-5 (measured 2.1e-6 on logits up to 3.7);
- greedy and beam-3 decodes: tokens and lengths equal, and every decision
  they rest on stands clear of what the measured gap between the two
  packages could move (`_greedy_margin`, `_beam_margins`; the smallest
  margins are printed);
- `preprocess_bgr`: atol 1e-5 after normalization (measured 1.7e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_autonomous_driving_perception_and_planning_torch.models import blip as tb
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import blip_state_from_flax
from multimodal_autonomous_driving_perception_and_planning_tpu.models import blip as jb

STATE_ATOL = 1e-5
LOGIT_ATOL = 1e-5
PIXEL_ATOL = 1e-5
IMG = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the same cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _perturbed(variables, seed=0):
    """Seeded noise in place of the leaves Flax initializes to constants."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        out = {}
        for name, value in tree.items():
            if isinstance(value, dict):
                out[name] = walk(value, path + [name])
                continue
            value = np.asarray(value)
            if name == "scale":
                value = 1.0 + 0.2 * rng.standard_normal(value.shape)
            elif name == "bias" or name in ("cls_token", "pos_embed", "position_embeddings"):
                value = 0.1 * rng.standard_normal(value.shape)
            out[name] = value.astype(np.float32)
        return out

    return {"params": walk(jax.tree_util.tree_map(np.asarray, variables["params"]), [])}


@pytest.fixture(scope="module")
def weights():
    """(JAX config, Flax variables, the port's model) on the same weights."""
    cfg = jb.BlipConfig.tiny()
    variables = jax.jit(jb.BlipForCaptioning(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32), jnp.zeros((1, 24), jnp.int32)
    )
    variables = _perturbed(variables)
    port = tb.BlipForCaptioning(tb.BlipConfig.tiny())
    port.load_state_dict(blip_state_from_flax(variables), strict=True)
    return cfg, variables, port.eval()


@pytest.fixture(scope="module")
def jax_decode(weights):
    """JAX's decoder logits on (ids, pixels), one jitted program a shape."""
    cfg, variables, _ = weights
    model = jb.BlipForCaptioning(cfg)

    @jax.jit
    def run(px, ids):
        kvs = model.apply(variables, px, method=jb.BlipForCaptioning.encode_cross)
        kvs = jax.tree_util.tree_map(lambda t: jnp.broadcast_to(t, (ids.shape[0],) + t.shape[1:]), kvs)
        return model.apply(variables, ids, kvs, method=jb.BlipForCaptioning.decode)

    return lambda px, ids: np.asarray(run(jnp.asarray(px), jnp.asarray(ids, jnp.int32)))


def _pixels(seed, batch=1):
    return np.random.default_rng(seed).standard_normal((batch, IMG, IMG, 3)).astype(np.float32)


def _nchw(px):
    return torch.from_numpy(np.ascontiguousarray(px.transpose(0, 3, 1, 2)))


def _port_logits(port, px, ids):
    with torch.inference_mode():
        kvs = port.encode_cross(_nchw(px))
        kvs = [tuple(t.expand(ids.shape[0], *t.shape[1:]) for t in kv) for kv in kvs]
        return port.decode(torch.as_tensor(ids, dtype=torch.int32), kvs).numpy()


def test_vision_states_match_flax(weights):
    """tests/test_converter_numerics.py:89's case, the port against Flax."""
    cfg, variables, port = weights
    px = _pixels(0)
    want = np.asarray(jb.BlipVisionModel(cfg).apply({"params": variables["params"]["vision"]}, jnp.asarray(px)))
    with torch.inference_mode():
        got = port.vision(_nchw(px)).numpy()
    assert got.shape == want.shape == (1, (IMG // 16) ** 2 + 1, cfg.vision_hidden)
    np.testing.assert_allclose(got, want, rtol=0, atol=STATE_ATOL)


def test_logits_match_flax(weights):
    """tests/test_converter_numerics.py:105's case: (1, 7) ids from bos."""
    cfg, variables, port = weights
    px = _pixels(1)
    ids = np.random.default_rng(2).integers(3, cfg.vocab_size, size=(1, 7)).astype(np.int32)
    ids[0, 0] = cfg.bos_token_id
    want = np.asarray(jb.BlipForCaptioning(cfg).apply(variables, jnp.asarray(px), jnp.asarray(ids)))
    with torch.inference_mode():
        got = port(_nchw(px), torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (1, 7, cfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def _greedy_margin(port, jax_decode, px_nhwc, seq, length, prompt_len, sep):
    """The smallest top-two logit margin of the decisions that wrote
    tokens prompt_len ... the last decoded one, each against twice the
    teacher-forced logit gap between the packages on the decoded buffer."""
    want = jax_decode(px_nhwc, seq[None])[0]
    got = _port_logits(port, px_nhwc, seq[None])[0]
    gap = float(np.abs(got - want).max())
    last = length if seq[length] == sep else length - 1
    margins = chip_smoke.top_two_margins(got[prompt_len - 1: last])
    assert len(margins) and margins.min() > 2 * gap, (margins.min(), gap)
    return float(margins.min()), gap


def test_greedy_decode_matches_jax(weights, jax_decode):
    """tests/test_vlm.py:105's case: a preprocessed random frame, a
    prompt of three in a buffer of four, 8 new tokens; tokens and length
    equal to JAX's `make_caption_fn`, deterministic, the prompt kept, and
    another image decodes otherwise (cross-attention is live)."""
    cfg, variables, port = weights
    _, caption_j = jb.make_caption_fn(cfg, max_new_tokens=8)
    _, caption_t = tb.make_caption_fn(tb.BlipConfig.tiny(), max_new_tokens=8, device="cpu")
    f = jax.jit(caption_j)
    prompt = np.asarray([cfg.bos_token_id, 5, 7, 0], np.int32)
    outs = []
    for seed in (0, 1):
        frame = np.random.default_rng(seed).integers(0, 255, (48, 64, 3)).astype(np.uint8)
        px = np.asarray(jb.preprocess_bgr(jnp.asarray(frame), cfg.image_size))
        ids_j, len_j = f(variables, jnp.asarray(px), jnp.asarray(prompt), jnp.asarray(3))
        ids_t, len_t = caption_t(port, _nchw(px), prompt, 3)
        ids_j, ids_t = np.asarray(ids_j), ids_t.numpy()
        assert ids_t.dtype == np.int32 and ids_t.shape == (12,)
        np.testing.assert_array_equal(ids_t, ids_j)
        assert int(len_t) == int(len_j)
        margin, gap = _greedy_margin(port, jax_decode, px, ids_t, int(len_t), 3, cfg.sep_token_id)
        print(f"greedy seed {seed}: smallest margin {margin:.3g}, logit gap {gap:.3g}")
        assert list(ids_t[:3]) == [cfg.bos_token_id, 5, 7] and 3 <= int(len_t) <= 12
        np.testing.assert_array_equal(caption_t(dict(port.state_dict()), _nchw(px), prompt, 3)[0].numpy(), ids_t)
        outs.append(ids_t)
    assert not np.array_equal(outs[0], outs[1])


def _beam_margins(port, jax_decode, px, prompt, prompt_len, max_new, sep):
    """`chip_smoke.replay_beam` on the port's log-probabilities, and each
    step's bound from JAX's log-probabilities on the same running
    sequences (`chip_smoke.beam_bounds`)."""
    logp_fn = chip_smoke.blip_logp_fn(port, port.encode_cross(_nchw(px)), 3)
    replay = chip_smoke.replay_beam(logp_fn, prompt, prompt_len, max_new, 3, sep)

    def jax_logp(run_seqs, i):
        return np.asarray(jax.nn.log_softmax(jnp.asarray(jax_decode(px, run_seqs)[:, i - 1]), axis=-1))

    return replay, np.asarray(replay["margins"]), chip_smoke.beam_bounds(replay, jax_logp)


@pytest.mark.parametrize("seed,max_new", [(3, 8), (5, 12), (11, 20)])
def test_beam3_decode_matches_jax(weights, jax_decode, seed, max_new):
    """tests/test_converter_numerics.py:158's cases: beam-3 from bos alone
    at 8, 12 and 20 new tokens; tokens and length equal to JAX's
    `make_beam_caption_fn`, and to `chip_smoke.replay_beam`'s numpy search
    on the port's log-probabilities, every decision clear of the gap."""
    cfg, variables, port = weights
    px = _pixels(seed)
    prompt = np.asarray([cfg.bos_token_id], np.int32)
    _, caption_j = jb.make_beam_caption_fn(cfg, max_new_tokens=max_new, num_beams=3)
    _, caption_t = tb.make_beam_caption_fn(tb.BlipConfig.tiny(), max_new_tokens=max_new, num_beams=3, device="cpu")
    ids_j, len_j = jax.jit(caption_j)(variables, jnp.asarray(px), jnp.asarray(prompt), jnp.asarray(1))
    ids_t, len_t = caption_t(port, _nchw(px), prompt, 1)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert int(len_t) == int(len_j)
    with torch.inference_mode():
        replay, margins, bounds = _beam_margins(port, jax_decode, px, prompt, 1, max_new, cfg.sep_token_id)
    np.testing.assert_array_equal(replay["seq"], ids_t.numpy())
    assert replay["length"] == int(len_t)
    print(f"beam seed {seed}: smallest margin {margins.min():.3g}, "
          f"smallest margin over its bound {(margins / bounds).min():.3g}")
    assert (margins > bounds).all(), list(zip(margins, bounds))


@pytest.mark.parametrize("case", ["fin_mask_ties", "all_neg", "quantized"])
def test_top_k_orders_ties_as_lax_top_k(case):
    """The beam's top-k: `tb.top_k` (a stable descending sort) gives
    ``jax.lax.top_k``'s values and indices, ties in index order.  In the
    merged finished pool the exact NEG ties decide which entries are kept,
    and so `fin_mask` and the early-stop test."""
    neg = np.float32(tb.NEG)
    rng = np.random.default_rng(0)
    if case == "fin_mask_ties":
        # Pool (3) then candidates (6): one real score, the rest NEG; the
        # mask marks finished entries, NEG among them.
        scores = np.asarray([neg, -2.5, neg, neg, neg, -1.25, neg, neg, neg], np.float32)
        mask = np.asarray([True, True, False, False, True, True, True, False, False])
        k = 3
    elif case == "all_neg":
        scores = np.full(9, neg, np.float32)
        mask = np.asarray([True, False, True, False, True, False, True, False, True])
        k = 3
    else:
        scores = (rng.integers(-4, 0, 3 * 64) * 0.5).astype(np.float32)
        mask = rng.random(3 * 64) < 0.5
        k = 6
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), k)
    got_v, got_i = tb.top_k(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(mask[got_i.numpy()], mask[np.asarray(want_i)])
    if case == "fin_mask_ties":
        # The lower-indexed NEG tie (a finished entry) is kept: the pool
        # reads as full, as in JAX.
        assert mask[got_i.numpy()].all()


@pytest.mark.parametrize("shape,size", [((720, 1280), 384), ((48, 64), 64), ((300, 200), 384)])
def test_preprocess_matches_jax(shape, size):
    """`preprocess_bgr` against JAX's: ``jax.image.resize(..., "cubic")``
    antialiases on downscale, as ``F.interpolate(antialias=True)`` does."""
    frame = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,)).astype(np.uint8)
    want = np.asarray(jb.preprocess_bgr(jnp.asarray(frame), size))
    got = tb.preprocess_bgr(torch.from_numpy(frame), size).numpy()
    assert got.shape == (1, 3, size, size)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=0, atol=PIXEL_ATOL)


def _hf_archive(weights, variant="fused"):
    """An HF-named state dict of the test weights (`chip_smoke.hf_state_from_port`):
    the vision qkv fused, or as {q,k,v}_proj; or, as safetensors leave it,
    the decoder bias only as ``cls.predictions.bias``."""
    cfg, _, port = weights
    sd = chip_smoke.hf_state_from_port(port.state_dict(), cfg)
    if variant == "split":
        h = cfg.vision_hidden
        for i in range(cfg.vision_layers):
            p = f"vision_model.encoder.layers.{i}.self_attn"
            for part in ("weight", "bias"):
                fused = sd.pop(f"{p}.qkv.{part}")
                for j, n in enumerate("qkv"):
                    sd[f"{p}.{n}_proj.{part}"] = fused[j * h: (j + 1) * h]
    elif variant == "bias_only":
        sd["text_decoder.cls.predictions.bias"] = sd.pop("text_decoder.cls.predictions.decoder.bias")
    # Keys both loaders ignore.
    sd["text_decoder.bert.embeddings.position_ids"] = np.arange(cfg.max_position)[None]
    sd["text_decoder.cls.predictions.extra"] = np.zeros(3, np.float32)
    return sd


@pytest.mark.parametrize("variant", ["fused", "split", "bias_only"])
def test_load_torch_state_dict_matches_jax_loader(weights, tmp_path, variant):
    """An HF-named archive through the port's `load_torch_state_dict` and
    JAX's: the same parameters, bit for bit, and those of the weights it
    was written from."""
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.weights import (
        load_npz_state_dict,
        save_npz_state_dict,
    )

    cfg, _, port = weights
    path = str(tmp_path / "blip.npz")
    save_npz_state_dict(path, _hf_archive(weights, variant), format="madpp-blip-v1")
    sd, meta = load_npz_state_dict(path)
    assert meta == {"format": "madpp-blip-v1"}
    got = tb.load_torch_state_dict(sd, tb.BlipConfig.tiny())
    want = blip_state_from_flax(jax.tree_util.tree_map(np.asarray, jb.load_torch_state_dict(sd, cfg)))
    assert got.keys() == want.keys() == port.state_dict().keys()
    for k, v in port.state_dict().items():
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], v), k


@pytest.mark.parametrize("fault", ["missing", "mismatch", "unexpected"])
def test_load_torch_state_dict_errors(weights, fault, monkeypatch):
    """tests/test_vlm.py:140's converter, its failures: a missing key, a
    wrong shape and a parameter the model lacks each raise with JAX's
    message, naming the port's parameter."""
    cfg, _, _ = weights
    sd = _hf_archive(weights)
    if fault == "missing":
        del sd["text_decoder.bert.encoder.layer.0.intermediate.dense.bias"]
        line = "missing text.layer0.fc1.bias (64,)"
    elif fault == "mismatch":
        sd["text_decoder.cls.predictions.decoder.bias"] = np.zeros(cfg.vocab_size + 1, np.float32)
        line = f"shape mismatch text.decoder.bias: got ({cfg.vocab_size + 1},), want ({cfg.vocab_size},)"
    else:
        # The map only writes parameters the model has: take one away from
        # the model's side.
        shapes = tb.expected_shapes(tb.BlipConfig.tiny())
        del shapes["text.transform_ln.bias"]
        monkeypatch.setattr(tb, "expected_shapes", lambda cfg: shapes)
        line = "unexpected text.transform_ln.bias"
    with pytest.raises(ValueError) as err:
        tb.load_torch_state_dict(sd, tb.BlipConfig.tiny())
    assert str(err.value).startswith("BLIP state dict conversion incomplete:\n  ")
    assert str(err.value).splitlines()[1:] == ["  " + line]
    if fault != "unexpected":
        with pytest.raises(ValueError, match="BLIP state dict conversion incomplete"):
            jb.load_torch_state_dict(sd, cfg)
    else:
        tb.load_torch_state_dict(sd, tb.BlipConfig.tiny(), validate=False)


def test_caption_fns_refuse_what_jax_refuses(weights):
    """The same ValueErrors as JAX: a prompt buffer plus budget beyond
    max_position, in init_fn and at caption time."""
    _, _, port = weights
    cfg = tb.BlipConfig.tiny()
    for make in (tb.make_caption_fn, tb.make_beam_caption_fn):
        init_fn, caption = make(cfg, max_new_tokens=20, device="cpu")
        with pytest.raises(ValueError, match="prompt_capacity \\+ max_new_tokens = 36 exceeds max_position 32"):
            init_fn(torch.Generator().manual_seed(0), prompt_capacity=16)
        with pytest.raises(ValueError, match="decode length 33 exceeds max_position 32"):
            caption(port, _nchw(_pixels(0)), np.zeros(13, np.int32), 1)
    params = tb.make_caption_fn(cfg, max_new_tokens=8, device="cpu")[0](torch.Generator().manual_seed(0))
    assert params.keys() == port.state_dict().keys()
