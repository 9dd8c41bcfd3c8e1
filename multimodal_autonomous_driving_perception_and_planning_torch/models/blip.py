"""BLIP image captioning in PyTorch, NCHW.

Port of the JAX package's models/blip.py, the
``Salesforce/blip-image-captioning-base`` architecture:

  * vision: ViT-B/16 (pre-LN), 384x384 inputs -> 577 tokens;
  * text: a BERT-base *post-LN* decoder with causal self-attention and
    per-layer cross-attention over the vision states, BERT LM head;
  * greedy (`make_caption_fn`) and beam (`make_beam_caption_fn`) decodes
    over a fixed-size token buffer.

Submodules carry the Flax module names (``vision.layer{i}.attn.query``,
``text.layer{i}.cross_ln``, ...), so a Flax path maps to a port path by a
rename (utils/convert.py `blip_state_from_flax`); `load_torch_state_dict`
maps a HuggingFace ``BlipForConditionalGeneration`` state dict.

Numerics are the JAX package's: float32 with TF32 off in the caption
functions (the JAX package pins float32 matmul passes); attention op for op
(scores by matmul, the masked fill with the dtype's minimum, softmax, the
second matmul); the exact erf GELU.  LayerNorm is `F.layer_norm`, whose
two-pass variance stands within ulps of Flax's E[x^2] - E[x]^2.  The decode
recomputes the whole buffer at every step, as the JAX package does (no KV
cache).  The JAX package computes BLIP in XLA with no Pallas kernel, so no
hand-written kernel stands here: the products are `torch.matmul` and
`F.linear`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import float32_matmuls, resolve_device


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    # Vision (BlipVisionConfig defaults for the base checkpoint).
    image_size: int = 384
    patch_size: int = 16
    vision_hidden: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp: int = 3072
    vision_eps: float = 1e-5
    # Text (BlipTextConfig defaults).
    vocab_size: int = 30524
    text_hidden: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_mlp: int = 3072
    text_eps: float = 1e-12
    max_position: int = 512
    # Special tokens (bert-base-uncased vocab + BLIP's [DEC]).
    bos_token_id: int = 30522
    sep_token_id: int = 102
    pad_token_id: int = 0

    @classmethod
    def tiny(cls) -> "BlipConfig":
        """A test-sized config (random init, structural tests)."""
        return cls(
            image_size=64,
            patch_size=16,
            vision_hidden=32,
            vision_layers=2,
            vision_heads=2,
            vision_mlp=64,
            vocab_size=64,
            text_hidden=32,
            text_layers=2,
            text_heads=2,
            text_mlp=64,
            max_position=32,
            bos_token_id=1,
            sep_token_id=2,
            pad_token_id=0,
        )


def _attention(q, k, v, mask=None):
    """Scaled dot-product attention; q/k/v are (B, H, L, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v)


class MultiHeadAttention(nn.Module):
    """``kv_features`` is the width of what keys and values project from
    (the vision width for cross-attention); Flax infers it."""

    def __init__(self, hidden: int, heads: int, kv_features: Optional[int] = None):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        kv_features = kv_features or hidden
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(kv_features, hidden)
        self.value = nn.Linear(kv_features, hidden)
        self.output = nn.Linear(hidden, hidden)

    def _split(self, t):
        b, l, _ = t.shape
        d = self.hidden // self.heads
        return t.reshape(b, l, self.heads, d).transpose(1, 2)

    def project_kv(self, kv):
        """Precompute (k, v) heads: loop-invariant for cross-attention."""
        return self._split(self.key(kv)), self._split(self.value(kv))

    def attend(self, x, k, v, mask=None):
        q = self._split(self.query(x))
        o = _attention(q, k, v, mask)
        b, _, l, _ = o.shape
        o = o.transpose(1, 2).reshape(b, l, self.hidden)
        return self.output(o)

    def forward(self, x, kv, mask=None):
        k, v = self.project_kv(kv)
        return self.attend(x, k, v, mask)


class ViTLayer(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        c = cfg
        self.ln1 = nn.LayerNorm(c.vision_hidden, eps=c.vision_eps)
        self.attn = MultiHeadAttention(c.vision_hidden, c.vision_heads)
        self.ln2 = nn.LayerNorm(c.vision_hidden, eps=c.vision_eps)
        self.fc1 = nn.Linear(c.vision_hidden, c.vision_mlp)
        self.fc2 = nn.Linear(c.vision_mlp, c.vision_hidden)

    def forward(self, x):
        h = self.ln1(x)
        x = x + self.attn(h, h)
        h = self.ln2(x)
        h = self.fc1(h)
        h = F.gelu(h)
        h = self.fc2(h)
        return x + h


class BlipVisionModel(nn.Module):
    """Pre-LN ViT on NCHW pixels; returns (B, 1 + n_patches, hidden) states."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        c = self.cfg = cfg
        n = (c.image_size // c.patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, c.vision_hidden, c.patch_size, stride=c.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.vision_hidden))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, c.vision_hidden))
        for i in range(c.vision_layers):
            self.add_module(f"layer{i}", ViTLayer(c))
        self.post_ln = nn.LayerNorm(c.vision_hidden, eps=c.vision_eps)

    def forward(self, pixel_values):
        c = self.cfg
        b = pixel_values.shape[0]
        x = self.patch_embed(pixel_values)  # (B, hidden, S/p, S/p)
        x = x.flatten(2).transpose(1, 2)  # row-major patches, as Flax's NHWC reshape
        x = torch.cat([self.cls_token.expand(b, 1, c.vision_hidden), x], dim=1)
        x = x + self.pos_embed
        for i in range(c.vision_layers):
            x = getattr(self, f"layer{i}")(x)
        return self.post_ln(x)


class BertDecoderLayer(nn.Module):
    """Post-LN BERT layer with causal self-attention + cross-attention."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        c = cfg
        self.self_attn = MultiHeadAttention(c.text_hidden, c.text_heads)
        self.cross_attn = MultiHeadAttention(c.text_hidden, c.text_heads, kv_features=c.vision_hidden)
        self.self_ln = nn.LayerNorm(c.text_hidden, eps=c.text_eps)
        self.cross_ln = nn.LayerNorm(c.text_hidden, eps=c.text_eps)
        self.fc1 = nn.Linear(c.text_hidden, c.text_mlp)
        self.fc2 = nn.Linear(c.text_mlp, c.text_hidden)
        self.out_ln = nn.LayerNorm(c.text_hidden, eps=c.text_eps)

    def cross_kv(self, vision):
        return self.cross_attn.project_kv(vision)

    def forward(self, x, cross_kv, self_mask):
        a = self.self_attn(x, x, self_mask)
        x = self.self_ln(x + a)
        a = self.cross_attn.attend(x, *cross_kv)
        x = self.cross_ln(x + a)
        h = self.fc1(x)
        h = F.gelu(h)
        h = self.fc2(h)
        return self.out_ln(x + h)


class BlipTextDecoder(nn.Module):
    """BERT-style causal decoder over the vision states -> vocab logits."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        c = self.cfg = cfg
        self.word_embeddings = nn.Embedding(c.vocab_size, c.text_hidden)
        self.position_embeddings = nn.Parameter(torch.zeros(c.max_position, c.text_hidden))
        self.emb_ln = nn.LayerNorm(c.text_hidden, eps=c.text_eps)
        for i in range(c.text_layers):
            self.add_module(f"layer{i}", BertDecoderLayer(c))
        self.transform = nn.Linear(c.text_hidden, c.text_hidden)
        self.transform_ln = nn.LayerNorm(c.text_hidden, eps=c.text_eps)
        self.decoder = nn.Linear(c.text_hidden, c.vocab_size)

    @property
    def layers(self) -> List[BertDecoderLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.cfg.text_layers)]

    def cross_kv(self, vision):
        """Per-layer cross-attention (k, v): computed once per image."""
        return [layer.cross_kv(vision) for layer in self.layers]

    def forward(self, input_ids, cross_kvs):
        c = self.cfg
        L = input_ids.shape[1]
        if L > c.max_position:
            raise ValueError(f"sequence length {L} exceeds max_position {c.max_position}")
        x = self.word_embeddings(input_ids)
        x = x + self.position_embeddings[None, :L]
        x = self.emb_ln(x)

        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()[None, None]
        for layer, kv in zip(self.layers, cross_kvs):
            x = layer(x, kv, causal)

        # BERT LM head: transform (dense + gelu + LN) then decode to vocab.
        h = self.transform(x)
        h = F.gelu(h)
        h = self.transform_ln(h)
        return self.decoder(h)


class BlipForCaptioning(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = BlipVisionModel(cfg)
        self.text = BlipTextDecoder(cfg)

    def forward(self, pixel_values, input_ids):
        vision = self.vision(pixel_values)
        return self.text(input_ids, self.text.cross_kv(vision))

    def encode_cross(self, pixel_values):
        """Vision forward + per-layer cross-attention K/V (loop-invariant
        across decode steps: computed once per image, not per token)."""
        return self.text.cross_kv(self.vision(pixel_values))

    def decode(self, input_ids, cross_kvs):
        return self.text(input_ids, cross_kvs)


_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to (-2, 2)


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initializers, in place and in registration order:
    Dense and Conv kernels ``lecun_normal`` (a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in), their biases 0;
    Embed a normal of variance 1 / features; LayerNorm scale 1, bias 0;
    the class token and both position embeddings 0.  ``generator`` must
    live on the parameters' device."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                nn.init.trunc_normal_(mod.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                mod.weight.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, math.sqrt(1.0 / mod.embedding_dim), generator=generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, BlipVisionModel):
                mod.cls_token.zero_()
                mod.pos_embed.zero_()
            elif isinstance(mod, BlipTextDecoder):
                mod.position_embeddings.zero_()


# OpenAI CLIP normalization, used by the BLIP processor.
IMAGE_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding, as a fused multiply-add
    gives it (exact in float64 for float32 operands of these sizes)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5 (jax.image's "cubic"), each
    multiply-add contracted as XLA compiles it."""
    near = _fma((_fma(1.5, x, -2.5) * x).astype(np.float32), x, 1.0)
    far = _fma(_fma(_fma(-0.5, x, 2.5), x, -4.0), x, 2.0)
    out = np.where(x >= 1.0, far, near)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def cubic_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The (in, out) float32 matrix with which ``jax.image.resize(...,
    "cubic")`` resamples one axis, computed op for op as JAX's
    ``compute_weight_mat`` does with its default ``antialias=True``: Keys'
    kernel widened by the scale on downscale, each column normalized by its
    sum, columns whose sample falls outside the input zeroed.  XLA fuses
    the sample positions' and the kernel's multiply-adds (one rounding
    each); without that, a position near 100 moves by half an ulp (4e-6)
    and a weight by as much (measured at 200 -> 384).  The weights stand
    within 2 ulps of JAX's."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = _fma(np.arange(out_size, dtype=f32) + f32(0.5), f32(inv_scale), -0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def preprocess_bgr(frame_bgr, image_size: int) -> torch.Tensor:
    """uint8 BGR (H, W, 3) -> normalized (1, 3, S, S) model input on the
    frame's device.

    Cubic resize + CLIP mean/std, as the JAX package's ``jax.image.resize
    (..., "cubic")``, which antialiases on downscale: its weight matrices
    (`cubic_resize_weights`) applied by float32 products, an axis whose
    size does not change left as it is.  (``F.interpolate``'s bicubic with
    ``antialias=True`` has the same kernel but other arithmetic: its pixels
    stand 2e-5 off JAX's at 300x200 -> 384 on the CPU after normalization,
    and its CUDA path 5e-5 off its CPU path at 480x640 -> 384.)
    """
    frame = torch.as_tensor(frame_bgr)
    dev = frame.device
    rgb = frame.flip(-1).to(torch.float32) / torch.full((), 255.0, device=dev)
    x = rgb.permute(2, 0, 1)  # (3, H, W)
    h, w = x.shape[1:]
    with float32_matmuls():
        if h != image_size:
            x = torch.from_numpy(cubic_resize_weights(h, image_size)).to(dev).T @ x
        if w != image_size:
            x = x @ torch.from_numpy(cubic_resize_weights(w, image_size)).to(dev)
    mean = torch.as_tensor(IMAGE_MEAN, device=dev)[:, None, None]
    std = torch.as_tensor(IMAGE_STD, device=dev)[:, None, None]
    return ((x - mean) / std)[None]


def model_from_state_dict(params: Dict[str, torch.Tensor], cfg: BlipConfig, device=None) -> BlipForCaptioning:
    """`BlipForCaptioning` in eval mode around a state dict's tensors, moved
    to ``device`` where one is given.  Built on the meta device: no
    initialization, and no copy of a tensor already in place."""
    with torch.device("meta"):
        model = BlipForCaptioning(cfg)
    if device is not None:
        params = {k: v.to(device) for k, v in params.items()}
    model.load_state_dict(params, strict=True, assign=True)
    return model.eval()


def _model_of(params_or_model, cfg: BlipConfig) -> BlipForCaptioning:
    """The model itself, or one around a state dict's tensors."""
    if isinstance(params_or_model, nn.Module):
        return params_or_model
    return model_from_state_dict(params_or_model, cfg)


def _make_init_fn(cfg: BlipConfig, max_new_tokens: int, dev: torch.device):
    def init_fn(generator: torch.Generator, prompt_capacity: int = 16) -> Dict[str, torch.Tensor]:
        """Seeded parameters, a ``state_dict`` of `BlipForCaptioning` on the
        caption function's device (``generator`` is a CPU generator)."""
        if prompt_capacity + max_new_tokens > cfg.max_position:
            raise ValueError(
                f"prompt_capacity + max_new_tokens = "
                f"{prompt_capacity + max_new_tokens} exceeds max_position "
                f"{cfg.max_position}"
            )
        fresh = BlipForCaptioning(cfg)
        init_params(fresh, generator)
        return {k: v.to(dev) for k, v in fresh.state_dict().items()}

    return init_fn


def _prompt_buffer(cfg: BlipConfig, prompt_ids, max_new_tokens: int, dev) -> torch.Tensor:
    """The (L,) int32 decode buffer, L = P + max_new_tokens, the prompt first."""
    prompt = torch.as_tensor(prompt_ids, dtype=torch.int32).to(dev)
    L = prompt.shape[0] + max_new_tokens
    if L > cfg.max_position:
        raise ValueError(f"decode length {L} exceeds max_position {cfg.max_position}")
    buf = torch.zeros(L, dtype=torch.int32, device=dev)
    buf[: prompt.shape[0]] = prompt
    return buf


def _finish(cfg: BlipConfig, seq: torch.Tensor, prompt_len: int, max_new_tokens: int):
    """Length = position of the first SEP at/after prompt_len, else the end
    of the decode; everything after it padded."""
    L = seq.shape[0]
    pos = torch.arange(L, device=seq.device)
    is_end = (seq == cfg.sep_token_id) & (pos >= prompt_len)
    length = torch.where(
        is_end.any(),
        torch.argmax(is_end.to(torch.int32)),
        torch.tensor(min(prompt_len + max_new_tokens, L), device=seq.device),
    )
    seq = torch.where(pos <= length, seq, torch.full_like(seq, cfg.pad_token_id))
    return seq, length.to(torch.int32)


def make_caption_fn(cfg: BlipConfig, max_new_tokens: int = 40, device="cuda"):
    """Build (init_fn, caption_fn).

    ``caption_fn(params_or_model, pixel_values, prompt_ids, prompt_len)``
    greedily decodes up to ``max_new_tokens`` tokens after ``prompt_len``
    and returns (token_ids (L,) int32, length) with everything after the
    SEP token padded.  ``params_or_model`` is a `BlipForCaptioning` or its
    state dict on ``device``; ``prompt_ids`` is a fixed-size (P,) buffer
    (bos + prompt tokens, padded); L = P + max_new_tokens.  The vision
    forward and all cross-attention K/V projections run once per image.

    The JAX package scans steps i = 1 ... L-1 and decodes only where
    prompt_len <= i < prompt_len + max_new_tokens and no SEP came yet; the
    other steps leave the buffer as it is.  This loop runs only the steps
    that decode and stops after the SEP, with the same outputs.
    """
    dev = resolve_device(device)

    @torch.inference_mode()
    def caption_fn(params_or_model, pixel_values, prompt_ids, prompt_len):
        model = _model_of(params_or_model, cfg)
        prompt_len = int(prompt_len)
        with float32_matmuls():
            buf = _prompt_buffer(cfg, prompt_ids, max_new_tokens, dev)
            cross_kvs = model.encode_cross(torch.as_tensor(pixel_values, dtype=torch.float32).to(dev))
            for i in range(max(1, prompt_len), min(buf.shape[0], prompt_len + max_new_tokens)):
                logits = model.decode(buf[None], cross_kvs)[0]
                # Next token predicted from position i-1, written at i.
                nxt = torch.argmax(logits[i - 1])
                buf[i] = nxt
                if int(nxt) == cfg.sep_token_id:
                    break
            return _finish(cfg, buf, prompt_len, max_new_tokens)

    return _make_init_fn(cfg, max_new_tokens, dev), caption_fn


NEG = -1.0e9  # the beam search's stand-in for minus infinity (a float32)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of a 1-D tensor and their indices, ties in
    index order, as ``jax.lax.top_k`` gives them (``torch.topk`` promises no
    order among ties, and the beam's pools are full of exact ``NEG`` ties)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def make_beam_caption_fn(cfg: BlipConfig, max_new_tokens: int = 40, num_beams: int = 3, device="cuda"):
    """Beam-search captioning, the reference's decode semantics.

    The reference captions with ``generate(num_beams=3)``
    (src/tagging/vlm_tagger.py:177).  The JAX package replicates
    transformers' vectorized beam search (generation/utils.py
    `_beam_search`, v4.57) as a fixed-width scan, and this is that scan
    step for step: 2N candidate continuations per step, running vs
    finished beam pools, HF's length-penalty normalization
    (``sum_logprobs / generated_len``), the early_stopping=False "highest
    attainable score" heuristic, and freeze-on-done.  Every top-k is
    `top_k` (ties by index).  Defaults (length_penalty=1.0,
    early_stopping=False, do_sample=False) match HF GenerationConfig.

    Same contract as `make_caption_fn`'s caption_fn.  The loop runs the
    steps the scan would not freeze and stops once the search is done.
    """
    dev = resolve_device(device)
    N = num_beams
    K = 2 * num_beams  # beams_to_keep with one EOS token

    @torch.inference_mode()
    def caption_fn(params_or_model, pixel_values, prompt_ids, prompt_len):
        model = _model_of(params_or_model, cfg)
        prompt_len = int(prompt_len)
        with float32_matmuls():
            prompt_buf = _prompt_buffer(cfg, prompt_ids, max_new_tokens, dev)
            L, V = prompt_buf.shape[0], cfg.vocab_size
            cross_kvs = model.encode_cross(torch.as_tensor(pixel_values, dtype=torch.float32).to(dev))
            # Broadcast the (1, H, S, D) cross K/V to the beam batch.
            cross_kvs = [tuple(t.expand(N, *t.shape[1:]) for t in kv) for kv in cross_kvs]

            run_seqs = prompt_buf.expand(N, L).clone()
            run_scores = torch.full((N,), NEG, device=dev)
            run_scores[0] = 0.0
            fin_seqs = run_seqs.clone()
            fin_scores = torch.full((N,), NEG, device=dev)
            fin_mask = torch.zeros(N, dtype=torch.bool, device=dev)
            unsat = torch.ones((), dtype=torch.bool, device=dev)  # early-stop heuristic unsatisfied
            max_len_total = prompt_len + max_new_tokens
            top_beam_mask = torch.arange(K, device=dev) < N  # only ranks < N may finalize

            for i in range(max(1, prompt_len), min(L, max_len_total)):
                logits = model.decode(run_seqs, cross_kvs)  # (N, L, V)
                logp = torch.log_softmax(logits[:, i - 1].to(torch.float32), dim=-1)
                cand = (run_scores[:, None] + logp).reshape(N * V)
                topk_vals, topk_idx = top_k(cand, K)
                topk_beam = topk_idx // V
                topk_tok = (topk_idx % V).to(torch.int32)
                topk_seqs = run_seqs[topk_beam]
                topk_seqs[:, i] = topk_tok  # (K, L)

                # Stopping criteria per candidate: EOS just written, or the
                # sequence has reached max length.
                hits = (topk_tok == cfg.sep_token_id) | (i + 1 >= max_len_total)

                # Next running beams: best N candidates that did NOT finish.
                run_cand_scores = topk_vals + hits.to(torch.float32) * NEG
                _, keep = top_k(run_cand_scores, N)
                new_run_seqs = topk_seqs[keep]
                new_run_scores = run_cand_scores[keep]

                # Finished pool: length-penalized scores of candidates that
                # finished at rank < N, merged with the existing pool.  A
                # tensor divisor keeps a true division on the card (a
                # Python number turns into a reciprocal multiply there);
                # length_penalty 1.0 makes gen_len ** 1.0 gen_len itself.
                gen_len = torch.full((), float(i + 1 - prompt_len), device=dev)
                pen = topk_vals / gen_len
                did_finish = hits & top_beam_mask
                pen = torch.where(did_finish & unsat, pen, NEG)
                merged_scores = torch.cat([fin_scores, pen])
                merged_seqs = torch.cat([fin_seqs, topk_seqs])
                merged_mask = torch.cat([fin_mask, did_finish])
                _, best = top_k(merged_scores, N)
                fin_seqs = merged_seqs[best]
                fin_scores = merged_scores[best]
                fin_mask = merged_mask[best]

                # Early-stopping heuristic (early_stopping=False branch): can
                # the best running beam still beat the worst finished one?
                best_possible = new_run_scores[0] / gen_len
                worst_finished = torch.where(fin_mask.all(), fin_scores.min(), NEG)
                unsat = unsat & (best_possible > worst_finished)
                run_seqs, run_scores = new_run_seqs, new_run_scores
                if not bool(unsat & ~hits.all()):
                    break  # done: the scan freezes every later step

            return _finish(cfg, fin_seqs[0], prompt_len, max_new_tokens)

    return _make_init_fn(cfg, max_new_tokens, dev), caption_fn


# ---------------------------------------------------------------------------
# Weight import from HuggingFace torch BlipForConditionalGeneration
# ---------------------------------------------------------------------------


def _float32(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(leaf, np.float32))


def expected_shapes(cfg: BlipConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of `BlipForCaptioning` and its shape (built on the
    meta device: no memory, no initialization)."""
    with torch.device("meta"):
        model = BlipForCaptioning(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def load_torch_state_dict(state_dict: Dict[str, Any], cfg: BlipConfig, validate: bool = True):
    """Convert a torch ``BlipForConditionalGeneration.state_dict()`` (torch
    tensors or numpy arrays) into the port's state dict (float32 CPU
    tensors), for ``BlipForCaptioning.load_state_dict``.

    The JAX package's `load_torch_state_dict` key for key: the fused vision
    ``qkv`` is split (``{q,k,v}_proj`` are accepted too), the decoder bias
    is taken from ``cls.predictions.bias`` where safetensors checkpoints
    leave it only there, and every other key is ignored.  Torch layouts
    need no transpose; the class token and the vision position embedding
    are reshaped to (1, 1, h) and (1, n + 1, h).

    ``validate=True`` (default) checks the result against the model's own
    parameter shapes and raises listing any missing, mismatched or
    unexpected parameter: a partially-mapped checkpoint must fail loudly
    here, not as an opaque error at caption time.
    """
    params: Dict[str, torch.Tensor] = {}

    def put(path, leaf):
        params[".".join(path)] = _float32(leaf)

    def dense(prefix_hf, path):
        w = state_dict.get(prefix_hf + ".weight")
        if w is None:
            return
        put(path + ["weight"], w)
        b = state_dict.get(prefix_hf + ".bias")
        if b is not None:
            put(path + ["bias"], b)

    def ln(prefix_hf, path):
        if prefix_hf + ".weight" not in state_dict:
            return
        put(path + ["weight"], state_dict[prefix_hf + ".weight"])
        put(path + ["bias"], state_dict[prefix_hf + ".bias"])

    # Vision.
    v = "vision_model"
    if f"{v}.embeddings.class_embedding" in state_dict:
        put(["vision", "cls_token"], _float32(state_dict[f"{v}.embeddings.class_embedding"]).reshape(1, 1, -1))
        put(
            ["vision", "pos_embed"],
            _float32(state_dict[f"{v}.embeddings.position_embedding"]).reshape(1, -1, cfg.vision_hidden),
        )
        put(["vision", "patch_embed", "weight"], state_dict[f"{v}.embeddings.patch_embedding.weight"])
        pb = state_dict.get(f"{v}.embeddings.patch_embedding.bias")
        if pb is not None:
            put(["vision", "patch_embed", "bias"], pb)
    for i in range(cfg.vision_layers):
        hf = f"{v}.encoder.layers.{i}"
        fl = ["vision", f"layer{i}"]
        ln(f"{hf}.layer_norm1", fl + ["ln1"])
        ln(f"{hf}.layer_norm2", fl + ["ln2"])
        # HF BLIP vision uses a single qkv projection.
        qkv_w = state_dict.get(f"{hf}.self_attn.qkv.weight")
        if qkv_w is not None:
            qkv_w = _float32(qkv_w)
            h = cfg.vision_hidden
            for j, name in enumerate(("query", "key", "value")):
                put(fl + ["attn", name, "weight"], qkv_w[j * h : (j + 1) * h])
            qkv_b = _float32(state_dict[f"{hf}.self_attn.qkv.bias"])
            for j, name in enumerate(("query", "key", "value")):
                put(fl + ["attn", name, "bias"], qkv_b[j * h : (j + 1) * h])
        else:
            for name in ("query", "key", "value"):
                dense(f"{hf}.self_attn.{name[0]}_proj", fl + ["attn", name])
        dense(f"{hf}.self_attn.projection", fl + ["attn", "output"])
        dense(f"{hf}.mlp.fc1", fl + ["fc1"])
        dense(f"{hf}.mlp.fc2", fl + ["fc2"])
    ln(f"{v}.post_layernorm", ["vision", "post_ln"])

    # Text decoder.
    t = "text_decoder.bert"
    emb = state_dict.get(f"{t}.embeddings.word_embeddings.weight")
    if emb is not None:
        put(["text", "word_embeddings", "weight"], emb)
        put(["text", "position_embeddings"], state_dict[f"{t}.embeddings.position_embeddings.weight"])
        ln(f"{t}.embeddings.LayerNorm", ["text", "emb_ln"])
    for i in range(cfg.text_layers):
        hf = f"{t}.encoder.layer.{i}"
        fl = ["text", f"layer{i}"]
        for name in ("query", "key", "value"):
            dense(f"{hf}.attention.self.{name}", fl + ["self_attn", name])
        dense(f"{hf}.attention.output.dense", fl + ["self_attn", "output"])
        ln(f"{hf}.attention.output.LayerNorm", fl + ["self_ln"])
        for name in ("query", "key", "value"):
            dense(f"{hf}.crossattention.self.{name}", fl + ["cross_attn", name])
        dense(f"{hf}.crossattention.output.dense", fl + ["cross_attn", "output"])
        ln(f"{hf}.crossattention.output.LayerNorm", fl + ["cross_ln"])
        dense(f"{hf}.intermediate.dense", fl + ["fc1"])
        dense(f"{hf}.output.dense", fl + ["fc2"])
        ln(f"{hf}.output.LayerNorm", fl + ["out_ln"])
    dense("text_decoder.cls.predictions.transform.dense", ["text", "transform"])
    ln("text_decoder.cls.predictions.transform.LayerNorm", ["text", "transform_ln"])
    dense("text_decoder.cls.predictions.decoder", ["text", "decoder"])
    # safetensors checkpoints drop tied duplicates: the decoder bias is then
    # stored only as cls.predictions.bias.
    if "text_decoder.cls.predictions.bias" in state_dict and "text.decoder.bias" not in params:
        put(["text", "decoder", "bias"], state_dict["text_decoder.cls.predictions.bias"])

    if validate:
        exp_paths = expected_shapes(cfg)
        got_paths = {k: tuple(p.shape) for k, p in params.items()}
        problems = []
        for path, shape in exp_paths.items():
            if path not in got_paths:
                problems.append(f"missing {path} {shape}")
            elif got_paths[path] != shape:
                problems.append(f"shape mismatch {path}: got {got_paths[path]}, want {shape}")
        for path in got_paths:
            if path not in exp_paths:
                problems.append(f"unexpected {path}")
        if problems:
            raise ValueError(
                "BLIP state dict conversion incomplete:\n  "
                + "\n  ".join(sorted(problems)[:20])
                + (f"\n  ... {len(problems) - 20} more" if len(problems) > 20 else "")
            )
    return params
