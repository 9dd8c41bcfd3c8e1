"""The port's VLM tagger (tagging/vlm.py) and its WordPiece tokenizer
(utils/tokenizer.py) against the JAX package's, on the CPU.

The tagger's tables, parsing, cache, statistics and search are the cases of
tests/test_vlm.py.  The torch BLIP backend captions from a tiny ``.npz``
archive with its ``vocab.txt`` (tests/test_converter_numerics.py:440's
set-up, the archive written from seeded weights by
`chip_smoke.hf_state_from_port`) with transformers blocked, and gives the
same caption text as the JAX package's backend at num_beams 1 and 3.
"""

import builtins
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_autonomous_driving_perception_and_planning_torch.config import VLMConfig
from multimodal_autonomous_driving_perception_and_planning_torch.models import blip as tb
from multimodal_autonomous_driving_perception_and_planning_torch.tagging.vlm import (
    VLMTagger,
    _StubBackend,
    _TorchBlipBackend,
    extract_tags,
    infer_road_type,
    infer_time_of_day,
    infer_weather,
    parse_risk,
)
from multimodal_autonomous_driving_perception_and_planning_torch.utils.tokenizer import WordPieceTokenizer
from multimodal_autonomous_driving_perception_and_planning_tpu.config import VLMConfig as JaxVLMConfig
from multimodal_autonomous_driving_perception_and_planning_tpu.models import blip as jb
from multimodal_autonomous_driving_perception_and_planning_tpu.tagging import vlm as jvlm
from multimodal_autonomous_driving_perception_and_planning_tpu.utils.tokenizer import (
    WordPieceTokenizer as JaxWordPieceTokenizer,
)

# tests/test_converter_numerics.py's vocabulary and sentences.
VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "a", "photo", "of", "driving", "scene", "showing", "this", "situation",
    "is", "the", "street", "with", "traffic", "during", "day", "night",
    "car", "cars", "truck", "bus", "busy", "danger", "##ous", "safe",
    "road", "ahead", "heavy", "light", "moving", "at", "about", "km",
    "h", "##s", "##ing", "##ed", "inter", "##section", "high", "##way",
    "pedestrian", "##rian", "cross", "##walk", "wet", "rain", "##y",
    ",", ".", "!", "?", "'", "100", "10", "##0", "##1", "n", "##'", "t",
    "don", "it", "we", "##n", "##t", "'re", "'s",
]
SENTENCES = [
    "a photo of a driving scene showing the street with heavy traffic",
    "this driving situation is dangerous with cars moving at about 100 km h",
    "The street, with LIGHT traffic!  Is it safe?",
    "rainy intersection ahead... pedestrians crossing the crosswalk",
    "café résumé straße",
    "unknownlongword supercalifragilistic",
    "don't we're it's",
    "漢字 mixed with latin",
    "  spaced\tout\nwhitespace  ",
    "punct.every,where!now?",
    "a photo [SEP] of traffic",
    "[CLS] this [MASK] scene [SEP]",
]


class FakeState:
    def __init__(self, speed=10.0, acceleration=0.0):
        self.speed = speed
        self.acceleration = acceleration


class FakeTrack:
    def __init__(self, class_name="car"):
        self.class_name = class_name


def test_keyword_extraction_tables():
    scene = "a busy city street at night with a truck and a cyclist in heavy traffic"
    safety = "this driving situation is dangerous, caution needed"
    tags = extract_tags(scene, safety)
    for want in ("urban", "night", "trucks", "cyclists", "heavy_traffic", "potential_hazard"):
        assert want in tags, (want, tags)
    assert sorted(tags) == sorted(jvlm.extract_tags(scene, safety))


def test_risk_parse_cascade():
    assert parse_risk("extremely dangerous, collision imminent")[0] == "critical"
    assert parse_risk("this is unsafe and hazardous")[0] == "high"
    # "risk" itself hits the high tier first (the reference's cascade order).
    assert parse_risk("moderate risk, be careful")[0] == "high"
    assert parse_risk("moderate conditions, attention required")[0] == "medium"
    assert parse_risk("all clear and calm")[0] == "low"


def test_inference_helpers():
    assert infer_road_type("a highway at dusk") == "highway"
    assert infer_road_type("a residential neighborhood") == "residential"
    assert infer_weather("rain on the windshield") == "rainy"
    assert infer_time_of_day("a dark evening road") == "night"


def test_tagger_cache_interval_and_context_tags():
    tagger = VLMTagger(VLMConfig(cache_interval=5), backend="stub")
    frame = np.full((48, 64, 3), 120, np.uint8)
    state = FakeState(speed=0.5, acceleration=-4.0)
    tracks = [FakeTrack() for _ in range(6)] + [FakeTrack("pedestrian")]

    t0 = tagger.tag_frame(frame, state, tracks)
    for want in ("stopped", "hard_braking", "heavy_traffic", "pedestrians_present"):
        assert want in t0.extracted_tags
    assert t0.confidence == 0.8

    t1 = tagger.tag_frame(frame, state, tracks)  # frames 1-4 from the cache
    assert t1.frame_idx == 1 and t1.scene_description == t0.scene_description
    for _ in range(3):
        tagger.tag_frame(frame, state, tracks)
    assert len(tagger.tag_history) == 1
    t5 = tagger.tag_frame(frame, state, tracks)  # frame 5: captioned again
    assert t5.frame_idx == 5 and len(tagger.tag_history) == 2


def test_tagger_search_and_stats():
    tagger = VLMTagger(VLMConfig(cache_interval=1), backend="stub")
    frame = np.full((48, 64, 3), 120, np.uint8)
    for i in range(8):
        tagger.tag_frame(frame, FakeState(speed=10.0), [FakeTrack()] * (i % 3))
    stats = tagger.get_statistics()
    assert stats["total_frames"] == 8 and stats["unique_tags"] >= 1
    assert len(tagger.search_by_description("driving scene")) == 8
    tagger.reset()
    assert tagger.get_statistics() == {}


def test_stub_tagger_matches_jax():
    """The stub backend's whole tagging surface, frame for frame, equal to
    the JAX package's."""
    port = VLMTagger(VLMConfig(cache_interval=3), backend="stub")
    ref = jvlm.VLMTagger(JaxVLMConfig(cache_interval=3), backend="stub")
    rng = np.random.default_rng(0)
    for i in range(10):
        frame = rng.integers(0, 255 if i % 2 else 50, (48, 64, 3)).astype(np.uint8)
        state = FakeState(speed=float(rng.uniform(0, 40)), acceleration=float(rng.uniform(-4, 2)))
        tracks = [FakeTrack(c) for c in rng.choice(["car", "pedestrian", "truck"], i % 8)]
        got, want = port.tag_frame(frame, state, tracks), ref.tag_frame(frame, state, tracks)
        assert {**got.to_dict(), "extracted_tags": sorted(got.extracted_tags)} == {
            **want.to_dict(), "extracted_tags": sorted(want.extracted_tags)}
    assert port.get_statistics() == ref.get_statistics()


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_blip_backends_fall_back_without_weights_or_card(backend):
    """With no local weights and no card (``VLMConfig.device`` "" is the
    card), the load error is captured and the tagger falls back to the stub
    captions rather than emitting error strings."""
    tagger = VLMTagger(VLMConfig(cache_interval=1), backend=backend)
    frame = np.full((48, 64, 3), 120, np.uint8)
    tags = tagger.tag_frame(frame, FakeState(), [])
    assert tags.scene_description and "error" not in tags.scene_description.lower()
    assert tagger._backend.load_error
    if not torch.cuda.is_available():
        assert "no CUDA device" in tagger._backend.load_error


@pytest.fixture
def vocab_file(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(path)


def test_tokenizer_matches_jax(vocab_file):
    """Ids and decoded text equal to the JAX package's tokenizer on every
    sentence, the __call__ surface the backend uses included."""
    port, ref = WordPieceTokenizer.from_vocab_file(vocab_file), JaxWordPieceTokenizer.from_vocab_file(vocab_file)
    assert port.vocab == ref.vocab
    for s in SENTENCES:
        ids = port.encode(s)
        assert ids == ref.encode(s), s
        np.testing.assert_array_equal(port(s, return_tensors="np")["input_ids"], ref(s, return_tensors="np")["input_ids"])
        assert port.decode(ids) == ref.decode(ids), s
        assert port.tokenize(s) == ref.tokenize(s), s


def test_tokenizer_blank_and_duplicate_lines_match_jax(tmp_path):
    """Ids by line number, blank and duplicate lines included, as the JAX
    package's tokenizer (and transformers') assigns them."""
    vocab = list(VOCAB)
    vocab.insert(10, "")
    vocab.insert(20, "photo")
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    port, ref = WordPieceTokenizer.from_vocab_file(str(path)), JaxWordPieceTokenizer.from_vocab_file(str(path))
    assert port.vocab == ref.vocab and port.inv_vocab == ref.inv_vocab
    for s in SENTENCES:
        assert port.encode(s) == ref.encode(s), s


TINY_VOCAB_CFG = dict(vocab_size=len(VOCAB), bos_token_id=2, sep_token_id=3, pad_token_id=0)


@pytest.fixture
def tiny_archive(tmp_path, vocab_file, monkeypatch):
    """A tiny BLIP ``.npz`` archive under HF key names beside the vocab,
    and both packages' backends built around ``BlipConfig.tiny()`` with the
    test vocabulary."""
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.weights import save_npz_state_dict

    cfg = dataclasses.replace(tb.BlipConfig.tiny(), **TINY_VOCAB_CFG)
    params = chip_smoke.blip_params(cfg)
    with torch.no_grad():  # the class token and the position embeddings start at 0: give them values
        gen = torch.Generator().manual_seed(1)
        for k in ("vision.cls_token", "vision.pos_embed", "text.position_embeddings"):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen)
    npz = tmp_path / "blip-tiny.npz"
    save_npz_state_dict(str(npz), chip_smoke.hf_state_from_port(params, cfg), format="madpp-blip-v1")
    assert (tmp_path / "vocab.txt").exists()
    jax_cfg = dataclasses.replace(jb.BlipConfig.tiny(), **TINY_VOCAB_CFG)
    monkeypatch.setattr(tb, "BlipConfig", lambda: cfg)
    monkeypatch.setattr(jb, "BlipConfig", lambda: jax_cfg)
    return str(npz)


@pytest.fixture
def no_transformers(monkeypatch):
    real_import = builtins.__import__

    def guarded(name, *a, **k):
        if name.startswith("transformers"):
            raise ImportError("transformers blocked: the backend must caption without it")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", guarded)


@pytest.mark.parametrize("num_beams", [1, 3])
def test_torch_backend_captions_as_jax_backend(tiny_archive, no_transformers, num_beams):
    """`_TorchBlipBackend` on the CPU and JAX's `_JaxBlipBackend` load the
    same archive and vocab.txt with transformers blocked and give the same
    caption text for both prompts (a real decode: no load error, not the
    stub's caption)."""
    kw = dict(model_name=tiny_archive, num_beams=num_beams, max_new_tokens=6)
    port = _TorchBlipBackend(VLMConfig(device="cpu", **kw))
    ref = jvlm._JaxBlipBackend(JaxVLMConfig(**kw))
    rng = np.random.default_rng(0)
    texts = set()
    for prompt in ("a photo of", "this driving situation is"):
        frame = rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
        got, want = port.generate(frame, prompt, {}), ref.generate(frame, prompt, {})
        assert port.load_error is None and ref.load_error is None, (port.load_error, ref.load_error)
        assert got == want, (got, want)
        assert got.startswith(prompt) and "error" not in got.lower()
        assert got != _StubBackend().generate(frame, prompt, {})
        texts.add(got)
    assert len(texts) == 2
    assert next(port._model.parameters()).device.type == "cpu"


def test_torch_tagger_captions_with_the_backend(tiny_archive, no_transformers):
    """`VLMTagger(backend="torch")` over five frames at cache_interval 2:
    three captioned frames, both captions from the backend each time (the
    stub never called), the cache between them."""
    tagger = VLMTagger(VLMConfig(model_name=tiny_archive, device="cpu", cache_interval=2, max_new_tokens=5),
                       backend="torch")
    calls = []
    fallback = tagger._fallback.generate
    tagger._fallback.generate = lambda *a, **k: calls.append(a) or fallback(*a, **k)
    rng = np.random.default_rng(1)
    for _ in range(5):
        tagger.tag_frame(rng.integers(0, 255, (48, 64, 3)).astype(np.uint8), FakeState(), [FakeTrack()])
    assert tagger._backend.load_error is None and not calls
    assert len(tagger.tag_history) == 3
    for tags in tagger.tag_history:
        assert tags.scene_description.startswith("a photo of a driving scene showing")
        assert tags.safety_assessment.startswith("this driving situation is")
