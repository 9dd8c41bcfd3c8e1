"""Vision-language tagger: a port of the JAX package's tagging/vlm.py.

Rebuild of the reference VLMTagger (src/tagging/vlm_tagger.py:78-469):
BLIP captioning with two prompts ("a photo of a driving scene showing",
"this driving situation is"), keyword->tag extraction tables, risk parsing,
frame-skip caching (inference every Nth frame), statistics, and description
search.

Backends:
  * ``blip``  — HuggingFace transformers BLIP (the reference path; lazily
    loaded, load errors captured like vlm_tagger.py:148-156).
  * ``torch`` — the port's BLIP (models.blip) on the card, in place of the
    JAX package's ``jax`` backend; needs local weights + tokenizer, falls
    back to the stub otherwise.
  * ``stub``  — deterministic caption synthesis from pipeline context
    (detections / ego state), so the extraction + search + statistics
    surface runs in weight-less environments and tests.

Both BLIP backends run on ``VLMConfig.device``; ``""`` is the card
(`utils.device.resolve_device("cuda")`), which raises without one (the
error is captured and the tagger falls back to the stub).  ``"cpu"`` runs
the model on the CPU, for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import VLMConfig
from ..utils.device import resolve_device


@dataclasses.dataclass
class VLMTags:
    """Container mirroring vlm_tagger.py:20-75."""

    frame_idx: int = 0
    timestamp: float = 0.0
    scene_description: str = ""
    safety_assessment: str = ""
    extracted_tags: List[str] = dataclasses.field(default_factory=list)
    road_type: str = "unknown"
    weather: str = "unknown"
    time_of_day: str = "unknown"
    vehicles_description: str = ""
    pedestrians_description: str = ""
    maneuver_description: str = ""
    risk_level: str = "low"
    risk_reason: str = ""
    confidence: float = 0.0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def get_tags_list(self) -> List[str]:
        tags = list(self.extracted_tags)
        if self.road_type != "unknown":
            tags.append(self.road_type)
        if self.weather != "unknown":
            tags.append(self.weather)
        if self.time_of_day != "unknown":
            tags.append(self.time_of_day)
        if self.risk_level != "low":
            tags.append(f"risk_{self.risk_level}")
        return list(set(tags))


# Keyword->tag tables (vlm_tagger.py:341-413).
ROAD_KEYWORDS = {
    "highway": ["highway", "freeway", "motorway", "expressway"],
    "intersection": ["intersection", "crossroads", "junction", "traffic light"],
    "urban": ["urban", "city", "downtown", "street"],
    "residential": ["residential", "neighborhood", "suburb"],
    "parking": ["parking", "parked", "parking lot"],
}
WEATHER_KEYWORDS = {
    "rainy": ["rain", "rainy", "wet", "raining"],
    "foggy": ["fog", "foggy", "mist", "hazy"],
    "snowy": ["snow", "snowy", "winter"],
    "clear": ["clear", "sunny", "bright"],
}


def extract_tags(scene_desc: str, safety_desc: str) -> List[str]:
    """Keyword extraction over both captions (vlm_tagger.py:341-413)."""
    text = (scene_desc + " " + safety_desc).lower()
    tags = []
    for tag, kws in ROAD_KEYWORDS.items():
        if any(k in text for k in kws):
            tags.append(tag)
    for tag, kws in WEATHER_KEYWORDS.items():
        if any(k in text for k in kws):
            tags.append(tag)
    if any(w in text for w in ("night", "dark", "nighttime")):
        tags.append("night")
    elif any(w in text for w in ("day", "daytime", "daylight", "sunny")):
        tags.append("daytime")
    if any(w in text for w in ("pedestrian", "people", "person", "walking")):
        tags.append("pedestrians")
    if any(w in text for w in ("cyclist", "bicycle", "bike")):
        tags.append("cyclists")
    if any(w in text for w in ("truck", "lorry")):
        tags.append("trucks")
    if any(w in text for w in ("bus", "buses")):
        tags.append("buses")
    if any(w in text for w in ("dangerous", "hazard", "risk", "unsafe", "caution")):
        tags.append("potential_hazard")
    if any(w in text for w in ("safe", "clear road", "no obstacles")):
        tags.append("safe_conditions")
    if any(w in text for w in ("close", "near miss", "almost", "too close")):
        tags.append("close_call")
    if any(w in text for w in ("heavy traffic", "congested", "traffic jam", "busy")):
        tags.append("heavy_traffic")
    if any(w in text for w in ("empty", "no traffic", "clear road")):
        tags.append("light_traffic")
    if any(w in text for w in ("turning", "turn left", "turn right")):
        tags.append("turning")
    if any(w in text for w in ("lane change", "changing lanes", "merging")):
        tags.append("lane_change")
    if any(w in text for w in ("stopping", "stopped", "brake", "braking")):
        tags.append("stopping")
    if any(w in text for w in ("crossing", "crosswalk", "cross the")):
        tags.append("crossing")
    return list(set(tags))


def parse_risk(safety_text: str) -> Tuple[str, str]:
    """Severity keyword cascade (vlm_tagger.py:415-426)."""
    t = safety_text.lower()
    if any(w in t for w in ("very dangerous", "extremely", "critical", "emergency", "collision")):
        return "critical", safety_text
    if any(w in t for w in ("dangerous", "hazard", "risk", "unsafe", "caution needed")):
        return "high", safety_text
    if any(w in t for w in ("moderate", "some risk", "attention", "careful")):
        return "medium", safety_text
    return "low", safety_text


def infer_road_type(desc: str) -> str:
    d = desc.lower()
    if any(w in d for w in ("highway", "freeway", "motorway")):
        return "highway"
    if any(w in d for w in ("intersection", "traffic light", "crossroad")):
        return "intersection"
    if any(w in d for w in ("city", "urban", "street", "building")):
        return "urban"
    if any(w in d for w in ("residential", "neighborhood", "house")):
        return "residential"
    return "road"


def infer_weather(desc: str) -> str:
    d = desc.lower()
    if any(w in d for w in ("rain", "wet", "rainy")):
        return "rainy"
    if any(w in d for w in ("snow", "snowy", "winter")):
        return "snowy"
    if any(w in d for w in ("fog", "foggy", "mist")):
        return "foggy"
    return "clear"


def infer_time_of_day(desc: str) -> str:
    d = desc.lower()
    return "night" if any(w in d for w in ("night", "dark", "evening")) else "day"


class _StubBackend:
    """Deterministic caption synthesis from pipeline context."""

    def generate(self, frame, prompt, context, max_tokens=None) -> str:
        del max_tokens  # synthesized captions are already short
        n_tracks = len(context.get("tracks") or [])
        speed = 0.0
        vs = context.get("vehicle_state")
        if vs is not None:
            speed = getattr(vs, "speed", 0.0) * 3.6
        brightness = float(np.mean(frame)) if frame is not None else 128.0
        tod = "night" if brightness < 60 else "daytime"
        traffic = "heavy traffic" if n_tracks > 5 else ("light traffic" if n_tracks <= 1 else "moderate traffic")
        if prompt and "situation" in prompt:
            if n_tracks > 5 or speed > 100:
                return "this driving situation is dangerous with heavy traffic nearby"
            return "this driving situation is safe with a clear road ahead"
        return (
            f"a photo of a driving scene showing a street with {traffic} "
            f"during the {tod}, vehicles moving at about {speed:.0f} km/h"
        )


class _BlipBackend:
    """HuggingFace BLIP captioning (vlm_tagger.py:119-190)."""

    def __init__(self, cfg: VLMConfig):
        self.cfg = cfg
        self.model = None
        self.processor = None
        self.load_error: Optional[str] = None
        self.device = None

    def _load(self) -> bool:
        if self.model is not None:
            return True
        if self.load_error:
            return False
        try:
            import torch

            self.device = resolve_device(self.cfg.device or "cuda")
            from transformers import BlipForConditionalGeneration, BlipProcessor

            self.processor = BlipProcessor.from_pretrained(self.cfg.model_name)
            self.model = BlipForConditionalGeneration.from_pretrained(
                self.cfg.model_name, torch_dtype=torch.float32
            )
            self.model.to(self.device)
            self.model.eval()
            return True
        except Exception as e:  # ImportError, download failure, ...
            self.load_error = str(e)
            return False

    def generate(self, frame, prompt, context, max_tokens=None) -> str:
        if not self._load():
            return f"Model load failed: {self.load_error}"
        try:
            import torch
            from PIL import Image

            rgb = np.ascontiguousarray(frame[..., ::-1])  # BGR -> RGB
            image = Image.fromarray(rgb.astype(np.uint8))
            if prompt:
                inputs = self.processor(images=image, text=prompt, return_tensors="pt")
            else:
                inputs = self.processor(images=image, return_tensors="pt")
            inputs = inputs.to(self.device)
            with torch.no_grad():
                out = self.model.generate(
                    **inputs,
                    # Per-call budget like the reference (scene 75 /
                    # safety 50, vlm_tagger.py:241-260), capped by config.
                    max_new_tokens=min(
                        max_tokens or self.cfg.max_new_tokens,
                        self.cfg.max_new_tokens,
                    ),
                    num_beams=self.cfg.num_beams,
                )
            return self.processor.decode(out[0], skip_special_tokens=True).strip()
        except Exception as e:
            return f"Generation error: {e}"


def prompt_buffer(tokenizer, prompt: str, cfg) -> Tuple[np.ndarray, int]:
    """A prompt's decode buffer for a BLIP config and the prompt's length:
    the tokenizer's ids with bos in place of [CLS] (BLIP's [DEC] token) and
    SEP dropped (the decode continues the prompt), zero-padded to an
    8-token bucket of at least 16 (the JAX package traces once a bucket)
    instead of truncating long prompts."""
    ids = tokenizer(prompt, return_tensors="np")["input_ids"][0].astype(np.int32)
    ids[0] = cfg.bos_token_id
    ids = ids[ids != cfg.sep_token_id]
    buf = np.zeros((max(16, ((len(ids) + 7) // 8) * 8),), np.int32)
    buf[: len(ids)] = ids
    return buf, len(ids)


class _TorchBlipBackend:
    """BLIP captioning through the port's model (models.blip) on
    ``VLMConfig.device``; the counterpart of the JAX package's
    ``_JaxBlipBackend``.

    ``cfg.model_name`` is a ``.npz`` archive from tools/export_weights.py
    with its ``vocab.txt`` beside it, or a local directory holding a torch
    ``pytorch_model.bin``/``model.safetensors`` state dict plus a BERT
    tokenizer; without weights the load error is captured like
    vlm_tagger.py:148-156 and the tagger falls back.
    """

    def __init__(self, cfg: VLMConfig):
        self.cfg = cfg
        self.load_error: Optional[str] = None
        self._ready = False
        self._captions = {}
        self._model = None
        self._tokenizer = None
        self._bcfg = None
        self._device = None

    def _load(self) -> bool:
        if self._ready:
            return True
        if self.load_error:
            return False
        try:
            import os

            from ..models.blip import BlipConfig, load_torch_state_dict, model_from_state_dict

            self._device = resolve_device(self.cfg.device or "cuda")
            name = self.cfg.model_name
            vocab_candidates = []
            if name.endswith(".npz"):
                # Portable-archive path: tools/export_weights.py writes the
                # tokenizer's vocab.txt next to the archive; the in-package
                # WordPiece implementation consumes it, so the host needs
                # no transformers.
                vocab_candidates.append(
                    os.path.join(os.path.dirname(name) or ".", "vocab.txt")
                )
            elif os.path.isdir(name):
                vocab_candidates.append(os.path.join(name, "vocab.txt"))
            vocab_path = next(
                (p for p in vocab_candidates if os.path.exists(p)), None
            )
            if vocab_path is not None:
                from ..utils.tokenizer import WordPieceTokenizer

                self._tokenizer = WordPieceTokenizer.from_vocab_file(vocab_path)
            else:
                # No local vocab.txt: try other local tokenizer files next
                # to the archive (tokenizer.json etc., which older exports
                # told users to copy) before resolving the hub name via
                # transformers (HF cache) — keeps offline hosts working.
                from transformers import AutoTokenizer

                tok_dir = (
                    os.path.dirname(name) or "." if name.endswith(".npz")
                    else name
                )
                local = None
                if os.path.isdir(tok_dir) and any(
                    os.path.exists(os.path.join(tok_dir, f))
                    for f in ("tokenizer.json", "tokenizer_config.json")
                ):
                    try:
                        local = AutoTokenizer.from_pretrained(tok_dir)
                    except Exception:
                        local = None
                if local is not None:
                    self._tokenizer = local
                else:
                    hub = (
                        "Salesforce/blip-image-captioning-base"
                        if name.endswith(".npz")
                        else name
                    )
                    self._tokenizer = AutoTokenizer.from_pretrained(hub)
            self._bcfg = BlipConfig()
            state_dict = self._load_state_dict(self.cfg.model_name)
            self._model = model_from_state_dict(
                load_torch_state_dict(state_dict, self._bcfg), self._bcfg, self._device
            )
            self._ready = True
            return True
        except Exception as e:  # no local weights / tokenizer / card, ...
            self.load_error = str(e)
            return False

    @staticmethod
    def _load_state_dict(path: str):
        import os

        if path.endswith(".npz") and os.path.exists(path):
            # Portable archive from tools/export_weights.py — loads with
            # numpy alone.
            from ..utils.weights import load_npz_state_dict

            sd, _ = load_npz_state_dict(path)
            return sd
        bin_path = os.path.join(path, "pytorch_model.bin")
        if os.path.exists(bin_path):
            import torch

            return torch.load(bin_path, map_location="cpu", weights_only=True)
        st_path = os.path.join(path, "model.safetensors")
        if os.path.exists(st_path):
            from safetensors.torch import load_file

            return load_file(st_path)
        raise FileNotFoundError(f"no torch state dict under {path}")

    def _caption_for(self, max_new_tokens: int):
        """One caption function per token budget (the reference asks for 75
        scene / 50 safety tokens, vlm_tagger.py:241-260)."""
        if max_new_tokens not in self._captions:
            from ..models.blip import make_beam_caption_fn, make_caption_fn

            # num_beams > 1 is the beam search held token for token to the
            # JAX package's, which HF generate matches (the reference
            # decodes with num_beams=3, vlm_tagger.py:177); 1 keeps the
            # cheaper greedy decode.
            if self.cfg.num_beams > 1:
                _, caption_fn = make_beam_caption_fn(
                    self._bcfg,
                    max_new_tokens=max_new_tokens,
                    num_beams=self.cfg.num_beams,
                    device=self._device,
                )
            else:
                _, caption_fn = make_caption_fn(
                    self._bcfg, max_new_tokens=max_new_tokens, device=self._device
                )
            self._captions[max_new_tokens] = caption_fn
        return self._captions[max_new_tokens]

    def generate(self, frame, prompt, context, max_tokens=None) -> str:
        if not self._load():
            return f"Model load failed: {self.load_error}"
        try:
            import torch

            from ..models.blip import preprocess_bgr

            c = self._bcfg
            px = preprocess_bgr(torch.as_tensor(np.asarray(frame)).to(self._device), c.image_size)
            buf, n = prompt_buffer(self._tokenizer, prompt or "a photo of", c)
            m = min(
                max_tokens or self.cfg.max_new_tokens, self.cfg.max_new_tokens
            )
            out_ids, length = self._caption_for(m)(self._model, px, buf, n)
            out = out_ids.cpu().numpy()[: int(length)]
            return self._tokenizer.decode(
                [t for t in out if t != c.bos_token_id], skip_special_tokens=True
            ).strip()
        except Exception as e:
            return f"Generation error: {e}"


class VLMTagger:
    """Open-vocabulary captioning -> structured tags with frame-skip caching."""

    def __init__(self, cfg: VLMConfig = VLMConfig(), backend: str = "auto"):
        self.cfg = cfg
        if backend == "auto":
            self._backend = _BlipBackend(cfg)
            self._fallback = _StubBackend()
        elif backend == "blip":
            self._backend = _BlipBackend(cfg)
            self._fallback = None
        elif backend == "torch":
            self._backend = _TorchBlipBackend(cfg)
            self._fallback = _StubBackend()
        else:
            self._backend = _StubBackend()
            self._fallback = None
        self.frame_count = 0
        self.tag_history: List[VLMTags] = []
        self._last_tags: Optional[VLMTags] = None

    def _generate(self, frame, prompt, context, max_tokens=None) -> str:
        text = self._backend.generate(frame, prompt, context, max_tokens)
        failed = "load failed" in text.lower() or "error" in text.lower()
        if failed and self._fallback is not None:
            return self._fallback.generate(frame, prompt, context, max_tokens)
        return text

    def tag_frame(
        self,
        frame: np.ndarray,
        vehicle_state=None,
        tracks: Optional[List] = None,
        force_update: bool = False,
    ) -> VLMTags:
        timestamp = self.frame_count / 30.0

        # Frame-skip cache (vlm_tagger.py:211-232).
        if (
            not force_update
            and self._last_tags is not None
            and self.frame_count % self.cfg.cache_interval != 0
        ):
            cached = dataclasses.replace(
                self._last_tags, frame_idx=self.frame_count, timestamp=timestamp
            )
            self.frame_count += 1
            return cached

        context = {"vehicle_state": vehicle_state, "tracks": tracks}
        tags = VLMTags(frame_idx=self.frame_count, timestamp=timestamp)
        # Token budgets and the promptless retry mirror the reference
        # (vlm_tagger.py:241-260): scene 75 tokens, retry without prompt if
        # the caption reads as an error, safety 50 tokens.
        scene_max = min(75, self.cfg.max_new_tokens)
        tags.scene_description = self._generate(
            frame, "a photo of a driving scene showing", context,
            max_tokens=scene_max,
        )
        low = tags.scene_description.lower()
        if "error" in low or "failed" in low:
            tags.scene_description = self._generate(
                frame, None, context, max_tokens=scene_max
            )
        tags.safety_assessment = self._generate(
            frame, "this driving situation is", context,
            max_tokens=min(50, self.cfg.max_new_tokens),
        )
        tags.extracted_tags = extract_tags(tags.scene_description, tags.safety_assessment)
        tags.road_type = infer_road_type(tags.scene_description)
        tags.weather = infer_weather(tags.scene_description)
        tags.time_of_day = infer_time_of_day(tags.scene_description)
        tags.risk_level, tags.risk_reason = parse_risk(tags.safety_assessment)

        # Vehicle-state context tags (vlm_tagger.py:303-316).
        if vehicle_state is not None:
            speed = getattr(vehicle_state, "speed", 0) * 3.6
            if speed < 5:
                tags.extracted_tags.append("stopped")
            elif speed > 100:
                tags.extracted_tags.append("high_speed")
            accel = getattr(vehicle_state, "acceleration", 0)
            if accel < -3:
                tags.extracted_tags.append("hard_braking")
            elif accel < -1:
                tags.extracted_tags.append("braking")
            elif accel > 1:
                tags.extracted_tags.append("accelerating")

        # Track context tags (vlm_tagger.py:318-325).
        if tracks:
            if len(tracks) > 5:
                tags.extracted_tags.append("heavy_traffic")
            peds = sum(1 for t in tracks if getattr(t, "class_name", "") == "pedestrian")
            if peds > 0:
                tags.extracted_tags.append("pedestrians_present")

        tags.confidence = 0.8
        self._last_tags = tags
        self.tag_history.append(tags)
        self.frame_count += 1
        return tags

    def get_statistics(self) -> Dict:
        if not self.tag_history:
            return {}
        counts: Dict[str, int] = {}
        for t in self.tag_history:
            for tag in t.extracted_tags:
                counts[tag] = counts.get(tag, 0) + 1
        ordered = sorted(counts.items(), key=lambda x: x[1], reverse=True)
        return {
            "total_frames": len(self.tag_history),
            "unique_tags": len(counts),
            "tag_frequency": dict(ordered[:20]),
            "frames_with_risk": sum(1 for t in self.tag_history if t.risk_level != "low"),
        }

    def search_by_description(self, query: str) -> List[VLMTags]:
        q = query.lower()
        out = []
        for t in self.tag_history:
            if (
                q in t.scene_description.lower()
                or q in t.safety_assessment.lower()
                or any(q in tag for tag in t.extracted_tags)
            ):
                out.append(t)
        return out

    def reset(self) -> None:
        self.frame_count = 0
        self.tag_history = []
        self._last_tags = None
