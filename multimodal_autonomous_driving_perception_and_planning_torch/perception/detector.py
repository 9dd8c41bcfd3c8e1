"""YOLO detection frontends: camera frames -> detection tables -> the
pipeline.

Detection maps a batch of frames to a (T, D, ...) detection stream on the
device, in chunks of ``batch`` frames (the conv tower, decode, and NMS with
kernel K5 once a chunk); the frame loop of `pipeline.make_sequence_runner`
then consumes the tables without leaving the device.  Port of the JAX
package's perception/detector.py runners; its ``ObjectDetector`` needs the
host-side detection records and comes with them (ROADMAP.md queue 1,
item 13).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import PipelineConfig
from ..models.yolov8 import make_yolo_detector
from ..pipeline import make_sequence_runner
from ..utils.device import resolve_device

TABLE_KEYS = ("bbox", "class_id", "confidence", "valid")


def _detect_chunks(detect_fn, params, frames, batch: int, dev: torch.device, keep_candidates: bool):
    """Run ``detect_fn`` over ``batch``-frame chunks, the last padded with
    zero frames as the JAX package pads it, so that every chunk has one
    shape.  Returns the (T, D, ...) tables and, with ``keep_candidates``,
    the (T, N, ...) candidates of every frame."""
    frames = torch.as_tensor(frames)
    t = frames.shape[0]
    tables, cands = [], []
    for start in range(0, t, batch):
        chunk = frames[start : start + batch].to(dev)
        if chunk.shape[0] < batch:
            pad = chunk.new_zeros((batch - chunk.shape[0],) + tuple(chunk.shape[1:]))
            chunk = torch.cat([chunk, pad])
        out = detect_fn(params, chunk, return_candidates=keep_candidates)
        if keep_candidates:
            out, c = out
            cands.append(c)
        tables.append(out)
    stream = {k: torch.cat([tab[k] for tab in tables])[:t] for k in TABLE_KEYS}
    if not keep_candidates:
        return stream, None
    candidates = {k: torch.cat([c[k] for c in cands])[:t] for k in ("boxes", "scores", "classes")}
    candidates.update(scale=cands[0]["scale"], pad=cands[0]["pad"])
    return stream, candidates


def make_yolo_frontend(
    cfg: PipelineConfig,
    variant: str = "n",
    batch: int = 8,
    score_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    img_size: int = 640,
    device="cuda",
):
    """Build (init_fn, stream_fn): stream_fn(params, frames (T, H, W, 3)) ->
    detection stream dict of (T, D, ...) tensors on the device."""
    dev = resolve_device(device)
    init_fn, detect_fn = make_yolo_detector(
        variant=variant,
        max_det=cfg.detector.max_detections,
        score_threshold=score_threshold,
        iou_threshold=iou_threshold,
        img_size=img_size,
        device=dev,
    )

    def stream_fn(params, frames) -> Dict[str, torch.Tensor]:
        return _detect_chunks(detect_fn, params, frames, batch, dev, False)[0]

    return init_fn, stream_fn


def make_yolo_sequence_runner(
    cfg: PipelineConfig,
    variant: str = "n",
    batch: int = 64,
    score_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    compute_dtype=None,
    map_to_taxonomy: bool = True,
    img_size: int = 640,
    device="cuda",
):
    """BASELINE config 3: camera frames in -> YOLO detection -> tracker ->
    ego estimation -> planner (-> tags with ``enable_tagging``) -> outputs.

    Returns (init_fn, run) where
      run(params, state, frames (T, H, W, 3), ego (T, 4)) -> (state', outs),
    ``outs`` with the keys of `make_sequence_runner`.  With
    ``keep_candidates=True``, ``outs`` also holds the detection tables
    ("detections", (T, D, ...)) and the NMS candidates ("candidates",
    (T, N, ...)) of the run, for checking the NMS stage.

    ``compute_dtype`` defaults to bfloat16 (the conv tower); the decode /
    NMS tail and the pipeline run in float32.  With ``cfg.use_frames`` the
    frames also go into the pipeline: lanes, scene features and
    frames-mode tags.
    """
    dev = resolve_device(device)
    init_fn, detect_fn = make_yolo_detector(
        variant=variant,
        max_det=cfg.detector.max_detections,
        score_threshold=score_threshold,
        iou_threshold=iou_threshold,
        map_to_taxonomy=map_to_taxonomy,
        img_size=img_size,
        compute_dtype=torch.bfloat16 if compute_dtype is None else compute_dtype,
        device=dev,
    )
    run_frames = make_sequence_runner(cfg, device=dev)

    def run(params, state, frames, ego, keep_candidates: bool = False):
        stream, candidates = _detect_chunks(detect_fn, params, frames, batch, dev, keep_candidates)
        inputs = dict(stream, ego_measurement=torch.as_tensor(ego, dtype=torch.float32))
        if cfg.use_frames:
            inputs["frame"] = frames
        final, outs = run_frames(state, inputs)
        if keep_candidates:
            outs["detections"], outs["candidates"] = stream, candidates
        return final, outs

    return init_fn, run
