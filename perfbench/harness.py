"""One run of one cell: set up the program from the seed, warm it, drive
its timed path for the window, then judge what it produced.

The system under test is the PyTorch/CUDA port's camera-to-plan entry,
``perception.detector.make_yolo_sequence_runner(...).run``.  Its traffic is
a closed loop of one camera stream: each request is one segment of frames,
a host tensor from a pool of seeded road frames, with its ego
measurements; the pipeline state carries from segment to segment like one
long drive; a segment is done when its outputs are on the host.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is read from the files ``BENCHMARK.json`` names.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import compare
from .reference import yolov8
from .trace import mark
from .traffic import road

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "multimodal_autonomous_driving_perception_and_planning_tpu"})


def process_start() -> float:
    """The wall-clock time this process started, from /proc."""
    stat = Path("/proc/self/stat").read_text()
    ticks = int(stat.rsplit(")", 1)[1].split()[19])
    btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                 if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def use_checkout_caches() -> None:
    """Keep the build and kernel caches in the checkout, at fixed paths,
    unless the environment names its own."""
    cache = ROOT / ".cache" / "perfbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & FORBIDDEN_MODULES)


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    """(cell, configuration, traffic, limits, its end-to-end and per-layer
    metric entries), each from its own file beside ``bench_path``."""
    base = bench_path.parent
    bench = json.loads(bench_path.read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in {bench_path.name}")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((base / entry["file"]).read_text())
    traffic = json.loads((base / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((base / "perfbench" / "limits" / f"{name}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return cell, config, traffic, limits, end_to_end, per_layer


def program_config(traffic: Dict):
    """The pipeline configuration the cell runs: the program's defaults
    with the lane step off, the serving outputs, and the traffic's table
    sizes and frame size."""
    from multimodal_autonomous_driving_perception_and_planning_torch.config import DEFAULT_CONFIG

    return DEFAULT_CONFIG.replace(
        use_frames=False,
        enable_tagging=True,
        emit_candidates=False,
        emit_trajectories=False,
        frame_height=traffic["frame_height"],
        frame_width=traffic["frame_width"],
        detector=dataclasses.replace(DEFAULT_CONFIG.detector, max_detections=traffic["max_detections"]),
        tracker=dataclasses.replace(DEFAULT_CONFIG.tracker, max_tracks=traffic["max_tracks"]),
    )


def make_weights(config: Dict, seed: int, device: torch.device, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Seeded detector weights, made on the device in the type they are
    served in (float32; the tower casts).  Every kernel is a normal
    truncated at two standard deviations with variance 1 / fan_in (one
    draw for all), every bias 0.  Then one pass over ``frames`` (uint8 road
    frames) sets what training would: each BatchNorm's running mean and
    variance are its input's, its scale ``bn_gain``; each head's last
    convolution is scaled and shifted so that its outputs have the
    configuration's mean and spread (box logits, class logits), so that
    scores and boxes spread as a detector's do."""
    shapes = yolov8.parameter_shapes(config)
    kernels = [(k, s) for k, s in shapes.items() if len(s) == 4]
    counts = [math.prod(s) for _, s in kernels]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(road.rng(seed, 2).integers(0, 2**62)))
    flat = torch.empty(sum(counts), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    scale = torch.tensor([math.sqrt(1.0 / math.prod(s[1:])) / 0.87962566103423978 for _, s in kernels],
                         device=device)
    flat.mul_(torch.repeat_interleave(scale, torch.tensor(counts, device=device)))
    weights, off = {}, 0
    for (k, s), n in zip(kernels, counts):
        weights[k] = flat[off : off + n].view(s)
        off += n
    for k, s in shapes.items():
        if len(s) != 4:
            one = ".bn." in k and k.endswith((".weight", ".running_var"))
            weights[k] = (torch.ones if one else torch.zeros)(s, device=device)
    model = yolov8.build(config, weights)
    cal = config["calibration"]

    def norm_stats(x):
        x = x.double()
        return x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3))

    def batchnorm(bn, args):
        mean, var = norm_stats(args[0])
        bn.running_mean.copy_(mean)
        # A channel nearly constant on these frames is not divided by its
        # tiny spread: that would blow up the least rounding after it.
        bn.running_var.copy_(var.clamp_min(cal["var_floor"] * var.mean()))
        bn.weight.fill_(cal["bn_gain"])

    def last_conv(target_mean, target_std):
        def hook(conv, _args, out):
            mean, var = norm_stats(out)
            gain = target_std / var.sqrt().clamp_min(1e-12)
            conv.weight.mul_(gain.float().view(-1, 1, 1, 1))
            conv.bias.copy_(target_mean - mean * gain)
            return (out - mean.float().view(1, -1, 1, 1)) * gain.float().view(1, -1, 1, 1) + target_mean
        return hook

    size, frames = config["img_size"], frames.to(device)
    bns = [m for m in model.modules() if isinstance(m, yolov8.BatchNorm)]
    hooks = [m.register_forward_pre_hook(batchnorm) for m in bns]
    for name, m in model.head.named_children():
        if name.endswith("_2"):
            box = name.startswith("cv2")
            hooks.append(m.register_forward_hook(last_conv(
                cal["box_logit_mean"] if box else cal["class_logit_mean"],
                cal["box_logit_std"] if box else cal["class_logit_std"])))
    yolov8.head_outputs(model, frames, size, block=frames.shape[0])
    for h in hooks:
        h.remove()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def tree_tensors(obj, prefix: str = ""):
    """(path, tensor) of every tensor in nested dicts and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from tree_tensors(v, f"{prefix}{k}.")
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from tree_tensors(getattr(obj, f.name), f"{prefix}{f.name}.")


def snapshot(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """The program's pipeline state as plain dicts of copies, by field."""
    return {f.name: {g.name: getattr(getattr(state, f.name), g.name).clone()
                     for g in dataclasses.fields(getattr(state, f.name))}
            for f in dataclasses.fields(state) if dataclasses.is_dataclass(getattr(state, f.name))}


class TowerTap:
    """Hooks on the program's detector module, found by its class when it
    first runs: they keep the head logits of a pass when asked, and in a
    traced run put a marker kernel on the card before and after each pass."""

    def __init__(self, trace: bool):
        from multimodal_autonomous_driving_perception_and_planning_torch.models.yolov8 import YOLOv8

        self.cls, self.trace = YOLOv8, trace
        self.capture, self.heads, self.model = False, None, None
        self._finder = torch.nn.modules.module.register_module_forward_pre_hook(self._find)

    def _find(self, module, _args):
        if self.model is None and isinstance(module, self.cls):
            self.model = module
            module.register_forward_hook(self._after)
            if self.trace:
                module.register_forward_pre_hook(lambda *_: mark())
                mark()  # this pass's opening marker; the pre-hook opens the next ones
            self._finder.remove()

    def _after(self, _module, _args, out):
        if self.trace:
            mark()
        if self.capture:
            self.heads = [(box, cls) for box, cls in out]


class HostCopy:
    """Brings a segment's serving outputs to the host: into pinned buffers
    made on the first segment, then one wait.  The detection tables and
    NMS candidates kept for the check and the trace stay on the device."""

    KEPT = ("detections", "candidates")

    def __init__(self, device: torch.device):
        self.device, self.buffers = device, {}

    def __call__(self, outs: Dict) -> None:
        for path, t in tree_tensors({k: v for k, v in outs.items() if k not in self.KEPT}):
            if self.device.type == "cuda":
                buf = self.buffers.get(path)
                if buf is None:
                    buf = self.buffers[path] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
            else:
                self.buffers[path] = t.clone()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Drive:
    """The program set up for one cell and seed, and the traffic it serves."""

    config: Dict
    traffic: Dict
    seed: int
    device: torch.device
    trace: bool = False

    def __post_init__(self):
        from multimodal_autonomous_driving_perception_and_planning_torch.perception.detector import (
            make_yolo_sequence_runner,
        )
        from multimodal_autonomous_driving_perception_and_planning_torch.pipeline import initial_state

        t = self.traffic
        self.seg = t["segment_frames"]
        self.cfg = program_config(t)
        frames = road.road_frames(self.seed, t["pool_frames"], t["frame_height"], t["frame_width"])
        self.pool = torch.from_numpy(frames)
        calibration = self.pool[: self.config["calibration"]["frames"]]
        self.weights = make_weights(self.config, self.seed, self.device, calibration)
        if self.device.type == "cuda":
            self.pool = self.pool.pin_memory()
        self.ego = torch.from_numpy(road.ego_measurements(self.seed, t["max_frames"], t["fps"]))
        _, self.run = make_yolo_sequence_runner(
            self.cfg, variant=self.config["variant"], batch=self.seg, score_threshold=t["score_threshold"],
            iou_threshold=t["iou_threshold"], compute_dtype=getattr(torch, self.config["compute_dtype"]),
            pre_topk=t["pre_topk"], img_size=self.config["img_size"], device=self.device,
        )
        self.state = initial_state(self.cfg, device=self.device)
        self.tap = TowerTap(self.trace)
        self.copy = HostCopy(self.device)
        self.done = 0  # segments of the drive served
        self.keep = False  # keep every segment's tables and candidates (the traced stretch)

    def inputs(self, i: int):
        p = (i * self.seg) % self.traffic["pool_frames"]
        e = (i * self.seg) % self.traffic["max_frames"]
        return self.pool[p : p + self.seg], self.ego[e : e + self.seg]

    def segment(self, capture: bool = False):
        """Serve the drive's next segment; returns its seconds from
        hand-over to outputs on the host, and with ``capture`` what the
        check needs of it, the state handed on included.  Only a captured
        segment, or one in the traced stretch, asks the program to keep
        its detection tables and NMS candidates; every other one is the
        serving call."""
        frames, ego = self.inputs(self.done)
        cap = None
        if capture:
            cap = {"index": self.done, "state": snapshot(self.state), "frames": frames, "ego": ego}
            self.tap.capture = True
        keep = capture or self.keep
        t0 = time.perf_counter()
        self.state, outs = self.run(self.weights, self.state, frames, ego, keep_candidates=keep)
        self.copy(outs)
        dt = time.perf_counter() - t0
        self.tap.capture = False
        self.done += 1
        if capture:
            cap.update(heads=self.tap.heads, outs=outs, final=snapshot(self.state))
        self.last_outs = outs
        return dt, cap


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile with linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values), q))


def sample_times(seed: int, count: int) -> List[float]:
    """``count`` points of the window, as shares of its length drawn from
    the seed within its first 85%: the segment handed over first after each
    is checked."""
    return sorted(float(u) for u in road.rng(seed, 3).uniform(0.0, 0.85, count))


def card_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit() -> Optional[str]:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: torch.device,
             bench_path: Path = ROOT / "BENCHMARK.json", control: bool = False, start: Optional[float] = None) -> Dict:
    """One run; returns the result line's object (and the control's
    numbers under ``"control"`` with ``control``)."""
    start = process_start() if start is None else start
    cell, config, traffic, limits, end_to_end, per_layer = load_cell(name, bench_path)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    drive = Drive(config, traffic, seed, device, trace)

    captures = []
    for w in range(traffic["warmup_segments"]):
        dt, cap = drive.segment(capture=w == 0)
        if cap is not None:
            captures.append(cap)
    setup_s = time.time() - start

    due = sample_times(seed, traffic["sampled_segments"])
    stretch = None
    if trace:
        from . import trace as tracing

        stretch = tracing.Stretch(drive, traffic["traced_segments"])

    def serve() -> float:
        sample = bool(due) and time.perf_counter() - t_start >= due[0] * seconds
        dt, cap = drive.segment(capture=sample)
        if cap is not None:
            captures.append(cap)
            while due and time.perf_counter() - t_start >= due[0] * seconds:
                due.pop(0)
        return dt

    latencies = []
    before_trace = 0  # segments served before the stretch opened
    t_start = time.perf_counter()
    while True:
        if stretch is not None and stretch.due(time.perf_counter() - t_start, seconds):
            before_trace = len(latencies)
            stretch.run(serve)
        latencies.append(serve())
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    frames = len(latencies) * drive.seg
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    layer_values = {}
    breakdown = None
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": card_name(device),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        # The profiler leaves the host slower for the rest of the run, so
        # only the segments before the stretch stand for untraced ones.
        ctx = stretch.context(config, traffic, latencies[:before_trace])
        for m in per_layer:
            value = importlib.import_module(f"perfbench.metrics.{m['name']}").read(ctx)
            if value is not None:
                layer_values[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = ctx.breakdown()
        device_info.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
    if device.type == "cuda":
        device_info["power"] = power_limit()

    # The check runs once the window is closed and the peak read, with the
    # program's own state freed.
    del drive.state, drive.last_outs
    drive.copy.buffers.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pipeline = dataclasses.asdict(drive.cfg)
    got, ctl, chain = compare.judge(captures, config, traffic, pipeline, drive.weights, control=control)
    checks = {k: {"value": got[k], "limit": limits[k]} for k in compare.NUMBERS}
    correct = all(v["value"] <= v["limit"] for v in checks.values()) and not due

    metrics = {}
    if trace:
        metrics = layer_values
    else:
        values = {
            "frames_per_s": frames / window_s,
            "segment_p95_ms": 1e3 * percentile(latencies, 95),
            "setup_s": setup_s,
        }
        for m in end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(latencies),
        "failed": 0,
        "metrics": metrics,
        "device": device_info,
        "stats": {"segments": len(latencies), "frames": frames, "window_s": window_s,
                  "segment_p50_ms": 1e3 * percentile(latencies, 50),
                  "segment_p95_ms": 1e3 * percentile(latencies, 95), "setup_s": setup_s,
                  "checked_segments": [c["index"] for c in captures], "chain": chain},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["control"] = ctl
    result["checks"] = checks
    return result
