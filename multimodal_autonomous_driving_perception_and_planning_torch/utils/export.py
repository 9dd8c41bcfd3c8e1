"""The serialized runner: the pipeline's frame step as a ``torch.export``
program, the serving tier's artifact.

The JAX package serializes its whole compiled scan runner with
``jax.export``.  Here the artifact is the frame step
(`pipeline._make_frame_step`, with the lane axis when ``batch > 1``)
exported with ``torch.export`` and saved with ``torch.export.save``:
PyTorch has no public scan to export, and a 64-frame chunk unrolled would
make the graph 64 times larger.  `deserialize_runner` loops the loaded
program over the chunk and writes each frame's outputs into ``(F, ...)``
buffers, as `pipeline.make_sequence_runner` loops the eager step, so its
results are that runner's.

The program reaches kernels K1-K3 only through the ``madpp`` custom ops
(ops/library.py): on the card each launches its kernel, on the CPU each
runs its plain version.  Its other constants (the Kalman model, the lane
flags, the planner's grids) are lifted into the program.

Calling convention, as the JAX package's ``flat_fn``: the program takes
and returns flat leaf lists.  In: the state's leaves (`types.tree_leaves`
order), then the frame's inputs, exactly the keys of
`example_sequence_inputs` in sorted order.  Out: the new state's leaves,
then the step's outputs (K3's packed tag rows among them) in sorted key
order.  The artifact carries those names, its frame count, lane count and
device beside the program.

Not exported yet: frames mode (the lane step reads the Canny hysteresis's
flag on the host; a frames-mode program waits for a fixed round count,
ROADMAP items 5a and 11), a program for several platforms at once (ROADMAP
item 11) and lanes sharded over cards (``dp``, ROADMAP item 10b).
"""

from __future__ import annotations

import io
import json
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..config import PipelineConfig
from ..ops import library  # noqa: F401 -- registers the madpp ops a loaded program calls
from ..pipeline import _make_frame_step, _make_runner, initial_state
from ..types import Detections, stack_lanes, tree_leaves, tree_unflatten
from .device import resolve_device

# The artifact's description of its program, saved beside it.
_META = "madpp_runner.json"


class TensorSpec(NamedTuple):
    """The shape and dtype of one input."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def example_sequence_inputs(cfg: PipelineConfig, num_frames: int) -> Dict[str, TensorSpec]:
    """The time-stacked inputs of a ``num_frames``-frame chunk, as specs
    (the JAX package's `example_sequence_inputs` without the zeros)."""
    d = cfg.detector.max_detections
    inputs = {
        "bbox": TensorSpec((num_frames, d, 4), torch.float32),
        "class_id": TensorSpec((num_frames, d), torch.int32),
        "confidence": TensorSpec((num_frames, d), torch.float32),
        "valid": TensorSpec((num_frames, d), torch.bool),
        "ego_measurement": TensorSpec((num_frames, 4), torch.float32),
    }
    if cfg.use_frames:
        inputs["frame"] = TensorSpec((num_frames, cfg.frame_height, cfg.frame_width, 3), torch.int32)
    return inputs


def _refuse_unexportable(cfg: PipelineConfig, dp: int) -> None:
    if dp > 1:
        raise NotImplementedError(
            f"dp={dp}: sharding the lane axis over cards needs torch.distributed (ROADMAP item 10b)"
        )
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    if cfg.use_frames:
        raise NotImplementedError(
            "use_frames: the lane step reads the Canny hysteresis's flag on the host, so a frames-mode "
            "program waits for a fixed round count (ROADMAP items 5a and 11, the frames-mode artifact)"
        )


def _frame_inputs(frame: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A frame of `example_sequence_inputs`' keys as the frame step's inputs."""
    dets = Detections(frame["bbox"], frame["class_id"], frame["confidence"], frame["valid"])
    return {"detections": dets, "ego_measurement": frame["ego_measurement"]}


def _flat_runner(cfg: PipelineConfig, num_frames: int, device="cuda", batch: int = 1):
    """``(module, example_leaves, in_keys, out_keys)`` for the frame step:
    ``module(*leaves)`` takes and returns the flat leaf lists of the module
    docstring, ``example_leaves`` are zeros of its inputs on ``device``.

    ``batch > 1`` gives the step a leading lane axis: one program advances
    ``batch`` independent states at once, K1-K3 one launch a frame for
    all lanes (the serving tier's micro-batching, apps/serve.py).
    ``num_frames`` is the chunk the runner takes; the step sees one frame.
    """
    _refuse_unexportable(cfg, 1)
    dev = resolve_device(device)
    step = _make_frame_step(cfg, dev, ops=True)
    specs = example_sequence_inputs(cfg, num_frames)
    in_keys = tuple(sorted(specs))
    state = initial_state(cfg, dev)
    frame = {k: torch.zeros(specs[k].shape[1:], dtype=specs[k].dtype, device=dev) for k in in_keys}
    if batch > 1:
        state = stack_lanes([state] * batch)
        frame = {k: torch.stack([v] * batch) for k, v in frame.items()}
    n_state = len(tree_leaves(state))

    def run_step(s, f):
        new_state, out, rows = step(s, _frame_inputs(f))
        return new_state, {**out, **rows}

    # One eager step first: every constant the step caches on first use
    # (the lane flags, the planner's grids) is then a real tensor, which
    # the trace lifts into the program; and it names the outputs.
    _, out = run_step(state, frame)
    out_keys = tuple(sorted(out))

    class FlatStep(torch.nn.Module):
        def forward(self, *leaves):
            new_state, out = run_step(tree_unflatten(state, leaves[:n_state]), dict(zip(in_keys, leaves[n_state:])))
            return [*tree_leaves(new_state), *(out[k] for k in out_keys)]

    return FlatStep(), [*tree_leaves(state), *frame.values()], in_keys, out_keys


def export_sequence_runner(
    cfg: PipelineConfig,
    num_frames: int,
    platforms: Sequence[str] = ("cuda",),
    batch: int = 1,
    dp: int = 1,
) -> bytes:
    """Serialize the ``num_frames``-frame sequence runner: the frame step's
    ``torch.export`` program and its description, as bytes.

    ``platforms`` is ``("cuda",)`` (K1-K3 are the kernels; needs the card)
    or ``("cpu",)`` (their plain versions).  ``batch > 1`` exports the step
    with a lane axis of ``batch``.  Frames mode, several platforms and
    ``dp > 1`` raise `NotImplementedError` naming their ROADMAP items.
    """
    platforms = tuple(platforms)
    if len(platforms) > 1:
        raise NotImplementedError(
            f"platforms={platforms}: one artifact for several platforms is not ported (ROADMAP item 11, "
            "the multi-platform artifact); export one per platform"
        )
    if platforms not in (("cuda",), ("cpu",)):
        raise ValueError(f"platforms={platforms}: the port exports for ('cuda',) or ('cpu',)")
    _refuse_unexportable(cfg, dp)
    module, leaves, in_keys, out_keys = _flat_runner(cfg, num_frames, platforms[0], batch)
    program = torch.export.export(module, tuple(leaves), strict=False)
    meta = {
        "num_frames": int(num_frames),
        "batch": int(batch),
        "device": platforms[0],
        "inputs": list(in_keys),
        "outputs": list(out_keys),
        "state_leaves": len(leaves) - len(in_keys),
    }
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def load_program(data: bytes):
    """The artifact's ``(ExportedProgram, description)``."""
    extra = {_META: ""}
    program = torch.export.load(io.BytesIO(data), extra_files=extra)
    if not extra[_META]:
        raise ValueError("not an artifact of export_sequence_runner: it has no runner description")
    return program, json.loads(extra[_META])


def deserialize_runner(data: bytes, cfg: PipelineConfig, num_frames: int, batch: int = 1, dp: int = 1):
    """bytes -> ``run(state, inputs) -> (state', outputs)``, the results of
    `make_sequence_runner` (``batch`` 1) or `make_batched_sequence_runner`
    (``batch`` > 1) on the artifact's device.

    ``cfg``, ``num_frames`` and ``batch`` are those of the exporting call:
    ``run`` refuses inputs other than `example_sequence_inputs`' keys and
    chunks of another length, and the program's guards refuse other
    shapes.
    """
    _refuse_unexportable(cfg, dp)
    program, meta = load_program(data)
    if (meta["num_frames"], meta["batch"]) != (num_frames, batch):
        raise ValueError(
            f"the artifact runs {meta['num_frames']}-frame chunks at batch {meta['batch']}; "
            f"asked for {num_frames} at batch {batch}"
        )
    dev = resolve_device(meta["device"])
    module = program.module()
    in_keys, out_keys, n_state = meta["inputs"], meta["outputs"], meta["state_leaves"]

    def step(state, inputs):
        dets = inputs["detections"]
        values = {"bbox": dets.bbox, "class_id": dets.class_id, "confidence": dets.confidence,
                  "valid": dets.valid, "ego_measurement": inputs["ego_measurement"]}
        leaves = module(*tree_leaves(state), *(values[k] for k in in_keys))
        return tree_unflatten(state, leaves[:n_state]), dict(zip(out_keys, leaves[n_state:])), {}

    runner = _make_runner(cfg, dev, lanes=batch > 1, step=step)
    time_axis = 1 if batch > 1 else 0

    def run(state, inputs):
        if set(inputs) != set(in_keys):
            raise ValueError(f"the artifact takes exactly the inputs {sorted(in_keys)}; got {sorted(inputs)}")
        frames = inputs["bbox"].shape[time_axis]
        if frames != num_frames:
            raise ValueError(f"the artifact runs {num_frames}-frame chunks; got {frames} frames")
        return runner(state, inputs)

    return run


def save_exported(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def load_exported(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()
