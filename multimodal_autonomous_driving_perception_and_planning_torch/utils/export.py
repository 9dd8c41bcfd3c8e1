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

Frames mode exports too: the lane step's Canny hysteresis, its one
data-dependent host read, runs under a ``while_loop`` in the traced step
(ops/image.py `hysteresis_traced`), so the program reads the flag once a
block of rounds, as the eager step does.

Platforms: an artifact for ``("cuda",)`` is exported on the card, one for
``("cpu",)`` on the CPU.  One for ``("cuda", "cpu")`` is exported on the
CPU and loads on either: the ``madpp`` ops dispatch on their tensors'
device, so the same program launches K1-K3 on the card and runs their
plain versions on the CPU, and `deserialize_runner` moves the program's
constants and its baked-in devices to the card with
``torch.export.passes.move_to_device_pass``.  The traced step holds no
branch on the device: its only device-dependent code is inside the ops.
So an artifact for the card can be made on a host without one.

Lanes over ranks (``dp``): an artifact of ``batch`` B lanes and ``dp`` D
holds the program of B/D lanes and records D.  Loaded in a process group
of D ranks (parallel/distributed.py), each rank runs its B/D lanes on its
own device, with no collective; `lane_sharding` is the sessions mesh.
"""

from __future__ import annotations

import io
import json
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..ops import library  # noqa: F401 -- registers the madpp ops a loaded program calls
from ..pipeline import _make_frame_step, _make_runner, check_card_limits, initial_state
from ..types import Detections, stack_lanes, tree_leaves, tree_map, tree_unflatten
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


_PLATFORMS = ("cuda", "cpu")


def _check_platforms(platforms) -> Tuple[str, ...]:
    platforms = tuple(platforms)
    if not platforms or len(set(platforms)) != len(platforms) or not set(platforms) <= set(_PLATFORMS):
        raise ValueError(f"platforms={platforms}: the port exports for 'cuda', 'cpu' or both, each once")
    return platforms


def _lanes_per_rank(batch: int, dp: int) -> int:
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    if batch % dp != 0:
        raise ValueError(f"batch={batch} must be a multiple of dp={dp}")
    return batch // dp


def _frame_inputs(frame: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A frame of `example_sequence_inputs`' keys as the frame step's inputs."""
    dets = Detections(frame["bbox"], frame["class_id"], frame["confidence"], frame["valid"])
    inputs = {"detections": dets, "ego_measurement": frame["ego_measurement"]}
    if "frame" in frame:
        inputs["frame"] = frame["frame"]
    return inputs


def _flat_runner(cfg: PipelineConfig, num_frames: int, device="cuda", batch: int = 1, lanes: bool = False):
    """``(module, example_leaves, in_keys, out_keys)`` for the frame step:
    ``module(*leaves)`` takes and returns the flat leaf lists of the module
    docstring, ``example_leaves`` are zeros of its inputs on ``device``.

    ``lanes`` (or ``batch > 1``) gives the step a leading lane axis of
    ``batch``: one program advances ``batch`` independent states at once,
    K1-K3 one launch a frame for all lanes (the serving tier's
    micro-batching, apps/serve.py).  ``num_frames`` is the chunk the runner
    takes; the step sees one frame.
    """
    dev = resolve_device(device)
    step = _make_frame_step(cfg, dev, ops=True)
    specs = example_sequence_inputs(cfg, num_frames)
    in_keys = tuple(sorted(specs))
    state = initial_state(cfg, dev)
    frame = {k: torch.zeros(specs[k].shape[1:], dtype=specs[k].dtype, device=dev) for k in in_keys}
    if lanes or batch > 1:
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

    ``platforms`` is ``("cuda",)`` (exported on the card: K1-K3 are the
    kernels), ``("cpu",)`` (their plain versions) or both, in either order
    (exported on the CPU, loadable on either; needs no card).  ``batch >
    1`` exports the step with a lane axis.  ``dp > 1`` (``batch % dp ==
    0``, else `ValueError`) exports the program of ``batch / dp`` lanes,
    each rank's share; making it needs no process group.
    """
    platforms = _check_platforms(platforms)
    local = _lanes_per_rank(batch, dp)
    if "cuda" in platforms:
        check_card_limits(cfg, torch.device("cuda"))
    on = platforms[0] if len(platforms) == 1 else "cpu"
    module, leaves, in_keys, out_keys = _flat_runner(cfg, num_frames, on, local, lanes=batch > 1)
    program = torch.export.export(module, tuple(leaves), strict=False)
    meta = {
        "num_frames": int(num_frames),
        "batch": int(batch),
        "dp": int(dp),
        "device": on,
        "exported_on": str(leaves[0].device),
        "platforms": list(platforms),
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


def lane_sharding(dp: int, device="cuda"):
    """``(mesh, shard_for)`` sharding the leading session-lane axis over the
    ``dp`` ranks of the process group: ``mesh`` a one-axis
    ``("sessions",)`` `DeviceMesh`, ``shard_for(tensor)`` this rank's share
    of a ``(B, ...)`` tensor as a ``DTensor`` placed ``Shard(0)`` on it
    (the counterpart of the JAX package's ``NamedSharding``; no
    communication).  ``device`` is this rank's.  Raises `ValueError` when
    ``dp`` is not the number of ranks (a process without a group has
    one rank and no mesh)."""
    from torch.distributed.tensor import DTensor, Shard

    from ..parallel.distributed import rank_mesh

    ranks = dist.get_world_size() if dist.is_initialized() else 1
    if dp != ranks or not dist.is_initialized():
        raise ValueError(
            f"lane_sharding: dp={dp} over the {ranks} rank(s) of this process"
            + ("" if dist.is_initialized() else " (no torch.distributed process group is initialized)")
            + "; dp must equal the number of ranks"
        )
    dev = resolve_device(device)
    mesh = rank_mesh((dp,), ("sessions",), dev, what="lane_sharding")
    rank = mesh.get_local_rank()

    def shard_for(leaf) -> DTensor:
        leaf = torch.as_tensor(leaf)
        if leaf.shape[0] % dp:
            raise ValueError(f"a lane axis of {leaf.shape[0]} does not split over dp={dp} ranks")
        return DTensor.from_local(leaf.tensor_split(dp)[rank].to(dev), mesh, [Shard(0)], run_check=False)

    return mesh, shard_for


def deserialize_runner(data: bytes, cfg: PipelineConfig, num_frames: int, batch: int = 1, dp: int = 1,
                       device: Optional[str] = None):
    """bytes -> ``run(state, inputs) -> (state', outputs)``, the results of
    `make_sequence_runner` (``batch`` 1) or `make_batched_sequence_runner`
    (``batch`` > 1).

    ``cfg``, ``num_frames``, ``batch`` and ``dp`` are those of the
    exporting call: ``run`` refuses inputs other than
    `example_sequence_inputs`' keys and chunks of another length, and the
    program's guards refuse other shapes.

    ``device`` is where the program runs: by default the artifact's own
    device, and the card for an artifact of several platforms (the rule
    for entry points); the program moves there when it was exported
    elsewhere.

    ``dp > 1`` needs a process group of ``dp`` ranks (a single-rank
    context is refused, as the JAX package's dp artifact refuses one
    device).  Every rank calls ``run`` with the whole ``batch`` lanes, as
    arrays or as ``DTensor``s sharded by `lane_sharding`, runs its own
    ``batch / dp`` lanes on its device, and returns its lanes of the
    results as ``DTensor``s placed ``Shard(0)`` on the sessions mesh
    (``.full_tensor()`` gathers one).  ``run.local(state, inputs)`` runs
    this rank's lanes given as plain tensors and returns plain tensors.
    """
    program, meta = load_program(data)
    local = _lanes_per_rank(batch, dp)
    if (meta["num_frames"], meta["batch"], meta.get("dp", 1)) != (num_frames, batch, dp):
        raise ValueError(
            f"the artifact runs {meta['num_frames']}-frame chunks at batch {meta['batch']} over dp "
            f"{meta.get('dp', 1)}; asked for {num_frames} at batch {batch} over dp {dp}"
        )
    platforms = meta.get("platforms", [meta["device"]])
    dev = resolve_device(device or ("cuda" if len(platforms) > 1 else meta["device"]))
    if dev.type not in platforms:
        raise ValueError(f"the artifact was exported for {platforms}; asked to run on {dev}")
    if dev.type == "cuda":
        check_card_limits(cfg, dev)
    if torch.device(meta.get("exported_on", meta["device"])) != dev:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, str(dev))
    sharding = lane_sharding(dp, dev) if dp > 1 else None
    module = program.module()
    in_keys, out_keys, n_state = meta["inputs"], meta["outputs"], meta["state_leaves"]

    def step(state, inputs):
        dets = inputs["detections"]
        values = {"bbox": dets.bbox, "class_id": dets.class_id, "confidence": dets.confidence,
                  "valid": dets.valid, "ego_measurement": inputs["ego_measurement"]}
        if "frame" in inputs:
            # The program takes int32 frames; uint8 ones convert on the device.
            values["frame"] = inputs["frame"].to(torch.int32)
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

    if sharding is None:
        return run
    mesh, shard_for = sharding

    def run_lanes(state, inputs):
        """This rank's ``local`` lanes of the whole batch, run, as DTensors."""
        from torch.distributed.tensor import DTensor, Shard

        def mine(x):
            x = x if isinstance(x, DTensor) else shard_for(x)
            return x.to_local().to(dev)

        new_state, outs = run(tree_map(mine, state), {k: mine(v) for k, v in inputs.items()})
        return tree_map(lambda t: DTensor.from_local(t, mesh, [Shard(0)], run_check=False), (new_state, outs))

    # ``local`` runs this rank's lanes alone, tensors in and out (the dp
    # server's ranks, which hold only their own lanes).
    run_lanes.mesh, run_lanes.lanes_per_rank, run_lanes.local = mesh, local, run
    return run_lanes


def save_exported(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def load_exported(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()
