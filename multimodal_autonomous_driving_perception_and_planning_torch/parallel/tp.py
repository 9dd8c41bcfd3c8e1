"""Tensor and data parallel detection and captioning over a 2-D mesh of
ranks.

The JAX package annotates the Flax parameters with ``NamedSharding``s over
a ``(data, model)`` mesh (conv kernels on their output channels, vectors
on their one axis), shards the frame batch over ``data``, and lets GSPMD
insert the collectives.  The port writes those collectives out, over a
``DeviceMesh`` of ranks (parallel/distributed.py):

* YOLO: each rank holds its slice of every conv's output channels (OIHW
  weights on dim 0, the BatchNorm vectors and biases on their one axis)
  and computes that slice of each ``ConvBN`` and head conv, then
  ``all_gather_into_tensor`` over ``model`` rebuilds the whole activation
  for the next layer.  The decode and the NMS (kernel K5 on the card) run
  on each rank's share of the frames, and the detection tables are
  gathered over ``data``, so every rank holds the whole batch's tables, as
  the JAX package's replicated ``P()`` outputs.
* BLIP: every ``nn.Linear`` whose output width divides is column-sharded
  over ``model`` (each rank holds its rows of the weight and the bias) and
  its output all-gathered, what ``parallelize_module`` with
  ``ColwiseParallel(output_layouts=Replicate())`` does.  The gather is
  written out with ``all_gather_into_tensor``, as for YOLO: DTensor's
  redistribution runs on functional collectives, which gloo does not take
  on CUDA tensors (PERF.md), and the ranks that share a card run on gloo.

A tensor whose sharded axis does not divide over ``model`` stays whole on
every rank, the JAX package's rule.  Without a process group the mesh is
None: one device, nothing sharded.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from .distributed import byte_specs, pack_bytes, rank_mesh, unpack_bytes


def make_tp_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None, data_axis: str = "data",
                 model_axis: str = "model", device="cuda"):
    """A ``(data, model)`` ``DeviceMesh`` over the ranks of the process
    group (None for one device without a group).

    Defaults, as the JAX package's: a model axis of 4, else 2, where it
    divides the number of ranks (yolov8n's narrowest sharded layer has 16
    output channels), and a data axis of the rest.  ``device`` is this
    rank's."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_model is None:
        n_model = next((c for c in (4, 2) if n % c == 0), 1)
    if n_data is None:
        n_data = n // n_model
    return rank_mesh((n_data, n_model), (data_axis, model_axis), device, what="make_tp_mesh")


def _axis(mesh, axis: str):
    """``(size, this rank's index)`` along ``axis`` of ``mesh``."""
    if mesh is None:
        return 1, 0
    return mesh[axis].size(), mesh.get_local_rank(axis)


def shard_yolo_variables(variables: Dict[str, Any], mesh, model_axis: str = "model") -> Dict[str, Any]:
    """YOLO variables (a `YOLOv8` state dict) placed on the mesh with
    output-channel tensor sharding: ``DTensor``s whose local part is this
    rank's slice, ``Shard(0)`` over ``model_axis`` for 4-D OIHW conv
    weights and 1-D vectors whose first axis divides, replicated
    otherwise.  Made from the whole tensors every rank holds, with no
    communication.  With no mesh, the variables as they are."""
    if mesh is None:
        return dict(variables)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    n, r = _axis(mesh, model_axis)
    axis = mesh.mesh_dim_names.index(model_axis)
    device = mesh.device_type

    def place(x):
        x = torch.as_tensor(x)
        placements = [Replicate()] * mesh.ndim
        if x.dim() in (1, 4) and x.shape[0] % n == 0:
            placements[axis] = Shard(0)
            x = x.tensor_split(n)[r]
        return DTensor.from_local(x.to(device).contiguous(), mesh, placements, run_check=False)

    return {k: place(v) for k, v in variables.items()}


def _gather_channels(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """This rank's (B, C / n, H, W) slice of an activation, all-gathered over
    ``group`` into the whole (B, C, H, W), as raw bytes (any dtype)."""
    b, c, h, w = x.shape
    local = x.contiguous().view(torch.uint8)
    out = local.new_empty((n * b,) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(out, local, group=group)
    return out.view(x.dtype).view(n, b, c, h, w).transpose(0, 1).reshape(b, n * c, h, w)


def _gather_last(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """This rank's (..., C / n) slice of a linear layer's output,
    all-gathered over ``group`` into the whole (..., C)."""
    *lead, c = x.shape
    local = x.contiguous().view(torch.uint8).reshape(-1, c * x.element_size())
    out = local.new_empty((n * local.shape[0], local.shape[1]))
    dist.all_gather_into_tensor(out, local, group=group)
    return out.view(x.dtype).view(n, -1, c).transpose(0, 1).reshape(*lead, n * c)


def _gather_rows(tensors, n: int, group):
    """Tensors with a leading batch axis, all-gathered over ``group`` and
    concatenated on that axis, rank order, in one collective."""
    buf = pack_bytes(tensors)
    out = buf.new_empty(n * buf.numel())
    dist.all_gather_into_tensor(out, buf, group=group)
    parts = [unpack_bytes(p, byte_specs(tensors)) for p in out.chunk(n)]
    return [torch.cat(col) for col in zip(*parts)]


def make_sharded_yolo_detector(
    mesh,
    variant: str = "n",
    img_size: int = 640,
    max_det: int = 32,
    data_axis: str = "data",
    model_axis: str = "model",
    **detector_kwargs,
):
    """Build ``(init_fn, detect_batch_fn)`` running data x tensor parallel
    over ``mesh``.

    ``detect_batch_fn(variables, frames)`` takes a (B, H, W, 3) batch, the
    same on every rank, with B divisible by the data axis; each rank
    detects on its share of the frames with its slice of every layer, and
    every rank returns the whole batch's fixed-capacity detection tables.
    ``init_fn(generator)`` initializes (as the unsharded detector, from a
    CPU generator) and places the variables (use `shard_yolo_variables`
    for weights loaded elsewhere).  ``detector_kwargs`` are
    models/yolov8.py `make_yolo_detector`'s (``compute_dtype``,
    thresholds, ``pre_topk``, ...); the device is this rank's."""
    from ..models import yolov8

    device = detector_kwargs.pop("device", "cuda") if mesh is None else mesh.device_type
    detector_kwargs.pop("device", None)
    init_raw, detect = yolov8.make_yolo_detector(variant=variant, img_size=img_size, max_det=max_det,
                                                 device=device, **detector_kwargs)
    n_model, _ = _axis(mesh, model_axis)
    n_data, data_rank = _axis(mesh, data_axis)
    if n_model > 1:
        group = mesh.get_group(model_axis)

        def gather(module, inputs, out):
            return _gather_channels(out, n_model, group)

        for name, m in detect.model.named_modules():
            conv = m.conv if isinstance(m, yolov8.ConvBN) else m
            # The ConvBN blocks and the head's last convs; a ConvBN's own
            # conv is gathered with its block, after the BatchNorm and SiLU.
            own = isinstance(m, yolov8.ConvBN) or (isinstance(m, yolov8.Conv) and not name.endswith(".conv"))
            if own and conv.weight.shape[0] % n_model == 0:
                m.register_forward_hook(gather)

    def init_fn(generator: torch.Generator):
        return shard_yolo_variables(init_raw(generator), mesh, model_axis)

    def detect_batch_fn(variables, frames):
        from torch.distributed.tensor import DTensor

        frames = torch.as_tensor(frames)
        if frames.shape[0] % n_data:
            raise ValueError(f"a batch of {frames.shape[0]} frames does not split over a data axis of {n_data}")
        params = {k: v.to_local() if isinstance(v, DTensor) else v for k, v in variables.items()}
        tables = detect(params, frames.tensor_split(n_data)[data_rank])
        if n_data > 1:
            keys = sorted(tables)
            tables = dict(zip(keys, _gather_rows([tables[k] for k in keys], n_data, mesh.get_group(data_axis))))
        return tables

    return init_fn, detect_batch_fn


def shard_blip_variables(variables, mesh, model_axis: str = "model", cfg=None) -> nn.Module:
    """Tensor-shard the BLIP captioner (models/blip.py) over ``mesh``:
    every ``nn.Linear`` whose output width divides over ``model_axis``
    keeps this rank's rows of its weight and bias, and its output is
    all-gathered into the whole width; the other layers stay whole.
    ``variables`` is a `BlipForCaptioning` (sharded in place) or its state
    dict (then ``cfg`` is its `BlipConfig`).  Returns the model, which
    `make_caption_fn`'s caption function takes as it is."""
    from ..models.blip import model_from_state_dict

    if isinstance(variables, nn.Module):
        model = variables
    else:
        if cfg is None:
            raise ValueError("shard_blip_variables: a state dict needs its BlipConfig (cfg=)")
        model = model_from_state_dict(variables, cfg, mesh.device_type if mesh is not None else None)
    n, r = _axis(mesh, model_axis)
    if n == 1:
        return model
    group = mesh.get_group(model_axis)

    def gather(module, inputs, out):
        return _gather_last(out, n, group)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear) and m.out_features % n == 0:
                m.weight = nn.Parameter(m.weight.tensor_split(n)[r].contiguous(), requires_grad=False)
                if m.bias is not None:
                    m.bias = nn.Parameter(m.bias.tensor_split(n)[r].contiguous(), requires_grad=False)
                m.register_forward_hook(gather)
    return model
