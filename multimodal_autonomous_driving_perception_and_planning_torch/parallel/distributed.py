"""Ranks: the port's way across cards, one process a device.

The JAX package has one controller that drives every chip; it needs no
counterpart of this module.  The port follows PyTorch's idiom instead:
each card is driven by a process of its own (a rank), the ranks join one
``torch.distributed`` process group, and the meshes of parallel/mesh.py,
parallel/tp.py and utils/export.py are ``DeviceMesh``es over those ranks.
The pipeline's pace is set by the host (a frame step is a few launches of
small kernels), so a single process feeding several cards would not scale.

Backends: NCCL between cards, gloo for ranks on the CPU.  Two ranks that
share one card (a check on a one-card machine) take gloo with CUDA
tensors, which the caller asks for on purpose by naming the devices: NCCL
refuses two ranks on one card.

Starting ranks:

* on cards, ``python -m torch.distributed.run --nproc-per-node N ...``
  (``torchrun``), and each rank calls `init_ranks` (NCCL, ``cuda:LOCAL_RANK``);
* from Python, `spawn` starts ``world_size`` processes that meet at a
  ``file://`` rendezvous under a directory of the caller's (no TCP port to
  race for), runs ``fn(device, *args)`` on each and returns the values,
  rank by rank: on the cards over NCCL unless the caller asks for gloo.
  Each rank has a join timeout: a rank that hangs fails the call instead
  of holding it.
"""

from __future__ import annotations

import math
import os
import time
import traceback
import uuid
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

BACKENDS = ("nccl", "gloo")


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rank_devices(world_size: int, backend: str, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The device of each of ``world_size`` ranks: ``devices`` as given, or
    by default ``cuda:0 ... cuda:N-1`` for NCCL and the CPU for gloo.
    Raises for NCCL without cards, for more NCCL ranks than cards or two on
    one card, and for CUDA devices that do not exist."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: the port's ranks run on {BACKENDS}")
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if devices is None:
        if backend == "nccl":
            devices = [f"cuda:{r}" for r in range(world_size)]
        else:
            devices = ["cpu"] * world_size
    devices = [torch.device(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl":
        if cards == 0:
            raise RuntimeError("backend='nccl' needs CUDA devices and this machine has none; use backend='gloo'")
        if any(d.type != "cuda" for d in devices) or len({d.index for d in devices}) != world_size:
            raise ValueError(
                f"NCCL runs one rank a card; got {[str(d) for d in devices]}. Ranks sharing a card take "
                "backend='gloo' with the devices named"
            )
    for d in devices:
        if d.type == "cuda" and (d.index is None or d.index >= cards):
            raise ValueError(f"{d}: this machine has {cards} CUDA device(s)")
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {d}")
    return devices


def init_ranks(device="cuda", backend: Optional[str] = None, init_method: str = "env://",
               rank: Optional[int] = None, world_size: Optional[int] = None,
               timeout: float = 600.0) -> torch.device:
    """Join (or start) the process group and return this rank's device.

    Under ``torchrun`` every argument but ``device`` comes from the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the
    rendezvous address).  ``device="cuda"`` is the card ``LOCAL_RANK`` with
    NCCL, refused when the host has no such card; ``"cpu"`` is the CPU with
    gloo.  A device with an index (``"cuda:0"``) is taken as it is, for
    ranks that share a card over gloo."""
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= cards:
            raise RuntimeError(
                f"rank {rank} (local rank {local}) has no card of its own: this host has {cards}; start at most "
                f"{cards} ranks a host, or name the devices with backend='gloo'"
            )
        dev = torch.device("cuda", local)
    dev = resolve_device(dev)
    backend = backend or _default_backend(dev)
    rank_devices(1, backend, [dev])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout))
    return dev


def rank_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device, what: str = "mesh"):
    """A ``DeviceMesh`` of ``shape`` over every rank of the process group,
    its axes named ``names``, or None for a mesh of this one rank, without
    a process group or beside other ranks (the one-device runners take
    it).  A mesh of more than one rank without a process group raises,
    naming the group; a mesh whose size is not the group's raises
    `ValueError`."""
    n = math.prod(shape)
    if n == 1 and (not dist.is_initialized() or dist.get_world_size() > 1):
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what}: a mesh of {n} ranks needs an initialized torch.distributed process group of {n} ranks "
            "(parallel/distributed.py `init_ranks` under torchrun, or `spawn`); no process group is initialized"
        )
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"{what}: a mesh of {n} ranks over a process group of {world} ranks; they must be equal")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, tuple(shape), mesh_dim_names=tuple(names))


# --- spawning ranks ----------------------------------------------------------


def _rank_main(fn, rank, world_size, backend, init_method, device, args, timeout, threads, results):
    """One spawned rank: join the group, run ``fn``, report its value or
    its traceback."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout))
        try:
            value = fn(dev, *args)
        finally:
            if dist.is_initialized():  # ``fn`` may have ended the group itself
                dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:  # noqa: BLE001 -- reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world_size: int, rendezvous_dir: str, *args, backend: Optional[str] = None,
          devices: Optional[Sequence] = None, timeout: float = 300.0, threads: Optional[int] = None) -> list:
    """Run ``fn(device, *args)`` on ``world_size`` new ranks and return
    their values, rank 0 first.

    The ranks are spawned processes (``fn`` and ``args`` are pickled, so
    ``fn`` is a module-level function) that meet at a ``file://``
    rendezvous in ``rendezvous_dir``.  By default they run on the cards,
    one a rank over NCCL (``cuda:0 ... cuda:N-1``), and a machine without
    enough cards raises; ``backend="gloo"`` runs them on the CPU, or on the
    ``devices`` named (`rank_devices` gives the defaults and the
    refusals).  Without ``backend``, ``devices`` all on the CPU take gloo
    and any other list NCCL.  ``threads`` sets
    each rank's intra-op threads.  A rank that raises makes the call raise
    `RuntimeError` with its traceback; ranks that have not all answered
    within ``timeout`` seconds (also each collective's limit) make it raise
    `TimeoutError`.  Every rank is ended before the call returns."""
    import multiprocessing as mp
    import queue

    if backend is None:
        cpu = devices is not None and all(torch.device(d).type == "cpu" for d in devices)
        backend = "gloo" if cpu else "nccl"
    devices = rank_devices(world_size, backend, devices)
    os.makedirs(rendezvous_dir, exist_ok=True)
    init_method = "file://" + os.path.join(os.path.abspath(rendezvous_dir), f"rendezvous-{uuid.uuid4().hex}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, name=f"rank{r}",
                    args=(fn, r, world_size, backend, init_method, str(devices[r]), args, timeout, threads, results))
        for r in range(world_size)
    ]
    values: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(values) < world_size:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = results.get(timeout=max(left, 0.01))
            except queue.Empty:
                missing = sorted(set(range(world_size)) - set(values))
                raise TimeoutError(f"ranks {missing} of {world_size} did not finish within {timeout:.0f} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            values[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(values) == world_size else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    return [values[r] for r in range(world_size)]


# --- moving tables between ranks ---------------------------------------------


# Each tensor starts at a multiple of this many bytes in a packed buffer,
# so that its view in the target dtype is aligned.
_ALIGN = 8


def _padded(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def pack_bytes(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tensors as one flat uint8 tensor on their device (one collective
    moves them all); `unpack_bytes` undoes it."""
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = _padded(b.numel()) - b.numel()
        parts += [b, b.new_zeros(pad)] if pad else [b]
    return torch.cat(parts)


def byte_specs(tensors: Sequence[torch.Tensor]) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    """The ``(shape, dtype)`` of each tensor, what `unpack_bytes` needs."""
    return [(tuple(t.shape), t.dtype) for t in tensors]


def _sizes(specs) -> List[int]:
    return [math.prod(shape) * torch.empty((), dtype=dtype).element_size() for shape, dtype in specs]


def packed_size(specs) -> int:
    """The bytes `pack_bytes` takes for tensors of ``specs``."""
    return sum(_padded(n) for n in _sizes(specs))


def unpack_bytes(buf: torch.Tensor, specs) -> List[torch.Tensor]:
    """The tensors of `pack_bytes`, as views of ``buf``."""
    sizes = _sizes(specs)
    parts = torch.split(buf, [_padded(n) for n in sizes])
    return [p[:n].view(dtype).view(shape) for p, n, (shape, dtype) in zip(parts, sizes, specs)]
