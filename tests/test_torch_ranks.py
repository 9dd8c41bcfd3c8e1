"""The port's ranks (parallel/distributed.py) on the CPU, and the functions
the other parallel tests run on spawned ranks.

Those functions live here, at module level, so that they pickle by name
and a spawned rank imports this module, which imports only the port (no
JAX): tests/test_torch_parallel.py and tests/test_torch_serve.py hold
their results to the JAX package in the pytest process.  Each rank runs
on gloo with one intra-op thread, meets the others at a ``file://``
rendezvous under the test's ``tmp_path``, and is joined with a timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import multimodal_autonomous_driving_perception_and_planning_torch as pt
from multimodal_autonomous_driving_perception_and_planning_torch.parallel import distributed
from multimodal_autonomous_driving_perception_and_planning_torch.parallel.mesh import (
    gather_cameras,
    make_camera_mesh,
    make_multicamera_runner,
    stack_states,
)
from multimodal_autonomous_driving_perception_and_planning_torch.types import tree_map

RANK_TIMEOUT = 240.0


def numpy_tree(tree):
    return tree_map(lambda t: t.numpy(), tree)


# --- functions run on the ranks ----------------------------------------------


def camera_mesh_rank(device, cfg_kw: dict, inputs: dict):
    """The camera mesh over every rank: the gathered outputs, the fleet and
    this rank's share of the final states, as numpy."""
    cfg = pt.DEFAULT_CONFIG.replace(**cfg_kw)
    n = inputs["bbox"].shape[0]
    mesh = make_camera_mesh(device=device)
    final, outs, fleet = make_multicamera_runner(cfg, mesh)(stack_states(cfg, n, device=device), inputs)
    local_next_id = final.tracks.next_id.to_local()
    return {
        "outs": numpy_tree(gather_cameras(outs)),
        "fleet": fleet["fleet_confirmed_per_frame"].numpy(),
        "mesh": (mesh.size, mesh.axis_names),
        "local_next_id": local_next_id.numpy(),
    }


def tp_yolo_rank(device, state: dict, frames: np.ndarray, n_data: int, n_model: int, kw: dict):
    """The tensor-parallel YOLO on the given weights: every rank's tables
    and its mesh's shape."""
    from multimodal_autonomous_driving_perception_and_planning_torch.parallel.tp import (
        make_sharded_yolo_detector,
        make_tp_mesh,
        shard_yolo_variables,
    )

    mesh = make_tp_mesh(n_data, n_model, device=device)
    _, detect = make_sharded_yolo_detector(mesh, **kw)
    variables = shard_yolo_variables({k: torch.as_tensor(v) for k, v in state.items()}, mesh)
    local_shapes = {k: tuple(v.to_local().shape) for k, v in variables.items() if k.endswith("b0.conv.weight")}
    tables = detect(variables, frames)
    return {"tables": {k: v.numpy() for k, v in tables.items()}, "mesh": tuple(mesh.shape),
            "default_mesh": tuple(make_tp_mesh(device=device).shape), "local_shapes": local_shapes}


def tp_blip_rank(device, state: dict, cfg, max_new_tokens: int, px: np.ndarray, prompt: np.ndarray,
                 prompt_len: int):
    """The BLIP captioner sharded over every rank: its greedy decode, and
    its first step's logits at every prompt position beside the unsharded
    model's."""
    from multimodal_autonomous_driving_perception_and_planning_torch.models import blip
    from multimodal_autonomous_driving_perception_and_planning_torch.parallel.tp import (
        make_tp_mesh,
        shard_blip_variables,
    )

    def logits(model):
        with torch.inference_mode():
            return model.decode(prompt_t[None], model.encode_cross(px_t))[0]

    px_t, prompt_t = torch.as_tensor(px), torch.as_tensor(prompt)
    _, caption = blip.make_caption_fn(cfg, max_new_tokens=max_new_tokens, device=device)
    params = {k: torch.as_tensor(v) for k, v in state.items()}
    whole = logits(blip.model_from_state_dict(params, cfg))
    mesh = make_tp_mesh(n_data=1, device=device)
    model = shard_blip_variables(params, mesh, cfg=cfg)
    ids, length = caption(model, px_t, prompt_t, prompt_len)
    sharded = sum(isinstance(m, torch.nn.Linear) and m.weight.shape[0] < m.out_features for m in model.modules())
    return {"ids": ids.numpy(), "length": int(length), "sharded_linears": sharded,
            "logits": logits(model).numpy(), "whole_logits": whole.numpy()}


def dp_server_rank(device, cfg, chunk: int, batch: int, chunks: dict):
    """A dp server over every rank: rank 0 drives each session's chunks in
    order, the sessions concurrently, and returns what it served, the
    batching metrics and each session's exported state; the other ranks
    serve their lanes until rank 0 closes."""
    from multimodal_autonomous_driving_perception_and_planning_torch.apps.serve import PipelineServer

    ps = PipelineServer(cfg=cfg, chunk=chunk, max_sessions=len(chunks), batch=batch, batch_window_ms=100.0,
                        dp=dist.get_world_size(), device=device)
    if ps.rank != 0:
        ps.serve_worker()
        return None
    try:
        sids = {s: ps.create_session() for s in chunks}
        got = {s: [None] * len(c) for s, c in chunks.items()}
        errors = []

        def drive(s):
            try:
                for i, arrays in enumerate(chunks[s]):
                    got[s][i] = ps.infer(sids[s], arrays)
            except Exception as e:  # noqa: BLE001 -- returned to the test
                errors.append(repr(e))

        threads = [threading.Thread(target=drive, args=(s,)) for s in chunks]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=RANK_TIMEOUT)
        return {"got": got, "errors": errors, "alive": any(t.is_alive() for t in threads),
                "batching": ps.metrics()["batching"], "states": {s: ps.export_session(sids[s]) for s in chunks}}
    finally:
        ps.close()


def dp_runner_rank(device, data: bytes, cfg, chunk: int, batch: int, state_leaves: list, inputs: dict):
    """The dp artifact's runner on every rank, on the whole batch (the
    state's leaves with their lane axis): this rank's lanes as local
    tensors and the whole results gathered."""
    from multimodal_autonomous_driving_perception_and_planning_torch.types import tree_unflatten
    from multimodal_autonomous_driving_perception_and_planning_torch.utils.export import deserialize_runner

    run = deserialize_runner(data, cfg, chunk, batch=batch, dp=dist.get_world_size(), device=str(device))
    state = tree_unflatten(pt.initial_state(cfg, device=device), [torch.as_tensor(x) for x in state_leaves])
    new_state, outs = run(state, inputs)
    local = outs["track_id"].to_local()
    whole = gather_cameras((new_state, outs))
    return {"local_track_id": local.numpy(), "whole": numpy_tree(whole), "lanes_per_rank": run.lanes_per_rank}


def _fails_on_rank_1(device):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    return dist.get_rank()


def _sleeps(device, seconds):
    time.sleep(seconds)


def _sums(device):
    t = torch.full((2,), float(dist.get_rank() + 1))
    dist.all_reduce(t)
    return t.tolist(), str(device)


# --- tests of the ranks themselves -------------------------------------------


def test_spawn_runs_every_rank_and_returns_in_rank_order(tmp_path):
    got = distributed.spawn(_sums, 2, str(tmp_path), backend="gloo", threads=1, timeout=RANK_TIMEOUT)
    assert got == [([3.0, 3.0], "cpu"), ([3.0, 3.0], "cpu")]


def test_a_failing_rank_fails_the_call_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank 1 fails"):
        distributed.spawn(_fails_on_rank_1, 2, str(tmp_path), backend="gloo", threads=1, timeout=RANK_TIMEOUT)


def test_a_hung_rank_times_out_and_is_ended(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 2 s"):
        distributed.spawn(_sleeps, 1, str(tmp_path), 60.0, backend="gloo", threads=1, timeout=2.0)
    assert time.monotonic() - t0 < 30.0


@pytest.mark.parametrize(
    "world,backend,devices,error,match",
    [
        (2, "nccl", None, (RuntimeError, ValueError), "nccl|CUDA"),
        (2, "nccl", ["cuda:0", "cuda:0"], (RuntimeError, ValueError), "nccl|NCCL"),
        (1, "gloo", ["cuda:3"], ValueError, "CUDA device"),
        (1, "mpi", None, ValueError, "backend"),
        (2, "gloo", ["cpu"], ValueError, "1 devices for 2 ranks"),
    ],
)
def test_rank_devices_refuse_what_cannot_run(world, backend, devices, error, match):
    """NCCL without cards, two NCCL ranks on one card, a card the machine
    lacks, an unknown backend, a device list of the wrong length."""
    if torch.cuda.is_available():
        pytest.skip("this machine has cards; the refusals of a machine without one show only without them")
    with pytest.raises(error, match=match):
        distributed.rank_devices(world, backend, devices)


def test_init_ranks_refuses_a_rank_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has cards")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="no card of its own"):
        distributed.init_ranks("cuda")
    assert not dist.is_initialized()


def test_spawn_runs_on_the_cards_unless_asked_for_gloo(tmp_path):
    """`spawn` without a backend puts its ranks on the cards over NCCL, so
    a machine without cards refuses it before any rank starts; CPU devices
    named without a backend take gloo."""
    if torch.cuda.is_available():
        pytest.skip("this machine has cards")
    with pytest.raises(RuntimeError, match="nccl"):
        distributed.spawn(_sums, 2, str(tmp_path), threads=1, timeout=RANK_TIMEOUT)
    assert not list(tmp_path.iterdir())
    got = distributed.spawn(_sums, 2, str(tmp_path), devices=["cpu", "cpu"], threads=1, timeout=RANK_TIMEOUT)
    assert got == [([3.0, 3.0], "cpu"), ([3.0, 3.0], "cpu")]


def test_packed_bytes_round_trip():
    tensors = [torch.tensor([True, False, True]), torch.arange(5, dtype=torch.int32),
               torch.linspace(0, 1, 6, dtype=torch.float32).view(2, 3), torch.zeros((0, 4)),
               torch.arange(3, dtype=torch.int64)]
    buf = distributed.pack_bytes(tensors)
    assert buf.dtype == torch.uint8 and buf.numel() == distributed.packed_size(distributed.byte_specs(tensors))
    back = distributed.unpack_bytes(buf, distributed.byte_specs(tensors))
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(back, tensors))


def test_a_mesh_of_one_rank_needs_no_group():
    assert distributed.rank_mesh((1,), ("camera",), "cpu") is None
    with pytest.raises(RuntimeError, match="process group"):
        distributed.rank_mesh((2, 2), ("data", "model"), "cpu")
