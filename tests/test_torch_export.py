"""The port's serialized runner (utils/export.py) and the madpp custom ops
(ops/library.py), on the CPU, where each op runs its kernel's plain
version.

The counterpart of tests/test_utils.py's round trip: JAX's
`export_sequence_runner` and the port's, each saved, loaded and run on the
same 20 frames, every leaf of the final state and the outputs equal,
discrete leaves bit for bit and floats within atol 1e-4 (PARITY.md).  The
port's artifact against its eager runner bit for bit at batch 1 and 4, a
load in a fresh process, the refusals, and `torch.library.opcheck` on
each op.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_autonomous_driving_perception_and_planning_torch as pt
from multimodal_autonomous_driving_perception_and_planning_torch.estimation.ego import estimator_step_row
from multimodal_autonomous_driving_perception_and_planning_torch.ops import library
from multimodal_autonomous_driving_perception_and_planning_torch.ops.kalman import (
    KalmanModel,
    make_constant_accel_model,
)
from multimodal_autonomous_driving_perception_and_planning_torch.tagging.rules import (
    TaggingRules,
    make_packed_tagging_step,
)
from multimodal_autonomous_driving_perception_and_planning_torch.tracking.tracker import tracker_update_with_order
from multimodal_autonomous_driving_perception_and_planning_torch.types import (
    Detections,
    KalmanState,
    TaggingState,
    TrackTable,
    stack_lanes,
    tree_leaves,
    tree_map,
)
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import kalman_model_from_numpy
from multimodal_autonomous_driving_perception_and_planning_torch.utils import export as ex
from multimodal_autonomous_driving_perception_and_planning_tpu.data.synthetic import (
    ego_motion_stream,
    simulated_detection_stream,
)

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 20
ATOL = 1e-4


def _config(pkg):
    return pkg.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)


CFG = _config(pt)


def _stream(frames=FRAMES, start=1, seed=0):
    dets = simulated_detection_stream(frames, start_frame_count=start)
    ego = ego_motion_stream(frames, dt=1.0 / 30.0, seed=seed).astype(np.float32)
    return {**{k: np.asarray(v) for k, v in dets.items()}, "ego_measurement": ego}


def _leaves(tree, path=""):
    """(path, tensor) of a result in the JAX package's leaf order: dict keys
    sorted, dataclass fields in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name), f"{path}/{f.name}")]
    return [(path, tree)]


def _assert_bit_equal(got, want):
    lg, lw = _leaves(got), _leaves(want)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (path, a), (_, b) in zip(lg, lw):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.fixture(scope="module")
def artifacts():
    """``artifacts(batch)``: the port's CPU artifact of 20-frame chunks in
    CFG, one export a lane count."""
    made = {}

    def get(batch):
        if batch not in made:
            made[batch] = ex.export_sequence_runner(CFG, FRAMES, platforms=("cpu",), batch=batch)
        return made[batch]

    return get


def test_artifact_round_trip_matches_jax(tmp_path, artifacts):
    """JAX's artifact and the port's, each through save and load, on the
    same 20 frames: every leaf equal, discrete bit for bit, floats within
    ATOL."""
    from multimodal_autonomous_driving_perception_and_planning_tpu import DEFAULT_CONFIG as JAX_DEFAULT
    from multimodal_autonomous_driving_perception_and_planning_tpu import initial_state as jax_initial_state
    from multimodal_autonomous_driving_perception_and_planning_tpu.utils import export as jex

    cfg_j = JAX_DEFAULT.replace(use_frames=False, enable_tagging=True)
    inputs = _stream()
    path_j, path_t = tmp_path / "runner.jaxexport", tmp_path / "runner.pt2"
    jex.save_exported(str(path_j), jex.export_sequence_runner(cfg_j, FRAMES, platforms=("cpu",)))
    ex.save_exported(str(path_t), artifacts(1))
    run_j = jex.deserialize_runner(jex.load_exported(str(path_j)), cfg_j, FRAMES)
    run_t = ex.deserialize_runner(ex.load_exported(str(path_t)), CFG, FRAMES)

    want = jax.tree_util.tree_flatten_with_path(
        run_j(jax_initial_state(cfg_j), {k: jnp.asarray(v) for k, v in inputs.items()})
    )[0]
    got = _leaves(run_t(pt.initial_state(CFG, device="cpu"), inputs))
    assert len(got) == len(want) > 50
    values = {}
    for (path, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        a = a.numpy()
        values[path] = (a, b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=path)
        elif path != "/1/plan_order":
            np.testing.assert_array_equal(a, b, err_msg=path)
    # Mirror-image candidates cost the same up to float rounding, so the
    # stable sort may order such a pair either way (tests/test_torch_pipeline.py):
    # the port's order is a permutation that sorts JAX's costs within ATOL.
    (order_t, order_j), costs_j = values["/1/plan_order"], values["/1/plan_costs"][1]
    np.testing.assert_array_equal(np.sort(order_t, axis=1), np.sort(order_j, axis=1))
    np.testing.assert_allclose(np.take_along_axis(costs_j, order_t, axis=1),
                               np.take_along_axis(costs_j, order_j, axis=1), rtol=0, atol=ATOL)


@pytest.mark.parametrize("batch", [1, 4])
def test_artifact_equals_the_eager_runner(artifacts, batch):
    """The loaded program looped over the chunk gives the eager runner's
    final state and outputs bit for bit, at batch 1 and with 4 lanes."""
    run = ex.deserialize_runner(artifacts(batch), CFG, FRAMES, batch=batch)
    if batch == 1:
        eager = pt.make_sequence_runner(CFG, device="cpu")
        state, inputs = pt.initial_state(CFG, device="cpu"), _stream()
    else:
        eager = pt.make_batched_sequence_runner(CFG, device="cpu")
        state = stack_lanes([pt.initial_state(CFG, device="cpu")] * batch)
        streams = [_stream(start=1 + 7 * b, seed=b) for b in range(batch)]
        inputs = {k: np.stack([s[k] for s in streams]) for k in streams[0]}
    _assert_bit_equal(run(state, inputs), eager(state, inputs))


def test_program_reaches_the_kernels_only_through_madpp_ops(artifacts):
    program, meta = ex.load_program(artifacts(1))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {t for t in targets if t.startswith("madpp.")} == {
        "madpp.tracker_step.default", "madpp.kalman_step.default", "madpp.tagging_step.default"
    }
    assert meta["inputs"] == sorted(ex.example_sequence_inputs(CFG, FRAMES))
    assert meta["state_leaves"] == len(tree_leaves(pt.initial_state(CFG, device="cpu")))
    assert (meta["num_frames"], meta["batch"], meta["device"]) == (FRAMES, 1, "cpu")


_FRESH = """
import sys
import numpy as np
import torch
from multimodal_autonomous_driving_perception_and_planning_torch import DEFAULT_CONFIG, initial_state
from multimodal_autonomous_driving_perception_and_planning_torch.types import tree_leaves
from multimodal_autonomous_driving_perception_and_planning_torch.utils.export import deserialize_runner, load_exported

path, inputs_path, out_path, frames = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
cfg = DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=True)
with np.load(inputs_path) as z:
    inputs = {k: z[k] for k in z.files}
state, outs = deserialize_runner(load_exported(path), cfg, frames)(initial_state(cfg, device="cpu"), inputs)
assert "jax" not in sys.modules and not any(m.startswith("multimodal_autonomous_driving_perception_and_planning_tpu") for m in sys.modules)
leaves = tree_leaves(state) + [outs[k] for k in sorted(outs) if k not in ("tags", "vehicle_state")]
leaves += tree_leaves(outs["vehicle_state"]) + [outs["tags"][k] for k in sorted(outs["tags"])]
np.savez(out_path, *[leaf.numpy() for leaf in leaves])
"""


def test_artifact_loads_in_a_fresh_process(tmp_path, artifacts):
    """A process that imports only the port loads the saved artifact (the
    madpp ops register on import) and runs what this process's eager
    runner runs."""
    path, inputs_path, out_path = tmp_path / "runner.pt2", tmp_path / "inputs.npz", tmp_path / "out.npz"
    ex.save_exported(str(path), artifacts(1))
    inputs = _stream()
    np.savez(inputs_path, **inputs)
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH, str(path), str(inputs_path), str(out_path), str(FRAMES)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    state, outs = pt.make_sequence_runner(CFG, device="cpu")(pt.initial_state(CFG, device="cpu"), inputs)
    want = tree_leaves(state) + [outs[k] for k in sorted(outs) if k not in ("tags", "vehicle_state")]
    want += tree_leaves(outs["vehicle_state"]) + [outs["tags"][k] for k in sorted(outs["tags"])]
    with np.load(out_path) as z:
        got = [z[f"arr_{i}"] for i in range(len(z.files))]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy()), i


def _wide(inputs):
    """The chunk with one more detection a frame."""
    return {k: v if k == "ego_measurement" else np.concatenate([v, v[:, :1]], axis=1) for k, v in inputs.items()}


@pytest.mark.parametrize("case", ["frame_count", "detection_width", "extra_input", "batch", "num_frames"])
def test_runner_refuses_other_inputs(artifacts, case):
    """A chunk of another length, another detection width (the program's
    guards), an input the artifact does not take, and a runner asked for
    another chunk length or lane count than the artifact's."""
    state = pt.initial_state(CFG, device="cpu")
    if case == "batch":
        with pytest.raises(ValueError, match="batch"):
            ex.deserialize_runner(artifacts(1), CFG, FRAMES, batch=2)
        return
    if case == "num_frames":
        with pytest.raises(ValueError, match="20-frame"):
            ex.deserialize_runner(artifacts(1), CFG, FRAMES + 1)
        return
    run = ex.deserialize_runner(artifacts(1), CFG, FRAMES)
    if case == "frame_count":
        with pytest.raises(ValueError, match="20-frame chunks; got 19"):
            run(state, _stream(FRAMES - 1))
    elif case == "detection_width":
        with pytest.raises(AssertionError, match="Guard failed"):
            run(state, _wide(_stream()))
    else:
        with pytest.raises(ValueError, match="exactly the inputs"):
            run(state, dict(_stream(), has_measurement=np.ones(FRAMES, bool)))


@pytest.mark.parametrize(
    "kwargs,error,match",
    [
        ({"dp": 2}, NotImplementedError, "ROADMAP item 10b"),
        ({"platforms": ("cuda", "cpu")}, NotImplementedError, "ROADMAP item 11"),
        ({"platforms": ("tpu",)}, ValueError, "'cuda',"),
        ({"use_frames": True}, NotImplementedError, "ROADMAP items 5a and 11"),
    ],
)
def test_export_refuses_what_is_not_ported(kwargs, error, match):
    cfg = CFG.replace(use_frames=True) if kwargs.pop("use_frames", False) else CFG
    with pytest.raises(error, match=match):
        ex.export_sequence_runner(cfg, 4, **{"platforms": ("cpu",), **kwargs})
    if "dp" in kwargs or cfg.use_frames:
        with pytest.raises(error, match=match):
            ex.deserialize_runner(b"", cfg, 4, **kwargs)


def test_cuda_export_needs_the_card():
    """The default platform is the card, refused without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal shows only without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.export_sequence_runner(CFG, 4)


# --- the madpp ops -----------------------------------------------------------


@pytest.fixture(scope="module")
def op_inputs():
    """Each op's arguments at a state the runner reaches after 12 frames, 3
    lanes of it for the lane-axis case."""
    cfg = CFG.replace(tracker=dataclasses.replace(CFG.tracker, max_tracks=16))
    inputs = _stream(13)
    state, _ = pt.make_sequence_runner(cfg, device="cpu")(
        pt.initial_state(cfg, device="cpu"), {k: v[:12] for k, v in inputs.items()}
    )
    dets = pt.detections_from_arrays({k: inputs[k][12] for k in ("bbox", "class_id", "confidence", "valid")}, "cpu")
    model = kalman_model_from_numpy(
        *make_constant_accel_model(
            cfg.estimator.dt, cfg.estimator.process_noise, cfg.estimator.measurement_noise,
            cfg.estimator.accel_noise_scale,
        ),
        device="cpu",
    )
    z = torch.from_numpy(inputs["ego_measurement"][12])
    has = torch.ones((), dtype=torch.bool)
    vrow = torch.arange(11, dtype=torch.float32) * 0.5
    rules = TaggingRules.from_config(cfg)
    trk, est = cfg.tracker, cfg.estimator

    def args(lanes):
        def lane(x):
            return x if lanes is None else torch.stack([x] * lanes).contiguous()

        s = tree_map(lane, state)
        d = tree_map(lane, dets)
        return {
            "tracker_step": (*tree_leaves(s.tracks), *tree_leaves(d), float(trk.iou_threshold), trk.max_age,
                             trk.min_hits),
            "kalman_step": (*tree_leaves(s.kalman), lane(z), lane(has), *model, float(est.dt),
                            float(est.speed_heading_hold)),
            "tagging_step": (*tree_leaves(d), *tree_leaves(s.tracks), lane(vrow), *tree_leaves(s.tagging),
                             rules.params.tolist(), rules.min_hits),
        }

    return args


@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("name", ["tracker_step", "kalman_step", "tagging_step"])
def test_madpp_op_passes_opcheck(op_inputs, name, lanes):
    """`torch.library.opcheck` on each op with its CPU implementation: the
    schema, the fake implementation's shapes against the real outputs, and
    the op under AOT dispatch."""
    torch.library.opcheck(getattr(torch.ops.madpp, name).default, op_inputs(lanes)[name])


@pytest.mark.parametrize("name", ["tracker_step", "kalman_step", "tagging_step"])
def test_madpp_op_route_equals_the_dispatcher(op_inputs, name):
    """The pipeline's entry point through the op (ops/library.py) against
    the same entry point's plain route on the CPU, every field bit for bit."""
    cfg = CFG.replace(tracker=dataclasses.replace(CFG.tracker, max_tracks=16))
    a = op_inputs(None)[name]
    if name == "tracker_step":
        table, dets = TrackTable(*a[:12]), Detections(*a[12:16])
        got = library.tracker_update_with_order(table, dets, cfg.tracker, cfg.tracker.min_hits)
        want = tracker_update_with_order(table, dets, cfg.tracker, cfg.tracker.min_hits)
    elif name == "kalman_step":
        ks, model = KalmanState(*a[:5]), KalmanModel(*a[7:11])
        got = library.estimator_step_row(ks, model, a[5], a[6], cfg.estimator)
        want = estimator_step_row(ks, model, a[5], a[6], cfg.estimator)
    else:
        dets, table = Detections(*a[:4]), TrackTable(*a[4:16])
        state = TaggingState(*a[17:25])
        got = library.make_packed_tagging_step(cfg)(state, dets, table, a[16])
        want = make_packed_tagging_step(cfg)(state, dets, table, a[16])
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("name", ["tracker_step", "kalman_step", "tagging_step"])
def test_cuda_implementation_never_runs_the_plain_version(op_inputs, name):
    """An op's CUDA implementation launches the kernel or raises: given
    tensors that are not on the card, it refuses them and does not run
    the plain version."""
    cuda_impl = {"tracker_step": library._tracker_step_cuda, "kalman_step": library._kalman_step_cuda,
                 "tagging_step": library._tagging_step_cuda}[name]
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        cuda_impl(*op_inputs(None)[name])
