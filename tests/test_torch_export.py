"""The port's serialized runner (utils/export.py) and the madpp custom ops
(ops/library.py), on the CPU, where each op runs its kernel's plain
version.

The counterpart of tests/test_utils.py's round trip: JAX's
`export_sequence_runner` and the port's, each saved, loaded and run on the
same 20 frames, every leaf of the final state and the outputs equal,
discrete leaves bit for bit and floats within atol 1e-4 (PARITY.md).  The
port's artifact against its eager runner bit for bit at batch 1 and 4, a
load in a fresh process, the dp, multi-platform and frames-mode exports
and what is still refused, and `torch.library.opcheck` on each op.  Then
frames mode at 120x160 against JAX's frames-mode artifact and the eager
runner at batch 1 and 2, the multi-platform artifact against the CPU one,
an artifact for the card made without one (tests/test_utils.py's
cross-host case), K3's frames mode through its op, and the Canny
hysteresis exported against its eager blocks.
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
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch.estimation.ego import estimator_step_row
from multimodal_autonomous_driving_perception_and_planning_torch.ops import image as it
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



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_yolo.py pins: the suite
    runs several workers on the same cores, and torch's default of one
    thread a core in each made the frames-mode steps wait on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# The cases keep the ids they had when each of them was refused.
@pytest.mark.parametrize(
    "case",
    ["dp", "platforms", "tpu", "use_frames"],
    ids=["kwargs0-NotImplementedError-ROADMAP item 10b", "kwargs1-NotImplementedError-ROADMAP item 11",
         "kwargs2-ValueError-'cuda',", "kwargs3-NotImplementedError-ROADMAP items 5a and 11"],
)
def test_export_refuses_what_is_not_ported(case, frames_artifacts):
    """What export once refused and now makes, and what it still refuses:
    ``dp=2`` exports the program of batch / dp lanes (a batch that does not
    split raises) and its runner refuses a context without dp ranks;
    ``("cuda", "cpu")`` exports on the CPU; a TPU target raises; frames
    mode exports with the frame among its inputs."""
    if case == "dp":
        with pytest.raises(ValueError, match="multiple of dp=2"):
            ex.export_sequence_runner(CFG, 4, platforms=("cpu",), dp=2)
        data = ex.export_sequence_runner(CFG, 4, platforms=("cpu",), batch=2, dp=2)
        assert (ex.load_program(data)[1]["dp"], ex.load_program(data)[1]["batch"]) == (2, 2)
        with pytest.raises(ValueError, match="dp=2 over the 1 rank.*no torch.distributed process group"):
            ex.deserialize_runner(data, CFG, 4, batch=2, dp=2, device="cpu")
    elif case == "platforms":
        _, meta = ex.load_program(ex.export_sequence_runner(CFG, 4, platforms=("cuda", "cpu")))
        assert (meta["platforms"], meta["exported_on"]) == (["cuda", "cpu"], "cpu")
    elif case == "tpu":
        with pytest.raises(ValueError, match="'cuda', 'cpu' or both"):
            ex.export_sequence_runner(CFG, 4, platforms=("tpu",))
    else:
        _, meta = ex.load_program(frames_artifacts(1)[0])
        assert "frame" in meta["inputs"] and {"lane_f", "lane_b"} <= set(meta["outputs"])


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


# --- frames mode, several platforms, the traced hysteresis --------------------

FRAMES_H, FRAMES_W, FRAMES_N = 120, 160, 8


def _frames_config(pkg):
    return pkg.DEFAULT_CONFIG.replace(use_frames=True, enable_tagging=True, frame_height=FRAMES_H,
                                      frame_width=FRAMES_W)


def _road_stream(lane=0):
    """A 120x160 road clip (the dashes' phase shifted a lane) with its
    detections and ego stream; the frames as uint8."""
    from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import SyntheticRoadGenerator

    frames = SyntheticRoadGenerator(width=FRAMES_W, height=FRAMES_H).generate_frames(FRAMES_N + 3 * lane)[3 * lane :]
    return {**_stream(FRAMES_N, start=1 + 7 * lane, seed=lane), "frame": frames}


@pytest.fixture(scope="module")
def frames_artifacts():
    """``frames_artifacts(batch)``: the port's frames-mode CPU artifact and
    its loaded runner, made once a lane count (a frames-mode export and a
    load take about 15 and 5 s here)."""
    made = {}

    def get(batch):
        if batch not in made:
            data = ex.export_sequence_runner(_frames_config(pt), FRAMES_N, platforms=("cpu",), batch=batch)
            made[batch] = data, ex.deserialize_runner(data, _frames_config(pt), FRAMES_N, batch=batch)
        return made[batch]

    return get


def test_frames_mode_artifact_matches_jax(frames_artifacts):
    """JAX's frames-mode `export_sequence_runner` and the port's at 120x160
    over 8 frames: every leaf of the final state and the outputs, discrete
    bit for bit, floats within ATOL."""
    from multimodal_autonomous_driving_perception_and_planning_tpu import initial_state as jax_initial_state
    from multimodal_autonomous_driving_perception_and_planning_tpu.utils import export as jex

    cfg_j, cfg_t = _frames_config(pj), _frames_config(pt)
    inputs = _road_stream()
    run_j = jex.deserialize_runner(jex.export_sequence_runner(cfg_j, FRAMES_N, platforms=("cpu",)), cfg_j, FRAMES_N)
    want = jax.tree_util.tree_flatten_with_path(
        run_j(jax_initial_state(cfg_j), {k: jnp.asarray(v.astype(np.int32) if k == "frame" else v)
                                         for k, v in inputs.items()})
    )[0]
    run_t = frames_artifacts(1)[1]
    got = _leaves(run_t(pt.initial_state(cfg_t, device="cpu"), inputs))
    assert len(got) == len(want) > 50
    assert any(p.startswith("/1/lane_obs") for p, _ in got)
    values = {}
    for (path, a), (_, b) in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        values[path] = (a, b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=path)
        elif path != "/1/plan_order":
            np.testing.assert_array_equal(a, b, err_msg=path)
    (order_t, order_j), costs_j = values["/1/plan_order"], values["/1/plan_costs"][1]
    np.testing.assert_allclose(np.take_along_axis(costs_j, order_t, axis=1),
                               np.take_along_axis(costs_j, order_j, axis=1), rtol=0, atol=ATOL)


@pytest.mark.parametrize("batch", [1, 2])
def test_frames_mode_artifact_equals_the_eager_runner(frames_artifacts, batch):
    """The frames-mode program looped over 8 road frames (uint8, as the
    eager runner takes them) gives the eager frames runner's state and
    outputs bit for bit, unbatched and with 2 lanes of their own clips; it
    reaches K1-K3 only through the madpp ops and runs the Canny
    hysteresis as two while_loops."""
    cfg = _frames_config(pt)
    data, run = frames_artifacts(batch)
    if batch == 1:
        eager = pt.make_sequence_runner(cfg, device="cpu")
        state, inputs = pt.initial_state(cfg, device="cpu"), _road_stream()
    else:
        eager = pt.make_batched_sequence_runner(cfg, device="cpu")
        state = stack_lanes([pt.initial_state(cfg, device="cpu")] * batch)
        streams = [_road_stream(b) for b in range(batch)]
        inputs = {k: np.stack([s[k] for s in streams]) for k in streams[0]}
    _assert_bit_equal(run(state, inputs), eager(state, inputs))
    program, _ = ex.load_program(data)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert {t for t in targets if t.startswith("madpp.")} == {
        "madpp.tracker_step.default", "madpp.kalman_step.default", "madpp.tagging_step.default"
    }
    assert sum("while_loop" in t for t in targets) == 2 * batch  # each lane's two Canny passes


def test_multi_platform_artifact_equals_the_cpu_artifact(artifacts):
    """``("cuda", "cpu")`` exports on the CPU; loaded with ``device="cpu"``
    it runs the madpp ops' plain versions and gives the CPU artifact's
    results bit for bit; loaded with the default device it asks for the
    card, refused here."""
    data = ex.export_sequence_runner(CFG, FRAMES, platforms=("cpu", "cuda"))
    program, meta = ex.load_program(data)
    assert (meta["platforms"], meta["device"]) == (["cpu", "cuda"], "cpu")
    assert {str(n.target) for n in program.graph.nodes if str(n.target).startswith("madpp.")} == {
        "madpp.tracker_step.default", "madpp.kalman_step.default", "madpp.tagging_step.default"
    }
    inputs, state = _stream(), pt.initial_state(CFG, device="cpu")
    got = ex.deserialize_runner(data, CFG, FRAMES, device="cpu")(state, inputs)
    _assert_bit_equal(got, ex.deserialize_runner(artifacts(1), CFG, FRAMES)(state, inputs))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ex.deserialize_runner(data, CFG, FRAMES)


def test_artifact_for_the_card_made_without_one():
    """tests/test_utils.py's cross-host case: an artifact for the card made
    on a host without one is a real program (over 10 kB), and so is one
    with the lanes spread over 4 ranks (each rank's program has one lane
    of the 4) made with no process group."""
    data = ex.export_sequence_runner(CFG, 4, platforms=("cuda", "cpu"))
    assert isinstance(data, (bytes, bytearray)) and len(data) > 10_000
    sharded = ex.export_sequence_runner(CFG, 4, platforms=("cuda", "cpu"), batch=4, dp=4)
    program, meta = ex.load_program(sharded)
    assert (meta["batch"], meta["dp"], meta["platforms"]) == (4, 4, ["cuda", "cpu"])
    first = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name.startswith("leaves"))
    assert first.meta["val"].shape[0] == 1  # one lane a rank


def _frames_op_args(op_inputs, lanes):
    """`op_inputs`' tagging arguments with a lane row and a feature row."""
    args = op_inputs(lanes)["tagging_step"]
    lead = () if lanes is None else (lanes,)
    rng = np.random.default_rng(3)
    lane_row = torch.as_tensor(np.concatenate([rng.normal(size=lead + (6,)), rng.integers(0, 2, lead + (2,))], -1),
                               dtype=torch.float32)
    feat_row = torch.as_tensor(np.abs(rng.normal(size=lead + (6,))) * [0.1, 8, 200, 0.2, 120, 300], dtype=torch.float32)
    return (*args, lane_row, feat_row)


@pytest.mark.parametrize("lanes", [None, 3])
def test_frames_mode_tagging_op_passes_opcheck(op_inputs, lanes):
    """`torch.library.opcheck` on ``madpp.tagging_step`` with its two
    frames-mode rows."""
    torch.library.opcheck(torch.ops.madpp.tagging_step.default, _frames_op_args(op_inputs, lanes))


def test_frames_mode_op_route_equals_the_dispatcher(op_inputs):
    """Frames-mode tagging through the op (the rows rebuilt into the
    observation and features the plain version reads) against the plain
    route on the original observation and features, bit for bit."""
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.rules import frames_from_rows

    cfg = CFG.replace(tracker=dataclasses.replace(CFG.tracker, max_tracks=16))
    a = _frames_op_args(op_inputs, None)
    dets, table, state = Detections(*a[:4]), TrackTable(*a[4:16]), TaggingState(*a[17:25])
    lane_obs, feats = frames_from_rows(a[27], a[28])
    feats = {**feats, "num_long_lines": feats["num_long_lines"].round().to(torch.int32)}
    got = library.make_packed_tagging_step(cfg)(state, dets, table, a[16], lane_obs, feats)
    want = make_packed_tagging_step(cfg)(state, dets, table, a[16], lane_obs, feats)
    _assert_bit_equal(got, want)
    _, tag_f, tag_i = library.make_packed_tagging_step(cfg)(state, dets, table, a[16])  # detections mode
    assert not (torch.equal(tag_f, got[1]) and torch.equal(tag_i, got[2]))


def _spiral_image(size=96, width=4):
    """A square spiral corridor of weak contrast (60) from a strong block
    (200) at its outer end: hysteresis grows along its walls a pixel a
    round, for hundreds of rounds."""
    img = np.zeros((size, size), np.int32)
    lo, hi = 6, size - 6
    while hi - lo > 2 * width + 4:
        img[lo : lo + width, lo:hi] = 60
        img[lo:hi, hi - width : hi] = 60
        img[hi - width : hi, lo + 2 * width : hi] = 60
        img[lo + 2 * width : hi, lo + 2 * width : lo + 3 * width] = 60
        lo, hi = lo + 2 * width, hi - 2 * width
    img[6 : 6 + width, 6:14] = 200
    return img


class _CannyRounds(torch.nn.Module):
    """`canny_rounds` as a module to export: the thresholds are inputs."""

    def __init__(self, iters):
        super().__init__()
        self.iters = iters

    def forward(self, gray, low, high):
        return it.canny_rounds(gray, low, high, self.iters)


@pytest.mark.parametrize("iters", [64, 1000])
@pytest.mark.parametrize("image", ["road", "spiral"])
def test_traced_hysteresis_equals_canny_rounds(image, iters):
    """`canny_rounds` exported (its blocks under a while_loop,
    `hysteresis_traced`) against its eager blocks: the same map and the
    same rounds and reads, on the lane step's two Canny passes over road
    frames and on a spiral that runs to the cap of 64 rounds and, with a
    cap of 1,000, to its fixpoint far past it."""
    from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import SyntheticRoadGenerator

    if image == "spiral":
        cases = [(torch.as_tensor(_spiral_image()), 100.0, 400.0)]
    else:
        cases = []
        for frame in SyntheticRoadGenerator(width=FRAMES_W, height=FRAMES_H).generate_frames(3):
            gray = it.bgr_to_gray_u8(torch.as_tensor(frame))
            blurred = it.gaussian_blur5_u8(gray)
            med = it.median_u8(blurred)
            low = torch.floor(torch.clamp(torch.tensor(0.7) * med, min=0.0))
            high = torch.floor(torch.clamp(torch.tensor(1.3) * med, max=255.0))
            cases += [(blurred, low, high), (it.downsample2_u8(gray), 50.0, 150.0)]
    exported, rounds = {}, []
    for gray, low, high in cases:
        args = (gray, torch.as_tensor(low, dtype=torch.float32), torch.as_tensor(high, dtype=torch.float32))
        if gray.shape not in exported:
            program = torch.export.export(_CannyRounds(iters), args, strict=False)
            assert sum("while_loop" in str(n.target) for n in program.graph.nodes if n.op == "call_function") == 1
            exported[gray.shape] = program.module()
        want, want_rounds, want_reads = it.canny_rounds(gray, low, high, iters)
        got, got_rounds, got_reads = exported[gray.shape](*args)
        assert torch.equal(got, want)
        assert (int(got_rounds), int(got_reads)) == (want_rounds, want_reads)
        rounds.append(want_rounds)
    if image == "spiral":
        assert rounds[0] == 64 if iters == 64 else 64 < rounds[0] < 1000
