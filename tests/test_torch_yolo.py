"""The port's YOLOv8 and YOLO runner against the JAX package's.

Weights come from one Flax ``YOLOv8(variant="n").init`` and are carried to
the port with `yolo_state_from_flax`.  The network runs in float32 here at
64-160 px.  Tolerances, with the measured maxima on this machine's CPU:

- every ``stop_after`` prefix and the head: atol 1e-5 (measured 2.4e-7 at
  b0, whose activations reach 1.26; the init's activations shrink about
  tenfold a stage, to head logits up to 3.7e-4, held to 4.2e-10);
- the YOLO runner: track ids, matches, counters and discrete tags exact.
  Floats: see `test_runner_matches_jax`.

Flax's initializers leave every score within 7e-5 of 0.5, where 1-ulp
ties decide the order of candidates, so the runner test calibrates the
BatchNorm statistics on its own frames first (unit-variance activations,
as in a trained network): logits of order 1, scores spread over 0.6-0.99.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import multimodal_autonomous_driving_perception_and_planning_torch as pt
import multimodal_autonomous_driving_perception_and_planning_tpu as pj
from multimodal_autonomous_driving_perception_and_planning_torch.models import yolov8 as yt
from multimodal_autonomous_driving_perception_and_planning_torch.perception.detector import (
    make_yolo_sequence_runner,
)
from multimodal_autonomous_driving_perception_and_planning_torch.utils.convert import yolo_state_from_flax
from multimodal_autonomous_driving_perception_and_planning_tpu.data.synthetic import ego_motion_stream
from multimodal_autonomous_driving_perception_and_planning_tpu.models import yolov8 as yj
from multimodal_autonomous_driving_perception_and_planning_tpu.perception import detector as dj

PREFIX_ATOL = 1e-5
IMG = 160  # the runner test's letterbox size (test_yolo_nms.py:218-256)
SCORE_T, IOU_T = 0.05, 0.45
MARGIN = 1e-4  # every threshold decision of the JAX run stands this far off
# The runner's floats against JAX's runner: the conv tower's float32
# rounding (head logits 1e-4 apart in the calibrated network) moves boxes by
# up to 0.015 px at the 4x letterbox scale, velocities by 4e-3 px a frame
# and TTC by 0.2%.  The runner's floats are also held to JAX's
# detections-mode runner on the port's own tables at the PARITY.md budget.
YOLO_ATOL, YOLO_RTOL = 0.05, 5e-3
ATOL = 1e-4
TTC_RTOL = 1e-5
DISCRETE = ("track_id", "track_class_id", "track_hits", "track_misses", "track_age",
            "track_vel_count", "confirmed_order", "num_confirmed", "match", "plan_best")
FLOAT = ("track_bbox", "track_confidence", "track_velocity", "plan_costs",
         "plan_best_positions", "plan_best_velocities")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the same
    cores, and torch's default of one thread a core each made these convs
    wait on one another (50 s a test instead of 0.3)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def flax_vars():
    model = yj.YOLOv8(variant="n", dtype=jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return jax.tree_util.tree_map(np.asarray, variables)


def _port_model(state, **kw):
    model = yt.YOLOv8(variant="n", **kw)
    model.load_state_dict(state, strict=True)
    return model.eval()


def _nchw(x):
    return torch.tensor(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_parameter_count_and_strict_load(flax_vars):
    state = yolo_state_from_flax(flax_vars)
    model = _port_model(state)
    n_port = sum(p.numel() for p in model.parameters())
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(flax_vars["params"]))
    assert n_port == n_jax == 3_157_184
    assert 2.8e6 < n_port < 3.5e6  # test_yolo_nms.py:91
    assert set(state) == set(model.state_dict())


@pytest.fixture(scope="module")
def jax_intermediates(flax_vars):
    """Two seeded 64x64 inputs through the JAX model, every block's
    activation captured, and the head outputs."""
    x = np.random.default_rng(0).random((2, 64, 64, 3), np.float32)
    model = yj.YOLOv8(variant="n", dtype=jnp.float32)
    head, inter = jax.jit(lambda v, x: model.apply(v, x, capture_intermediates=True))(flax_vars, jnp.asarray(x))
    return x, inter["intermediates"], head


@pytest.mark.parametrize("stop", ["b0", "b2", "b4", "b6", "b9", "neck", "head"])
def test_prefix_matches_jax(flax_vars, jax_intermediates, stop):
    x, inter, head = jax_intermediates
    model = _port_model(yolo_state_from_flax(flax_vars), stop_after="" if stop == "head" else stop)
    with torch.no_grad():
        got = model(_nchw(x))
    if stop == "neck":
        pairs = [(got[0], inter["n15"]["__call__"][0]), (got[1], inter["n18"]["__call__"][0]),
                 (got[2], inter["n21"]["__call__"][0])]
    elif stop == "head":
        pairs = [(g, w) for gs, ws in zip(got, head) for g, w in zip(gs, ws)]
        assert all(g.dtype == torch.float32 for g, _ in pairs)
    else:
        pairs = [(got, inter[stop]["__call__"][0])]
    for g, w in pairs:
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=0, atol=PREFIX_ATOL, err_msg=stop)


def test_decode_matches_jax(jax_intermediates):
    """The JAX head outputs through both decodes, and the zero-logit anchor
    geometry (test_yolo_nms.py:103-109)."""
    _, _, head = jax_intermediates
    ports = [(_nchw(b), _nchw(c)) for b, c in head]
    for sigmoid in (True, False):
        jb, jc = yj.decode_predictions(head, 64, apply_sigmoid=sigmoid)
        tb, tc = yt.decode_predictions(ports, 64, apply_sigmoid=sigmoid)
        assert tb.shape == (2, 84, 4) and tc.shape == (2, 84, 80)
        # The DFL softmax and its expectation (about 7.5 bins) round
        # differently in the two libraries, times the stride (up to 32):
        # measured 6.1e-5 on boxes that reach 64 px.
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-7)
    zero = [(torch.zeros_like(b), c) for b, c in ports]
    zb, _ = yt.decode_predictions(zero, 64)
    np.testing.assert_allclose(zb[0, 0].numpy(), [(0.5 - 7.5) * 8, (0.5 - 7.5) * 8, 64.0, 64.0], atol=1e-3)
    assert (zb[..., 2] >= zb[..., 0]).all() and (zb[..., 3] >= zb[..., 1]).all()


@pytest.mark.parametrize("size,atol", [(640, 0.0), (160, 1e-4)])
def test_letterbox_matches_jax(size, atol):
    """Exact at 640 (the identity resize), within 1e-4 at 160, where both
    antialias the bilinear downscale."""
    img = np.random.default_rng(3).integers(0, 255, (480, 640, 3)).astype(np.float32)
    got, scale, pad = yt.letterbox(img, size)
    want, w_scale, w_pad = yj.letterbox(jnp.asarray(img), size)
    assert (scale, pad) == (w_scale, w_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
    batch, _, _ = yt.letterbox(np.stack([img, img]), size)
    np.testing.assert_array_equal(batch[1].numpy(), got.numpy())
    if size == 640:
        assert pad == (0, 80) and float(got[0, 0, 0]) == 114.0


def _ultralytics_key(port_key: str) -> str:
    """The inverse of the importer's rename: b2.m0.cv1.conv.weight ->
    model.2.m.0.cv1.conv.weight, head.cv2_0_2.weight -> model.22.cv2.0.2.weight."""
    layers = {v: k for k, v in yt._ULTRA_LAYER_TO_PORT.items()}
    block, *rest = port_key.split(".")
    if block == "head":
        tower = rest[0].split("_")
        rest = tower + rest[1:]
    rest = [f"m.{p[1:]}" if p[0] == "m" and p[1:].isdigit() else p for p in rest]
    return ".".join(["model", str(layers[block])] + rest)


def test_ultralytics_importer_matches_jax(flax_vars):
    """One random ultralytics-layout state dict (with the DFL conv and
    BatchNorm counters the importers drop) through both importers: the
    same network, bit for bit."""
    rng = np.random.default_rng(4)
    shapes = {k: v.shape for k, v in yolo_state_from_flax(flax_vars).items()}
    sd = {_ultralytics_key(k): rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    sd["model.22.dfl.conv.weight"] = np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)
    sd["model.0.bn.num_batches_tracked"] = np.int64(7)
    got = yt.load_torch_state_dict(sd, variant="n")
    want = yolo_state_from_flax(jax.tree_util.tree_map(np.asarray, yj.load_torch_state_dict(sd, variant="n")))
    assert set(got) == set(want) == set(shapes)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _port_model(got)
    torch_sd = {k: torch.tensor(v) for k, v in sd.items()}
    assert set(yt.load_torch_state_dict(torch_sd)) == set(got)
    with pytest.raises(ValueError, match="yolov8n"):
        yt.load_torch_state_dict(sd, variant="s")


def test_infer_variant_from_state_dict():
    for variant, (_, width, _) in yt.YOLOV8_VARIANTS.items():
        sd = {"model.0.conv.weight": np.zeros((yt._make_divisible(64 * width), 3, 3, 3), np.float32)}
        assert yt.infer_variant_from_state_dict(sd) == yj.infer_variant_from_state_dict(sd) == variant
    assert yt.infer_variant_from_state_dict({"0.conv.weight": torch.zeros(48, 3, 3, 3)}) == "m"
    with pytest.raises(ValueError, match="not a known"):
        yt.infer_variant_from_state_dict({"model.0.conv.weight": np.zeros((24, 3, 3, 3))})
    with pytest.raises(ValueError, match="no stem conv"):
        yt.infer_variant_from_state_dict({})


def test_init_fn_mirrors_flax_initializers(flax_vars):
    """The same tensors as Flax's init, drawn from the same distributions:
    truncated normal kernels at variance 1 / fan_in, zero biases, unit BN."""
    init_fn, _ = yt.make_yolo_detector(device="cpu")
    got = init_fn(torch.Generator().manual_seed(0))
    want = yolo_state_from_flax(flax_vars)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k, w in want.items():
        g = got[k]
        if g.dim() == 4:
            fan_in = g[0].numel()
            std = np.sqrt(1.0 / fan_in)
            bound = 2 * std / 0.87962566103423978
            assert float(g.abs().max()) <= bound * (1 + 1e-6) and float(torch.as_tensor(w).abs().max()) <= bound * (1 + 1e-6)
            if g.numel() >= 4096:
                assert abs(float(g.std()) / std - 1) < 0.05, k
                assert abs(float(torch.as_tensor(w).std()) / std - 1) < 0.05, k
        else:
            assert torch.equal(g, w), k
    again = init_fn(torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_detector_end_to_end():
    """test_yolo_nms.py:122 in the port: bf16 at 640, the default
    thresholds and taxonomy mapping, one frame and a batch."""
    init_fn, detect_fn = yt.make_yolo_detector(max_det=16, device="cpu")
    params = init_fn(torch.Generator().manual_seed(0))
    out = detect_fn(params, np.zeros((480, 640, 3), np.int32))
    assert out["bbox"].shape == (16, 4) and out["valid"].dtype == torch.bool
    cls = out["class_id"][out["valid"]]
    assert ((cls >= 0) & (cls < 8)).all()
    frames = np.random.default_rng(0).integers(0, 255, (2, 480, 640, 3)).astype(np.uint8)
    tables, cands = detect_fn(params, frames, return_candidates=True)
    assert tables["class_id"].shape == (2, 16) and tables["class_id"].dtype == torch.int32
    assert cands["boxes"].shape == (2, 8400, 4) and cands["scores"].dtype == torch.float32


def test_frontend_pads_the_last_chunk():
    """make_yolo_frontend over 3 frames in chunks of 2: the last chunk is
    padded with a zero frame, as the JAX package pads it, and each frame's
    table is the detector's on its chunk."""
    from multimodal_autonomous_driving_perception_and_planning_torch.perception.detector import make_yolo_frontend

    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False)
    init_fn, stream_fn = make_yolo_frontend(cfg, batch=2, img_size=IMG, device="cpu")
    _, detect_fn = yt.make_yolo_detector(max_det=cfg.detector.max_detections, img_size=IMG, device="cpu")
    params = init_fn(torch.Generator().manual_seed(1))
    frames = np.random.default_rng(2).integers(0, 255, (3, 480, 640, 3)).astype(np.uint8)
    stream = stream_fn(params, frames)
    chunks = [frames[:2], np.concatenate([frames[2:], np.zeros_like(frames[:1])])]
    want = [detect_fn(params, c) for c in chunks]
    for k, v in stream.items():
        assert v.shape[0] == 3, k
        assert torch.equal(v, torch.cat([w[k] for w in want])[:3]), k


def test_bf16_cpu_run_within_chip_smoke_bound():
    """bf16 against float32 on the head logits, each scale's largest gap
    over its largest logit: the bound chip_smoke.py holds the card to."""
    init_fn, _ = yt.make_yolo_detector(device="cpu")
    params = init_fn(torch.Generator().manual_seed(0))
    frames = torch.tensor(np.random.default_rng(0).integers(0, 255, (2, 480, 640, 3)).astype(np.uint8))
    x, _, _ = yt.preprocess(frames, IMG)
    f32, bf16 = _port_model(params), _port_model(params, dtype=torch.bfloat16)
    with torch.no_grad():
        gaps = chip_smoke.relative_gaps(bf16(x), f32(x))
    assert 0 < max(gaps) <= chip_smoke.BF16_LOGIT_REL, gaps


def test_yolo_runner_refuses_without_card_and_frames_mode(monkeypatch):
    """Frames mode builds (lanes from the same frames), at any Hough theta
    grid (60 thetas); a run without a card is refused."""
    cfg = pt.DEFAULT_CONFIG.replace(use_frames=False)
    make_yolo_sequence_runner(pt.DEFAULT_CONFIG, device="cpu")
    odd = pt.DEFAULT_CONFIG.replace(lanes=dataclasses.replace(pt.DEFAULT_CONFIG.lanes, num_thetas=60))
    make_yolo_sequence_runner(odd, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_yolo_sequence_runner(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yt.make_yolo_detector()


# ---------------------------------------------------------------------------
# The runner, against JAX's
# ---------------------------------------------------------------------------


def _calibrate(model, x):
    """Set every BatchNorm's running statistics to its input's per-channel
    mean and variance over ``x``, in forward order."""

    def hook(mod, args):
        (a,) = args
        mod.running_mean.copy_(a.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(a.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, yt.BatchNorm)]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()


@pytest.fixture(scope="module")
def runner_case(flax_vars):
    """Six seeded 480x640 frames as test_yolo_nms.py:227-231 makes them, the
    calibrated weights in both packages, and JAX's candidates and tables
    per frame.  Seed 3 is the first of seeds 1-8 whose JAX run leaves every
    decision clear of the margins (`_margin_faults`); all eight gave equal
    track ids, but the others hold near-calls such as two survivors 1e-5
    apart with the packages' scores 1e-5 apart."""
    frames = np.random.default_rng(3).integers(0, 255, (6, 480, 640, 3)).astype(np.float32)
    ego = ego_motion_stream(6, seed=0).astype(np.float32)
    model = _port_model(yolo_state_from_flax(flax_vars))
    _calibrate(model, yt.preprocess(torch.tensor(frames), IMG)[0])
    state = model.state_dict()
    flax_cal = jax.tree_util.tree_map(np.asarray, flax_vars)

    def put(tree, path):
        for name, value in tree.items():
            if isinstance(value, dict):
                put(value, path + [name])
            else:
                tree[name] = state[".".join(path + ["running_" + name])].numpy()

    put(flax_cal["batch_stats"], [])

    jmodel = yj.YOLOv8(variant="n", dtype=jnp.float32)
    _, detect = yj.make_yolo_detector(max_det=16, score_threshold=SCORE_T, iou_threshold=IOU_T,
                                      compute_dtype=jnp.float32, map_to_taxonomy=False, img_size=IMG)

    def one(v, frame):
        padded, _, _ = yj.letterbox(frame[..., ::-1].astype(jnp.float32), IMG)
        boxes, logits = yj.decode_predictions(jmodel.apply(v, (padded / 255.0)[None]), IMG, apply_sigmoid=False)
        cands = (boxes[0], jax.nn.sigmoid(jnp.max(logits[0], -1)), jnp.argmax(logits[0], -1).astype(jnp.int32))
        return cands, detect(v, frame)

    cands, tables = jax.jit(jax.vmap(one, in_axes=(None, 0)))(flax_cal, jnp.asarray(frames))
    return dict(frames=frames, ego=ego, state=state, flax=flax_cal,
                cands=tuple(np.asarray(c) for c in cands),
                tables={k: np.asarray(v) for k, v in tables.items()})


def _pairwise_iou(a, b):
    """IoU of every pair, in float64 (for margins only)."""
    a, b = a[:, None].astype(np.float64), b[None].astype(np.float64)
    iw = np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0])
    ih = np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1])
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    union = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
             + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]) - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def _order_margin(gap, eps):
    return eps == 0 or gap > 2 * eps


def _track_ious(outs, tables, f):
    """The tracker's IoU matrix at frame f: the table after frame f - 1
    against frame f's detections (live pairs only)."""
    alive = np.asarray(outs["track_id"])[f - 1] > 0
    valid = np.asarray(tables["valid"])[f]
    return _pairwise_iou(np.asarray(outs["track_bbox"])[f - 1][alive], np.asarray(tables["bbox"])[f][valid])


def _margin_faults(case, port, outs_j, outs_t, cfg):
    """Every decision of the JAX run that the float gap between the two
    packages could turn, with its reason, or [] if all stand clear.

    ``eps`` is the largest gap between the port's candidate scores and
    JAX's.  An order between two scores stands clear when they differ by
    more than 2 eps; a threshold decision when it stands MARGIN off.  Only
    decisions that can reach the detection table count: a candidate's keep
    depends only on higher-scored ones, so those scored below the 17th
    survivor (less 2 eps) decide nothing in the 16-slot table.  The
    tracker's decisions: IoU against its threshold, and the order of live
    entries that share a row or a column, against twice the largest IoU gap
    between the two runs.
    """
    boxes, scores, classes = case["cands"]
    eps = float(np.abs(port["scores"] - scores).max())
    faults = [] if eps <= MARGIN else [f"candidate scores differ by {eps}"]
    thr_gap = float(np.abs(scores - SCORE_T).min())
    if thr_gap <= MARGIN:
        faults.append(f"a score stands {thr_gap} from the threshold {SCORE_T}")
    k, slots = 256, 16  # make_yolo_detector's pre_topk, the table's capacity
    for f in range(len(scores)):
        order = np.argsort(-scores[f], kind="stable")
        s = scores[f][order]
        pool = order[:k]
        iou = _pairwise_iou(*(2 * [boxes[f][pool] + classes[f][pool, None].astype(np.float64) * 7680.0]))
        keep = np.zeros(k, bool)
        for j in range(k):
            keep[j] = s[j] > 0 and not (keep[:j] & (iou[:j, j] > IOU_T)).any()
        survivors = np.flatnonzero(keep)[: slots + 1]
        floor = s[survivors[-1]] - 2 * eps if len(survivors) > slots else -np.inf
        if len(order) > k and s[k] >= floor and not _order_margin(s[k - 1] - s[k], eps):
            faults.append(f"frame {f}: the pool's cut at {k} stands {s[k - 1] - s[k]} apart")
        r = int((s[:k] >= floor).sum())  # the candidates that decide the table
        upper = np.triu(np.ones((r, r), bool), 1)
        near = upper & (np.abs(iou[:r, :r] - IOU_T) <= MARGIN)
        if near.any():
            faults.append(f"frame {f}: {int(near.sum())} IoUs within {MARGIN} of {IOU_T}")
        for i, j in zip(*np.nonzero(upper & (iou[:r, :r] > IOU_T))):
            if not _order_margin(s[i] - s[j], eps):
                faults.append(f"frame {f}: the suppressing pair ({i}, {j}) stands {s[i] - s[j]} apart")
        for a, b in zip(survivors[:-1], survivors[1:]):
            if not _order_margin(s[a] - s[b], eps):
                faults.append(f"frame {f}: survivors {a} and {b} stand {s[a] - s[b]} apart")
    thr = cfg.tracker.iou_threshold
    pairs = [(_track_ious(outs_j, case["tables"], f), _track_ious(outs_t, port["tables"], f))
             for f in range(1, len(scores))]
    eps_iou = max((float(np.abs(a - b).max()) for a, b in pairs if a.size and a.shape == b.shape), default=0.0)
    if eps_iou > MARGIN / 2:
        faults.append(f"track IoUs differ by {eps_iou}")
    for f, (iou, _) in enumerate(pairs, start=1):
        if (np.abs(iou - thr) <= MARGIN).any():
            faults.append(f"frame {f}: a track IoU within {MARGIN} of {thr}")
        for line in list(iou) + list(iou.T):
            v = np.sort(line[line >= thr - MARGIN])
            if (np.diff(v) <= 2 * eps_iou).any():
                faults.append(f"frame {f}: competing track IoUs within {2 * eps_iou}")
    return faults


def _assert_close(name, got, want, atol, rtol):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("tagging", [False, True], ids=["tagging_off", "tagging_on"])
def test_runner_matches_jax(runner_case, tagging):
    """make_yolo_sequence_runner with test_yolo_nms.py:218-256's arguments
    in both packages: discrete outputs and tags exact, once the margins of
    every decision stand clear; floats at the YOLO tolerance, and at the
    PARITY.md budget against JAX's detections-mode runner on the port's
    own tables."""
    case = runner_case
    kw = dict(batch=4, score_threshold=SCORE_T, map_to_taxonomy=False, img_size=IMG)
    cfg_j = pj.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=tagging)
    cfg_t = pt.DEFAULT_CONFIG.replace(use_frames=False, enable_tagging=tagging)
    _, run_j = dj.make_yolo_sequence_runner(cfg_j, compute_dtype=jnp.float32, **kw)
    _, outs_j = run_j(case["flax"], pj.initial_state(cfg_j), jnp.asarray(case["frames"]), jnp.asarray(case["ego"]))
    _, run_t = make_yolo_sequence_runner(cfg_t, compute_dtype=torch.float32, device="cpu", **kw)
    _, outs_t = run_t(case["state"], pt.initial_state(cfg_t, device="cpu"), case["frames"], case["ego"],
                      keep_candidates=True)
    tables = outs_t.pop("detections")
    cands = outs_t.pop("candidates")
    assert set(outs_t) == set(outs_j)
    assert tables["valid"].any(), "the calibrated network must detect"
    assert len(np.unique(np.asarray(outs_j["track_id"]))) > 10, "tracks must be born"

    port = {"scores": cands["scores"].numpy(), "tables": {k: v.numpy() for k, v in tables.items()}}
    faults = _margin_faults(case, port, outs_j, outs_t, cfg_t)
    assert not faults, "a float gap may turn these decisions:\n" + "\n".join(faults[:20])

    for k in ("valid", "class_id"):
        np.testing.assert_array_equal(tables[k].numpy(), case["tables"][k], err_msg=k)
    for k in DISCRETE:
        got, want = outs_t[k].numpy(), np.asarray(outs_j[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in FLOAT:
        _assert_close(k, outs_t[k].numpy(), np.asarray(outs_j[k]), YOLO_ATOL, YOLO_RTOL)
    assert set(outs_t["tags"]) == set(outs_j["tags"])
    for k, want in outs_j["tags"].items():
        got, want = outs_t["tags"][k].numpy(), np.asarray(want)
        if np.issubdtype(want.dtype, np.floating):
            _assert_close(f"tags.{k}", got, want, YOLO_ATOL, YOLO_RTOL)
        else:
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=f"tags.{k}")

    # The pipeline alone, on the port's own tables: the PARITY.md budget.
    inputs = {k: jnp.asarray(v.numpy()) for k, v in tables.items()}
    inputs["ego_measurement"] = jnp.asarray(case["ego"])
    _, ref = pj.make_sequence_runner(cfg_j, donate=False)(pj.initial_state(cfg_j), inputs)
    for k in DISCRETE:
        np.testing.assert_array_equal(outs_t[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in FLOAT:
        _assert_close(k, outs_t[k].numpy(), np.asarray(ref[k]), ATOL, 0.0)
    for f in dataclasses.fields(outs_t["vehicle_state"]):
        _assert_close(f.name, getattr(outs_t["vehicle_state"], f.name).numpy(),
                      np.asarray(getattr(ref["vehicle_state"], f.name)), ATOL, 0.0)
    for k, want in ref["tags"].items():
        want = np.asarray(want)
        if np.issubdtype(want.dtype, np.floating):
            rtol = TTC_RTOL if k in ("track_ttc", "min_ttc") else 0.0
            _assert_close(f"tags.{k}", outs_t["tags"][k].numpy(), want, ATOL, rtol)


@pytest.mark.parametrize("caller", [(True, True), (False, True), (True, False)], ids=["both", "cudnn", "matmul"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_float32_tower_turns_tf32_off_inside_its_forward_only(dtype, caller):
    """The tower's float32 forward runs with TF32 off for matmuls and cuDNN
    convolutions (torch's default lets cuDNN's float32 convolutions run in
    TF32; float32 is the parity dtype), read inside by a hook on the first
    and the last conv; the caller's flags come back after it; bf16 leaves
    them as the caller set them."""
    seen = []

    def hook(module, inputs, out):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))

    model = yt.YOLOv8(variant="n", dtype=dtype)
    model.b0.register_forward_hook(hook)
    model.head.register_forward_hook(hook)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = caller
        with torch.inference_mode():
            model(torch.zeros(1, 3, 64, 64))
        after = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert seen == [(False, False)] * 2 if dtype == torch.float32 else seen == [caller] * 2
    assert after == caller
