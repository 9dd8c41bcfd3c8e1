"""Synthetic parity fixtures, and simulated detections made on the device.

Host-side generators that are bit-exact with the reference's seeded numpy
semantics (src/perception/detector.py:125-169,
data/loaders/video_loader.py:166-205).  They draw from a private
``np.random.RandomState`` in place of numpy's global generator:
``RandomState(seed)`` starts the same MT19937 stream as
``np.random.seed(seed)``, so the draws are the same, and the generators are
safe to call from several threads.  `device_detection_stream` makes its
tables on the device from ``torch.Generator`` draws instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

# Class-sampling weights from detector.py:159-160.
CLASS_WEIGHTS = (0.6, 0.15, 0.1, 0.05, 0.03, 0.05, 0.01, 0.01)

CLASS_NAMES = (
    "car",
    "truck",
    "pedestrian",
    "cyclist",
    "motorcycle",
    "bus",
    "traffic_light",
    "stop_sign",
)  # detector.py:39-48


def simulated_detections_for_frame(
    frame_count: int, height: int = 480, width: int = 640
):
    """Detections for one frame, bit-exact with ObjectDetector._detect_simulated.

    ``frame_count`` is the reference's post-increment counter, i.e. 1 for the
    first frame (detector.py:96); the reference reseeds with
    ``frame_count % 1000`` every frame.  Returns (boxes (n,4), class_ids (n,),
    confidences (n,)).
    """
    rs = np.random.RandomState(frame_count % 1000)
    num_vehicles = rs.randint(3, 8)
    boxes, classes, confs = [], [], []
    for i in range(num_vehicles):
        distance_factor = rs.uniform(0.3, 1.0)
        base_w = int(80 * distance_factor + 40)
        base_h = int(60 * distance_factor + 30)
        t = frame_count * 0.02
        x_base = (i * 150 + int(50 * np.sin(t + i))) % (width - base_w)
        y_base = int(height * 0.4 + (height * 0.4 * distance_factor))
        x1 = max(0, x_base + rs.randint(-10, 10))
        y1 = max(0, y_base + rs.randint(-5, 5))
        x2 = min(width, x1 + base_w)
        y2 = min(height, y1 + base_h)
        class_id = rs.choice(len(CLASS_WEIGHTS), p=np.asarray(CLASS_WEIGHTS))
        conf = rs.uniform(0.75, 0.98)
        boxes.append((x1, y1, x2, y2))
        classes.append(int(class_id))
        confs.append(float(conf))
    return (
        np.asarray(boxes, np.float32),
        np.asarray(classes, np.int32),
        np.asarray(confs, np.float32),
    )


def simulated_detection_stream(
    num_frames: int,
    height: int = 480,
    width: int = 640,
    capacity: int = 16,
    start_frame_count: int = 1,
):
    """Padded (F, D, ...) detection tables for a frame sequence.

    Returns a dict of numpy arrays: bbox (F, D, 4), class_id (F, D),
    confidence (F, D), valid (F, D).
    """
    bbox = np.zeros((num_frames, capacity, 4), np.float32)
    cls = np.zeros((num_frames, capacity), np.int32)
    conf = np.zeros((num_frames, capacity), np.float32)
    valid = np.zeros((num_frames, capacity), bool)
    for f in range(num_frames):
        b, c, cf = simulated_detections_for_frame(start_frame_count + f, height, width)
        n = min(len(b), capacity)
        bbox[f, :n] = b[:n]
        cls[f, :n] = c[:n]
        conf[f, :n] = cf[:n]
        valid[f, :n] = True
    return {"bbox": bbox, "class_id": cls, "confidence": conf, "valid": valid}


def ego_motion_stream(
    num_frames: int, dt: float = 1.0 / 30.0, seed: int | None = 0
) -> np.ndarray:
    """(F, 4) [x, y, vx, vy] measurements, matching
    VideoDataLoader.generate_ego_motion (video_loader.py:166-205):
    constant 10 m/s, heading 0.05 sin(0.5 t), gaussian noise
    sigma = (0.1, 0.1, 0.05, 0.05).  ``seed=None`` draws from fresh entropy."""
    rs = np.random.RandomState(seed)
    out = np.zeros((num_frames, 4), np.float64)
    x = y = 0.0
    speed = 10.0
    for i in range(num_frames):
        t = i * dt
        heading = 0.05 * np.sin(t * 0.5)
        vx = speed * np.cos(heading)
        vy = speed * np.sin(heading)
        x += vx * dt
        y += vy * dt
        out[i] = (
            x + rs.normal(0, 0.1),
            y + rs.normal(0, 0.1),
            vx + rs.normal(0, 0.05),
            vy + rs.normal(0, 0.05),
        )
    return out


class IncrementalEgoMotion:
    """Stateful `ego_motion_stream` producing successive rows in O(n) per
    call: bit-identical to slicing one monolithic stream, without
    regenerating it from frame 0 for every chunk."""

    def __init__(self, dt: float = 1.0 / 30.0, seed: int = 0):
        self.dt = dt
        self._i = 0
        self._x = 0.0
        self._y = 0.0
        self._rs = np.random.RandomState(seed)

    def take(self, num_frames: int) -> np.ndarray:
        out = np.zeros((num_frames, 4), np.float64)
        speed = 10.0
        for j in range(num_frames):
            t = self._i * self.dt
            heading = 0.05 * np.sin(t * 0.5)
            vx = speed * np.cos(heading)
            vy = speed * np.sin(heading)
            self._x += vx * self.dt
            self._y += vy * self.dt
            out[j] = (
                self._x + self._rs.normal(0, 0.1),
                self._y + self._rs.normal(0, 0.1),
                vx + self._rs.normal(0, 0.05),
                vy + self._rs.normal(0, 0.05),
            )
            self._i += 1
        return out


def simulated_vehicle_motion_stream(num_frames: int, dt: float = 0.033, seed: int | None = 0):
    """(measurements, ground_truth) per SimulatedVehicleMotion
    (vehicle_state.py:260-330): speed 10 + 3 sin(0.2 t), heading
    0.1 sin(0.3 t) + 0.05 sin(0.7 t), noise sigma (0.5, 0.5, 0.2, 0.2).
    ``seed=None`` draws from numpy's global generator, as the reference
    does without a seed."""
    rs = np.random.RandomState(seed) if seed is not None else np.random.mtrand._rand
    meas = np.zeros((num_frames, 4), np.float64)
    truth = np.zeros((num_frames, 4), np.float64)
    x = y = 0.0
    time = 0.0
    for i in range(num_frames):
        time += dt
        speed = 10 + 3 * np.sin(time * 0.2)
        heading = 0.1 * np.sin(time * 0.3) + 0.05 * np.sin(time * 0.7)
        vx = speed * np.cos(heading)
        vy = speed * np.sin(heading)
        x += vx * dt
        y += vy * dt
        truth[i] = (x, y, vx, vy)
        meas[i] = (
            x + rs.normal(0, 0.5),
            y + rs.normal(0, 0.5),
            vx + rs.normal(0, 0.2),
            vy + rs.normal(0, 0.2),
        )
    return meas, truth


def generate_agent_trajectories(num_agents: int, num_steps: int, dt: float = 1.0 / 30.0, seed: int | None = 0):
    """Random-walk agent trajectories, matching
    SyntheticDataGenerator.generate_agent_trajectories: per agent, start
    x~U(-20,20), y~U(10,40), heading~U(-0.3,0.3), speed~U(5,15); each step
    heading += N(0,0.02), speed += N(0,0.1) clipped to [3,20], then
    Euler-integrate.  ``seed=None`` draws from numpy's global generator.

    Returns dict mapping agent_id -> list of (x, y, vx, vy) tuples.
    """
    rs = np.random.RandomState(seed) if seed is not None else np.random.mtrand._rand
    trajectories = {}
    for agent_id in range(num_agents):
        x = rs.uniform(-20, 20)
        y = rs.uniform(10, 40)
        heading = rs.uniform(-0.3, 0.3)
        speed = rs.uniform(5, 15)
        agent_traj = []
        for _ in range(num_steps):
            heading += rs.normal(0, 0.02)
            speed = np.clip(speed + rs.normal(0, 0.1), 3, 20)
            vx = speed * np.cos(heading)
            vy = speed * np.sin(heading)
            x += vx * dt
            y += vy * dt
            agent_traj.append((x, y, vx, vy))
        trajectories[agent_id] = agent_traj
    return trajectories


# The period of the device stream's keys: JAX folds ``frame_count % 1000``
# into its key, as the reference reseeds numpy with it (detector.py:134).
DEVICE_STREAM_PERIOD = 1000


def _wave(angle: torch.Tensor) -> torch.Tensor:
    """``floor(50 sin(angle))`` of float32 angles, as the JAX package's
    float32 arithmetic gives it.  Neither XLA's float32 sine nor PyTorch's
    is correctly rounded, and they differ: at 2031.04f (counter 100,802,
    slot 15) XLA gives 0.99999994 and PyTorch's CPU sine 1.0, which moves
    the floor from 49 to 50.  The sine in float64, rounded to float32,
    gives XLA's floor at every angle of counters 1 to 1,000,000 x 16
    slots (tests/test_torch_device_detections.py), on the CPU and on the
    card alike."""
    return torch.floor(50 * torch.sin(angle.double()).float())


def _detections_from_draws(frame_count, num, df, jx, jy, cls, conf, height: int = 480, width: int = 640):
    """The deterministic part of `device_detection_stream`: the tables of
    frames ``frame_count`` (F,) from their draws, the JAX package's
    arithmetic step by step in float32.

    ``num`` (F,) int boxes a frame; ``df`` (F, D) float32 distance factors;
    ``jx``, ``jy`` (F, D) int jitters; ``cls`` (F, D) int classes; ``conf``
    (F, D) float32 confidences.  Returns bbox (F, D, 4) float32, class_id
    (F, D) int32, confidence (F, D) float32 and valid (F, D) bool."""
    dev = df.device
    i = torch.arange(df.shape[-1], dtype=torch.int32, device=dev)
    base_w = torch.floor(80 * df + 40)
    base_h = torch.floor(60 * df + 30)
    t = frame_count.to(torch.float32)[:, None] * 0.02
    x_base = torch.remainder(i * 150 + _wave(t + i), width - base_w)
    y_base = torch.floor(height * 0.4 + height * 0.4 * df)
    x1 = torch.clamp_min(x_base + jx.to(torch.int32), 0.0)
    y1 = torch.clamp_min(y_base + jy.to(torch.int32), 0.0)
    x2 = torch.clamp_max(x1 + base_w, float(width))
    y2 = torch.clamp_max(y1 + base_h, float(height))
    return {
        "bbox": torch.stack([x1, y1, x2, y2], dim=-1).to(torch.float32),
        "class_id": cls.to(torch.int32),
        "confidence": conf.to(torch.float32),
        "valid": i < num.to(torch.int32)[:, None],
    }


def device_detection_draws(capacity: int = 16, seed: int = 0, device="cuda"):
    """The draws of every key of `device_detection_stream`: row k holds the
    draws of the frames whose counter is k modulo DEVICE_STREAM_PERIOD,
    drawn at once on ``device`` by a ``torch.Generator`` seeded with
    ``seed``.  The ranges are JAX's: ``num`` in [3, 8), ``df`` uniform in
    [0.3, 1), ``jx`` in [-10, 10), ``jy`` in [-5, 5), ``cls`` by
    CLASS_WEIGHTS, ``conf`` uniform in [0.75, 0.98).  Returns a dict of
    (1000,) and (1000, capacity) tensors."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (DEVICE_STREAM_PERIOD, capacity)

    def uniform(lo: float, hi: float):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    weights = torch.tensor(CLASS_WEIGHTS, dtype=torch.float32, device=dev)
    return {
        "num": torch.randint(3, 8, (DEVICE_STREAM_PERIOD,), generator=g, device=dev, dtype=torch.int32),
        "df": uniform(0.3, 1.0),
        "jx": torch.randint(-10, 10, shape, generator=g, device=dev, dtype=torch.int32),
        "jy": torch.randint(-5, 5, shape, generator=g, device=dev, dtype=torch.int32),
        "cls": torch.multinomial(weights, DEVICE_STREAM_PERIOD * capacity, replacement=True, generator=g)
        .view(shape)
        .to(torch.int32),
        "conf": uniform(0.75, 0.98),
    }


def device_detection_stream(
    num_frames: int,
    height: int = 480,
    width: int = 640,
    capacity: int = 16,
    seed: int = 0,
    start_frame_count: int = 1,
    device="cuda",
):
    """Simulated detections made on the device, keyed by the frame counter.

    The JAX package draws each frame from ``fold_in(PRNGKey(seed),
    frame_count % 1000)``; here the draws of the 1,000 keys come from one
    ``torch.Generator`` seeded with ``seed`` on the device
    (`device_detection_draws`), and frame ``c`` takes row ``c % 1000``.  So
    the stream is a pure function of ``(seed, frame_count)`` with period
    1,000: a chunk that starts at ``start_frame_count=s`` equals the same
    slice of one whole stream.  Threefry's bits cannot be reproduced, so
    the draws follow JAX's distribution, not its values; the tables follow
    from the draws by JAX's arithmetic (`_detections_from_draws`).

    Returns a dict of (F, D, ...) tensors on ``device``: bbox, class_id,
    confidence, valid."""
    draws = device_detection_draws(capacity, seed, device)
    dev = draws["df"].device
    counters = torch.arange(start_frame_count, start_frame_count + num_frames, device=dev)
    rows = torch.remainder(counters, DEVICE_STREAM_PERIOD)
    picked = {k: v.index_select(0, rows) for k, v in draws.items()}
    return _detections_from_draws(counters, height=height, width=width, **picked)
