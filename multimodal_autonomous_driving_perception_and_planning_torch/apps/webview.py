"""Zero-dependency web dashboard (stdlib http.server), progressive.

    python -m multimodal_autonomous_driving_perception_and_planning_torch.apps.webview --frames 120 --port 8700

The port's counterpart of the JAX package's apps/webview.py (``app.py
--backend web`` stays the JAX package's): the same surfaces as the
reference's Streamlit tabs (Live View / Auto-Tags / Metrics & Search),
streamed progressively.  The pipeline runs chunk by chunk on the card
(state chained across chunks, equal to one whole run; see
runtime/stream.py), and each chunk's rendered frames and tags appear in
the dashboard as soon as they land, so the user scrubs early frames while
later ones are still computing.  Rendering and JPEG encoding use cv2 on the
host (`viz`).
"""

from __future__ import annotations

import importlib.util
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><title>AV Pipeline Dashboard</title>
<style>
 body { font-family: sans-serif; background: #111; color: #eee; margin: 20px; }
 img { border: 1px solid #333; max-width: 100%; }
 .row { display: flex; gap: 20px; flex-wrap: wrap; }
 .card { background: #1c1c1c; padding: 14px; border-radius: 8px; margin-top: 14px; }
 input[type=range] { width: 100%; }
 .tag { display: inline-block; background: #2d4f67; border-radius: 10px;
        padding: 2px 9px; margin: 2px; font-size: 13px; }
 .risk-high, .risk-critical { background: #7a2d2d; }
 pre { white-space: pre-wrap; }
 #progress { height: 6px; background: #333; border-radius: 3px; }
 #bar { height: 6px; background: #3c79a8; border-radius: 3px; width: 0%; }
</style></head>
<body>
<h2>Multimodal AV Perception &amp; Planning — PyTorch/CUDA Pipeline Dashboard</h2>
<div class="card">
  <div id="progress"><div id="bar"></div></div>
  <div><span id="ready">0</span> / <span id="total">{total}</span> frames processed</div>
  <input type="range" id="slider" min="0" max="0" value="0">
  <div>Frame <span id="fidx">0</span>
    <button id="play" onclick="toggle()">&#9654; Play</button>
    <select id="speed"><option value="0.5">0.5x</option>
      <option value="1" selected>1x</option><option value="2">2x</option>
      <option value="4">4x</option></select></div>
</div>
<div class="row">
  <div class="card"><h3>Combined view</h3><img id="view" src="" width="900"></div>
  <div class="card" style="min-width:300px"><h3>Frame tags</h3><div id="tags"></div>
    <h3>Vehicle state</h3><pre id="state"></pre></div>
</div>
<div class="row">
  <div class="card" style="flex:1"><h3>Tag statistics</h3>
    <div id="tagbars"></div><pre id="stats"></pre></div>
  <div class="card" style="flex:1"><h3>Search</h3>
    <input id="q" placeholder="tag or description, e.g. risk_high">
    <button onclick="search()">Search</button><pre id="results"></pre>
    <h3>Database</h3>
    <button onclick="saveDb()">&#128190; Save tags to database</button>
    <pre id="saveres"></pre></div>
</div>
<div class="card"><h3>Ego state history</h3><div class="row" id="charts"></div></div>
<script>
const slider = document.getElementById('slider');
let firstReady = false;
function update(i) {
  document.getElementById('fidx').textContent = i;
  document.getElementById('view').src = '/frame?i=' + i;
  fetch('/tags?i=' + i).then(r => r.json()).then(d => {
    document.getElementById('tags').innerHTML =
      d.all_tags.map(t => `<span class="tag risk-${t.replace('risk_','')}">${t}</span>`).join('');
    document.getElementById('state').textContent = JSON.stringify(d.state, null, 1);
  });
}
slider.oninput = () => update(slider.value);
let playing = null;
function toggle() {
  // Autoplay at 30 fps x speed, like the reference's rerun loop
  // (app.py:780-785: delay = 0.033 / speed); wraps at the last ready frame.
  if (playing) { clearInterval(playing); playing = null;
    document.getElementById('play').innerHTML = '&#9654; Play'; return; }
  const speed = parseFloat(document.getElementById('speed').value);
  playing = setInterval(() => {
    let i = (parseInt(slider.value) + 1) % (parseInt(slider.max) + 1);
    slider.value = i; update(i);
  }, 33 / speed);
  document.getElementById('play').innerHTML = '&#9646;&#9646; Pause';
}
function poll() {
  fetch('/status').then(r => r.json()).then(d => {
    document.getElementById('ready').textContent = d.ready;
    document.getElementById('total').textContent = d.total;
    document.getElementById('bar').style.width = (100 * d.ready / d.total) + '%';
    if (d.ready > 0) {
      slider.max = d.ready - 1;
      if (!firstReady) { firstReady = true; update(0); refreshStats(); }
    }
    if (d.ready < d.total) setTimeout(poll, 700);
    else refreshStats();
  });
}
function refreshStats() {
  fetch('/stats').then(r => r.json()).then(d => {
    document.getElementById('stats').textContent = JSON.stringify(d, null, 1);
    const freq = Object.entries(d.tag_frequency || {}).slice(0, 15);
    document.getElementById('tagbars').innerHTML = freq.map(([tag, v]) =>
      `<div style="display:flex;align-items:center;margin:2px 0;font-size:12px">` +
      `<span style="width:160px">${tag}</span>` +
      `<div style="background:#3c79a8;height:12px;width:${(160*v).toFixed(0)}px"></div>` +
      `<span style="margin-left:6px;color:#888">${(100*v).toFixed(0)}%</span></div>`
    ).join('');
  });
  refreshCharts();
}
function sparkline(title, xs, ys) {
  const W = 360, H = 140, P = 26;
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const sx = v => P + (W - 2*P) * (xmax > xmin ? (v - xmin) / (xmax - xmin) : 0.5);
  const sy = v => H - P - (H - 2*P) * (ymax > ymin ? (v - ymin) / (ymax - ymin) : 0.5);
  const pts = xs.map((v, i) => sx(v).toFixed(1) + ',' + sy(ys[i]).toFixed(1)).join(' ');
  return `<div><h4 style="margin:4px 0">${title}</h4>` +
    `<svg width="${W}" height="${H}" style="background:#161616;border-radius:6px">` +
    `<polyline points="${pts}" fill="none" stroke="#3c79a8" stroke-width="1.5"/>` +
    `<text x="4" y="${H-8}" fill="#888" font-size="10">${ymin.toFixed(1)}</text>` +
    `<text x="4" y="14" fill="#888" font-size="10">${ymax.toFixed(1)}</text>` +
    `</svg></div>`;
}
function refreshCharts() {
  fetch('/history').then(r => r.json()).then(d => {
    if (!d.speed_kmh || !d.speed_kmh.length) return;
    const f = d.speed_kmh.map((_, i) => i);
    document.getElementById('charts').innerHTML =
      sparkline('Speed (km/h)', f, d.speed_kmh) +
      sparkline('Heading (deg)', f, d.heading_deg) +
      sparkline('Acceleration (m/s²)', f, d.accel) +
      sparkline('Trajectory (x, y)', d.x, d.y);
  });
}
function saveDb() {
  fetch('/save', {method: 'POST'}).then(r => r.json()).then(d => {
    document.getElementById('saveres').textContent = JSON.stringify(d, null, 1);
  });
}
function search() {
  fetch('/search?q=' + encodeURIComponent(document.getElementById('q').value))
    .then(r => r.json()).then(d => {
      document.getElementById('results').textContent =
        d.frames.length ? 'Frames: ' + d.frames.join(', ') : 'No matches';
    });
}
poll();
</script></body></html>
"""


class DashboardData:
    """Per-frame renders + tags backing the HTTP endpoints; grows as the
    background processor appends completed chunks (thread-safe)."""

    def __init__(self, total: int, tagger=None):
        self.total = total
        self.frames_jpeg: List[bytes] = []
        self.frame_tags: List = []
        self.states: List[Dict] = []
        self.tagger = tagger
        self.error: Optional[str] = None
        # Each chunk's seconds on the host clock: the runner (to its outputs
        # on the host) and the rendering.
        self.chunk_seconds: List[Dict[str, float]] = []
        self._lock = threading.Lock()
        self._done = threading.Event()

    @property
    def ready(self) -> int:
        with self._lock:
            return len(self.frames_jpeg)

    def append_chunk(self, jpegs, tags_list, states) -> None:
        with self._lock:
            self.frames_jpeg.extend(jpegs)
            self.frame_tags.extend(tags_list)
            self.states.extend(states)

    def mark_done(self) -> None:
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    # Tagger reads/writes share _lock: the worker thread mutates the
    # AutoTagger (ingest_device_tags) while handler threads iterate its
    # dicts — unguarded, get_tag_statistics can raise "dictionary changed
    # size during iteration" mid-processing.
    def ingest_tags(self, device_tags, n: int) -> None:
        with self._lock:
            self.tagger.ingest_device_tags(device_tags, n)

    def stats_json(self) -> bytes:
        with self._lock:
            stats = self.tagger.get_tag_statistics() if self.tagger else {}
            return json.dumps(stats).encode()

    def history_json(self) -> bytes:
        """Ego state-history series for the 2x2 plots (the reference's
        create_state_plots: speed / heading / acceleration / XY trajectory,
        app.py:194-257)."""
        with self._lock:
            series = {
                k: [s[k] for s in self.states]
                for k in ("speed_kmh", "heading_deg", "accel", "x", "y")
            }
        return json.dumps(series).encode()

    def search_json(self, query: str) -> bytes:
        with self._lock:
            hits = (
                [ft.frame_idx for ft in self.tagger.search_by_tag(query)]
                if self.tagger
                else []
            )
        return json.dumps({"query": query, "frames": hits}).encode()

    def finalize_tagger(self) -> None:
        with self._lock:
            if self.tagger is not None:
                self.tagger.finalize()

    def save_to_db(self, db_path: str = "driving_tags.db") -> bytes:
        """Persist the session to SQLite (the reference's "Save Tags to
        Database" button, app.py:522-529: finalize then save_all_tags)."""
        from ..database import TagDatabase

        with self._lock:
            if self.tagger is None:
                return json.dumps({"error": "no tagging session"}).encode()
            self.tagger.finalize()
            db = TagDatabase(db_path)
            try:
                count = db.save_all_tags(self.tagger)
                sid = self.tagger.session.session_id
            finally:
                db.close()
        return json.dumps(
            {"session": sid, "frames_saved": count, "db_path": db_path}
        ).encode()


def _render_chunk(cfg, frames, dets, outs, start, bev, overlay, data):
    """Host-side rendering of one completed chunk; returns the per-frame
    jpeg/tags/state lists.  ``frames`` is the UNPADDED slice: outputs
    beyond its length (tail-chunk padding) are ignored; ``outs`` are on the
    host.  On a machine without cv2 the frames have empty JPEGs."""
    from ..host import extract_frame

    tagger = data.tagger
    n = frames.shape[0]
    render = importlib.util.find_spec("cv2") is not None
    data.ingest_tags(outs["tags"], n)
    jpegs, tags_list, states = [], [], []
    for f in range(n):
        res = extract_frame(outs, dets, f)
        jpegs.append(_jpeg(frames[f], res, start + f, bev, overlay) if render else b"")
        tags_list.append(tagger.frame_tags[start + f])
        vs = res.vehicle_state
        states.append(
            {
                "speed_kmh": round(vs.speed * 3.6, 1),
                "heading_deg": round(float(np.degrees(vs.heading)), 1),
                "accel": round(vs.acceleration, 2),
                "x": round(vs.x, 1),
                "y": round(vs.y, 1),
                "tracks": len(res.tracks),
                "plan": res.optimal_trajectory.trajectory_type,
            }
        )
    return jpegs, tags_list, states


def _jpeg(frame, res, frame_num: int, bev, overlay) -> bytes:
    """One frame's combined view (camera layers, info panel, bird's-eye
    view) as JPEG bytes."""
    import cv2

    from .demo import bev_view, viz_camera

    cam = viz_camera(frame.copy(), res)
    cam = overlay.draw_info_panel(cam, res.vehicle_state, fps=30.0, frame_num=frame_num)
    combined = overlay.create_side_by_side(cam, bev_view(bev, res))
    ok, buf = cv2.imencode(".jpg", combined, [cv2.IMWRITE_JPEG_QUALITY, 82])
    return buf.tobytes() if ok else b""


def process_into(
    data: DashboardData,
    num_frames: int,
    video_path: Optional[str] = None,
    use_frames: bool = True,
    chunk: int = 30,
    device="cuda",
) -> None:
    """Run the pipeline chunk by chunk on ``device``, appending results into
    ``data`` as each chunk completes.  State chains across chunks, so the
    stream of outputs equals one whole run's."""
    from .. import DEFAULT_CONFIG, initial_state, make_sequence_runner
    from ..data.frames import SyntheticRoadGenerator
    from ..data.synthetic import IncrementalEgoMotion
    from ..runtime.stream import _chunk_inputs, pad_tail
    from ..tagging.auto_tagger import AutoTagger
    from ..types import tree_map
    from ..utils.device import resolve_device
    from ..viz import BEVRenderer, OverlayRenderer

    try:
        dev = resolve_device(device)
        cfg = DEFAULT_CONFIG.replace(use_frames=use_frames, enable_tagging=True)

        if video_path:
            from ..data.video import VideoDataLoader

            loader = VideoDataLoader(video_path, target_size=(cfg.frame_width, cfg.frame_height))
            num_frames = min(num_frames, loader.total_frames)
            all_frames = loader.load_frames(num_frames)
            dt = loader.dt  # the clip's rate, as apps/demo.py takes it
            loader.release()
            src_name = video_path
        else:
            all_frames = SyntheticRoadGenerator(cfg.frame_width, cfg.frame_height).generate_frames(num_frames)
            dt = 1.0 / 30.0
            src_name = "synthetic"
        data.total = num_frames

        runner = make_sequence_runner(cfg, device=dev)
        state = initial_state(cfg, device=dev)
        tagger = AutoTagger(video_path=src_name, fps=1.0 / dt)
        data.tagger = tagger
        bev = BEVRenderer(cfg.bev)
        overlay = OverlayRenderer()
        # O(n) a chunk ego rows, bit-identical to one monolithic seed-0
        # stream (as runtime/stream.py takes them).
        ego_src = IncrementalEgoMotion(dt=dt, seed=0)

        start = 0
        while start < num_frames:
            n = min(chunk, num_frames - start)
            frames = all_frames[start : start + n]
            # Every run takes the full ``chunk``, as run_stream's do: only
            # the final chunk can be short, and its padded outputs are
            # dropped by _render_chunk/ingest.
            fpad = np.empty((chunk,) + frames.shape[1:], np.uint8)
            fpad[:n] = frames
            pad_tail(fpad, n)
            dets, inputs = _chunk_inputs(cfg, torch.from_numpy(fpad), start, dt, ego=ego_src.take(chunk))
            t0 = time.perf_counter()
            state, outs = runner(state, inputs)
            outs = tree_map(lambda x: x.cpu(), outs)
            t1 = time.perf_counter()
            data.append_chunk(*_render_chunk(cfg, frames, dets, outs, start, bev, overlay, data))
            data.chunk_seconds.append({"run": t1 - t0, "render": time.perf_counter() - t1})
            start += n
        data.finalize_tagger()
    except Exception as e:  # surface in /status instead of dying silently
        data.error = f"{type(e).__name__}: {e}"
        raise
    finally:
        data.mark_done()


def build_dashboard_data(
    num_frames: int = 120,
    video_path: Optional[str] = None,
    use_frames: bool = True,
    device="cuda",
) -> DashboardData:
    """Synchronous build (processes everything, then returns)."""
    data = DashboardData(total=num_frames)
    process_into(data, num_frames, video_path, use_frames, device=device)
    return data


def make_handler(data: DashboardData):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, body: bytes, ctype: str = "text/html", code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _frame_index(self, q, n: int) -> Optional[int]:
            """Clamped ?i= value, or None (a 400 was sent) if non-numeric."""
            try:
                i = int(q.get("i", ["0"])[0])
            except ValueError:
                self._send(b"bad frame index", "text/plain", 400)
                return None
            return min(max(i, 0), n - 1)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            n = data.ready
            if url.path == "/":
                self._send(_PAGE.replace("{total}", str(data.total)).encode())
            elif url.path == "/status":
                self._send(
                    json.dumps(
                        {"ready": n, "total": data.total, "error": data.error}
                    ).encode(),
                    "application/json",
                )
            elif url.path == "/frame":
                if n == 0:
                    self._send(b"processing", "text/plain", 202)
                    return
                i = self._frame_index(q, n)
                if i is None:
                    return
                self._send(data.frames_jpeg[i], "image/jpeg")
            elif url.path == "/tags":
                if n == 0:
                    self._send(b"{}", "application/json", 202)
                    return
                i = self._frame_index(q, n)
                if i is None:
                    return
                ft = data.frame_tags[i]
                self._send(
                    json.dumps(
                        {"all_tags": ft.all_tags, "state": data.states[i]}
                    ).encode(),
                    "application/json",
                )
            elif url.path == "/stats":
                self._send(data.stats_json(), "application/json")
            elif url.path == "/history":
                self._send(data.history_json(), "application/json")
            elif url.path == "/search":
                query = q.get("q", [""])[0]
                self._send(data.search_json(query), "application/json")
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/save":
                q = parse_qs(url.query)
                db_path = q.get("db", ["driving_tags.db"])[0]
                self._send(data.save_to_db(db_path), "application/json")
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def serve(
    port: int = 8700,
    num_frames: int = 120,
    video_path: Optional[str] = None,
    block: bool = True,
    progressive: bool = True,
    host: str = "127.0.0.1",
    device="cuda",
):
    """Start the dashboard.  With ``progressive`` (default) the server is
    reachable immediately and frames appear as chunks complete; otherwise
    everything is processed before binding the port.  Binds loopback by
    default (POST /save writes a caller-named SQLite file, which must not
    be remotely reachable); pass ``host="0.0.0.0"`` to expose it
    deliberately.  ``port=0`` takes a free port (``server.server_address``)."""
    data = DashboardData(total=num_frames)
    if progressive:
        worker = threading.Thread(
            target=process_into,
            args=(data, num_frames, video_path),
            kwargs={"device": device},
            daemon=True,
        )
        worker.start()
        print(f"Processing {num_frames} frames in the background (progressive)...")
    else:
        print(f"Processing {num_frames} frames through the device pipeline...")
        process_into(data, num_frames, video_path, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(data))
    server.dashboard_data = data  # for tests / callers
    print(f"Dashboard: http://localhost:{server.server_address[1]}/")
    if block:
        server.serve_forever()
    else:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="AV pipeline web dashboard (PyTorch/CUDA port)")
    parser.add_argument("--frames", type=int, default=120, help="frames to process")
    parser.add_argument("--video", type=str, default=None, help="a video file (default: synthetic road frames)")
    parser.add_argument("--port", type=int, default=8700)
    parser.add_argument("--host", default="127.0.0.1", help="bind address (loopback by default)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    serve(port=args.port, num_frames=args.frames, video_path=args.video, host=args.host, device=args.device)


if __name__ == "__main__":
    main()
