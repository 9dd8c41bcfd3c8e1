"""The port's stdlib web dashboard (`apps.webview`) on the CPU.

tests/test_webview.py's 2 cases on the port (progressive serving and the
endpoint contracts; chunked equal to monolithic), on a free port, and the
port's dashboard data against the JAX package's on the same 10
detections-mode frames: every frame's tags equal, the states' counts and
plan types equal and their rounded floats within one rounding step.
"""

import json
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

import chip_smoke
from multimodal_autonomous_driving_perception_and_planning_torch.apps.webview import (
    DashboardData,
    build_dashboard_data,
    main,
    process_into,
    serve,
)

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _get(url):
    return urllib.request.urlopen(url, timeout=60).read()


def test_webview_progressive_endpoints(tmp_path):
    server = serve(port=0, num_frames=8, block=False, progressive=True, **CPU)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        html = _get(base + "/").decode()
        assert "Dashboard" in html and "/status" in html
        status = json.loads(_get(base + "/status"))
        assert status["total"] == 8 and 0 <= status["ready"] <= 8

        deadline = time.time() + 120
        while time.time() < deadline:
            status = json.loads(_get(base + "/status"))
            assert status["error"] is None, status["error"]
            if status["ready"] == 8:
                break
            time.sleep(0.3)
        assert status["ready"] == 8

        assert _get(base + "/frame?i=3")[:2] == b"\xff\xd8"  # JPEG magic
        tags = json.loads(_get(base + "/tags?i=3"))
        assert "all_tags" in tags and "speed_kmh" in tags["state"]
        stats = json.loads(_get(base + "/stats"))
        assert stats["total_frames"] == 8
        hist = json.loads(_get(base + "/history"))
        for k in ("speed_kmh", "heading_deg", "accel", "x", "y"):
            assert len(hist[k]) == 8, k
        assert all(isinstance(v, (int, float)) for v in hist["speed_kmh"])

        road = tags["all_tags"][0]
        hits = json.loads(_get(base + "/search?q=" + road))
        assert 3 in hits["frames"]
        assert _get(base + "/frame?i=999")[:2] == b"\xff\xd8"  # clamps

        db = str(tmp_path / "tags.db")
        req = urllib.request.Request(base + "/save?db=" + urllib.parse.quote(db), method="POST")
        saved = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert saved["frames_saved"] == 8 and saved["db_path"] == db
        from multimodal_autonomous_driving_perception_and_planning_torch.database import TagDatabase

        tdb = TagDatabase(db)
        try:
            assert len(tdb.search_by_tag(road)) == len(hits["frames"])
        finally:
            tdb.close()

        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + "/frame?i=abc")
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


def test_webview_chunked_equals_monolithic(monkeypatch):
    """Progressive chunking does not change results: tags and states equal
    the synchronous whole-clip build, with or without renders."""
    mono = build_dashboard_data(num_frames=10, **CPU)
    prog = DashboardData(total=10)
    process_into(prog, 10, chunk=4, **CPU)  # 4 + 4 + 2
    assert [ft.all_tags for ft in prog.frame_tags] == [ft.all_tags for ft in mono.frame_tags]
    assert prog.states == mono.states
    assert len(prog.frames_jpeg) == 10 and all(j[:2] == b"\xff\xd8" for j in prog.frames_jpeg)
    # On a machine without cv2 nothing renders, and the tags and states stand.
    monkeypatch.setitem(sys.modules, "cv2", None)
    bare = build_dashboard_data(num_frames=10, **CPU)
    assert [ft.all_tags for ft in bare.frame_tags] == [ft.all_tags for ft in mono.frame_tags]
    assert bare.states == mono.states and bare.frames_jpeg == [b""] * 10


def test_dashboard_data_equals_jax():
    from multimodal_autonomous_driving_perception_and_planning_tpu.apps import webview as webview_j

    got = build_dashboard_data(num_frames=10, use_frames=False, **CPU)
    want = webview_j.build_dashboard_data(num_frames=10, use_frames=False)
    assert [ft.all_tags for ft in got.frame_tags] == [ft.all_tags for ft in want.frame_tags]
    assert len(got.states) == len(want.states) == 10
    steps = {"speed_kmh": 0.1, "heading_deg": 0.1, "accel": 0.01, "x": 0.1, "y": 0.1}
    for a, b in zip(got.states, want.states):
        assert (a["tracks"], a["plan"]) == (b["tracks"], b["plan"])
        for k, step in steps.items():
            assert abs(a[k] - b[k]) <= step * 1.0001, (k, a[k], b[k])
    chip_smoke.same_records(json.loads(got.stats_json()), json.loads(want.stats_json()), "stats")  # session times masked


def test_main_parses_the_web_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr("multimodal_autonomous_driving_perception_and_planning_torch.apps.webview.serve",
                        lambda **kw: seen.update(kw))
    main(["--frames", "40", "--port", "8799", "--host", "0.0.0.0", "--device", "cpu"])
    assert seen == {"port": 8799, "num_frames": 40, "video_path": None, "host": "0.0.0.0", "device": "cpu"}
