"""The port's Streamlit dashboard (`apps.dashboard`), driven by the scripted
stub `streamlit` module of tests/test_dashboard.py.

streamlit is not installed; the stub implements the API surface the
dashboard uses, so its whole code path (process -> session state -> three
tabs -> search -> DB save) runs against the port's pipeline on the CPU
(frames mode at 120x160, 30 frames).  tests/test_dashboard.py's 2 cases."""

import sys
import types

import pytest
import torch


class _Ctx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getattr__(self, name):
        # Nested widget calls inside a context (sidebar.header etc.).
        return getattr(sys.modules["streamlit"], name)


class _Column(_Ctx):
    pass


class _SessionState(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def _make_stub(button_script, text_script=None, toggle_script=None):
    """A streamlit stub; ``button_script`` maps button label -> bool,
    ``text_script`` maps text_input label -> str, ``toggle_script`` maps
    toggle label -> bool."""
    st = types.ModuleType("streamlit")
    st.session_state = _SessionState()
    st.calls = []
    text_script = text_script or {}
    toggle_script = toggle_script or {}

    def rec(name, ret=None):
        def f(*a, **k):
            st.calls.append((name, a[:1]))
            return ret

        return f

    st.set_page_config = rec("set_page_config")
    st.title = rec("title")
    st.header = rec("header")
    st.subheader = rec("subheader")
    st.info = rec("info")
    st.success = rec("success")
    st.write = rec("write")
    st.json = rec("json")
    st.image = rec("image")
    st.metric = rec("metric")
    st.bar_chart = rec("bar_chart")
    st.line_chart = rec("line_chart")
    st.rerun = rec("rerun")
    st.file_uploader = rec("file_uploader", None)
    st.checkbox = lambda label, value=False, **k: value
    st.toggle = lambda label, value=False, **k: toggle_script.get(label, value)
    st.sidebar = _Ctx()
    st.spinner = lambda *a, **k: _Ctx()

    def text_input(label, *a, **k):
        st.calls.append(("text_input", (label,)))
        return text_script.get(label, "")

    st.text_input = text_input

    def slider(label, mn=0, mx=1, value=None, *a, **k):
        st.calls.append(("slider", (label,)))
        return mn  # smallest workload / first frame / slowest speed

    st.slider = slider

    def button(label, *a, **k):
        return button_script.get(label, False)

    st.button = button

    def tabs(labels):
        return [_Ctx() for _ in labels]

    st.tabs = tabs

    def columns(n):
        n = n if isinstance(n, int) else len(n)
        cols = []
        for _ in range(n):
            c = _Column()
            c.image = st.image
            c.metric = st.metric
            cols.append(c)
        return cols

    st.columns = columns
    return st


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_cfg(monkeypatch):
    import multimodal_autonomous_driving_perception_and_planning_torch as m

    cfg = m.DEFAULT_CONFIG.replace(frame_height=120, frame_width=160)
    monkeypatch.setattr(m, "DEFAULT_CONFIG", cfg)
    return cfg


def test_dashboard_process_and_render(monkeypatch, tmp_path, small_cfg):
    from multimodal_autonomous_driving_perception_and_planning_torch.apps import dashboard

    monkeypatch.chdir(tmp_path)  # driving_tags.db lands here

    # Run 1: press Process (synthetic, 30 frames at the stubbed slider min).
    st = _make_stub({"Process": True})
    monkeypatch.setitem(sys.modules, "streamlit", st)
    dashboard.main(device="cpu")
    assert st.session_state.results is not None
    frames, dets, outs, tagger, n = st.session_state.results
    assert n == 30 and len(tagger.frame_tags) == 30
    # All three tabs rendered: camera+bev images, metrics, charts.
    names = [c[0] for c in st.calls]
    assert names.count("image") >= 2
    assert names.count("metric") >= 4
    assert "bar_chart" in names and "line_chart" in names

    # Run 2: rerun without Process — renders from cached session state.
    st2 = _make_stub({})
    st2.session_state = st.session_state
    monkeypatch.setitem(sys.modules, "streamlit", st2)
    dashboard.main(device="cpu")
    assert [c[0] for c in st2.calls].count("image") >= 2

    # Run 3: save to DB.
    st3 = _make_stub({"Save tags to database": True})
    st3.session_state = st.session_state
    monkeypatch.setitem(sys.modules, "streamlit", st3)
    dashboard.main(device="cpu")
    assert any(c[0] == "success" for c in st3.calls)
    import sqlite3

    con = sqlite3.connect(tmp_path / "driving_tags.db")
    # frame_tags holds one row per (frame, tag); frames is one per frame.
    n_frames = con.execute("SELECT COUNT(*) FROM frames").fetchone()[0]
    n_tag_rows = con.execute(
        "SELECT COUNT(DISTINCT frame_id) FROM frame_tags"
    ).fetchone()[0]
    con.close()
    assert n_frames == 30 and n_tag_rows == 30

    # Run 4 (reference app.py:780-785): autoplay is on by default, so after
    # rendering the dashboard advances the scrub index and requests a rerun.
    st4 = _make_stub({})
    st4.session_state = st.session_state
    st4.session_state.frame_idx = 0
    monkeypatch.setitem(sys.modules, "streamlit", st4)
    dashboard.main(device="cpu")
    assert any(c[0] == "rerun" for c in st4.calls)
    assert st4.session_state.frame_idx == 1

    # Run 5 (reference app.py:531-533): the DB stats button dumps
    # get_tag_statistics() as JSON — the save in run 3 makes it non-empty.
    st5 = _make_stub({"View statistics": True})
    st5.session_state = st.session_state
    monkeypatch.setitem(sys.modules, "streamlit", st5)
    dashboard.main(device="cpu")
    assert any(c[0] == "json" for c in st5.calls)


def test_dashboard_vlm_and_nl_search(monkeypatch, tmp_path, small_cfg):
    """VLM toggle produces captions (stub fallback offline) and the
    natural-language search (reference app.py:706-723) finds them."""
    from multimodal_autonomous_driving_perception_and_planning_torch.apps import dashboard

    monkeypatch.chdir(tmp_path)

    st = _make_stub({"Process": True}, toggle_script={"Use VLM captioner": True})
    monkeypatch.setitem(sys.modules, "streamlit", st)
    dashboard.main(device="cpu")
    vlm = st.session_state.vlm
    assert len(vlm.tag_history) >= 1  # the viewed frame was captioned

    # Search for a word the stub backend always emits in its captions.
    desc = vlm.tag_history[0].scene_description
    word = next(w for w in desc.lower().split() if len(w) > 3)
    st2 = _make_stub({}, text_script={"Search by description": word})
    st2.session_state = st.session_state
    monkeypatch.setitem(sys.modules, "streamlit", st2)
    dashboard.main(device="cpu")
    writes = [c for c in st2.calls if c[0] == "write"]
    assert any("frames match" in str(a) for _, a in writes)


def test_device_flag_after_streamlits_separator():
    from multimodal_autonomous_driving_perception_and_planning_torch.apps import dashboard

    assert dashboard._device_from_argv([]) == "cuda"
    assert dashboard._device_from_argv(["--device", "cpu"]) == "cpu"
    assert dashboard._device_from_argv(["--device"]) == "cuda"
