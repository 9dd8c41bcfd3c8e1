"""Streamlit dashboard on the port.

    python -m streamlit run multimodal_autonomous_driving_perception_and_planning_torch/apps/dashboard.py [-- --device cpu]

(from the root of the repository: ``python -m`` puts it on the path, and
the module imports the package by its name, since Streamlit runs it as a
script).  The port's counterpart of the JAX package's apps/dashboard.py,
the interactive equivalent of the reference's app.py:362-815: video
upload, frame scrubber with autoplay, live view (camera + BEV + metric
widgets), auto-tag badges with a VLM-vs-rules toggle, metrics plots,
natural-language tag search, and SQLite persistence.

The reference re-runs the whole per-frame Python pipeline on every
Streamlit rerun (app.py:780-785).  Here the clip runs once through the
sequence runner on the card and reruns only scrub the results on the host,
so an interaction costs a render, not a pipeline run.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def main(device="cuda"):
    """One Streamlit run of the page; the pipeline runs on ``device``."""
    import streamlit as st

    from multimodal_autonomous_driving_perception_and_planning_torch import (
        DEFAULT_CONFIG,
        initial_state,
        make_sequence_runner,
    )
    from multimodal_autonomous_driving_perception_and_planning_torch.apps.demo import _build_inputs, bev_view, viz_camera
    from multimodal_autonomous_driving_perception_and_planning_torch.data.frames import SyntheticRoadGenerator
    from multimodal_autonomous_driving_perception_and_planning_torch.data.video import VideoDataLoader
    from multimodal_autonomous_driving_perception_and_planning_torch.database import TagDatabase
    from multimodal_autonomous_driving_perception_and_planning_torch.host import extract_frame
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.auto_tagger import AutoTagger
    from multimodal_autonomous_driving_perception_and_planning_torch.tagging.vlm import VLMTagger
    from multimodal_autonomous_driving_perception_and_planning_torch.types import tree_map
    from multimodal_autonomous_driving_perception_and_planning_torch.viz import BEVRenderer, OverlayRenderer

    st.set_page_config(page_title="AV Perception & Planning (CUDA)", layout="wide")
    st.title("Multimodal AV Perception & Planning — PyTorch/CUDA Pipeline")

    if "db" not in st.session_state:
        st.session_state.cfg = DEFAULT_CONFIG
        st.session_state.db = TagDatabase("driving_tags.db")
        st.session_state.vlm = VLMTagger(DEFAULT_CONFIG.vlm)
        st.session_state.results = None
        st.session_state.frame_idx = 0

    cfg = st.session_state.cfg

    with st.sidebar:
        st.header("Input")
        upload = st.file_uploader("Upload video", type=["mp4", "avi", "mov", "mkv"])
        num_frames = st.slider("Frames to process", 30, 600, 150, 30)
        use_synthetic = st.checkbox("Use synthetic road scene", value=upload is None)
        if st.button("Process"):
            with st.spinner("Running the pipeline on the card..."):
                if upload is not None and not use_synthetic:
                    tmp = Path(tempfile.mkstemp(suffix=Path(upload.name).suffix)[1])
                    tmp.write_bytes(upload.read())
                    loader = VideoDataLoader(
                        str(tmp), target_size=(cfg.frame_width, cfg.frame_height)
                    )
                    n = min(num_frames, loader.total_frames)
                    frames = loader.load_frames(n)
                    loader.release()
                    src = upload.name
                else:
                    gen = SyntheticRoadGenerator(cfg.frame_width, cfg.frame_height)
                    n = num_frames
                    frames = gen.generate_frames(n)
                    src = "synthetic"
                dets, inputs = _build_inputs(frames, n, 1 / 30.0, True, cfg)
                runner = make_sequence_runner(cfg, device=device)
                _, outs = runner(initial_state(cfg, device=device), inputs)
                outs = tree_map(lambda x: x.cpu(), outs)
                tagger = AutoTagger(video_path=src, fps=30.0)
                tagger.ingest_device_tags(outs["tags"], n)
                tagger.finalize()
                st.session_state.results = (frames, dets, outs, tagger, n)
                st.session_state.vlm.reset()
                st.session_state.frame_idx = 0

        # Playback controls (reference app.py:504-519: Reset, Auto Play
        # default-on, speed multiplier 0.5-3.0).  Autoplay here only
        # advances the scrub index over precomputed results — the rerun
        # loop is O(render), not O(pipeline) as in the reference.
        st.header("Controls")
        if st.button("Reset"):
            st.session_state.frame_idx = 0
            st.session_state.vlm.reset()
        auto_play = st.checkbox("Auto Play", value=True)
        playback_speed = st.slider("Speed", 0.5, 3.0, 1.0, 0.5)

        # Database controls (reference app.py:522-533: save + stats).
        st.header("Database")
        if st.session_state.results is not None:
            if st.button("Save tags to database"):
                _, _, _, tagger, _ = st.session_state.results
                count = st.session_state.db.save_all_tags(tagger)
                st.success(f"Saved {count} frames to driving_tags.db")
        if st.button("View statistics"):
            st.json(st.session_state.db.get_tag_statistics())

    if st.session_state.results is None:
        st.info("Upload a video or use the synthetic scene, then press Process.")
        return

    frames, dets, outs, tagger, n = st.session_state.results
    bev = BEVRenderer(cfg.bev)
    overlay = OverlayRenderer()

    frame_idx = st.slider("Frame", 0, n - 1, min(st.session_state.frame_idx, n - 1))
    st.session_state.frame_idx = frame_idx
    res = extract_frame(outs, dets, frame_idx)

    tab_live, tab_tags, tab_metrics = st.tabs(["Live View", "Auto-Tags", "Metrics & Search"])

    with tab_live:
        cam = viz_camera(frames[frame_idx].copy(), res)
        cam = overlay.draw_info_panel(cam, res.vehicle_state, fps=30.0, frame_num=frame_idx)
        bev_img = bev_view(bev, res)
        c1, c2 = st.columns(2)
        c1.image(cam[..., ::-1], caption="Camera view")
        c2.image(bev_img[..., ::-1], caption="Bird's eye view")
        m = st.columns(4)
        m[0].metric("Speed", f"{res.vehicle_state.speed * 3.6:.1f} km/h")
        m[1].metric("Tracks", len(res.tracks))
        m[2].metric("Detections", len(res.detections))
        m[3].metric("Plan", res.optimal_trajectory.trajectory_type)

    with tab_tags:
        use_vlm = st.toggle("Use VLM captioner", value=False)
        ft = tagger.frame_tags[frame_idx]
        if use_vlm:
            vt = st.session_state.vlm.tag_frame(
                frames[frame_idx], res.vehicle_state, res.tracks
            )
            st.write("**Scene:**", vt.scene_description)
            st.write("**Safety:**", vt.safety_assessment)
            st.write(" ".join(f"`{t}`" for t in vt.get_tags_list()))
        else:
            st.write(" ".join(f"`{t}`" for t in ft.all_tags))
            st.json(
                {
                    "scene": ft.scene,
                    "maneuver": ft.maneuver,
                    "risk": ft.interaction["overall_risk"],
                }
            )

    with tab_metrics:
        stats = tagger.get_tag_statistics()
        c1, c2 = st.columns(2)
        with c1:
            st.subheader("Tag frequency (top 15)")
            st.bar_chart(dict(list(stats["tag_frequency"].items())[:15]))
            st.subheader("Risk distribution")
            st.bar_chart(stats["risk_distribution"])
        with c2:
            st.subheader("Ego state history")
            vs = outs["vehicle_state"]
            st.line_chart(
                {
                    "speed_kmh": np.asarray(vs.speed) * 3.6,
                    "heading_deg": np.degrees(np.asarray(vs.heading)),
                }
            )
        st.subheader("Search frames by tag")
        query = st.text_input("Tag", placeholder="e.g. risk_high, braking, highway")
        if query:
            hits = tagger.search_by_tag(query.strip())
            st.write(f"{len(hits)} frames:", [h.frame_idx for h in hits][:50])

        # VLM natural-language search (reference app.py:706-723): substring
        # search over the captions the VLM tagger has produced so far (it
        # tags lazily in the Auto-Tags tab, so coverage grows as you view
        # frames with the VLM toggle on).
        st.subheader("Natural language search (VLM)")
        nl_query = st.text_input(
            "Search by description",
            placeholder="e.g. pedestrian crossing, dangerous situation, highway",
        )
        if nl_query:
            vlm_hits = st.session_state.vlm.search_by_description(nl_query.strip())
            st.write(f"{len(vlm_hits)} frames match `{nl_query}`")
            for vt in vlm_hits[:10]:
                st.write(
                    f"Frame {vt.frame_idx} (t={vt.timestamp:.2f}s) — "
                    f"{vt.scene_description} [risk: {vt.risk_level}]"
                )

    # Auto-advance (reference app.py:780-785): ~30 fps base cadence scaled
    # by the speed multiplier, then rerun with the next frame selected.
    if auto_play and frame_idx < n - 1:
        time.sleep(0.033 / playback_speed)
        st.session_state.frame_idx = frame_idx + 1
        st.rerun()


def _device_from_argv(argv) -> str:
    """``--device cpu`` after Streamlit's ``--``; the card otherwise."""
    return argv[argv.index("--device") + 1] if "--device" in argv[:-1] else "cuda"


if __name__ == "__main__":  # under `streamlit run`
    main(_device_from_argv(sys.argv[1:]))
