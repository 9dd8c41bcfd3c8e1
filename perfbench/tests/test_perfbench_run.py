"""The command line: what a run prints, and where it refuses."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "yolov8m.drive"


def _metrics(kind: str):
    return {m["name"] for m in BENCH[kind] if CELL in m.get("workloads", [CELL])}


def _run(*args, timeout=900):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_no_card_no_result():
    """Without CUDA (forced off here) the run exits non-zero and prints no
    result line."""
    env_code = ("import os, sys, runpy; os.environ['CUDA_VISIBLE_DEVICES'] = ''; "
                "sys.argv = ['perfbench/run.py', '--workload', 'yolov8m.drive', '--seed', '1', '--seconds', '1']; "
                "runpy.run_path('perfbench/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", env_code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_cell_runs_correct_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run("--workload", CELL, "--seed", "2147483711", "--seconds", "4", "--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    want = _metrics("per_layer" if trace == "1" else "end_to_end")
    assert want >= ({"device_idle_pct", "mfu_pct"} if trace == "1" else {"frames_per_s", "segment_p95_ms", "setup_s"})
    assert set(r["metrics"]) == want
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1


def test_untraced_segment_p95_reads_the_window_tail():
    """The per-layer tail is numpy's 95th percentile of the segments the
    harness hands over, in milliseconds, and nothing without segments."""
    from types import SimpleNamespace

    from perfbench.metrics import untraced_segment_p95_ms

    seconds = [0.05 + 0.001 * (i % 17) for i in range(300)] + [0.4]
    assert untraced_segment_p95_ms.read(SimpleNamespace(segment_s=seconds)) == pytest.approx(
        1e3 * float(np.percentile(seconds, 95)))
    assert untraced_segment_p95_ms.read(SimpleNamespace(segment_s=[])) is None
