"""The PyTorch port imports no JAX: not ``jax``, not ``jaxlib``, and
nothing of the JAX package, whose every submodule imports jax through the
package's ``__init__``.  Checked on the source, so an import inside a
function counts as much as one at the top."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "multimodal_autonomous_driving_perception_and_planning_torch"
FORBIDDEN = ("jax", "jaxlib", "multimodal_autonomous_driving_perception_and_planning_tpu")
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda_kernels.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_sees_the_port():
    assert len(FILES) > 15
    assert "torch" in set(_imported_modules(PORT / "pipeline.py"))
    assert "jax" in {m.split(".")[0] for m in _imported_modules(ROOT / "tests" / "test_torch_pipeline.py")}


def test_frames_generator_needs_no_cv2():
    """The port draws its road frames with numpy alone: the card's machine
    has no cv2.  The JAX package's generator imports it."""
    assert "cv2" not in {m.split(".")[0] for m in _imported_modules(PORT / "data" / "frames.py")}
    jax_frames = ROOT / "multimodal_autonomous_driving_perception_and_planning_tpu" / "data" / "frames.py"
    assert "cv2" in set(_imported_modules(jax_frames))


NO_CV2_MODULES = (
    "multimodal_autonomous_driving_perception_and_planning_torch",
    "multimodal_autonomous_driving_perception_and_planning_torch.host",
    "multimodal_autonomous_driving_perception_and_planning_torch.data",
    "multimodal_autonomous_driving_perception_and_planning_torch.data.video",
    "multimodal_autonomous_driving_perception_and_planning_torch.runtime",
    "multimodal_autonomous_driving_perception_and_planning_torch.runtime.stream",
    "multimodal_autonomous_driving_perception_and_planning_torch.viz",
    "multimodal_autonomous_driving_perception_and_planning_torch.perception.detector",
    "multimodal_autonomous_driving_perception_and_planning_torch.apps.demo",
    "multimodal_autonomous_driving_perception_and_planning_torch.apps.webview",
    "multimodal_autonomous_driving_perception_and_planning_torch.apps.dashboard",
)


def test_port_imports_without_cv2():
    """With cv2 unimportable (``sys.modules["cv2"] = None``), every module of
    the port imports: the renderers, the video loader and the apps import
    cv2 only when they draw or decode.  A fresh interpreter, so that no
    module is already loaded."""
    import subprocess
    import sys

    code = (
        "import importlib, sys\n"
        "sys.modules['cv2'] = None\n"
        f"for name in {NO_CV2_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "assert sys.modules['cv2'] is None\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')]\n"
        "print('ok')\n"
    )
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0 and done.stdout.strip() == "ok", done.stderr


def test_renderers_import_cv2_inside_functions():
    """The port's renderers, video loader and apps name cv2 in no top-level
    import (the JAX renderers import it at the top)."""
    for rel in ("viz/draw.py", "viz/bev.py", "viz/overlays.py", "data/video.py", "apps/demo.py", "apps/webview.py"):
        tree = ast.parse((PORT / rel).read_text())
        top = [alias.name for node in tree.body if isinstance(node, ast.Import) for alias in node.names]
        assert "cv2" not in top, rel
        assert "cv2" in set(_imported_modules(PORT / rel)), rel  # they do use it


def test_frame_ring_is_the_ports_own_copy():
    src = PORT / "runtime" / "frame_ring.cpp"
    assert src.is_file() and not src.is_symlink()
    assert "ring_next_batch" in src.read_text()
