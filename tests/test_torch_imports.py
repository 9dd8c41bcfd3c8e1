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
