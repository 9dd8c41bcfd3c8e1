"""The PyTorch port imports no JAX: not ``jax``, not ``jaxlib``, and
nothing of the JAX package, whose every submodule imports jax through the
package's ``__init__``.  Checked on the source, so an import inside a
function counts as much as one at the top."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "multimodal_autonomous_driving_perception_and_planning_torch"
JAX_PKG = ROOT / "multimodal_autonomous_driving_perception_and_planning_tpu"
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


def _jax_all(init: Path) -> list:
    """The names in a JAX package ``__init__.py``'s ``__all__``, read from its
    source (importing it would import jax)."""
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


# The JAX package and each of its subpackages that declares ``__all__``.
EXPORTING = [""] + sorted(p.parent.name for p in JAX_PKG.glob("*/__init__.py") if _jax_all(p))


@pytest.mark.parametrize("sub", EXPORTING, ids=lambda s: s or "package")
def test_port_exports_every_name_of_the_jax_subpackage(sub):
    """Every name in a JAX subpackage's ``__all__`` resolves in the port's
    counterpart (``from <port>.<sub> import <name>`` works wherever it works
    for the JAX package)."""
    names = _jax_all(JAX_PKG / sub / "__init__.py")
    assert names, sub
    module = importlib.import_module(PORT.name + (f".{sub}" if sub else ""))
    missing = [n for n in names if not hasattr(module, n)]
    assert not missing, f"{module.__name__} lacks {missing}"


def test_every_jax_subpackage_is_walked():
    assert {"ops", "tagging", "tracking", "utils"} <= set(EXPORTING) and len(EXPORTING) >= 14


def test_to_numpy_copies_every_tensor_to_the_host():
    """`types.to_numpy`, the JAX package's `types.to_numpy`: a table, or a
    dict of tables and tensors, with every tensor a numpy array of the
    same dtype and values."""
    from multimodal_autonomous_driving_perception_and_planning_torch.types import TrackTable, to_numpy

    table = TrackTable.empty(4, 3, "cpu")
    out = to_numpy({"table": table, "n": torch.tensor(3, dtype=torch.int32), "xs": [torch.arange(2.0)]})
    assert isinstance(out["table"], TrackTable)
    for f in ("track_id", "bbox", "trajectory", "next_id"):
        got, want = getattr(out["table"], f), getattr(table, f)
        assert isinstance(got, np.ndarray) and got.dtype == want.numpy().dtype
        np.testing.assert_array_equal(got, want.numpy())
    assert out["n"].dtype == np.int32 and int(out["n"]) == 3
    np.testing.assert_array_equal(out["xs"][0], [0.0, 1.0])


def test_to_numpy_matches_the_jax_package():
    """`types.to_numpy` against the JAX package's `types.to_numpy` on the
    same tree: tensors (float32, int32, bool), a None leaf (an empty subtree
    to JAX, kept as None), Python scalars, a nested tuple and a list.  Both
    give the same structure, and every leaf the same dtype, shape and
    values."""
    import jax.numpy as jnp

    from multimodal_autonomous_driving_perception_and_planning_torch.types import to_numpy
    from multimodal_autonomous_driving_perception_and_planning_tpu.types import to_numpy as jax_to_numpy

    rng = np.random.default_rng(16)
    leaves = {
        "f": rng.standard_normal((3, 4)).astype(np.float32),
        "i": rng.integers(-9, 9, size=(5,)).astype(np.int32),
        "b": rng.random((2, 2)) > 0.5,
    }

    def tree(arr):
        return {
            "f": arr(leaves["f"]),
            "none": None,
            "n": 3,
            "x": 2.5,
            "nest": (arr(leaves["i"]), (arr(leaves["b"]), None, 7)),
            "list": [arr(leaves["f"][0]), None],
        }

    got = to_numpy(tree(torch.from_numpy))
    want = jax_to_numpy(tree(jnp.asarray))

    def same(g, w, where):
        assert type(g) is type(w), (where, type(g), type(w))
        if w is None:
            return
        if isinstance(w, dict):
            assert g.keys() == w.keys(), where
            for k in w:
                same(g[k], w[k], f"{where}.{k}")
        elif isinstance(w, (tuple, list)):
            assert len(g) == len(w), where
            for k, (a, b) in enumerate(zip(g, w)):
                same(a, b, f"{where}[{k}]")
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, (where, g.dtype, w.dtype, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=where)

    same(got, want, "tree")
    assert got["none"] is None and got["nest"][1][1] is None and got["list"][1] is None
