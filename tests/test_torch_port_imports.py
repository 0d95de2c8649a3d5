"""The PyTorch port stands alone: no module of dream_gnn_tpu_torch (nor
chip_smoke.py) imports JAX, optax, sklearn or the JAX package, so it
installs and runs on a machine that has none of them."""

import ast
from pathlib import Path

import jax  # noqa: F401  (every port test file imports both frameworks)
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "optax", "sklearn", "dream_gnn_tpu"}
SOURCES = sorted((ROOT / "dream_gnn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_found():
    assert len(SOURCES) > 20
    assert all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    # Compare the top-level module name exactly: "dream_gnn_tpu_torch"
    # starts with "dream_gnn_tpu" but is the port itself.
    bad = sorted(set(_top_level_imports(path)) & FORBIDDEN)
    assert not bad, f"{path.name} imports {bad}"


def test_scan_catches_forbidden(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import dream_gnn_tpu_torch.config\n"
                   "from dream_gnn_tpu.config import ModelConfig\n"
                   "def f():\n    import optax\n")
    assert set(_top_level_imports(src)) & FORBIDDEN == {"dream_gnn_tpu",
                                                         "optax"}
