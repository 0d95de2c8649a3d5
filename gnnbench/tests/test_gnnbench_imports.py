"""What the benchmark's files import, read from their syntax trees:
nothing under gnnbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program."""

from __future__ import annotations

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "dream_gnn_tpu"}
PROGRAM = "dream_gnn_tpu_torch"


def _sources():
    for base, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def imported(path: str) -> set:
    """Every module name a file imports, absolute."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not {top(n) for n in imported(path)} & FORBIDDEN


def _closure(start: str) -> set:
    """The benchmark's own modules that ``start`` reaches by imports."""
    seen, todo = set(), [start]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imported(path):
            if top(name) != "gnnbench":
                continue
            parts = name.split(".")[1:]
            for k in range(len(parts), 0, -1):
                cand = os.path.join(BENCH, *parts[:k]) + ".py"
                if os.path.exists(cand):
                    todo.append(cand)
                    break
    return seen


@pytest.mark.parametrize("name", ["dense", "sparse", "common"])
def test_the_reference_imports_nothing_of_the_program(name):
    for path in _closure(os.path.join(BENCH, "reference", f"{name}.py")):
        assert PROGRAM not in {top(n) for n in imported(path)}, path


def test_the_top_level_name_is_compared_whole():
    assert top("dream_gnn_tpu_torch.train") not in FORBIDDEN
    assert top("dream_gnn_tpu.train") in FORBIDDEN
