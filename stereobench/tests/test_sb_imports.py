"""What the harness and the reference import, read from their sources: no
top-level module of JAX or of the JAX package anywhere under stereobench/
(names compared whole: the program's name begins with the JAX
package's), and nothing of the program in the reference."""

import ast
import os

import pytest

from .conftest import REPO

HARNESS = os.path.join(REPO, "stereobench")
JAX = {"jax", "jaxlib", "flax", "crossscalepatchmatch_tpu"}
PROGRAM = "crossscalepatchmatch_tpu_torch"


def sources():
    for d, _, files in os.walk(HARNESS):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & JAX


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "reference_fly.py", "scene.py",
                 "roofline.py"):
        got = set(top_level_imports(os.path.join(HARNESS, name)))
        assert got <= {"__future__", "dataclasses", "typing", "numpy",
                       "torch"}, (name, got)
        assert PROGRAM not in got
