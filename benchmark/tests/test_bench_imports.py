"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the plain reference imports nothing of the port either."""

from __future__ import annotations

import ast
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "image_restoration_platform_tpu"}
PORT = "image_restoration_platform_tpu_torch"


def _sources(sub: str = ""):
    base = os.path.join(HERE, sub)
    for dirpath, _dirs, files in os.walk(base):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not (_top_level_imports(path) & JAX)


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    found = _top_level_imports(path)
    assert PORT not in found and not (found & JAX)


def test_the_prefix_is_not_a_match():
    assert "image_restoration_platform_tpu_torch".split(".", 1)[0] not in JAX


def test_run_finds_forbidden_modules(monkeypatch):
    from benchmark import run

    assert "image_restoration_platform_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]
