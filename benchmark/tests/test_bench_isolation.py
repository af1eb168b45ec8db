"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the port."""

import ast

import pytest

from benchmark import core

FILES = sorted(p for p in core.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(core.HERE)))
def test_no_jax(path):
    for name, level in imported(path):
        if level == 0:
            assert name not in core.FORBIDDEN_MODULES, (path, name)


def test_whole_name_compare():
    # the port's name begins with the JAX package's stem; only whole names count
    assert "tacotron_multispeaker_torch" not in core.FORBIDDEN_MODULES


@pytest.mark.parametrize("path", sorted((core.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    for name, level in imported(path):
        assert level <= 1, (path, name)
        if level == 0:
            assert name in ("__future__", "math", "numpy", "torch"), (path, name)
