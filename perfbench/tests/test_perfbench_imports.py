"""Nothing under perfbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level names compared
whole: the port's name begins with the JAX package's)."""

import ast
import glob
import os

import pytest

from perfbench import harness

FILES = sorted(glob.glob(os.path.join(harness.HERE, "**", "*.py"), recursive=True))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "matchering_tpu"}


@pytest.mark.parametrize(
    "path", [f for f in FILES if os.sep + "reference" + os.sep in f], ids=os.path.basename
)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "matchering_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "os", "concurrent", "typing", "numpy", "scipy"}


def test_the_walk_sees_an_import_of_the_port():
    assert "matchering_tpu_torch" in top_level_imports(os.path.join(harness.HERE, "harness.py"))
    assert "matchering_tpu" not in top_level_imports(os.path.join(harness.HERE, "harness.py"))


def test_the_harness_names_a_loaded_jax_package(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "matchering_tpu.ops", types.ModuleType("matchering_tpu.ops"))
    assert "matchering_tpu" in harness.forbidden_modules()
    monkeypatch.delitem(sys.modules, "matchering_tpu.ops")
    assert "matchering_tpu" not in harness.forbidden_modules()
