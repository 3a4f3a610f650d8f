"""The port's public surface against the JAX package's.

Every module of ``matchering_tpu`` is read with ``ast`` (nothing of JAX is
imported): each public top-level function and class (no leading ``_``)
must have a callable of the same name in the port's module of the same
path.  The JAX package's ``ops/pallas_envelope.py`` (K1) is the port's
``kernels/envelope.py``.  The only names without a counterpart are those
of ``NOT_PORTED``, each with its reason.  The ``__all__`` of the port's
``ops`` and ``parallel`` packages must hold every name of the JAX
package's.
"""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PACKAGE = ROOT / "matchering_tpu"

# JAX module (dotted, below the package) -> the port's module of another path
RENAMED = {"ops.pallas_envelope": "kernels.envelope"}

_XLA_CACHE = (
    "touches only the XLA compiler's persistent cache; the port compiles its "
    "kernels with nvcc into the source-hashed kernels/_build cache"
)
NOT_PORTED = {
    ("utils", "enable_compile_cache"): _XLA_CACHE,
    ("utils", "ensure_compile_cache"): _XLA_CACHE,
    ("utils", "enable_pallas_vmem_headroom"): (
        "raises the TPU's scoped-VMEM limit for XLA's Pallas kernels; the card "
        "has no such budget to set"
    ),
    ("ops.pallas_envelope", "fits_pallas"): (
        "the TPU's scoped-VMEM fit test for K1; K1's counterpart check on the "
        "card is kernels/envelope.check_window"
    ),
}


def _jax_modules():
    modules = []
    for path in sorted(JAX_PACKAGE.rglob("*.py")):
        parts = path.relative_to(JAX_PACKAGE).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        modules.append(".".join(parts))
    return modules


def _module_path(dotted: str) -> pathlib.Path:
    base = JAX_PACKAGE.joinpath(*dotted.split(".")) if dotted else JAX_PACKAGE
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def _public(dotted: str):
    """The public top-level functions and classes of a JAX module."""
    tree = ast.parse(_module_path(dotted).read_text())
    kinds = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    return [node.name for node in tree.body if isinstance(node, kinds) and not node.name.startswith("_")]


def _dunder_all(dotted: str):
    tree = ast.parse(_module_path(dotted).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"matchering_tpu.{dotted} has no __all__")


def _port_module(dotted: str):
    dotted = RENAMED.get(dotted, dotted)
    return importlib.import_module("matchering_tpu_torch" + ("." + dotted if dotted else ""))


@pytest.mark.parametrize("dotted", _jax_modules())
def test_every_public_function_and_class_has_its_counterpart(dotted):
    port = _port_module(dotted)
    missing = [
        name
        for name in _public(dotted)
        if (dotted, name) not in NOT_PORTED and not callable(getattr(port, name, None))
    ]
    assert not missing, f"{port.__name__} lacks the counterparts of matchering_tpu.{dotted}: {missing}"


def test_the_names_left_out_are_real_and_absent():
    """Each name of NOT_PORTED is a public function of its JAX module that
    the port indeed leaves out, with a reason."""
    for (dotted, name), reason in NOT_PORTED.items():
        assert name in _public(dotted)
        assert not hasattr(_port_module(dotted), name)
        assert reason


@pytest.mark.parametrize("dotted", ["ops", "parallel"])
def test_package_all_holds_the_jax_names(dotted):
    port = _port_module(dotted)
    missing = sorted(set(_dunder_all(dotted)) - set(port.__all__))
    assert not missing, f"{port.__name__}.__all__ lacks {missing}"
    for name in port.__all__:
        assert hasattr(port, name), name
