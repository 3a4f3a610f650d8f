"""The port's public surface against the JAX package's.

Every module of ``matchering_tpu`` is read with ``ast`` (nothing of JAX is
imported): each public top-level function and class (no leading ``_``)
must have a callable of the same name in the port's module of the same
path.  The JAX package's ``ops/pallas_envelope.py`` (K1) is the port's
``kernels/envelope.py``.  The only names without a counterpart are those
of ``NOT_PORTED``, each with its reason.  The ``__all__`` of the port's
``ops`` and ``parallel`` packages must hold every name of the JAX
package's.

Each counterpart also takes the JAX call forms: its signature (a class's
``__init__``, or its dataclass or NamedTuple fields) has JAX's positional
parameters at its head, in order and by name, every keyword of JAX's, a
default wherever JAX has one and on every parameter JAX lacks, ``device``
keyword-only, and ``*args``/``**kwargs`` where JAX has them.  The only
forms that differ are those of ``SIGNATURE_DIFFERS``, each with the names
it maps and its reason.
"""

import ast
import importlib
import inspect
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


_SHARDED = (
    "the sharded ops take one (R, block) tensor per device and the TimeGrid of "
    "their devices, where the JAX ops take the local shard under shard_map and "
    "the name of the mesh axis"
)
_SHARDED_NAMES = {"x_local": "parts", "array_local": "parts", "drive_local": "parts", "axis": "grid"}
_SHARDED_OPS = (
    "convolve_same_sharded",
    "carried_scan",
    "lfilter_first_order_sharded",
    "filtfilt_first_order_sharded",
    "filtfilt_first_order_sharded_truncated",
    "sliding_max_attack_sharded",
    "sliding_max_hold_sharded",
    "piece_rms_sharded",
    "piece_rms_sharded_dynamic",
    "masked_average_spectrum_sharded",
    "masked_average_spectrum_sharded_dynamic",
    "global_peak",
    "limit_sharded",
)
# (JAX module, name) -> (JAX parameter -> the port's, reason)
SIGNATURE_DIFFERS = {
    **{("parallel.timeshard", name): (_SHARDED_NAMES, _SHARDED) for name in _SHARDED_OPS},
    ("parallel.launch", "local_results"): (
        {"global_array": "local"},
        "takes the LocalOutput (output, global rows) of master_batch_distributed or "
        "master_farm_distributed and the variant to read: torch has no global array "
        "whose addressable shards a process could walk",
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


_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VARIADIC = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def _jax_signature(dotted: str, name: str):
    """(positional, keyword-only, *args, **kwargs) of a JAX function or
    class, each parameter as (name, has a default), read with ``ast``;
    None for a class with neither ``__init__`` nor annotated fields (an
    enum, an exception)."""
    tree = ast.parse(_module_path(dotted).read_text())
    node = next(n for n in tree.body if getattr(n, "name", None) == name)
    if isinstance(node, ast.ClassDef):
        init = [n for n in node.body if isinstance(n, ast.FunctionDef) and n.name == "__init__"]
        if not init:
            fields = [n for n in node.body if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]
            if not fields:
                return None
            return [(f.target.id, f.value is not None) for f in fields], [], False, False
        node = init[0]
    args = node.args
    positional = args.posonlyargs + args.args
    first_default = len(positional) - len(args.defaults)
    heads = [(a.arg, i >= first_default) for i, a in enumerate(positional)]
    if isinstance(node, ast.FunctionDef) and node.name == "__init__":
        heads = heads[1:]  # self
    keywords = [(a.arg, d is not None) for a, d in zip(args.kwonlyargs, args.kw_defaults)]
    return heads, keywords, args.vararg is not None, args.kwarg is not None


def _signature_faults(dotted: str, name: str, renames=None):
    """How the port's counterpart fails to take the JAX call forms, with
    the JAX parameters renamed by ``renames`` first."""
    jax_sig = _jax_signature(dotted, name)
    if jax_sig is None:
        return []
    renames = renames or {}
    heads, keywords, varargs, kwargs = jax_sig
    heads = [(renames.get(n, n), d) for n, d in heads]
    keywords = [(renames.get(n, n), d) for n, d in keywords]
    params = inspect.signature(getattr(_port_module(dotted), name)).parameters
    positional = [p.name for p in params.values() if p.kind in _POSITIONAL]
    faults = []
    if positional[: len(heads)] != [n for n, _ in heads]:
        faults.append(f"positional parameters {positional}, JAX's {[n for n, _ in heads]} first")
    for n, has_default in heads + keywords:
        p = params.get(n)
        if p is None or ((n, has_default) in keywords and p.kind == inspect.Parameter.POSITIONAL_ONLY):
            faults.append(f"no keyword {n!r}")
        elif has_default and p.default is inspect.Parameter.empty:
            faults.append(f"{n!r} is required, JAX's has a default")
    jax_names = {n for n, _ in heads + keywords}
    for p in params.values():
        if p.kind in _VARIADIC:
            continue
        if p.name not in jax_names and p.default is inspect.Parameter.empty:
            faults.append(f"{p.name!r} is required and JAX has no such parameter")
        if p.name == "device" and p.kind != inspect.Parameter.KEYWORD_ONLY:
            faults.append("'device' is not keyword-only")
    kinds = {p.kind for p in params.values()}
    if varargs and inspect.Parameter.VAR_POSITIONAL not in kinds:
        faults.append("no *args")
    if kwargs and inspect.Parameter.VAR_KEYWORD not in kinds:
        faults.append("no **kwargs")
    return faults


@pytest.mark.parametrize("dotted", _jax_modules())
def test_every_public_signature_takes_the_jax_call_forms(dotted):
    faults = {
        name: _signature_faults(dotted, name, SIGNATURE_DIFFERS.get((dotted, name), ({}, ""))[0])
        for name in _public(dotted)
        if (dotted, name) not in NOT_PORTED
    }
    faults = {name: f for name, f in faults.items() if f}
    assert not faults, f"the port's counterparts of matchering_tpu.{dotted} refuse JAX's call forms: {faults}"


def test_the_signatures_that_differ_are_real():
    """Each entry of SIGNATURE_DIFFERS is a public function of its JAX
    module whose port takes another form, with a reason: JAX's names
    alone fail the check, every renamed parameter is JAX's and the
    port's, and the renamed form passes."""
    for (dotted, name), (renames, reason) in SIGNATURE_DIFFERS.items():
        assert name in _public(dotted) and reason
        assert _signature_faults(dotted, name), (dotted, name)
        heads, keywords, _, _ = _jax_signature(dotted, name)
        jax_names = {n for n, _ in heads + keywords}
        port_names = set(inspect.signature(getattr(_port_module(dotted), name)).parameters)
        used = {old: new for old, new in renames.items() if old in jax_names}
        assert used, (dotted, name)
        assert set(used.values()) <= port_names, (dotted, name)
        assert not _signature_faults(dotted, name, renames), (dotted, name)
