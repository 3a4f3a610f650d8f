"""The JAX package's call forms, by value, on the port.

``tests/test_torch_surface.py`` holds every public name and signature of
``matchering_tpu`` to its counterpart in the port; this file holds the
values.  Each public function and class it walks has one of:

* a ``CASES`` entry: example arguments built with numpy from a seed, in
  the form the JAX package or its own tests pass them (ints, numpy ints,
  0-d arrays, host arrays, keywords, defaults).  The JAX function and the
  port's take the same arguments at float64 on the CPU (a host array goes
  to the port as a CPU tensor) and their values are compared: 1e-12
  relative to the reference's largest magnitude for the ops, the JAX
  package's own tolerances where its tests state them
  (``tests/test_batch_lengths.py``: rtol 1e-12 for piece RMS, rtol 1e-10
  with atol 1e-13 for the dynamic spectrum), and >= 200 dB for
  ``master_graph`` as in ``tests/test_torch_pipeline.py``;
* a ``HELD`` entry: the test of another file that calls it in the JAX
  form already (``test_torch_public_ops.py`` and the like);
* an ``ALLOWED`` entry: a name that needs no call, with its reason;
* or an entry of the surface test's ``NOT_PORTED``.

The walk fails when a public name has none of these.  The cases of
functions whose JAX twin computes on the device run a second time with
their host arrays passed as numpy arrays: the port stages them on the
card (``utils.stage_host_arrays``), so without one it raises
``resolve_device``'s error, and never runs them on the CPU.

No JAX call here compiles a whole graph: ``master_graph`` runs op by op
on tracks of at most 3 s, never the jitted ``master``; the ops and the
limiter run through ``jax.jit`` with their non-array arguments static.
"""

import ast
import dataclasses
import importlib
import pathlib
from typing import Any, Callable, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matchering_tpu as mj
from matchering_tpu_torch import state
from matchering_tpu_torch.utils import RowInts
from test_torch_surface import NOT_PORTED, _jax_modules, _port_module, _public

TESTS = pathlib.Path(__file__).resolve().parent
SR = 44100
ATTACK = 44  # Config().limiter.attack at 44.1 kHz, in samples
RECOMPUTE_SPAN = 4 * 45 - 2  # 4 * make_odd(ATTACK) - 2: the JAX length form's floor
_N = 8192  # one length for the scans and the limiter cases, so they share compiled programs


# ---------------------------------------------------------------------------
# Argument leaves: one value, as each package takes it


class Zero(NamedTuple):
    """A 0-d array: ``jnp.asarray`` for JAX, ``torch.tensor`` for the port."""

    value: Any


class Both(NamedTuple):
    """A value of each package's own type (a Config, a log code)."""

    jax: Any
    port: Any


def _for_jax(x, host=False):
    """JAX's argument: a host array as a JAX array, or left a numpy array
    with ``host`` (where the JAX function takes numpy arrays)."""
    if isinstance(x, np.ndarray):
        return x if host else jnp.asarray(x)
    if isinstance(x, Zero):
        return jnp.asarray(x.value)
    if isinstance(x, Both):
        return x.jax
    if isinstance(x, (tuple, list)):
        return type(x)(_for_jax(v, host) for v in x)
    if isinstance(x, dict):
        return {k: _for_jax(v, host) for k, v in x.items()}
    return x


def _for_port(x, host=False):
    """The port's argument: a host array as a CPU tensor, or left a numpy
    array with ``host``."""
    if isinstance(x, np.ndarray):
        return x.copy() if host else torch.from_numpy(x.copy())
    if isinstance(x, Zero):
        return np.asarray(x.value) if host else torch.as_tensor(np.asarray(x.value))
    if isinstance(x, Both):
        return x.port
    if isinstance(x, (tuple, list)):
        return type(x)(_for_port(v, host) for v in x)
    if isinstance(x, dict):
        return {k: _for_port(v, host) for k, v in x.items()}
    return x


def _has_host_array(x) -> bool:
    if isinstance(x, np.ndarray):
        return x.ndim > 0
    if isinstance(x, (tuple, list)):
        return any(_has_host_array(v) for v in x)
    if isinstance(x, dict):
        return any(_has_host_array(v) for v in x.values())
    return False


def _values(x):
    """Outputs as numpy arrays and plain values, the same tree for both."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (jnp.ndarray, np.ndarray, np.generic)):
        return np.asarray(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _values(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _values(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _values(v) for k, v in zip(x._fields, x)}
    if isinstance(x, (tuple, list)):
        return [_values(v) for v in x]
    if hasattr(x, "name") and hasattr(x, "value"):  # an enum member
        return (x.name, x.value)
    if type(x).__module__.startswith(("matchering_tpu.", "matchering_tpu_torch.")):
        return {"class": type(x).__name__, **_values(vars(x))}
    return x


# ---------------------------------------------------------------------------
# Comparisons


def _pairs(port, reference, path=""):
    """(path, port leaf, reference leaf) over two value trees of one shape."""
    if isinstance(reference, dict):
        assert isinstance(port, dict) and set(port) == set(reference), (path, port, reference)
        for k in reference:
            yield from _pairs(port[k], reference[k], f"{path}.{k}")
    elif isinstance(reference, list):
        assert isinstance(port, list) and len(port) == len(reference), path
        for i, (p, r) in enumerate(zip(port, reference)):
            yield from _pairs(p, r, f"{path}[{i}]")
    else:
        yield path, port, reference


def relative(rtol=1e-12):
    """Every array within ``rtol`` of the reference's largest magnitude;
    every other value equal."""

    def check(port, reference):
        for path, p, r in _pairs(port, reference):
            if isinstance(r, np.ndarray) and r.dtype.kind in "fc":
                p = np.asarray(p)
                assert p.shape == r.shape, (path, p.shape, r.shape)
                scale = max(float(np.max(np.abs(r), initial=0.0)), 1e-300)
                err = float(np.max(np.abs(p - r), initial=0.0)) / scale
                assert err <= rtol, (path, err)
            elif isinstance(r, np.ndarray):
                np.testing.assert_array_equal(p, r, err_msg=path)
            elif isinstance(r, float):
                assert abs(p - r) <= rtol * max(abs(r), 1e-300), (path, p, r)
            else:
                assert p == r, (path, p, r)

    return check


def allclose(rtol, atol=0.0):
    def check(port, reference):
        for path, p, r in _pairs(port, reference):
            np.testing.assert_allclose(np.asarray(p), np.asarray(r), rtol=rtol, atol=atol, err_msg=path)

    return check


def valid_pieces(rtol):
    """``(rmses, valid)``: ``valid`` equal, and the RMSes it flags within
    ``rtol`` (the others are meaningless in both packages)."""

    def check(port, reference):
        (rmses, valid), (want_rmses, want_valid) = port, reference
        np.testing.assert_array_equal(valid, want_valid)
        keep = want_valid > 0
        np.testing.assert_allclose(rmses[keep], want_rmses[keep], rtol=rtol)

    return check


def absolute(atol):
    def check(port, reference):
        for path, p, r in _pairs(port, reference):
            p, r = np.asarray(p), np.asarray(r)
            assert p.shape == r.shape, path
            assert float(np.max(np.abs(p - r), initial=0.0)) <= atol, path

    return check


def snr_at_least(db):
    def check(port, reference):
        for path, p, r in _pairs(port, reference):
            if r is None:
                assert p is None, path
                continue
            p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
            assert p.shape == r.shape, (path, p.shape, r.shape)
            err = np.sum((p - r) ** 2)
            measured = np.inf if err == 0 else 10 * np.log10(np.sum(r**2) / err)
            assert measured >= db, (path, measured)

    return check


def same_form(port, reference):
    """Random strings: the same length, and for a file name the same
    prefix and extension."""
    assert isinstance(port, str) and len(port) == len(reference)
    if "." in reference:
        assert port.split("-")[0] == reference.split("-")[0]
        assert port.split(".")[-1] == reference.split(".")[-1]


# ---------------------------------------------------------------------------
# The table


class Case(NamedTuple):
    build: Callable[[np.random.RandomState], tuple]  # rng -> (args, kwargs)
    check: Callable = relative()
    on_device: bool = True  # JAX computes on its device: the host-array rule applies
    host_inputs: bool = False  # the JAX function takes numpy arrays: both get them
    port_kwargs: Optional[Dict[str, Any]] = None  # keywords only the port takes (device=)
    label: str = ""
    reference: Optional[Callable] = None  # computes JAX's values from JAX's (args, kwargs)


def _call(dotted, name, args, kwargs, compiled):
    """The JAX function on ``args``; ``compiled``: through ``jax.jit`` with
    every argument that is not a JAX array static (one XLA program, where
    op-by-op dispatch compiles each primitive of a scan on its own)."""
    fn = getattr(importlib.import_module("matchering_tpu." + dotted), name)
    if not compiled:
        return fn(*args, **kwargs)
    # a numpy scalar is the same static value as the Python scalar
    args = tuple(a.item() if isinstance(a, np.generic) else a for a in args)
    kwargs = {k: v.item() if isinstance(v, np.generic) else v for k, v in kwargs.items()}
    static = tuple(i for i, a in enumerate(args) if not isinstance(a, jax.Array))
    names = tuple(k for k, v in kwargs.items() if not isinstance(v, jax.Array))
    key = (dotted, name, static, names)
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(fn, static_argnums=static, static_argnames=names)
    return _COMPILED[key](*args, **kwargs)


_COMPILED = {}


CASES: Dict[tuple, list] = {}


def case(dotted, name, build, **options):
    CASES.setdefault((dotted, name), []).append(Case(build, **options))


def stereo(r, n, gain=0.5):
    return r.randn(n, 2) * gain


def loud(r, n):
    return np.clip(r.randn(n, 2) * 0.9, -1.6, 1.6)


def padded(r, length, n, gain=0.9):
    x = np.zeros((n, 2))
    x[:length] = r.randn(length, 2) * gain
    return x


def config64(**kwargs):
    jconfig = mj.Config(dtype="float64", **kwargs)
    return Both(jconfig, state.config_from_dict(dataclasses.asdict(jconfig)))


def first_order(kind):
    from matchering_tpu.ops import iir as jiir
    from matchering_tpu_torch.ops import iir

    args = {"attack": (-2.0, ATTACK), "release": (800.0 / 3000.0, SR)}[kind]
    make = "one_pole_filter" if kind == "attack" else "butter1_coefficients"
    return Both(getattr(jiir, make)(*args), getattr(iir, make)(*args))


def code(name):
    from matchering_tpu.log.codes import Code as JCode
    from matchering_tpu_torch.log.codes import Code

    return Both(JCode[name], Code[name])


def results(*files):
    import matchering_tpu_torch as mt

    return Both([mj.pcm16(f) for f in files], [mt.pcm16(f) for f in files])


# --- utils, config, results, log -------------------------------------------

case("utils", "get_temp_folder", lambda r: ((results("masters/a.wav", "previews/b.wav"),), {}), on_device=False)
case("utils", "random_str", lambda r: ((), {}), check=same_form, on_device=False)
case("utils", "random_str", lambda r: ((8,), {}), check=same_form, on_device=False)
case("utils", "random_file", lambda r: ((), {"prefix": "preview", "extension": "flac"}), check=same_form, on_device=False)
case("utils", "to_db", lambda r: ((0.37,), {}), on_device=False)
case("utils", "ms_to_samples", lambda r: ((1.0, SR), {}), on_device=False)
case("utils", "ms_to_samples", lambda r: ((np.float64(3000.0), np.int64(48000)), {}), on_device=False)
case("utils", "make_odd", lambda r: ((44,), {}), on_device=False)
case("utils", "make_odd", lambda r: ((np.int64(45),), {}), on_device=False)
case("utils", "time_str", lambda r: ((3 * 3600 * SR + 17, SR), {}), on_device=False)
case("config", "Config", lambda r: ((), {}), on_device=False)
case("config", "Config", lambda r: ((), {"dtype": "float64", "fft_size": 1024, "length_bucketing": 1 << 18}), on_device=False)
case("config", "LimiterConfig", lambda r: ((), {"attack": 2.0, "release_filter_order": 2}), on_device=False)
case("results", "Result", lambda r: (("out.flac", "PCM_24"), {"use_limiter": False}), on_device=False)
for _name in ("pcm16", "pcm24", "pcm32f"):
    case("results", _name, lambda r: (("out.wav",), {}), on_device=False)
case("farm", "PairJob", lambda r: (("t.wav", "r.wav"), {}), on_device=False)
case("log.explanations", "explain", lambda r: ((code("ERROR_TARGET_EQUALS_REFERENCE"),), {}), on_device=False)
case("log.explanations", "explain_with_code", lambda r: ((code("WARNING_TARGET_IS_CLIPPING"),), {}), on_device=False)

# --- io.pcm: host codecs in both packages ---------------------------------

def _pcm_bytes(kind):
    """Six frames of raw samples of ``kind``, made from the seed."""

    def build(r):
        if kind in ("float", "double"):
            return r.randn(6).astype("<f4" if kind == "float" else "<f8").tobytes()
        width = {"pcm16": 2, "pcm24": 3, "pcm32": 4}.get(kind, 1)
        return r.randint(0, 256, 6 * width, dtype=np.uint8).tobytes()

    return build


for _kind in ("pcm16", "pcm24", "pcm32", "float", "double", "ulaw", "alaw"):
    for _name in [f"decode_{_kind}"] + ([f"decode_{_kind}_raw"] if _kind.startswith("pcm") else []):
        case("io.pcm", _name, lambda r, b=_pcm_bytes(_kind): ((b(r),), {}), on_device=False, host_inputs=True)
    case(
        "io.pcm", f"encode_{_kind}",
        lambda r: ((np.clip(r.randn(50, 2) * 0.7, -1.0, 1.0),), {"big_endian": True}),
        on_device=False, host_inputs=True,
    )

# --- ops.basics ------------------------------------------------------------

case("ops.basics", "lr_to_ms", lambda r: ((stereo(r, 300),), {}))
case("ops.basics", "ms_to_lr", lambda r: ((r.randn(300), r.randn(300)), {}))
case("ops.basics", "mono_to_stereo", lambda r: ((r.randn(300, 1),), {}))
case("ops.basics", "amplify", lambda r: ((stereo(r, 300), 0.37), {}))
case("ops.basics", "amplify", lambda r: ((stereo(r, 300), Zero(0.37)), {}))
case("ops.basics", "clip", lambda r: ((stereo(r, 300, 2.0),), {}))
case("ops.basics", "clip", lambda r: ((stereo(r, 300, 2.0),), {"to": 0.8}))
case("ops.basics", "flip", lambda r: ((r.rand(300),), {}))
case("ops.basics", "max_mix", lambda r: ((r.rand(300), r.rand(300), r.rand(300)), {}))
case("ops.basics", "rectify", lambda r: ((stereo(r, 300, 2.0), 0.998), {}))
case("ops.basics", "normalize", lambda r: ((stereo(r, 300, 2.0), 0.998, 1e-6, True), {}))
case("ops.basics", "normalize", lambda r: ((stereo(r, 300, 2.0), 0.998, 1e-6), {"normalize_clipped": False}))
case("ops.basics", "fade", lambda r: ((stereo(r, 300), 40), {}))
case("ops.basics", "rms", lambda r: ((r.randn(300),), {}))
case("ops.basics", "unfold", lambda r: ((r.randn(4321), 700, 6), {}))
case("ops.basics", "batch_rms", lambda r: ((r.randn(6, 700),), {}))
case("ops.basics", "piece_rms_flat", lambda r: ((r.randn(9000), 1500, 5), {}))
case("ops.basics", "piece_rms_flat", lambda r: ((r.randn(9000), np.int64(1500), np.int64(5)), {}))
# the JAX package's dynamic geometry: 0-d int32 piece size and division count
# on a zero-padded channel (tests/test_batch_lengths.py:60-78)
_GEOMETRY = ((7001, 3), (4000, 2))  # (piece_size, divisions) of two true lengths
for _piece, _div in _GEOMETRY:
    case(
        "ops.basics", "piece_rms_dynamic",
        lambda r, p=_piece, d=_div: (
            (np.concatenate([r.randn(p * d + 123), np.zeros(30000 - p * d - 123)]),
             Zero(np.int32(p)), Zero(np.int32(d)), 5),
            {},
        ),
        check=valid_pieces(1e-12), label=f"0-d piece {_piece}",
    )
    case(
        "ops.basics", "piece_rms_dynamic",
        lambda r, p=_piece, d=_div: ((np.concatenate([r.randn(p * d), np.zeros(9000)]), p, np.int64(d), 5), {}),
        check=valid_pieces(1e-12), label=f"int piece {_piece}",
    )
case("ops.basics", "masked_rms", lambda r: ((r.rand(6), np.array([1.0, 0, 1, 1, 0, 1])), {}))
case("ops.basics", "loudest_piece_stats", lambda r: ((r.rand(6),), {}))
case(
    "ops.basics", "loudest_piece_stats_masked",
    lambda r: ((r.rand(5), np.array([1.0, 1, 1, 0, 0]), Zero(np.int32(3))), {}),
)
case("ops.basics", "loudest_piece_stats_masked", lambda r: ((r.rand(5), np.array([1.0, 1, 1, 1, 0]), 4), {}))
case("ops.basics", "pcm_int_scale", lambda r: ((np.dtype(np.int16),), {}), on_device=False)
case("ops.basics", "pcm_int_scale", lambda r: ((np.dtype(np.int32),), {}), on_device=False)
case("ops.basics", "to_working_float", lambda r: ((r.randint(-32768, 32767, (300, 2)).astype(np.int16), np.dtype("float64")), {}))
case("ops.basics", "to_working_float", lambda r: ((stereo(r, 300), "float64"), {}))
case("ops.basics", "count_max_peaks", lambda r: ((np.clip(stereo(r, 3000, 2.0), -1.0, 1.0),), {}))

# --- ops.blocks, convolve, fftpack, fir -------------------------------------

case("ops.blocks", "overlapping_blocks", lambda r: ((r.randn(1200, 2), 7, 128, 300), {}))
case("ops.convolve", "fft_convolve_same", lambda r: ((r.randn(5000), r.randn(257)), {}))
case("ops.convolve", "fft_convolve_same", lambda r: ((r.randn(60000), r.randn(257)), {"block_fft": 1 << 12}))
case("ops.convolve", "fft_convolve_same_batch", lambda r: ((r.randn(4, 5000), r.randn(4, 257)), {}))
case("ops.convolve", "fft_convolve_same_batch", lambda r: ((r.randn(2, 60000), r.randn(2, 257), 1 << 12), {}))
case("ops.fftpack", "irfft", lambda r: ((r.randn(3, 129) + 1j * r.randn(3, 129), 256), {}))
case("ops.fftpack", "irfft", lambda r: ((r.randn(129, 3) + 1j * r.randn(129, 3), 256), {"axis": 0}))
case("ops.fftpack", "four_step_fft", lambda r: ((r.randn(2, 4096), r.randn(2, 4096)), {}))
case("ops.fftpack", "four_step_fft", lambda r: ((r.randn(2, 4096), r.randn(2, 4096)), {"inverse": True}))
case("ops.fir", "hann_symmetric", lambda r: ((1024, np.float64), {}), on_device=False, port_kwargs={"device": "cpu"})
case("ops.fir", "fir_from_magnitude", lambda r: ((r.rand(513) + 0.5, 1024), {}))

# --- ops.iir ---------------------------------------------------------------

case("ops.iir", "FirstOrderFilter", lambda r: ((0.25, 0.25, -0.5), {}), on_device=False)
case("ops.iir", "one_pole_filter", lambda r: ((-2.0, ATTACK), {}), on_device=False)
case("ops.iir", "one_pole_filter", lambda r: ((-2.0, np.int64(ATTACK)), {}), on_device=False)
case("ops.iir", "butter1_coefficients", lambda r: ((7.0, SR), {}), on_device=False)
case("ops.iir", "butter_coefficients", lambda r: ((1, 7.0, SR), {}), on_device=False)
case("ops.iir", "butter_coefficients", lambda r: ((2, 800.0 / 3000.0, SR), {}), on_device=False)
case("ops.iir", "scan_first_order", lambda r: ((r.randn(_N), 0.9999), {}))
case("ops.iir", "scan_first_order", lambda r: ((r.randn(_N), Zero(0.9999)), {}))
case("ops.iir", "block_scan_summary", lambda r: ((r.randn(_N), Zero(0.93)), {}))
case("ops.iir", "lfilter_first_order", lambda r: ((first_order("release"), r.rand(_N)), {}))
case("ops.iir", "lfilter_first_order", lambda r: ((first_order("release"), r.rand(_N), 0.25), {}))
case("ops.iir", "lfilter_first_order", lambda r: ((first_order("attack"), r.rand(_N)), {"zi": Zero(0.5)}))
case("ops.iir", "filtfilt_first_order", lambda r: ((first_order("attack"), r.rand(_N)), {}))
for _form in (3000, np.int64(3000), Zero(np.int32(7))):
    case(
        "ops.iir", "filtfilt_first_order_truncated",
        lambda r, L=_form: ((first_order("attack"), np.concatenate([r.rand(3000), np.zeros(_N - 3000)]), L), {}),
        label=type(_form).__name__,
    )
case("ops.iir", "butter_lowpass", lambda r: ((1, 7.0, SR, r.rand(_N)), {}))
case("ops.iir", "lfilter", lambda r: (((0.3, 0.2), (1.0, -0.5), r.randn(_N)), {}))
case("ops.iir", "lfilter", lambda r: (((0.5, 0.5), (2.0, -0.5), r.randn(_N)), {}))

# --- ops.lowess, resample, smoothing ----------------------------------------

case("ops.lowess", "plan_lowess", lambda r: ((400, 0.0375, 0.001), {}), on_device=False)
case("ops.lowess", "linear_operator", lambda r: ((400, 0.0375, 0.001), {}), on_device=False)
case("ops.lowess", "smooth", lambda r: ((r.rand(400), 0.0375), {}))
case("ops.lowess", "smooth", lambda r: ((r.rand(400), 0.0375, 1, 0.001), {}))
case("ops.resample", "plan_resample", lambda r: ((48000, SR), {}), on_device=False)
case("ops.resample", "resample", lambda r: ((r.randn(4800, 2) * 0.5, 48000, SR), {}))
case("ops.resample", "resample", lambda r: ((r.randn(300), SR, SR), {}))
case("ops.smoothing", "interpolation_operators", lambda r: ((SR, 1024, 4), {}), on_device=False)
case(
    "ops.smoothing", "smooth_exponentially",
    lambda r: ((r.rand(513) + 0.5, SR, 1024, 4, 0.0375, 0, 0.001), {}),
)

# --- ops.sliding -----------------------------------------------------------

case("ops.sliding", "max_filter1d", lambda r: ((r.rand(3000), 89), {}))
case("ops.sliding", "sliding_max_attack", lambda r: ((r.rand(3000), ATTACK), {}))
case("ops.sliding", "sliding_max_hold", lambda r: ((r.rand(3000), ATTACK), {}))
def _int(length):
    return int(np.asarray(length.value if isinstance(length, Zero) else length))


for _form in (2000, np.int64(RECOMPUTE_SPAN), Zero(np.int32(2999)), Zero(np.int64(3000))):
    case(
        "ops.sliding", "sliding_max_attack_truncated",
        lambda r, L=_form: ((np.concatenate([r.rand(_int(L)), np.zeros(3000 - _int(L))]), ATTACK, L), {}),
        check=relative(0.0), label=type(_form).__name__,
    )

# --- ops.spectrum ----------------------------------------------------------

_MASK = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
case("ops.spectrum", "framed_magnitude_mean", lambda r: ((r.randn(6, 1000), 128), {}))
case("ops.spectrum", "masked_average_spectrum", lambda r: ((r.randn(6, 1000), _MASK, 128), {}))
case("ops.spectrum", "masked_average_spectrum_flat", lambda r: ((r.randn(6077), _MASK, 1000, 6, 128), {}))
case(
    "ops.spectrum", "masked_average_spectrum_flat_pair",
    lambda r: ((r.randn(6077), r.randn(6077), _MASK, 1000, 6, 128), {}),
)
# the JAX package's dynamic geometry (tests/test_batch_lengths.py:80-104):
# a 0-d int32 piece size, div_max and fpp_max from the padded length
_DYN_MASK = np.array([1.0, 0.0, 1.0, 0.0, 0.0])
for _piece in (3001, 100):  # whole frames in a piece; none
    case(
        "ops.spectrum", "masked_average_spectrum_dynamic",
        lambda r, p=_piece: ((np.concatenate([r.randn(3 * p), np.zeros(4000)]), _DYN_MASK, Zero(np.int32(p)), 5, 512, 7), {}),
        check=allclose(1e-10, 1e-13), label=f"piece {_piece}",
    )
    for _form in (Zero(np.int32(_piece)), _piece, np.int64(_piece)):
        case(
            "ops.spectrum", "masked_average_spectrum_dynamic_pair",
            lambda r, p=_piece, L=_form: (
                (np.concatenate([r.randn(3 * p), np.zeros(4000)]),
                 np.concatenate([r.randn(3 * p), np.zeros(4000)]), _DYN_MASK, L, 5, 512, 7),
                {},
            ),
            check=allclose(1e-10, 1e-13), label=f"{type(_form).__name__} piece {_piece}",
        )

# --- limiter ---------------------------------------------------------------


def _jax_limit(args, kwargs):
    """JAX's ``limit(array, config, length=None)`` through one ``jax.jit``,
    the length in any form passed as the int32 the graph's own division
    takes (``matchering_tpu/stages.py:76``), so one compiled limiter serves
    every form of a shape."""
    from matchering_tpu.limiter import limit as jlimit

    if "limit" not in _COMPILED:
        _COMPILED["limit"] = jax.jit(jlimit, static_argnums=1)
    length = kwargs.get("length")
    return _COMPILED["limit"](*args, length=None if length is None else jnp.asarray(length, jnp.int32))


case("limiter", "limit", lambda r: ((loud(r, _N), config64()), {}), check=absolute(1e-12), reference=_jax_limit)
for _form in (5000, np.int64(5000), Zero(np.int32(RECOMPUTE_SPAN))):
    case(
        "limiter", "limit",
        lambda r, L=_form: (
            (padded(r, _int(L), _N, 1.2), config64()),
            {"length": L},
        ),
        check=absolute(1e-12), label=f"length {type(_form).__name__}", reference=_jax_limit,
    )

# --- stages: the graph on a zero-padded pair ----------------------------------

_T_LEN, _R_LEN, _PAD = int(2.5 * SR), int(2.8 * SR), 3 * SR


def _graph_pair(r):
    return padded(r, _T_LEN, _PAD, 0.3), padded(r, _R_LEN, _PAD, 0.9)


def _jax_master_graph(args, kwargs):
    """JAX's ``master_graph``, op by op, with its last stage taken apart:
    the limited variant is ``limit(result_no_limiter, config,
    length=target_length) * final_amplitude_coefficient``, as the graph
    computes it, with the limiter through ``jax.jit`` (op by op its scans
    compile primitive by primitive, ~12 s on a CPU)."""
    from matchering_tpu import stages as jstages

    out = jstages.master_graph(*args, **dict(kwargs, need_default=False, need_no_limiter=True))
    limited = _jax_limit(
        (out.result_no_limiter, args[2]), {"length": kwargs.get("target_length")}
    ) * out.report["final_amplitude_coefficient"]
    return out._replace(
        result=limited if kwargs.get("need_default", True) else None,
        result_no_limiter=out.result_no_limiter if kwargs.get("need_no_limiter") else None,
    )


_GRAPH = dict(need_default=True, need_no_limiter=True, need_no_limiter_normalized=True)
_GRAPH_CONFIG = config64(max_piece_size=1, fft_size=1024)  # 3 pieces at 2.5 s
case("stages", "piece_division", lambda r: ((661500, 80000), {}), on_device=False)
case("stages", "piece_division", lambda r: ((np.int64(_T_LEN), 2 * SR), {}), on_device=False)
for _label, _lengths in (
    ("int", (_T_LEN, _R_LEN)),
    ("numpy int", (np.int64(_T_LEN), np.int32(_R_LEN))),
    ("0-d", (Zero(np.int32(_T_LEN)), Zero(np.int32(_R_LEN)))),
    ("target only", (_T_LEN, None)),
):
    case(
        "stages", "master_graph",
        lambda r, lengths=_lengths: (
            (*_graph_pair(r), _GRAPH_CONFIG),
            dict(_GRAPH, target_length=lengths[0], reference_length=lengths[1]),
        ),
        check=snr_at_least(200.0), label=_label, reference=_jax_master_graph,
    )

# --- checker, parallel.batch ------------------------------------------------

_CHECK = dict(host_inputs=True, port_kwargs={"device": "cpu"})
case("checker", "check", lambda r: ((stereo(r, 3 * SR), SR, config64(), "target"), {}), **_CHECK)
case("checker", "check", lambda r: ((r.randn(3 * SR, 1) * 0.3, SR, config64(), "reference"), {}), **_CHECK)
case("checker", "check_equality", lambda r: ((stereo(r, 300), stereo(r, 300)), {}), on_device=False, host_inputs=True)
case(
    "parallel.batch", "bucket_pad",
    lambda r: (([stereo(r, 3000), stereo(r, 5000)],), {"multiple": 1024}), **_CHECK,
)


# ---------------------------------------------------------------------------
# Names held by another test in the JAX form, and names that need no call

HELD = {
    ("__main__", "build_parser"): ("test_torch_cli.py", "test_parser_matches_jax"),
    ("__main__", "main"): ("test_torch_cli.py", "test_main_writes_what_process_writes"),
    ("core", "render_variants"): ("test_torch_public_ops.py", "test_render_variants"),
    ("core", "process"): ("test_torch_pipeline.py", "test_process_wav_matches_jax_within_one_lsb"),
    ("farm", "process_batch"): ("test_torch_farm.py", "test_process_batch_matches_jax"),
    ("ops.iir", "ds_pole_powers"): ("test_torch_public_ops.py", "test_ds_pole_powers"),
    # held to scipy's lfilter by the JAX package's own 180 dB gate: the port
    # splits a float64 scan where JAX carries double-single arithmetic
    ("ops.iir", "scan_first_order_ds"): ("test_torch_public_ops.py", "test_scan_first_order_ds"),
    ("ops.smoothing", "interpolation_operator_arrays"): ("test_torch_public_ops.py", "test_interpolation_operator_arrays"),
    ("ops.smoothing", "operator_arrays_for_config"): ("test_torch_public_ops.py", "test_operator_arrays_for_config"),
    ("preview", "create_preview"): ("test_torch_preview.py", "test_create_preview_matches_jax"),
    ("parallel.batch", "master_batch"): ("test_torch_batch.py", "test_master_batch_matches_jax"),
    ("parallel.batch", "master_pairs"): ("test_torch_farm.py", "test_master_pairs_round_robin_over_devices"),
    ("stages", "master"): ("test_torch_pipeline.py", "test_master_float64_matches_jax"),
    ("stages", "main"): ("test_torch_batch.py", "test_stages_main_takes_the_jax_call_form"),
    ("parallel.timeshard", "carried_scan"): ("test_torch_public_ops.py", "test_carried_scan"),
    ("parallel.timeshard", "sliding_max_attack_sharded"): ("test_torch_public_ops.py", "test_sliding_max_attack_sharded"),
    ("parallel.timeshard", "piece_rms_sharded_dynamic"): ("test_torch_public_ops.py", "test_piece_rms_sharded_dynamic"),
    ("parallel.timeshard", "masked_average_spectrum_sharded_dynamic"): (
        "test_torch_public_ops.py", "test_masked_average_spectrum_sharded_dynamic",
    ),
    ("parallel.timeshard", "limit_sharded"): ("test_torch_timeshard.py", "test_limit_sharded"),
    ("parallel.timeshard", "master_sharded"): ("test_torch_timeshard.py", "test_master_sharded_matches_jax"),
    ("parallel.timeshard", "master_farm"): ("test_torch_mesh.py", "test_master_farm_matches_jax"),
}

_CODEC = "a file codec: its bytes and round trips are held by test_torch_codecs.py and test_torch_io.py"
_SHARDED = (
    "a sharded op in the documented (parts, ..., grid) form (test_torch_surface.py's "
    "SIGNATURE_DIFFERS); test_torch_timeshard.py::test_sharded_op holds its values against "
    "the JAX op on the 8-device virtual mesh"
)
_LAUNCH = "spawns or joins worker processes; held by test_torch_launch.py's self-tests"
_LOG = "a log handler: it prints, held by the coded events of test_torch_pipeline.py"
ALLOWED = {
    **{("io.aiff", n): _CODEC for n in ("AiffFormatError", "read", "write")},
    **{("io.caf", n): _CODEC for n in ("CafFormatError", "is_caf", "read", "write")},
    **{("io.codecs", n): _CODEC for n in ("ffmpeg_available", "check_format", "is_lossy_container", "read", "write")},
    ("io.loader", "load"): _CODEC,
    **{("io.native.binding", n): _CODEC for n in ("available", "read_wav", "write_wav", "read_flac", "write_flac")},
    ("io.native.build", "build"): "builds the native codec library with g++; test_torch_codecs.py builds and loads it",
    **{("io.native.mp3", n): _CODEC for n in ("available", "write_available", "is_mp3", "read_mp3", "write_mp3")},
    **{("io.native.opus", n): _CODEC for n in ("available", "is_opus", "read_opus", "write_available", "write_opus")},
    **{("io.native.vorbis", n): _CODEC for n in ("available", "is_ogg", "read_ogg", "write_ogg")},
    ("io.saver", "save"): _CODEC,
    **{("io.w64", n): _CODEC for n in ("is_w64", "read", "write")},
    **{("io.wav", n): _CODEC for n in ("WavFormatError", "raw_decoder_for", "decoder_for", "read", "write")},
    ("log.codes", "Code"): "a constant: an enum of event codes; the explain cases read its members",
    ("log.exceptions", "ModuleError"): "an exception class",
    ("log.explanations", "get_explanation_handler"): _LOG,
    **{("log.handlers", n): _LOG for n in ("set_handlers", "warning", "info", "debug", "debug_line")},
    ("ops.lowess", "LowessPlan"): "a container of plan_lowess's fields, which its case compares",
    ("ops.resample", "ResamplePlan"): "a container of plan_resample's fields, which its case compares",
    ("ops.pallas_envelope", "limiter_front_end"): (
        "the Pallas kernel (K1 in the port): the JAX function runs only on the TPU; on the CPU the "
        "JAX suite reaches it through limit's XLA path, which the limit cases compare, and "
        "chip_smoke.py holds K1 against its plain twin on the card"
    ),
    ("stages", "MasterOutput"): "a container of master_graph's outputs, which its cases compare field by field",
    **{("parallel.timeshard", n): _SHARDED for n in (
        "convolve_same_sharded", "lfilter_first_order_sharded", "filtfilt_first_order_sharded",
        "sliding_max_hold_sharded", "piece_rms_sharded", "masked_average_spectrum_sharded",
        "global_peak", "filtfilt_first_order_sharded_truncated",
    )},
    **{("parallel.launch", n): _LAUNCH for n in (
        "initialize", "global_mesh", "local_pair_slice", "master_batch_distributed", "local_results",
        "master_farm_distributed", "agree_bucket", "run_selftest", "main",
    )},
    **{("parallel.mesh", n): (
        "builds a mesh of devices: a JAX Mesh and the port's grid of torch devices hold no common "
        "values; test_torch_mesh.py holds the layout"
    ) for n in ("make_mesh", "single_axis_mesh")},
}


def _public_names():
    return [(dotted, name) for dotted in _jax_modules() for name in _public(dotted)]


def test_every_public_name_is_walked():
    """Each public function and class of the JAX package has a case, a
    test that holds it, a reason, or no port; every entry names a real
    public function."""
    public = set(_public_names())
    covered = set(CASES) | set(HELD) | set(ALLOWED) | set(NOT_PORTED)
    missing = sorted(public - covered)
    assert not missing, f"public names with no case, held test or reason: {missing}"
    stale = sorted(covered - public)
    assert not stale, f"entries for names the JAX package does not have: {stale}"
    assert not set(CASES) & (set(HELD) | set(ALLOWED)), "a name with a case is neither held nor allowed"
    assert all(ALLOWED.values())


@pytest.mark.parametrize("key", sorted(HELD), ids=lambda k: ".".join(k))
def test_held_names_are_called_by_their_test(key):
    """The test a name points to exists and calls the name."""
    filename, function = HELD[key]
    tree = ast.parse((TESTS / filename).read_text())
    node = next((n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function), None)
    assert node is not None, f"{filename} has no {function}"
    called = {getattr(n, "attr", getattr(n, "id", None)) for n in ast.walk(tree)}
    assert key[1] in called, f"{filename} never names {key[1]}"


def _case_ids():
    ids = []
    for (dotted, name), cases in CASES.items():
        for i, c in enumerate(cases):
            ids.append(pytest.param(dotted, name, i, id=f"{dotted}.{name}[{c.label or i}]"))
    return ids


@pytest.mark.parametrize("dotted,name,index", _case_ids())
def test_jax_call_form_gives_jax_values(dotted, name, index):
    c = CASES[(dotted, name)][index]
    args, kwargs = c.build(np.random.RandomState(1234 + index))
    jax_args, jax_kwargs = _for_jax(args, c.host_inputs), _for_jax(kwargs, c.host_inputs)
    if c.reference is not None:
        want = c.reference(jax_args, jax_kwargs)
    else:
        want = _call(dotted, name, jax_args, jax_kwargs, c.on_device and not c.host_inputs)
    port = getattr(_port_module(dotted), name)
    got = port(*_for_port(args, c.host_inputs), **_for_port(kwargs, c.host_inputs), **(c.port_kwargs or {}))
    c.check(_values(got), _values(want))


def _takes_host_arrays(param) -> bool:
    dotted, name, index = param.values
    c = CASES[(dotted, name)][index]
    return c.on_device and _has_host_array(c.build(np.random.RandomState(0)))


def _leaves(x):
    if isinstance(x, dict):
        return [v for value in x.values() for v in _leaves(value)]
    if isinstance(x, (tuple, list)):
        return [v for value in x for v in _leaves(value)]
    return [x]


@pytest.mark.parametrize("dotted,name,index", [p for p in _case_ids() if _takes_host_arrays(p)])
def test_host_arrays_never_run_silently_on_the_cpu(dotted, name, index):
    """The same call with its host arrays left numpy arrays and no
    ``device=``: they are staged on the card, and without one the call
    raises ``resolve_device``'s error."""
    c = CASES[(dotted, name)][index]
    args, kwargs = c.build(np.random.RandomState(1234 + index))
    port = getattr(_port_module(dotted), name)
    if torch.cuda.is_available():
        out = port(*_for_port(args, host=True), **_for_port(kwargs, host=True))
        tensors = [v for v in _leaves(out) if isinstance(v, torch.Tensor)]
        assert tensors and all(v.device.type == "cuda" for v in tensors)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port(*_for_port(args, host=True), **_for_port(kwargs, host=True))


# ---------------------------------------------------------------------------
# The per-track length forms on the port: one code path, the one-row batch


def _loud_track(length, n, seed=7):
    return padded(np.random.RandomState(seed), length, n, 1.2)


def test_jax_limit_length_form_diverges_below_the_recompute_span():
    """The JAX package's own length form is off below 4 * make_odd(attack)
    - 2 samples (178 here): its tail recompute reads a window clamped to
    the track's start.  The port's int form follows ``limit(x[:L])``."""
    from matchering_tpu_torch.limiter import limit

    length = 150
    x = _loud_track(length, _N)
    jconfig = mj.Config(dtype="float64")
    config = state.config_from_dict(dataclasses.asdict(jconfig))
    whole = np.asarray(_jax_limit((jnp.asarray(x[:length]), jconfig), {}))
    jax_form = np.asarray(_jax_limit((jnp.asarray(x), jconfig), {"length": length}))[:length]
    assert np.max(np.abs(jax_form - whole)) > 0.1
    port_form = limit(torch.from_numpy(x), config, length=length).numpy()
    assert np.max(np.abs(port_form[:length] - whole)) <= 1e-12
    assert not port_form[length:].any()


@pytest.mark.parametrize("form", ["int", "numpy int", "0-d tensor", "0-d array", "list"])
def test_limit_length_forms_are_the_one_row_batch(form):
    """Every per-track length form of ``limit`` is the one-row batch with
    ``RowInts``, bit for bit; a length below the attack window or past the
    track raises, as the batched form does."""
    from matchering_tpu_torch.limiter import limit

    n, length = _N, 4321
    x = torch.from_numpy(_loud_track(length, n))
    config = state.config_from_dict(dataclasses.asdict(mj.Config(dtype="float64")))
    batched = limit(x[None], config, length=RowInts.of([length], "cpu"))[0]
    value = {
        "int": length, "numpy int": np.int64(length), "0-d tensor": torch.tensor(length),
        "0-d array": np.asarray(length), "list": [length],
    }[form]
    got = limit(x if form != "list" else x[None], config, length=value)
    assert torch.equal(got if form != "list" else got[0], batched)
    for wrong in (88, n + 1):  # the window is 89 samples
        with pytest.raises(ValueError, match="outside"):
            limit(x, config, length=wrong if form != "0-d tensor" else torch.tensor(wrong))


def test_sliding_max_attack_truncated_follows_the_whole_track_below_the_span():
    """Below 178 samples the JAX form's values before the length are off;
    the port's are the reference's max filter of ``x[:L]``, and past L
    the max filter of the track as given, as in the JAX package."""
    from scipy import ndimage

    from matchering_tpu_torch.ops import sliding

    length, n, window = 120, 1000, 2 * 45 - 1
    x = np.zeros(n)
    x[:length] = np.random.RandomState(3).rand(length)
    got = sliding.sliding_max_attack_truncated(torch.from_numpy(x), ATTACK, length).numpy()
    np.testing.assert_array_equal(got[:length], ndimage.maximum_filter1d(x[:length], window, mode="reflect"))
    np.testing.assert_array_equal(got[length:], ndimage.maximum_filter1d(x, window, mode="reflect")[length:])
    with pytest.raises(ValueError, match="outside"):
        sliding.sliding_max_attack_truncated(torch.from_numpy(x), ATTACK, 88)


@pytest.mark.parametrize("form", ["numpy int", "0-d tensor", "target only"])
def test_master_takes_the_length_forms(form):
    """``stages.master`` checks and stages every per-track length form as
    ``master_graph`` takes them: the same output as the one-row
    ``RowInts`` call."""
    from matchering_tpu_torch import stages

    r = np.random.RandomState(11)
    target, reference = padded(r, 20000, 24000, 0.3), padded(r, 22000, 24000, 0.9)
    config = state.config_from_dict(dataclasses.asdict(mj.Config(dtype="float64", fft_size=1024)))
    lengths = {
        "numpy int": (np.int64(20000), np.int32(22000)),
        "0-d tensor": (torch.tensor(20000), torch.tensor(22000)),
        "target only": (20000, None),
    }[form]
    got = stages.master(
        target, reference, config, True, True, False, *lengths, device="cpu"
    )
    want = stages.master_graph(
        torch.from_numpy(target), torch.from_numpy(reference), config, True, True, False,
        target_length=RowInts.of([20000], "cpu"),
        reference_length=None if lengths[1] is None else RowInts.of([22000], "cpu"),
    )
    for key in ("result", "result_no_limiter"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    with pytest.raises(ValueError, match="outside"):
        stages.master(target, reference, config, target_length=np.int64(24001), device="cpu")


def test_sharded_length_forms():
    """The sharded limiter and filtfilt take their length as an int, a
    numpy int or a 0-d tensor, with the same values."""
    from matchering_tpu_torch.ops import iir
    from matchering_tpu_torch.parallel import timeshard
    from test_torch_timeshard import GRID, SHARDS, shards, whole

    n = SHARDS * 4096
    length = n - 1234
    x = _loud_track(length, n)
    config = state.config_from_dict(dataclasses.asdict(mj.Config(dtype="float64")))
    want = whole(timeshard.limit_sharded(shards(x), config, GRID, length=length), n)
    smoother = iir.one_pole_filter(-2.0, ATTACK)
    want_ff = whole(timeshard.filtfilt_first_order_sharded_truncated(smoother, shards(x[:, 0]), length, GRID), n)
    for form in (np.int64(length), torch.tensor(length)):
        got = whole(timeshard.limit_sharded(shards(x), config, GRID, length=form), n)
        np.testing.assert_array_equal(got, want)
        got = whole(timeshard.filtfilt_first_order_sharded_truncated(smoother, shards(x[:, 0]), form, GRID), n)
        np.testing.assert_array_equal(got, want_ff)
