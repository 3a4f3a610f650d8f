"""Every class of input the loader and checker admit, held to the JAX package.

``tests/test_torch_config_walk.py`` walks the configuration space; this
file walks the input space.  ``INPUT_CLASSES`` names each class: the two
tracks it writes from a numpy seed (``matchering_tpu.io.codecs.write``),
the role it changes, the ``Config`` fields it needs, and its outcome:

* ``FILE``: both packages write the result; the port's PCM_16 file, and
  its previews where the class asks for them, within one PCM_16 step of
  the JAX package's;
* ``JAX_FAULT``: the JAX package's float32 result is off the reference,
  below its own 95 dB gate (a mono target, a pure tone: its packed
  convolution leaks the mid's rounding into the side, ROADMAP queue 3
  item 8); the port's file is held to the JAX package's float64 ``master``
  exported at PCM_16 instead, and its float32 ``master`` to the class's
  gate against that master (120 dB for the mono target).  A mono target's
  side stays exactly 0 in the port;
* ``SILENT_MID``: R = -L, whose mid is exactly 0; the reference's RMS
  correction then multiplies by ``reference_match_rms / min_value`` at
  every step (ROADMAP queue 3 item 9).  The port's float64 steps are held
  to that algebra, and no file is compared;
* ``RAISES``: both packages raise the class's ``ModuleError`` code and
  write no file.

Every class's info and warning codes equal the JAX package's, in order,
and include the class's own codes.  Every result-bearing class but
``SILENT_MID`` passes the float32 gate: the port's float32 ``master`` of
the decoded pair at 95 dB or above against the JAX package's float64
``master``.  Each ``Code`` that ``process()`` can emit has a class that
emits it, a pointer to the test that does (``POINTERS``) or a reason
(``REASONS``).  Then the same classes through ``process_batch`` (both
dispatches), the command line and ``master_sharded``; the JAX package's
faults, pinned; and a float32 limit both packages share (ROADMAP queue 3
item 10), pinned.
"""

import ast
import dataclasses
import functools
import os
import pathlib
import shutil
import tempfile
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

import matchering_tpu as mj
from matchering_tpu.io import codecs as jcodecs
from matchering_tpu.ops import convolve as jconvolve
import matchering_tpu_torch as mt
from matchering_tpu_torch import __main__ as cli
from matchering_tpu_torch.io import codecs
from matchering_tpu_torch.ops import convolve
from matchering_tpu_torch.parallel import mesh, timeshard

TESTS = pathlib.Path(__file__).resolve().parent
SR = 44100
SECONDS = 5
N = SECONDS * SR
FFT = mt.Config().fft_size
LSB = 1  # PCM_16 codes
GATE_DB = 95.0  # the JAX package's float32 gate (tests/test_dtype_gates.py)
PORT_GATE_DB = 120.0  # where the JAX package is at fault, the port's float32 against the float64 master
ALGEBRA_RTOL = 1e-12
ULP = 2.0**-23  # one float32 ulp at 1.0
SHARDS = 4

FILE, JAX_FAULT, SILENT_MID, RAISES = "file", "jax fault", "silent mid", "raises"
C = mt.Code
PROGRESS = (C.INFO_LOADING, C.INFO_MATCHING_LEVELS, C.INFO_MATCHING_FREQS, C.INFO_CORRECTING_LEVELS,
            C.INFO_FINALIZING, C.INFO_EXPORTING, C.INFO_MAKING_PREVIEWS, C.INFO_COMPLETED)


@pytest.fixture(scope="module", autouse=True)
def folder(tmp_path_factory):
    """The module's files: each class's tracks, written once, and each
    package's outputs."""
    global FOLDER
    FOLDER = tmp_path_factory.mktemp("input_walk")
    yield FOLDER
    for cached in (_paths, run, decoded, jax_master, port_master, tone_against_noise):
        cached.cache_clear()


FOLDER: Optional[pathlib.Path] = None


# ---------------------------------------------------------------------------
# The tracks


@dataclasses.dataclass(frozen=True)
class Track:
    """One file of a class: its samples (None: bytes no codec reads), rate,
    container and subtype."""

    audio: Optional[np.ndarray]
    rate: int = SR
    ext: str = "wav"
    subtype: str = "PCM_16"


def _base(seed=15):
    """A 5 s target and reference under ``bench.py``'s slow envelope: a
    target of 1/f-like noise, its channels distinct (a music-like
    spectrum), and ``bench.py``'s square-wave reference with noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(N) / SR
    env = (0.6 + 0.4 * np.sin(2 * np.pi * t * 0.25) ** 2)[:, None]
    target = 0.02 * signal.lfilter([1.0], [1.0, -0.97], rng.randn(N, 2), axis=0) * env
    square = 0.7 * np.sign(np.sin(2 * np.pi * 110 * t))[:, None]
    reference = (square + 0.05 * rng.randn(N, 2)) * env
    return target, reference


TARGET, REFERENCE = _base()


def _noise(n, seed, scale=0.3, channels=2):
    return scale * np.random.RandomState(seed).randn(n, channels)


def _tone():
    """A pure 220 Hz tone, the right channel at 0.9 of the left: every bin
    but one sits at the PCM_16 floor."""
    tone = 0.3 * np.sin(2 * np.pi * 220 * np.arange(N) / SR)
    return np.stack([tone, 0.9 * tone], axis=1)


def _pinned(peak, count):
    """``TARGET`` with ``count`` samples of the left channel at ``peak``
    (the config walk's ``_pinned``): the checker's clipping and limiter
    advisories count the samples at the peak."""
    x = TARGET.copy()
    x[np.arange(count) * 97, 0] = peak
    return x


def _side_free(x):
    return np.stack([x[:, 0], -x[:, 0]], axis=1)


@dataclasses.dataclass(frozen=True)
class InputClass:
    """One class of input: the tracks it writes, the role it changes
    (``"target"``, ``"reference"`` or both), its outcome, the codes it
    emits (or, for ``RAISES``, the code raised), the ``Config`` fields it
    needs, whether it asks for the preview pair, and, for ``JAX_FAULT``,
    the gate of the port's float32 ``master`` against the JAX float64
    ``master``."""

    target: Callable[[], Track]
    reference: Callable[[], Track]
    roles: Tuple[str, ...]
    outcome: str = FILE
    codes: Tuple[mt.Code, ...] = ()
    config: Tuple[Tuple[str, object], ...] = ()
    previews: bool = False
    port_gate_db: float = PORT_GATE_DB


def _stereo_target():
    return Track(TARGET)


def _stereo_reference():
    return Track(REFERENCE)


def _same_file():
    return SAME_FILE


SAME_FILE = "the target's own file"
SHORT = dict(max_length=4.0, max_piece_size=2.0)  # a 5 s track is too long; a piece must fit

INPUT_CLASSES = {
    "stereo": InputClass(_stereo_target, _stereo_reference, (), codes=PROGRESS, previews=True),
    # the checker doubles a mono track: the target's side is exactly 0
    "mono target": InputClass(lambda: Track(TARGET[:, :1]), _stereo_reference, ("target",), JAX_FAULT,
                              (C.INFO_TARGET_IS_MONO,), previews=True),
    # a side 0.05 of the mid: the side filter's gains are large beside the
    # mid's, and the JAX package's packed convolution leaks between them;
    # the port's float32 is held to the JAX package's own gate here, not to
    # 120 dB: its own convolution's rounding is lifted by those gains too
    "pure tone target": InputClass(lambda: Track(_tone()), _stereo_reference, ("target",), JAX_FAULT,
                                   port_gate_db=GATE_DB),
    "R = -L target": InputClass(lambda: Track(_side_free(TARGET)), _stereo_reference, ("target",), SILENT_MID),
    "PCM_24 WAV target": InputClass(lambda: Track(TARGET, subtype="PCM_24"), _stereo_reference, ("target",)),
    "PCM_32 WAV target": InputClass(lambda: Track(TARGET, subtype="PCM_32"), _stereo_reference, ("target",)),
    "FLOAT WAV target": InputClass(lambda: Track(TARGET, subtype="FLOAT"), _stereo_reference, ("target",)),
    "AIFF target": InputClass(lambda: Track(TARGET, ext="aiff"), _stereo_reference, ("target",)),
    "FLAC target": InputClass(lambda: Track(TARGET, ext="flac", subtype="PCM_24"), _stereo_reference, ("target",)),
    "one silent channel target": InputClass(lambda: Track(TARGET * [1.0, 0.0]), _stereo_reference, ("target",)),
    "-80 dBFS noise target": InputClass(lambda: Track(_noise(N, 80, 1e-4), subtype="PCM_24"), _stereo_reference,
                                        ("target",)),
    "DC offset target": InputClass(lambda: Track(TARGET + 0.4), _stereo_reference, ("target",)),
    "float over full scale target": InputClass(lambda: Track(4.0 * TARGET, subtype="FLOAT"), _stereo_reference,
                                               ("target",)),
    "minimum length target": InputClass(lambda: Track(TARGET[:FFT + 1]), _stereo_reference, ("target",)),
    "odd length target": InputClass(lambda: Track(np.tile(TARGET, (2, 1))[:7 * SR + 12_345]), _stereo_reference,
                                    ("target",)),
    "silent target": InputClass(lambda: Track(np.zeros((N, 2))), _stereo_reference, ("target",)),
    "silent reference": InputClass(_stereo_target, lambda: Track(np.zeros((N, 2))), ("reference",)),
    "mono reference": InputClass(_stereo_target, lambda: Track(REFERENCE[:, :1]), ("reference",),
                                 codes=(C.INFO_REFERENCE_IS_MONO,)),
    "third-length reference": InputClass(_stereo_target, lambda: Track(REFERENCE[:N // 3]), ("reference",)),
    # both sides exactly 0: the side filter's gain is about 1, and nothing leaks visibly
    "mono target and reference": InputClass(lambda: Track(TARGET[:, :1]), lambda: Track(REFERENCE[:, :1]),
                                            ("target", "reference"),
                                            codes=(C.INFO_TARGET_IS_MONO, C.INFO_REFERENCE_IS_MONO)),
    "22.05 kHz target": InputClass(lambda: Track(TARGET[::2], rate=22050), _stereo_reference, ("target",),
                                   codes=(C.WARNING_TARGET_IS_RESAMPLED,)),
    "48 kHz PCM_24 reference": InputClass(
        _stereo_target, lambda: Track(_noise(SECONDS * 48000, 48, 0.25), rate=48000, subtype="PCM_24"),
        ("reference",), codes=(C.INFO_REFERENCE_IS_RESAMPLED,)),
    # -1.0 is a PCM_16 code (-32768), +1.0 is not: the pinned samples sit at the negative full scale
    "clipping target": InputClass(lambda: Track(_pinned(-1.0, 50)), _stereo_reference, ("target",),
                                  codes=(C.WARNING_TARGET_IS_CLIPPING,)),
    "limited target": InputClass(lambda: Track(_pinned(0.6, 200)), _stereo_reference, ("target",),
                                 codes=(C.WARNING_TARGET_LIMITER_IS_APPLIED,)),
    "equal pair allowed": InputClass(_stereo_target, _same_file, ("target", "reference"),
                                     config=(("allow_equality", True),)),
    # errors
    "garbage target": InputClass(lambda: Track(None), _stereo_reference, ("target",), RAISES,
                                 (C.ERROR_TARGET_LOADING,)),
    "garbage reference": InputClass(_stereo_target, lambda: Track(None), ("reference",), RAISES,
                                    (C.ERROR_REFERENCE_LOADING,)),
    "long target": InputClass(_stereo_target, lambda: Track(REFERENCE[:3 * SR]), ("target",), RAISES,
                              (C.ERROR_TARGET_LENGTH_IS_EXCEEDED,), tuple(SHORT.items())),
    "long reference": InputClass(lambda: Track(TARGET[:3 * SR]), _stereo_reference, ("reference",), RAISES,
                                 (C.ERROR_REFERENCE_LENGTH_LENGTH_IS_EXCEEDED,), tuple(SHORT.items())),
    "short target": InputClass(lambda: Track(TARGET[:FFT - 1]), _stereo_reference, ("target",), RAISES,
                               (C.ERROR_TARGET_LENGTH_IS_TOO_SMALL,)),
    "short reference": InputClass(_stereo_target, lambda: Track(REFERENCE[:FFT - 1]), ("reference",), RAISES,
                                  (C.ERROR_REFERENCE_LENGTH_LENGTH_TOO_SMALL,)),
    # the checker admits fft_size samples (its bound is < fft_size); the
    # graph needs more (core.py's _assert_graph_ready, the reference's
    # core.py:69-74): both packages raise the validation code
    "fft_size target": InputClass(lambda: Track(TARGET[:FFT]), _stereo_reference, ("target",), RAISES,
                                  (C.ERROR_VALIDATION,)),
    "3-channel target": InputClass(lambda: Track(_noise(N, 3, channels=3)), _stereo_reference, ("target",), RAISES,
                                   (C.ERROR_TARGET_NUM_OF_CHANNELS_IS_EXCEEDED,)),
    "3-channel reference": InputClass(_stereo_target, lambda: Track(_noise(N, 4, channels=3)), ("reference",),
                                      RAISES, (C.ERROR_REFERENCE_NUM_OF_CHANNELS_IS_EXCEEDED,)),
    "target equals reference": InputClass(_stereo_target, _same_file, ("target", "reference"), RAISES,
                                          (C.ERROR_TARGET_EQUALS_REFERENCE,)),
}

RESULT_BEARING = [name for name, cls in INPUT_CLASSES.items() if cls.outcome != RAISES]
ERRORS = [name for name, cls in INPUT_CLASSES.items() if cls.outcome == RAISES]
JAX_FAULTS = [name for name, cls in INPUT_CLASSES.items() if cls.outcome == JAX_FAULT]
SILENT_MIDS = [name for name, cls in INPUT_CLASSES.items() if cls.outcome == SILENT_MID]
# class -> why the float32 gate does not apply
GATE_REASONS = {
    "R = -L target": "the mid is exactly 0, so each RMS-correction step multiplies by "
                     "reference_match_rms / min_value (~5e5): float32 and float64 write different noise",
}
# the Config fields process() reads on the host alone; the masters leave them out
HOST_ONLY = ("allow_equality",)

# code -> (test file, test function) that holds process() or its loader emitting it
POINTERS = {
    C.INFO_REFERENCE_IS_LOSSY: ("test_torch_codecs.py", "test_loader_advisory_fires_for_native_lossy"),
    C.WARNING_TARGET_IS_LOSSY: ("test_torch_codecs.py", "test_loader_advisory_fires_for_native_lossy"),
}
# code -> why no class of process() emits it
REASONS = {
    C.INFO_UPLOADING: "the reference's front-end state (a file being uploaded): process() never sends it",
    C.INFO_WAITING: "the reference's front-end state (a job in a queue): process() never sends it",
    C.ERROR_UNKNOWN: "neither package raises it: it names a front end's unexpected failure",
}


# ---------------------------------------------------------------------------
# Running a class through a package's process()


def _write(track, path):
    if track.audio is None:
        path.write_bytes(b"no codec reads these bytes " * 64)
    else:
        jcodecs.write(str(path), track.audio, track.rate, track.subtype)


def _slug(name):
    return "".join(c if c.isalnum() else "_" for c in name)


@functools.lru_cache(maxsize=None)
def _paths(name):
    cls = INPUT_CLASSES[name]
    target = cls.target()
    t_path = FOLDER / f"{_slug(name)}.target.{target.ext}"
    _write(target, t_path)
    reference = cls.reference()
    if reference is SAME_FILE:
        return str(t_path), str(t_path)
    r_path = FOLDER / f"{_slug(name)}.reference.{reference.ext}"
    _write(reference, r_path)
    return str(t_path), str(r_path)


def _package(label):
    return mj if label == "jax" else mt


def _config(package, name, host=True, **extra):
    """The class's ``Config`` in ``package``; ``host=False`` leaves out the
    fields only ``process()`` reads, so the masters share their programs."""
    fields = {k: v for k, v in INPUT_CLASSES[name].config if host or k not in HOST_ONLY}
    return package.Config(**fields, **extra)


@dataclasses.dataclass(frozen=True)
class Outcome:
    codes: Tuple[int, ...]  # info and warning codes, in order
    error: Optional[int]
    files: dict  # "result", "preview_target", "preview_result" -> PCM_16 codes, where written


def _read_codes(path):
    audio, rate = codecs.read(path, raw_int=True)
    assert rate == SR and audio.dtype == np.int16
    return audio


def _outputs(label, name):
    return {key: str(FOLDER / f"{_slug(name)}.{label}.{key}.wav")
            for key in ("result", "preview_target", "preview_result")}


@functools.lru_cache(maxsize=None)
def run(label, name):
    """``process()`` of ``label``'s package on the class's files, one
    PCM_16 result and, where the class asks, the preview pair."""
    package, cls = _package(label), INPUT_CLASSES[name]
    target, reference = _paths(name)
    outputs = _outputs(label, name)
    previews = [package.pcm16(outputs["preview_target"]), package.pcm16(outputs["preview_result"])]
    codes = []

    def record(message):
        codes.append(int(message.split(":")[0]))

    package.log(info_handler=record, warning_handler=record, show_codes=True)
    error = None
    try:
        package.process(target, reference, [package.pcm16(outputs["result"])], _config(package, name),
                        *(previews if cls.previews else ()), **({"device": "cpu"} if package is mt else {}))
    except package.ModuleError as raised:
        error = int(raised.code)
    finally:
        package.log()
    files = {key: _read_codes(path) for key, path in outputs.items() if os.path.exists(path)}
    return Outcome(tuple(codes), error, files)


def _checked(name, raw_int):
    """The class's pair through the JAX package's loader and checker."""
    config = _config(mj, name)
    return tuple(mj.check(*mj.load(path, role, str(FOLDER), raw_int=raw_int), config, role)[0]
                 for path, role in zip(_paths(name), ("target", "reference")))


@functools.lru_cache(maxsize=None)
def decoded(name):
    """The class's pair as ``process()`` hands it to the graph, in float64."""
    return tuple(np.asarray(track, np.float64) for track in _checked(name, raw_int=False))


@functools.lru_cache(maxsize=None)
def jax_master(name, dtype="float64"):
    """The JAX package's ``master``: in float64 on the decoded pair, in
    float32 on the tracks as its ``process()`` stages them (raw PCM
    codes), so it runs ``process()``'s own program."""
    if dtype == "float32":
        target, reference = _checked(name, raw_int=True)
        config = _config(mj, name)
    else:
        target, reference = decoded(name)
        config = _config(mj, name, host=False, dtype=dtype)
    out = mj.master(target, reference, config)
    return np.asarray(out.result, np.float64), {k: float(v) for k, v in out.report.items()}


@functools.lru_cache(maxsize=None)
def port_master(name, dtype="float32"):
    target, reference = decoded(name)
    out = mt.master(target, reference, _config(mt, name, host=False, dtype=dtype), device="cpu")
    return out.result.double().numpy(), {k: float(v) for k, v in out.report.items()}


def exported(name, result):
    """A float result as its PCM_16 file holds it (the JAX package's
    writer)."""
    path = FOLDER / f"{_slug(name)}.exported.wav"
    jcodecs.write(str(path), result, SR, "PCM_16")
    return _read_codes(str(path))


def lsb_apart(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.max(np.abs(a.astype(np.int32) - b.astype(np.int32))))


def _rms_steps(report):
    return [report[f"rms_correction_{k + 1}"] for k in range(mt.Config().rms_correction_steps)]


def _follows_the_algebra(report, rtol):
    """Each RMS-correction step is ``reference_match_rms / min_value``: the
    reference's loop where the mid is exactly 0."""
    want = report["reference_match_rms"] / mt.Config().min_value
    return bool(np.allclose(_rms_steps(report), want, rtol=rtol, atol=0))


# ---------------------------------------------------------------------------
# The walk's own checks


def test_every_code_has_a_class_a_pointer_or_a_reason():
    """Each ``Code`` has exactly one of: a class that emits or raises it,
    a pointer to the test that does, or a reason; both packages have the
    same codes."""
    by_class = {code for cls in INPUT_CLASSES.values() for code in cls.codes}
    entries = [by_class, set(POINTERS), set(REASONS)]
    missing = sorted(int(code) for code in set(mt.Code) - set.union(*entries))
    assert not missing, f"codes with no class, pointer or reason: {missing}"
    for i, a in enumerate(entries):
        for b in entries[i + 1:]:
            assert not a & b, f"codes with two entries: {sorted(a & b)}"
    assert {int(code) for code in mt.Code} == {int(code) for code in mj.Code}
    assert all(REASONS.values())


@pytest.mark.parametrize("code", sorted(POINTERS), ids=lambda c: str(int(c)))
def test_pointed_tests_exist_and_name_their_code(code):
    filename, function = POINTERS[code]
    tree = ast.parse((TESTS / filename).read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == function for n in ast.walk(tree)), (
        f"{filename} has no {function}")
    names = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)}
    names |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert code.name in names or int(code) in names, f"{filename} never names {code.name}"


ROLE_CODES = [
    (C.INFO_TARGET_IS_MONO, C.INFO_REFERENCE_IS_MONO),
    (C.ERROR_TARGET_NUM_OF_CHANNELS_IS_EXCEEDED, C.ERROR_REFERENCE_NUM_OF_CHANNELS_IS_EXCEEDED),
    (C.ERROR_TARGET_LENGTH_IS_TOO_SMALL, C.ERROR_REFERENCE_LENGTH_LENGTH_TOO_SMALL),
    (C.ERROR_TARGET_LENGTH_IS_EXCEEDED, C.ERROR_REFERENCE_LENGTH_LENGTH_IS_EXCEEDED),
    (C.WARNING_TARGET_IS_RESAMPLED, C.INFO_REFERENCE_IS_RESAMPLED),
    (C.ERROR_TARGET_LOADING, C.ERROR_REFERENCE_LOADING),
]


@pytest.mark.parametrize("codes", ROLE_CODES, ids=lambda c: f"{int(c[0])}-{int(c[1])}")
def test_both_roles_are_walked(codes):
    """Where the role picks the code, each role has its class."""
    for code, role in zip(codes, ("target", "reference")):
        assert any(code in cls.codes and role in cls.roles for cls in INPUT_CLASSES.values()), (code, role)


# ---------------------------------------------------------------------------
# Each class through process() in both packages


@pytest.mark.parametrize("name", list(INPUT_CLASSES))
def test_events_match_jax(name):
    """The info and warning codes equal the JAX package's, in order, and
    hold the class's codes; or both raise the class's code."""
    cls, port, jax_ = INPUT_CLASSES[name], run("port", name), run("jax", name)
    assert port.codes == jax_.codes
    assert port.error == jax_.error
    if cls.outcome == RAISES:
        assert port.error == int(cls.codes[0])
    else:
        assert port.error is None
        assert set(cls.codes) <= set(port.codes), (cls.codes, port.codes)


@pytest.mark.parametrize("name", ERRORS)
def test_errors_write_no_file(name):
    assert not run("port", name).files and not run("jax", name).files


@pytest.mark.parametrize("name", [n for n in RESULT_BEARING if INPUT_CLASSES[n].outcome == FILE])
def test_files_match_jax(name):
    """The port's PCM_16 file, and its previews where asked for, within
    one step of the JAX package's."""
    port, jax_ = run("port", name), run("jax", name)
    expected = {"result", "preview_target", "preview_result"} if INPUT_CLASSES[name].previews else {"result"}
    assert set(port.files) == set(jax_.files) == expected
    for key in expected:
        assert lsb_apart(port.files[key], jax_.files[key]) <= LSB, key


@pytest.mark.parametrize("name", [n for n in RESULT_BEARING if n not in GATE_REASONS])
def test_float32_gate(name, snr):
    """The port's float32 ``master`` of the decoded pair against the JAX
    package's float64 ``master``: 95 dB or above."""
    measured = snr(jax_master(name)[0], port_master(name)[0])
    assert measured >= GATE_DB, measured


@pytest.mark.parametrize("name", JAX_FAULTS)
def test_a_jax_fault_class_follows_the_float64_master(name, snr):
    """Where the JAX package is off (its float32 ``master`` below its own
    95 dB gate against its float64 ``master``): the port's file within one
    step of that float64 master exported at PCM_16, its target preview
    within one step of the JAX package's, and its float32 ``master`` at
    the class's gate or above against the float64 master."""
    want, _ = jax_master(name)
    assert snr(want, jax_master(name, "float32")[0]) < GATE_DB
    port = run("port", name)
    assert lsb_apart(port.files["result"], exported(name, want)) <= LSB
    if INPUT_CLASSES[name].previews:
        assert lsb_apart(port.files["preview_target"], run("jax", name).files["preview_target"]) <= LSB
    assert snr(want, port_master(name)[0]) >= INPUT_CLASSES[name].port_gate_db


SIDE_FREE = [n for n in RESULT_BEARING if INPUT_CLASSES[n].target().audio.shape[1] == 1]


@pytest.mark.parametrize("name", SIDE_FREE)
def test_a_mono_target_keeps_its_side_at_zero(name):
    """A mono target is doubled, so its side is exactly 0: the port's
    float32 ``master``, its file and its result preview keep L = R."""
    got, _ = port_master(name)
    assert np.array_equal(got[:, 0], got[:, 1])
    files = run("port", name).files
    for key in ("result", "preview_result"):
        if key in files:
            assert np.array_equal(files[key][:, 0], files[key][:, 1]), key


@pytest.mark.parametrize("name", SILENT_MIDS)
def test_silent_mid_class_follows_the_reference_algebra(name):
    """R = -L: each of the port's float64 RMS-correction steps is
    ``reference_match_rms / min_value`` (1e-12 relative), its result keeps
    R = -L exactly, and the port writes its file."""
    got, report = port_master(name, "float64")
    assert _follows_the_algebra(report, ALGEBRA_RTOL), _rms_steps(report)
    assert np.array_equal(got[:, 0], -got[:, 1])
    assert run("port", name).files["result"].shape == (N, 2)


# ---------------------------------------------------------------------------
# The other entry points, on the port alone

FARM = ["stereo", "mono target", "one silent channel target", "DC offset target", "PCM_24 WAV target",
        "FLAC target", "minimum length target"]


@pytest.mark.parametrize("dispatch", ["pipelined", "vmapped"])
def test_farm_writes_process_files(dispatch):
    """``process_batch`` on one batch of mixed classes (a shorter target
    among them): each job's file within one step of the port's own
    ``process()`` file for it; the mono job's side exactly 0."""
    outputs = [str(FOLDER / f"farm_{dispatch}_{k}.wav") for k in range(len(FARM))]
    jobs = [mt.PairJob(*_paths(name), [mt.pcm16(path)]) for name, path in zip(FARM, outputs)]
    mt.process_batch(jobs, mt.Config(), dispatch=dispatch, device="cpu")
    for name, path in zip(FARM, outputs):
        got = _read_codes(path)
        assert lsb_apart(got, run("port", name).files["result"]) <= LSB, name
        if name in SIDE_FREE:
            assert np.array_equal(got[:, 0], got[:, 1]), name


def test_cli_writes_the_bytes_of_process():
    """``__main__.main`` on the mono class writes ``process()``'s bytes."""
    name = "mono target"
    path = str(FOLDER / "cli.wav")
    run("port", name)
    assert cli.main([*_paths(name), path, "-q"], device="cpu") == 0
    with open(path, "rb") as got, open(_outputs("port", name)["result"], "rb") as want:
        assert got.read() == want.read()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_master_sharded_keeps_the_mono_side_at_zero(dtype, snr):
    """``master_sharded`` over four CPU shards on the mono class: the side
    exactly 0; in float64 within one float32 ulp at 1.0 of ``master()``
    (1e-12 relative), in float32 at 120 dB or above against it (the shards
    sum their statistics in another order)."""
    target, reference = (torch.from_numpy(x) for x in decoded("mono target"))
    config = mt.Config(dtype=dtype)
    grid = mesh.single_axis_mesh("time", devices=["cpu"] * SHARDS)
    got = timeshard.master_sharded(target, reference, config, mesh=grid).result
    assert torch.equal(got[:, 0], got[:, 1])
    want = mt.master(target, reference, config, device="cpu").result
    if dtype == "float64":
        assert float((got - want).abs().max()) <= min(ULP, 1e-12 * float(want.abs().max()))
    else:
        assert snr(want.numpy(), got.numpy()) >= PORT_GATE_DB


# ---------------------------------------------------------------------------
# The JAX package's faults, pinned (ROADMAP queue 3 items 8 and 9)


def test_jax_packed_convolution_leaks_a_zero_row():
    """An 8 s zero row beside 0.3-RMS noise, through 4096-tap FIRs of
    unit norm and of gain 1e4: the JAX package's packed pair convolution
    (``matchering_tpu/ops/convolve.py:91``) puts the noise row's rounding
    into the zero row (peak above 1e-3 in float32); the port runs each row
    as its own transform, and the zero row stays exactly 0 while the other
    is within 1e-5 of scipy's float64 convolution."""
    n, taps = 8 * SR, 4096
    rng = np.random.RandomState(8)
    rows = np.stack([0.3 * rng.randn(n), np.zeros(n)]).astype(np.float32)
    firs = rng.randn(2, taps) * np.hanning(taps)
    firs = (firs / np.linalg.norm(firs, axis=1, keepdims=True) * [[1.0], [1e4]]).astype(np.float32)
    leaked = np.asarray(jax.jit(jconvolve.fft_convolve_same_batch)(jnp.asarray(rows), jnp.asarray(firs)))
    assert float(np.max(np.abs(leaked[1]))) > 1e-3
    got = convolve.fft_convolve_same_batch(torch.from_numpy(rows), torch.from_numpy(firs))
    assert float(got[1].abs().max()) == 0.0
    want = signal.fftconvolve(rows[0].astype(np.float64), firs[0].astype(np.float64), "same")
    assert float(np.max(np.abs(got[0].numpy() - want))) <= 1e-5


def test_jax_mono_target_misses_its_own_float32_gate(snr):
    """On the mono class the JAX package's float32 ``master`` (its
    ``process()`` program) lies below its own 95 dB gate against its float64
    ``master``; the port's float32 is at 120 dB or above against both
    float64 masters."""
    want, _ = jax_master("mono target")
    assert snr(want, jax_master("mono target", "float32")[0]) < GATE_DB
    got, _ = port_master("mono target")
    assert snr(want, got) >= PORT_GATE_DB
    assert snr(port_master("mono target", "float64")[0], got) >= PORT_GATE_DB


def test_silent_mid_rms_correction_follows_the_reference_algebra():
    """R = -L: the port's float64 steps are the reference's algebra
    (``reference_match_rms / min_value``, 1e-12 relative); the JAX
    package's float64 steps are not all that, since its packed convolution
    leaks the side into the mid."""
    _, report = port_master("R = -L target", "float64")
    assert _follows_the_algebra(report, ALGEBRA_RTOL)
    _, jax_report = jax_master("R = -L target")
    assert not _follows_the_algebra(jax_report, ALGEBRA_RTOL), _rms_steps(jax_report)


def _tone_against_noise():
    """The pure tone target against a noise reference, as PCM_16 codes."""
    env = (0.6 + 0.4 * np.sin(2 * np.pi * np.arange(N) / SR * 0.25) ** 2)[:, None]
    reference = np.clip(0.5 * np.random.RandomState(10).randn(N, 2) * env, -1, 1)
    return tuple(np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16) for x in (_tone(), reference))


@functools.lru_cache(maxsize=None)
def tone_against_noise():
    """The pair's masters: JAX float32 (on the codes, as its ``process()``
    stages them), JAX float64, and the port's float32 and float64."""
    codes = _tone_against_noise()
    floats = [c / 32768.0 for c in codes]
    return {
        "jax float32": np.asarray(mj.master(*codes, mj.Config()).result, np.float64),
        "jax float64": np.asarray(mj.master(*(jnp.asarray(x) for x in floats), mj.Config(dtype="float64")).result),
        "port float32": mt.master(*floats, mt.Config(), device="cpu").result.double().numpy(),
        "port float64": mt.master(*floats, mt.Config(dtype="float64"), device="cpu").result.numpy(),
    }


def test_float32_misses_the_gate_on_a_pure_tone_against_noise_in_both_packages(snr):
    """An open fault of the float32 chain, in both packages (ROADMAP queue
    3 item 10): a pure tone leaves every other bin at the PCM_16 floor, and
    against a noise reference the filter lifts those bins by 1e4 and more,
    with the float32 rounding of the tone's analysis and convolution in
    them.  Both float32 masters lie below the 95 dB gate against the JAX
    float64 ``master``, the port's no lower than the JAX package's; the
    float64 masters agree (200 dB), so ``Config(dtype="float64")`` is the
    remedy a user has."""
    out = tone_against_noise()
    want = out["jax float64"]
    jax32, port32 = snr(want, out["jax float32"]), snr(want, out["port float32"])
    assert jax32 < GATE_DB and port32 < GATE_DB, (jax32, port32)
    assert port32 >= jax32
    assert snr(want, out["port float64"]) >= 200.0


def report():
    """Each result-bearing class's numbers, one line each: the port's
    file against the JAX package's, and both float32 masters against the
    JAX float64 ``master``.  From the repository root: ``python -c "import
    sys; sys.path[:0] = ['tests', '.']; import conftest, test_torch_input_walk
    as walk; walk.report()"``."""
    global FOLDER
    from conftest import snr_db

    FOLDER = pathlib.Path(tempfile.mkdtemp(prefix="input_walk_"))
    try:
        for name in RESULT_BEARING:
            port, jax_ = run("port", name), run("jax", name)
            want, _ = jax_master(name)
            print(f"{name}: files {lsb_apart(port.files['result'], jax_.files['result'])} LSB apart; "
                  f"JAX float32 {snr_db(want, jax_master(name, 'float32')[0]):.1f} dB, "
                  f"port float32 {snr_db(want, port_master(name)[0]):.1f} dB against JAX float64", flush=True)
        out = tone_against_noise()
        print("pure tone against noise: " + ", ".join(
            f"{key} {snr_db(out['jax float64'], out[key]):.1f} dB" for key in ("jax float32", "port float32",
                                                                                "port float64"))
            + " against JAX float64", flush=True)
    finally:
        shutil.rmtree(FOLDER, ignore_errors=True)

