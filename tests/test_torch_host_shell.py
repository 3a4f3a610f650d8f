"""The port's host shell on the CPU: staging, the equality check, the export.

``check()`` stages every track on the device it is given (integer PCM as
its raw codes, mono doubled there), once; ``process()``'s equality check,
graph and previews read the staged tensors and copy nothing more.  The
equality decision must be the JAX package's (``matchering_tpu.checker.
check_equality``, numpy on the host) on the same inputs.  The export copies
each variant to the host at its working dtype, and every writer widens
float32 to float64 where it quantises, so a float32 result writes the
bytes of the same result widened to float64: for each container and
subtype, and for ``process()``'s own files.  Signals are a few seconds at
44.1 kHz; the JAX side is numpy only (no JAX compile).
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

import matchering_tpu_torch as mt
from matchering_tpu import checker as jchecker
from matchering_tpu_torch import checker, preview, stages
from matchering_tpu_torch.io import codecs, wav

SR = 44100
ATOL, RTOL = 1e-8, 1e-5  # np.allclose's


def _track(seconds, seed, gain=0.5, channels=2):
    r = np.random.RandomState(seed)
    n = int(seconds * SR)
    env = 0.5 + 0.5 * np.sin(np.arange(n) / SR * 1.3)[:, None]
    return np.clip(gain * r.randn(n, channels) * env, -1, 1)


def _codes(track, bits=16):
    """Integer PCM codes of a float track, as the WAV reader stages them
    (24-bit codes in the top bytes of int32)."""
    if bits == 16:
        return np.clip(np.rint(track * 2**15), -(2**15), 2**15 - 1).astype(np.int16)
    codes = np.clip(np.rint(track * 2**23), -(2**23), 2**23 - 1).astype(np.int32)
    return codes << 8


def _edge(reference, factor):
    """``reference`` with one sample moved by ``factor`` times
    ``np.allclose``'s allowance at it: inside below 1, outside above."""
    target = reference.copy()
    target[123, 1] = reference[123, 1] + factor * (ATOL + RTOL * abs(reference[123, 1]))
    return target


def _equality_cases():
    base = _track(1, 3)
    pcm = _codes(base)
    pcm24 = _codes(base, 24)
    return {
        "int16-int16-same": (pcm, pcm.copy()),
        "int16-int16-one-code-off": (pcm, np.where(np.arange(pcm.size).reshape(pcm.shape) == 7, pcm + 1, pcm)),
        "int16-float64-same-track": (pcm, pcm / 2.0**15),
        "float64-int16-same-track": (pcm / 2.0**15, pcm),
        "int32-float64-same-track": (pcm24, pcm24 / 2.0**31),
        "float64-float64-same": (base, base.copy()),
        "shapes-differ": (base, base[:-1]),
        "just-inside": (_edge(base, 0.5), base),
        "at-the-edge": (_edge(base, 1.0), base),
        "just-outside": (_edge(base, 2.0), base),
        "scaled-beyond-rtol": (base * 1.001, base),
        "mono-same-track": (pcm[:, :1], pcm[:, :1].copy()),
        "mono-vs-stereo-of-it": (pcm[:, :1], np.repeat(pcm[:, :1], 2, axis=1)),
    }


EQUALITY = _equality_cases()


def _raises(fn, *args):
    try:
        fn(*args)
    except (jchecker.ModuleError, mt.ModuleError) as error:
        return error.code.value
    return None


@pytest.mark.parametrize("case", sorted(EQUALITY))
def test_equality_decision_matches_jax(case):
    """The port's decision on the tracks ``check()`` staged equals the JAX
    package's on the same host arrays (mono doubled as its checker does)."""
    target, reference = EQUALITY[case]
    stereo = [np.repeat(a, 2, axis=1) if a.shape[1] == 1 else a for a in (target, reference)]
    want = _raises(jchecker.check_equality, *stereo)
    staged = [mt.check(a, SR, mt.Config(), "reference", device="cpu")[0] for a in (target, reference)]
    assert all(isinstance(t, torch.Tensor) for t in staged)
    got = _raises(mt.check_equality, *staged)
    assert got == want
    # the host arrays themselves decide alike
    assert _raises(mt.check_equality, *stereo) == want


def test_equality_compares_on_the_targets_device(monkeypatch):
    """A tensor target pulls a host reference to its device, and the
    comparison runs in float64 there."""
    seen = []
    real = checker._as_float64

    def spy(array, device):
        out = real(array, device)
        seen.append((out.device.type, out.dtype))
        return out

    monkeypatch.setattr(checker, "_as_float64", spy)
    pcm = _codes(_track(1, 4))
    with pytest.raises(mt.ModuleError):
        mt.check_equality(torch.from_numpy(pcm), pcm / 2.0**15)
    assert seen == [("cpu", torch.float64)] * 2


@pytest.mark.parametrize(
    "kind", ["int16", "int32", "float32", "float64", "mono-int16", "resampled-int16"]
)
def test_check_stages_a_tensor_on_the_device(kind, monkeypatch):
    """Every track comes back as a stereo tensor on the device, in the
    dtype it crossed in (float64 once resampled there), after exactly one
    copy to the device."""
    copies = []
    real = checker.to_device
    monkeypatch.setattr(checker, "to_device", lambda a, d: copies.append(type(a)) or real(a, d))
    base = _track(1, 5)
    rate = 48000 if kind.startswith("resampled") else SR
    array = {
        "int16": _codes(base),
        "int32": _codes(base, 24),
        "float32": base.astype(np.float32),
        "float64": base,
        "mono-int16": _codes(base)[:, :1],
        "resampled-int16": _codes(base),
    }[kind]
    staged, staged_rate = mt.check(array, rate, mt.Config(), "target", device="cpu")
    assert isinstance(staged, torch.Tensor) and staged.device.type == "cpu"
    assert staged_rate == SR and staged.ndim == 2 and staged.shape[1] == 2
    assert copies == [np.ndarray]
    if kind.startswith("resampled"):
        assert staged.dtype == torch.float64
        return
    assert str(staged.dtype) == f"torch.{array.dtype}"
    np.testing.assert_array_equal(staged.numpy(), np.repeat(array, 2 // array.shape[1], axis=1))


def _samples():
    """Float32 samples with every edge a writer meets: full scale, beyond
    it both ways (clipped), a code's half step, tiny values and noise."""
    r = np.random.RandomState(11)
    noise = r.uniform(-1.2, 1.2, (3000, 2))
    edges = np.array([1.0, -1.0, 1.5, -1.5, 0.5 / 2**15, -0.5 / 2**23, 1e-30, 0.0,
                      1 - 2.0**-24, -(1 - 2.0**-24), 32767 / 32768, -32768 / 32768])
    return np.concatenate([np.stack([edges, edges[::-1]], 1), noise]).astype(np.float32)


WRITES = [
    ("wav", s) for s in ("PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE", "ALAW", "ULAW")
] + [("aiff", s) for s in ("PCM_16", "PCM_24", "PCM_32", "FLOAT")] + [
    ("flac", s) for s in ("PCM_16", "PCM_24")
] + [
    (ext, s) for ext in ("w64", "caf")
    for s in ("PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE", "ALAW", "ULAW")
] + [("ogg", "VORBIS"), ("mp3", "MPEG_LAYER_III"), ("opus", "OPUS")]


@pytest.mark.parametrize("ext,subtype", WRITES, ids=[f"{e}-{s}" for e, s in WRITES])
def test_float32_result_writes_the_bytes_of_float64(tmp_path, ext, subtype):
    """``save`` of float32 samples writes the same file as ``save`` of the
    same samples widened to float64, through whichever backend
    ``codecs.write`` picks for the container."""
    if not codecs.check_format(ext, subtype):
        pytest.skip(f"no {ext} {subtype} writer on this host")
    samples = _samples()
    if ext in ("ogg", "mp3", "opus"):
        samples = np.clip(samples, -1, 1)  # the lossy encoders take in-range audio
    paths = [str(tmp_path / f"{dtype}.{ext}") for dtype in ("f32", "f64")]
    mt.save(paths[0], samples, SR, subtype)
    mt.save(paths[1], samples.astype(np.float64), SR, subtype)
    with open(paths[0], "rb") as f32, open(paths[1], "rb") as f64:
        assert f32.read() == f64.read()


@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "PCM_32", "FLOAT"])
def test_float32_numpy_and_native_wav_writers_agree(tmp_path, subtype):
    """float32 through ``save`` (its codes path), through the numpy
    writer, and float64 through ``save``: one file."""
    samples = _samples()
    files = {
        "save_f32": lambda p: mt.save(p, samples, SR, subtype),
        "numpy_f32": lambda p: wav.write(p, samples, SR, subtype),
        "save_f64": lambda p: mt.save(p, samples.astype(np.float64), SR, subtype),
    }
    data = []
    for name, write in files.items():
        write(str(tmp_path / f"{name}.wav"))
        data.append((tmp_path / f"{name}.wav").read_bytes())
    assert data[0] == data[1] == data[2]


def test_ffmpeg_staging_widens_float32(tmp_path, monkeypatch):
    """The ffmpeg fallback stages a DOUBLE WAV: float32 widens into the
    same file (a stand-in ffmpeg copies the staged WAV out)."""
    script = tmp_path / "ffmpeg"
    script.write_text(
        "#!%s\nimport shutil, sys\nargs = sys.argv[1:]\n"
        "shutil.copy(args[args.index('-i') + 1], args[-1])\n" % sys.executable
    )
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    samples = _samples()
    for name, array in (("f32", samples), ("f64", samples.astype(np.float64))):
        codecs._write_via_ffmpeg(str(tmp_path / f"{name}.mp3"), array, SR, "MP3", "MPEG_LAYER_III")
    assert (tmp_path / "f32.mp3").read_bytes() == (tmp_path / "f64.mp3").read_bytes()


CONFIG = mt.Config(fft_size=1024)
PROCESS_OUTPUTS = [
    (ext, s) for ext in ("wav", "aiff", "w64", "caf") for s in ("PCM_16", "PCM_24", "FLOAT")
] + [("wav", "PCM_32"), ("flac", "PCM_16"), ("flac", "PCM_24")]


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """``process()`` on the CPU (float32, ``Config(fft_size=1024)``: the
    export is the point, and the default operators take minutes to build
    under the suite's six workers) of a 5 s PCM_16 WAV pair into every
    container and subtype above, with both previews; the staging copies
    it made recorded per module; and the master of the same staged tracks,
    which the test exports as float64."""
    tmp = tmp_path_factory.mktemp("host_shell")
    wav.write(str(tmp / "t.wav"), _track(5, 21, 0.3), SR, "PCM_16")
    wav.write(str(tmp / "r.wav"), _track(5, 22, 0.9), SR, "PCM_16")
    results = [mt.Result(str(tmp / f"out_{s}.{ext}"), s) for ext, s in PROCESS_OUTPUTS]
    copies = []
    with pytest.MonkeyPatch.context() as patch:
        for module in (checker, stages, preview):
            def spy(array, device, real=module.to_device, name=module.__name__.rsplit(".", 1)[-1]):
                copies.append((name, isinstance(array, torch.Tensor)))
                return real(array, device)

            patch.setattr(module, "to_device", spy)
        mt.process(str(tmp / "t.wav"), str(tmp / "r.wav"), results, CONFIG,
                   mt.pcm16(str(tmp / "pt.wav")), mt.pcm16(str(tmp / "pr.wav")), device="cpu")
    # the same master from the same staged tracks
    target, _ = mt.check(mt.load(str(tmp / "t.wav"), "target", raw_int=True)[0], SR, CONFIG,
                         "target", device="cpu")
    reference, _ = mt.check(mt.load(str(tmp / "r.wav"), "reference", raw_int=True)[0], SR,
                            CONFIG, "reference", device="cpu")
    master = mt.master(target, reference, CONFIG, device="cpu").result
    return tmp, master, copies


@pytest.mark.parametrize("ext,subtype", PROCESS_OUTPUTS, ids=[f"{e}-{s}" for e, s in PROCESS_OUTPUTS])
def test_process_files_equal_a_float64_export(processed, ext, subtype):
    """Each of ``process()``'s files (from its float32 export) is the file
    a float64 export of the same master writes."""
    tmp, master, _ = processed
    assert master.dtype == torch.float32
    want = tmp / f"want_{subtype}.{ext}"
    codecs.write(str(want), master.numpy().astype(np.float64), SR, subtype)
    assert (tmp / f"out_{subtype}.{ext}").read_bytes() == want.read_bytes()


def test_process_stages_each_track_once(processed):
    """Only ``check()`` copies host arrays to the device, once per track;
    the graph and the previews get the staged tensors."""
    _, _, copies = processed
    assert [c for c in copies if not c[1]] == [("checker", False), ("checker", False)]
    assert {name for name, _ in copies} == {"checker", "stages", "preview"}


def test_process_previews_are_written(processed):
    tmp, _, _ = processed
    for name in ("pt.wav", "pr.wav"):
        piece, rate = wav.read(str(tmp / name))
        assert rate == SR and piece.shape[1] == 2 and np.all(np.isfinite(piece))
