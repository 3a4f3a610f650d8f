"""Smoke-run the PyTorch port's example scripts end to end on the CPU.

The twin of tests/test_examples.py: each ``examples/torch_*.py`` takes its
JAX example's argv plus ``--device cpu`` and must run to completion,
producing its output files (the ``.flac`` previews and variant included),
when pointed at generated WAVs.  They run in-process via runpy.
"""

import os
import runpy
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wav_pair(tmp_path_factory):
    from matchering_tpu_torch.io import wav as wavio

    folder = tmp_path_factory.mktemp("torch_examples")
    sr = 44100
    n = 8 * sr
    r = np.random.RandomState(7)
    t = np.arange(n) / sr
    target = (0.25 * np.sin(2 * np.pi * 220 * t) + 0.05 * r.randn(n))[:, None]
    target = np.repeat(target, 2, axis=1)
    reference = (0.8 * np.sign(np.sin(2 * np.pi * 110 * t)) + 0.02 * r.randn(n))[:, None]
    reference = np.clip(np.repeat(reference, 2, axis=1), -0.98, 0.98)
    tgt = str(folder / "target.wav")
    ref = str(folder / "reference.wav")
    wavio.write(tgt, target, sr, "PCM_16")
    wavio.write(ref, reference, sr, "PCM_16")
    return tgt, ref


def _run(monkeypatch, script, args):
    import matchering_tpu_torch as mg

    path = os.path.join(REPO, "examples", script)
    monkeypatch.setattr(sys, "argv", [path, *args, "--device", "cpu"])
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        mg.log()  # restore the silent default handlers


@pytest.mark.parametrize(
    "script, outputs",
    [
        ("torch_basic.py", ["{p}_16bit.wav", "{p}_24bit.wav"]),
        (
            "torch_with_preview.py",
            ["{p}_16bit.wav", "{p}_preview_before.flac", "{p}_preview_after.flac"],
        ),
        (
            "torch_advanced_results.py",
            ["{p}_16bit.wav", "{p}_no_limiter.flac", "{p}_no_limiter_raw_level.aiff"],
        ),
        ("torch_edited_config.py", ["{p}_16bit.wav", "{p}_24bit.wav"]),
        ("torch_advanced_text_output.py", ["{p}_16bit.wav"]),
    ],
)
def test_example_runs(wav_pair, tmp_path, monkeypatch, script, outputs):
    tgt, ref = wav_pair
    prefix = str(tmp_path / "out")
    _run(monkeypatch, script, [tgt, ref, prefix])
    for out in outputs:
        produced = out.format(p=prefix)
        assert os.path.exists(produced), produced
        assert os.path.getsize(produced) > 1000, produced


def test_flac_outputs_decode(wav_pair, tmp_path, monkeypatch):
    """The FLAC preview decodes, stereo; an 8 s track is shorter than the
    30 s preview, so the preview is the whole track."""
    from matchering_tpu_torch.io import codecs

    tgt, ref = wav_pair
    prefix = str(tmp_path / "out")
    _run(monkeypatch, "torch_with_preview.py", [tgt, ref, prefix])
    audio, rate = codecs.read(f"{prefix}_preview_after.flac")
    assert rate == 44100 and audio.shape == (8 * 44100, 2)
    assert np.all(np.isfinite(audio)) and np.abs(audio).max() > 0


def test_farm_example_runs(wav_pair, tmp_path, monkeypatch):
    tgt, ref = wav_pair
    _run(monkeypatch, "torch_mastering_farm.py", [tgt, ref, tgt, ref, str(tmp_path)])
    for i in range(2):
        out = str(tmp_path / f"master_{i}.wav")
        assert os.path.exists(out) and os.path.getsize(out) > 1000


def test_longform_example_runs_over_two_shards(wav_pair, tmp_path, monkeypatch):
    """``--device cpu`` puts the track's two time shards on the CPU
    (``master_sharded`` over ``["cpu"] * 2``) at 96 kHz."""
    from matchering_tpu_torch.io import codecs

    tgt, ref = wav_pair
    out = str(tmp_path / "long.wav")
    _run(monkeypatch, "torch_longform_sharded.py", [tgt, ref, out])
    audio, rate = codecs.read(out)
    assert rate == 96000 and audio.shape == (8 * 96000, 2)
    assert np.all(np.isfinite(audio)) and np.abs(audio).max() > 0.1
