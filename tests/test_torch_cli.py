"""``python -m matchering_tpu_torch`` against the JAX package's CLI.

The parser must offer the JAX parser's options with the same choices and
defaults; ``main(argv, device="cpu")`` must write what ``process()`` writes
for the same arguments; ``--time_sharded`` must write what the unsharded
CLI writes (one PCM_16 LSB), and beside ``--length_bucketing`` end in the
JAX parser's error; from the command line it runs on the card only.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import matchering_tpu_torch as mt
from matchering_tpu.__main__ import build_parser as jax_parser
from matchering_tpu_torch.__main__ import build_parser, main
from matchering_tpu_torch.io import wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _options(parser):
    return {
        action.dest: (tuple(action.option_strings), action.choices, action.default,
                      action.nargs, action.type, type(action).__name__)
        for action in parser._actions
    }


def test_parser_matches_jax():
    assert _options(build_parser()) == _options(jax_parser())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    t = np.arange(7 * 44100) / 44100
    target = np.stack([0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.randn(t.size)] * 2, 1)
    t48 = np.arange(7 * 48000) / 48000
    reference = np.stack([0.7 * np.sign(np.sin(2 * np.pi * 110 * t48))] * 2, 1)
    wav.write(str(d / "t.wav"), target, 44100, "PCM_16")
    wav.write(str(d / "r48.wav"), reference, 48000, "PCM_24")
    return d


def test_main_writes_what_process_writes(files):
    d = files
    args = [str(d / "t.wav"), str(d / "r48.wav")]
    assert main(args + [str(d / "cli.aiff"), "-b", "24", "--preview_result",
                        str(d / "cli_p.wav"), "--quiet"], device="cpu") == 0
    mt.process(*args, [mt.pcm24(str(d / "api.aiff"))], mt.Config(), None,
               mt.pcm16(str(d / "api_p.wav")), device="cpu")
    for cli, api in (("cli.aiff", "api.aiff"), ("cli_p.wav", "api_p.wav")):
        assert (d / cli).read_bytes() == (d / api).read_bytes()
    audio, rate = mt.io.codecs.read(str(d / "cli.aiff"))
    assert rate == 44100 and audio.shape == (7 * 44100, 2)


def test_main_no_limiter_normalized(files):
    d = files
    out = str(d / "nl.w64")
    argv = [str(d / "t.wav"), str(d / "r48.wav"), out, "-b", "32f", "--no_limiter", "--quiet"]
    assert main(argv, device="cpu") == 0
    audio, _ = mt.io.codecs.read(out)
    assert abs(np.abs(audio).max() - mt.Config().threshold) < 1e-6


@pytest.mark.parametrize(
    "flag", [["--time_sharded"], ["--length_bucketing", "65536", "--time_sharded"]]
)
def test_unported_options_are_parser_errors(flag, files, capsys):
    """``--time_sharded`` alone runs the time-sharded master over the
    devices given (four CPU shards here) and writes the unsharded CLI's
    file within one PCM_16 LSB; beside ``--length_bucketing`` it is the
    JAX parser's error."""
    d = files
    args = [str(d / "t.wav"), str(d / "r48.wav")]
    if len(flag) > 1:
        with pytest.raises(SystemExit) as stop:
            main(args + [str(d / "both.wav"), *flag], device="cpu")
        assert stop.value.code == 2
        assert "--time_sharded derives its shapes from the shard grid" in capsys.readouterr().err
        return
    assert main(args + [str(d / "sharded.wav"), *flag, "--quiet"], device=["cpu"] * 4) == 0
    assert main(args + [str(d / "unsharded.wav"), "--quiet"], device="cpu") == 0
    sharded, rate = wav.read(str(d / "sharded.wav"), raw_int=True)
    unsharded, _ = wav.read(str(d / "unsharded.wav"), raw_int=True)
    assert rate == 44100 and sharded.dtype == np.int16 and sharded.shape == unsharded.shape
    assert np.max(np.abs(sharded.astype(np.int32) - unsharded)) <= 1


def test_command_line_needs_a_card(files):
    """``python -m matchering_tpu_torch`` has no device option: without a
    card it fails rather than running on the CPU, and writes nothing."""
    d = files
    run = subprocess.run(
        [sys.executable, "-m", "matchering_tpu_torch", str(d / "t.wav"), str(d / "r48.wav"),
         str(d / "nocard.wav"), "--quiet"],
        cwd=REPO, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120,
    )
    assert run.returncode != 0
    assert "CUDA" in run.stderr
    assert not (d / "nocard.wav").exists()


def test_cli_import_loads_no_jax():
    code = (
        "import sys, matchering_tpu_torch.__main__; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'matchering_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
