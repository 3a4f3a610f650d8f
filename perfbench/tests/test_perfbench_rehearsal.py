"""Whole runs on the CPU at a tiny size (the kernels' plain twins, tracks
of seconds): the control flow of run.py, the result line, and the check
that sees a broken timed path come out not correct."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

CELLS = ["song44k.process_wav16", "longform96k.master"]
SEED = 2**31 + 17


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_cpu(tiny, name, trace):
    line = harness.run_cell(name, SEED, 1.0, trace, device="cpu", cell=tiny(name))
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    song = name.startswith("song")
    expected = {"host_decode_check_ms", "host_export_ms"} if trace and song else set()
    if not trace:  # no device metric off the card
        expected = {"audio_s_per_s.song", "setup_s"} if song else {
            "audio_s_per_s.longform", "call_p95_ms.longform", "setup_s"}
    assert set(line["metrics"]) == expected
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("fault", ["altered", "unchanged"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, name, fault):
    from matchering_tpu_torch import stages
    from matchering_tpu_torch.ops import basics

    real = stages.master_graph

    def broken(target, reference, config, *args, **kwargs):
        out = real(target, reference, config, *args, **kwargs)
        if fault == "altered":  # an answer altered where it is produced: 0.009 dB louder
            return out._replace(result=out.result * 1.001)
        # a step that returns its state unchanged: the target passes through
        return out._replace(result=basics.to_working_float(target, config.torch_dtype))

    monkeypatch.setattr(stages, "master_graph", broken)
    line = harness.run_cell(name, SEED, 1.0, False, device="cpu", cell=tiny(name))
    assert line["failed"] == 0 and not line["correct"]
    failing = [k for k, v in line["checks"].items() if v["value"] > v["limit"]]
    assert failing, line["checks"]


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload", CELLS[0], "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT,
    )
    assert out.returncode == 2 and out.stdout == ""


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert out.returncode != 0 and out.stdout == ""
