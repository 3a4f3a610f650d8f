"""The port's measurement drivers, ``bench_torch.py`` and
``tools_record_bench_torch.py``, on the CPU at small sizes.

The drivers build the JAX drivers' inputs bit for bit, run the port's
``master_graph`` and ``master_batch`` (held to the JAX package at float64
by ``test_torch_pipeline.py`` and ``test_torch_batch.py``), and their
numbers add up: the aggregated round is the sum of the per-pair
checksums, the four stages chained are the graph, the batch's checksum is
the pairs'.  Nothing here compiles a JAX program: ``bench`` and
``tools_record_bench`` import only numpy and the standard library at
module level.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import bench
import bench_torch
import matchering_tpu_torch as mt
import tools_record_bench
import tools_record_bench_torch as record

SR = 44100
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _close(got: float, want: float) -> bool:
    """Equal to float32 rounding: one float32 ulp relative."""
    return abs(got - want) <= 2.0**-23 * abs(want)


# --- the inputs: the JAX drivers' arrays, bit for bit ---


@pytest.mark.parametrize("seed", [42, 57])
def test_make_pair_is_bench_pys(seed):
    for got, want in zip(bench_torch.make_pair(2, SR, seed), bench.make_pair(2, SR, seed)):
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("seconds", [2, 2.5])
def test_record_make_pair_is_the_jax_tools(seconds):
    for got, want in zip(record._make_pair(seconds, SR), tools_record_bench._make_pair(seconds, SR)):
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    # chip_smoke.py hands bench's seed-42 pair to the record driver
    for got, want in zip(record._make_pair(2, SR), bench_torch.make_pair(2, SR, 42)):
        assert np.array_equal(got, want)


def test_make_pairs_are_the_loops():
    pairs = bench_torch.make_pairs(3, 1, SR, first_seed=50)
    for seed, pair in zip(range(50, 53), pairs):
        for got, want in zip(pair, bench.make_pair(1, SR, seed)):
            assert np.array_equal(got, want)


class _Staged(Exception):
    """Raised by the fake ``master`` with the tracks the JAX tool staged."""


def _jax_longform_tracks(minutes, sr, ref_seconds):
    """The tracks ``tools_record_bench.bench_longform`` stages, taken from
    it with stand-ins for jax and the package (nothing compiles)."""

    def master(target, reference, config, need_default):
        raise _Staged(target, reference)

    jax = types.SimpleNamespace(device_put=np.array, jit=lambda fn: fn)
    jnp = types.SimpleNamespace(sum=np.sum)
    mg = types.SimpleNamespace(Config=dict, master=master)
    with pytest.raises(_Staged) as staged:
        tools_record_bench.bench_longform(jax, jnp, mg, minutes, sr, ref_seconds)
    return staged.value.args


def test_longform_tracks_are_the_jax_tools():
    """Built in chunks on threads, the same arrays as the JAX tool's
    whole-track form (one minute at 96 kHz crosses a chunk boundary)."""
    want = _jax_longform_tracks(1, 96000, 3)
    assert want[0].shape[0] > record.LONGFORM_CHUNK
    got = record._longform_tracks(60, 96000, 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)


# --- bench_torch: the graph, the rounds, the command ---


def test_bench_graph_checksum_is_the_graphs():
    """bench's graph on an 8 s pair: the checksum of ``master_graph``
    (operators of the config staged by the graph itself) at ``s = 1``, bit
    for bit."""
    target, reference = bench_torch.make_pair(8, SR, 42)
    driver = bench_torch.Bench([(target, reference)], 8, device="cpu")
    s = torch.tensor(1.0)
    out = mt.master_graph(torch.from_numpy(target) * (1.0 + 1e-7 * s), torch.from_numpy(reference),
                          mt.Config(), need_default=True)
    want = torch.sum(torch.abs(out.result))
    got = driver.graph(*driver.staged[0], driver.scale(1))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert driver.single(1) == want.item()


def test_bench_round_is_the_sum_of_its_pairs():
    driver = bench_torch.Bench(bench_torch.make_pairs(2, 2), 2, device="cpu")
    perpair = driver.run_perpair(5)
    assert len(perpair) == 2 and all(v > 0 for v in perpair)
    assert _close(driver.run(5), sum(perpair))
    assert driver.run(6) != driver.run(5)  # each rep perturbs the targets
    throughput, rows = bench_torch.measure(driver, reps=1)
    assert set(rows) >= {"pipelined_B2", "pipelined_B2_perpair_fetch", "single_pair", "workload"}
    assert set(rows["pipelined_B2"]) == {"times_s", "median_s", "audio_sec_per_s", "pairs_per_s"}
    assert set(rows["single_pair"]) == {"times_s", "median_wall_s", "realtime_factor"}
    assert rows["workload"] == {"seconds": 2, "sample_rate": SR, "pairs": 2}
    assert throughput == rows["pipelined_B2"]["audio_sec_per_s"] == 2 * 2 / rows["pipelined_B2"]["median_s"]


def test_bench_command_prints_one_line_and_writes_nothing(tmp_path):
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--device", "cpu", "--pairs", "2",
         "--seconds", "2", "--reps", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr
    lines = run.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["unit"] == "audio-sec/sec" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 50, 3)
    rows = json.loads(run.stderr.strip().splitlines()[-1])
    assert {"pipelined_B2", "pipelined_B2_perpair_fetch", "single_pair", "workload", "device"} <= set(rows)
    assert rows["device"]["device"] == "cpu" and rows["device"]["torch"] == torch.__version__
    assert os.listdir(tmp_path) == []


# --- tools_record_bench_torch: stages, sweep, long form, command ---


def test_stages_chained_are_the_graph():
    """The four stages, chained at float64 with the unfolded operators (the
    device LOWESS runs between the products), give ``master_graph``'s
    result bit for bit."""
    config = mt.Config(dtype="float64")
    target, reference = (torch.from_numpy(x) for x in bench_torch.make_pair(8, SR, 42))
    interp_ops = record._unfolded_operators(config, CPU)
    assert interp_ops[0].shape[0] == config.log_grid_size
    carry = (target, reference)
    names = []
    for name, fn in record._stages(config, interp_ops):
        checksum, out = fn(*carry)
        assert checksum.ndim == 0 and bool(torch.isfinite(checksum))
        names.append(name)
        carry = (out,)
    assert names == ["analysis_and_fir", "convolution", "rms_correction_x4", "limiter"]
    want = mt.master_graph(target, reference, config, need_default=True, interp_ops=interp_ops).result
    assert carry[0].dtype == torch.float64 and torch.equal(carry[0], want)


def test_batch_sweep_checksum_is_the_pairs():
    config = mt.Config(dtype="float64")
    rows = record.bench_batch_sweep(config, seconds=3, sizes=(1, 2), device="cpu")
    assert set(rows) == {"1", "2"}
    for row in rows.values():
        assert {"wall_s", "pairs_per_s", "audio_sec_per_s"} <= set(row)
    target, reference = record._make_pair(3, SR)
    singles = [
        torch.sum(torch.abs(mt.master_graph(
            torch.from_numpy(target * (1 + 0.02 * i)), torch.from_numpy(reference * (1 - 0.01 * i)), config,
        ).result)).item()
        for i in range(2)
    ]
    assert _close(rows["1"]["checksum"], singles[0])
    assert _close(rows["2"]["checksum"], sum(singles))


def test_longform_int16_and_float32_agree_bit_for_bit():
    out = record.bench_longform(minutes=0.05, sr=SR, ref_seconds=3, device="cpu")
    block = out["int16_staging"]
    assert block["bit_identical"] and block["results_equal"]
    assert block["checksum_int16"] == block["checksum_float32"] > 0
    assert out["minutes_audio"] == 0.05 and out["warm_run_s"] > 0


def test_record_command_writes_only_with_out(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(record, "SECONDS", 3)
    monkeypatch.chdir(tmp_path)
    record.main(["--device", "cpu", "--skip-sweep"])
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [next(iter(line)) for line in printed] == ["device", "single_pair_180s_44k", "per_stage_180s_44k"]
    assert set(printed[2]["per_stage_180s_44k"]) == {
        "analysis_and_fir", "convolution", "rms_correction_x4", "limiter", "sum_wall_s"}
    assert os.listdir(tmp_path) == []

    path = tmp_path / "extra.json"
    record.main(["--device", "cpu", "--skip-sweep", "--out", str(path)])
    printed = {k: v for line in capsys.readouterr().out.strip().splitlines() for k, v in json.loads(line).items()}
    assert os.listdir(tmp_path) == ["extra.json"]
    assert json.loads(path.read_text()) == printed


# --- both drivers: no JAX, no silent CPU ---


@pytest.mark.parametrize("modules", ["bench_torch, tools_record_bench_torch", "bench, tools_record_bench"])
def test_drivers_import_no_jax(modules):
    code = (
        f"import sys, {modules}; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'matchering_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


@pytest.mark.parametrize("main", [bench_torch.main, record.main])
def test_drivers_without_a_card_raise(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([])
