"""The port's length-aware batch (``parallel.batch.bucket_pad`` +
``master_batch`` with the true lengths) against the benchmark's plain
float64 reference (``perfbench/reference``) on three seeded pairs of
2-5 s at 44.1 kHz in a bucket of 2^15: each row is the master of its
unpadded pair, zero past its length; the batch path's counters count the
padding; its spans are recorded once a call.  Imports no JAX."""

import numpy as np
import pytest
import threadpoolctl
import torch

import matchering_tpu_torch as mt
from matchering_tpu_torch import trace
from matchering_tpu_torch.parallel import batch
from perfbench import harness, signals
from perfbench.reference import farm as reference_farm

SR = 44100
BUCKET = 1 << 15
ROWS = 3
CELL = harness.Cell.load("farm44k.batch16")


def _lengths(rng):
    return [int(n) for n in rng.integers(2 * SR, 5 * SR, size=ROWS)]


@pytest.fixture(scope="module")
def farm():
    """The pairs, the reference's padded rows, and the port's float64 and
    float32 batches (the float32 one recorded), with one torch thread and
    one BLAS thread: the tier-1 run's six workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpoolctl.threadpool_limits(limits=1):
            rng = np.random.default_rng(2**31 + 20)
            gen = signals.generator(2**31 + 20, "cpu")
            targets = [signals.track(n, SR, CELL.traffic["target"], gen, "cpu").double() for n in _lengths(rng)]
            references = [signals.track(n, SR, CELL.traffic["reference"], gen, "cpu").double()
                          for n in _lengths(rng)]
            parameters = CELL.config["parameters"]
            n_pad = reference_farm.bucket_length([t.shape[0] for t in targets], BUCKET)
            expected = reference_farm.master_rows([t.numpy() for t in targets], [r.numpy() for r in references],
                                                  parameters, n_pad)
            out = {"targets": targets, "references": references, "expected": expected}
            for dtype in ("float64", "float32"):
                config = harness.port_config(mt, {**parameters, "dtype": dtype})
                tracks = [[x.to(config.torch_dtype) for x in role] for role in (targets, references)]
                trace.clear()
                before = trace.counts()
                with trace.recording():
                    padded_targets, target_lengths = batch.bucket_pad(tracks[0], BUCKET, device="cpu")
                    padded_references, reference_lengths = batch.bucket_pad(tracks[1], BUCKET, device="cpu")
                    result = batch.master_batch(
                        padded_targets, padded_references, config, need_default=True,
                        target_lengths=target_lengths, reference_lengths=reference_lengths, device="cpu",
                    ).result
                after = trace.counts()
                out[dtype] = {
                    "result": result.double().numpy(),
                    "shapes": (padded_targets.shape[1], padded_references.shape[1]),
                    "lengths": (target_lengths, reference_lengths),
                    "counted": {k: after.get(k, 0) - before.get(k, 0) for k in after if k.startswith("batch.")},
                    "spans": trace.spans(),
                }
            trace.clear()
            yield out
    finally:
        torch.set_num_threads(threads)


def _errors(farm, dtype, row):
    got, want = farm[dtype]["result"][row], farm["expected"][row]
    rel = np.sqrt(np.sum((got - want) ** 2) / np.sum(want**2))
    return rel, np.abs(got - want).max()


@pytest.mark.parametrize("row", range(ROWS))
def test_float64_rows_equal_the_reference(farm, row):
    rel, _ = _errors(farm, "float64", row)
    assert rel < 1e-9


@pytest.mark.parametrize("row", range(ROWS))
def test_float32_rows_sit_inside_the_cells_limits(farm, row):
    rel, widest = _errors(farm, "float32", row)
    assert rel < CELL.limits["rel_rms_error"] and widest < CELL.limits["max_abs_error"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_samples_past_a_rows_length_are_exactly_zero(farm, dtype):
    result = farm[dtype]["result"]
    assert result.shape[1] == farm["expected"].shape[1] and result.shape[1] % BUCKET == 0
    for row, target in zip(result, farm["targets"]):
        assert target.shape[0] < row.shape[0] and not row[target.shape[0]:].any()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_the_counters_count_the_padding(farm, dtype):
    n, m = farm[dtype]["shapes"]
    assert (n, m) == tuple(reference_farm.bucket_length([x.shape[0] for x in role], BUCKET)
                           for role in (farm["targets"], farm["references"]))
    true = sum(x.shape[0] for role in (farm["targets"], farm["references"]) for x in role)
    assert farm[dtype]["counted"] == {
        "batch.rows": ROWS, "batch.padded_samples": ROWS * (n + m), "batch.true_samples": true,
    }


@pytest.mark.parametrize("name, roots", [("bucket", 2), ("batch", 1), ("length_tail", 0)])
def test_each_span_is_recorded_once_a_call(farm, name, roots):
    """Two ``bucket`` roots (one a role), one ``batch`` root, and one
    ``length_tail`` inside the batch's ``finalize``."""
    spans = farm["float32"]["spans"]
    by_id = {s.id: s for s in spans}
    named = [s for s in spans if s.name == name]
    assert len(named) == max(roots, 1)
    assert sum(s.parent is None for s in named) == roots
    if name == "length_tail":
        chain = [by_id[named[0].parent]]
        while chain[-1].parent is not None:
            chain.append(by_id[chain[-1].parent])
        assert [s.name for s in chain] == ["finalize", "batch"]
