"""The cells of the entry ``staged`` (``farm44k.batch16``: the port's
length-aware batch path; ``song44k.master_staged``: ``master()`` per
pair on card-staged tracks): whole runs on the CPU at a tiny size, broken
answers reading not correct, the readers of the batch path's spans and
counters, and the cell's padding arithmetic."""

import json

import numpy as np
import pytest

from perfbench import calibrate, devtrace, harness
from perfbench.entries.process import fixed_lengths
from perfbench.reference import farm as reference_farm
from perfbench.reference import matchering as reference
from perfbench.tests.test_perfbench_spans import MS, Calls, make_run

FARM, STAGED = "farm44k.batch16", "song44k.master_staged"
CELLS = [FARM, STAGED]
SEED = 2**31 + 23


def shrink(cell, cycle=False):
    """The cell with seconds-long tracks, a batch of 4 over 2 references
    and a bucket of 2^15 (the farm), and the compared call the first, the
    one call a run's window always reaches however slow the CPU: the pair
    cell then has one target.  ``cycle``: the pair cell has 2 targets and
    compares a call among the first cycle of its 4 pairs."""
    traffic = cell.traffic
    if traffic["batch"] > 1:
        traffic.update(batch=4, targets=4, references=2, target_seconds=[2, 5], reference_seconds=[2, 5],
                       compare_among_first=1)
        cell.config["parameters"]["length_bucketing"] = 1 << 15
    else:
        traffic.update(targets=2 if cycle else 1, references=2, target_seconds=[3, 6], reference_seconds=[3, 6],
                       compare_among_first=4 if cycle else 1)
    return cell


def small(name, cycle=False):
    return shrink(harness.Cell.load(name), cycle)


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_cpu(name, trace):
    line = harness.run_cell(name, SEED, 1.0, trace, device="cpu", cell=small(name))
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    expected = set()  # no device metric off the card
    if not trace:
        expected = {"audio_s_per_s.longform", "call_p95_ms.longform", "setup_s"} if name == FARM else {
            "audio_s_per_s.song", "setup_s"}
    assert set(line["metrics"]) == expected
    if name == FARM:
        assert line["checks"]["padding_leak"]["value"] == 0.0
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("name, fault", [(FARM, "altered"), (FARM, "unchanged"), (FARM, "leaks"),
                                         (STAGED, "altered"), (STAGED, "unchanged")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    from matchering_tpu_torch import stages
    from matchering_tpu_torch.ops import basics
    from matchering_tpu_torch.parallel import batch

    real = stages.master_graph

    def broken(target, reference, config, *args, **kwargs):
        out = real(target, reference, config, *args, **kwargs)
        if fault == "altered":  # 0.009 dB louder
            return out._replace(result=out.result * 1.001)
        if fault == "unchanged":  # the target passes through
            return out._replace(result=basics.to_working_float(target, config.torch_dtype))
        # a floor of 1e-6 past the true lengths only
        past = 1 - kwargs["target_length"].mask(out.result.shape[-2], out.result.dtype)[..., None]
        return out._replace(result=out.result + 1e-6 * past)

    monkeypatch.setattr(stages, "master_graph", broken)
    monkeypatch.setattr(batch, "master_graph", broken)
    line = harness.run_cell(name, SEED, 1.0, False, device="cpu", cell=small(name))
    assert line["failed"] == 0 and not line["correct"]
    failing = {k for k, v in line["checks"].items() if v["value"] > v["limit"]}
    assert failing
    if fault == "leaks":
        assert failing == {"padding_leak"}


@pytest.mark.parametrize("name", CELLS)
def test_the_compared_call_holds_the_longest_target(name):
    """So the result the compared call keeps on the device, and a run's
    peak memory, do not follow the seed."""
    import torch

    import matchering_tpu_torch as mt

    cell = small(name, cycle=True)
    for seed in (1, 2**31 + 5, 2**33 + 7):
        state = cell.entry().prepare(harness.Context(cell, seed, torch.device("cpu"), "", False, mt, torch))
        targets, _ = state.pairing(state.compared)
        assert targets[state.rows[0]].shape[0] == max(t.shape[0] for s in state.sets for t in s)
        assert state.compared < cell.traffic["compare_among_first"] and len(set(state.rows)) == len(state.rows)


def test_the_calibration_reaches_the_compared_call():
    readings = calibrate.readings(small(FARM), SEED, False, "cpu")
    assert readings["checks"]["missing_results"] == 0 and readings["checks"]["padding_leak"] == 0.0


def farm_call(b, t0, device_ms, padded, true):
    """One farm call's roots at ``t0`` ms: two ``bucket``s, then ``batch``
    with its graph's stages and the ``length_tail`` in ``finalize``."""
    counters = {"batch.rows": 16, "batch.padded_samples": padded, "batch.true_samples": true}
    b.add(("bucket", t0, t0 + 1, [], device_ms / 10), counters={"batch.padded_samples": 0})
    b.add(("bucket", t0 + 1, t0 + 2, [], device_ms / 10), counters={})
    b.add(("batch", t0 + 2, t0 + 9, [
        ("levels", t0 + 2, t0 + 3, [], 1.0),
        ("finalize", t0 + 3, t0 + 8, [("length_tail", t0 + 4, t0 + 5, [], device_ms / 100)], 2.0),
    ], device_ms), counters=counters)


def farm_run(monkeypatch, calls=((1, 100.0), (20, 120.0), (40, 140.0)), ranges=None):
    b = Calls()
    for t0, device_ms in calls:
        farm_call(b, t0, device_ms, padded=1000, true=600)
    run = make_run(len(calls), b.spans, monkeypatch, cell=FARM)
    ranges = ranges or [(t0 - 0.5, t0 + 10) for t0, _ in calls]
    run.trace = devtrace.Trace([], [("window", 0, 100 * MS)] + [("call", int(s * MS), int(e * MS)) for s, e in ranges])
    return run


def test_the_batch_readers_give_medians_per_call(monkeypatch):
    run = farm_run(monkeypatch)
    read = lambda name: harness.reader(name)(run)  # noqa: E731
    assert read("batch_device_ms") == pytest.approx(120.0)
    assert read("bucket_device_ms") == pytest.approx(24.0)  # both roles' buckets
    assert read("length_tail_device_ms") == pytest.approx(1.2)
    assert read("padding_share") == pytest.approx(40.0)


def test_the_batch_readers_need_one_call_range_per_call(monkeypatch):
    run = farm_run(monkeypatch, ranges=[(0.5, 11), (19.5, 30)])  # the third call has no range
    for name in ("batch_device_ms", "bucket_device_ms", "length_tail_device_ms", "padding_share"):
        assert harness.reader(name)(run) is None


@pytest.mark.parametrize("case", ["no_batch_spans", "off_the_card"])
def test_no_value_from_a_program_without_the_batch_spans(monkeypatch, case):
    """The parent's program masters a batch with no ``batch``, ``bucket``
    or ``length_tail`` span and no ``batch.*`` counter: its graph's stages
    are the roots.  The readers give nothing there and do not raise."""
    b = Calls()
    for t0 in (1, 20):
        b.add(("levels", t0, t0 + 1, [], 1.0), counters={"host_reads": 0})
        b.add(("finalize", t0 + 1, t0 + 5, [], 2.0), counters={"host_reads": 0})
    run = make_run(2, b.spans, monkeypatch, cell=FARM)
    run.trace = devtrace.Trace([], [("window", 0, 100 * MS), ("call", 0, 10 * MS), ("call", 19 * MS, 30 * MS)])
    if case == "off_the_card":
        run = farm_run(monkeypatch)
        run.device_type = "cpu"
    for name in ("batch_device_ms", "bucket_device_ms", "length_tail_device_ms", "padding_share"):
        assert harness.reader(name)(run) is None


def test_the_split_end_to_end_names_read():
    calls = [harness.Call(i * 0.1, (i + 1) * 0.1, 4320.0, 16 * 18_350_080, 4) for i in range(20)]
    run = harness.Run(cell=harness.Cell.load(FARM), device_type="cuda", device_kind="x", setup_s=1.0,
                      window=(0.0, 2.0), calls=calls, peak_bytes=None, trace=None, peaks={})
    assert harness.reader("audio_s_per_s.longform")(run) == pytest.approx(43200.0)
    assert harness.reader("call_p95_ms.longform")(run) == pytest.approx(100.0)
    assert harness.reader("audio_s_per_s.song")(run) == pytest.approx(43200.0)
    reported = {cell: {m["name"] for m in harness.Cell.load(cell).end_to_end} for cell in (FARM, STAGED)}
    assert reported[FARM] == {"audio_s_per_s.longform", "call_p95_ms.longform", "peak_mem_gib", "setup_s"}
    assert reported[STAGED] == {"audio_s_per_s.song", "peak_mem_gib", "setup_s"}


def cell_lengths(cell):
    traffic, rate = cell.traffic, cell.config["parameters"]["internal_sample_rate"]
    targets = fixed_lengths(traffic["target_seconds"], traffic["targets"], rate)
    references = fixed_lengths(traffic["reference_seconds"], traffic["references"], rate)
    return targets, references * (traffic["batch"] // traffic["references"])


def test_the_farm_cell_pads_a_third_of_its_samples(monkeypatch):
    cell = harness.Cell.load(FARM)
    assert cell.config["batch"] == cell.traffic["batch"] == 16 and cell.config["reduced"] == ["batch"]
    targets, references = cell_lengths(cell)
    bucket = cell.config["parameters"]["length_bucketing"]
    n, m = (reference_farm.bucket_length(lengths, bucket) for lengths in (targets, references))
    assert (n, m) == (18_350_080, 17_825_792)
    assert sum(targets) / 44100 == pytest.approx(4320.0, abs=1e-3)  # every call, every seed
    padded, true = 16 * (n + m), sum(targets) + sum(references)  # as master_batch counts them
    b = Calls()
    farm_call(b, 1, 100.0, padded, true)
    run = make_run(1, b.spans, monkeypatch, cell=FARM)
    run.trace = devtrace.Trace([], [("window", 0, 100 * MS), ("call", 0, 20 * MS)])
    assert harness.reader("padding_share")(run) == pytest.approx(34.2, abs=0.1)


def test_the_staged_cell_takes_the_song_pools_lengths():
    staged, song = harness.Cell.load(STAGED), harness.Cell.load("song44k.process_wav16")
    for key in ("targets", "references", "target_seconds", "reference_seconds", "target", "reference"):
        assert staged.traffic[key] == song.traffic[key]
    assert staged.traffic["batch"] == 1 and staged.config == song.config


def test_the_reference_pads_each_pair_to_the_bucket():
    rng = np.random.default_rng(5)
    targets = [rng.standard_normal((n, 2)) * 0.1 for n in (9000, 12000)]
    references = [rng.standard_normal((n, 2)) * 0.3 for n in (11000, 8000)]
    n_pad = reference_farm.bucket_length([t.shape[0] for t in targets], 1 << 12)
    assert n_pad == 12288
    rows = reference_farm.master_rows(targets, references, {"fft_size": 1024}, n_pad)
    assert rows.shape == (2, n_pad, 2) and not rows[0, 9000:].any()
    assert np.array_equal(rows[1, :12000], reference.master(targets[1], references[1], {"fft_size": 1024}))


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(card, name):
    cell = small(name)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        sound = calibrate.readings(cell, seed, False, "cuda")["checks"]
        control = calibrate.readings(cell, seed, True, "cuda")["checks"]
        assert all(sound[k] <= cell.limits[k] for k in cell.limits), sound
        assert control["rel_rms_error"] > cell.limits["rel_rms_error"], control
