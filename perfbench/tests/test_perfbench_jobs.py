"""The cell ``farmwav44k.jobs8`` (entry ``jobs``: ``process_batch`` file
to file, every job writing its master and both previews): the traffic's
arithmetic from its files, whole runs on the CPU at a tiny size, broken
answers reading not correct, the plain reference's previews on a signal
whose loudest window is known, and the cell's readers on hand-built spans."""

import json
import os

import numpy as np
import pytest

from perfbench import devtrace, harness
from perfbench.entries.process import fixed_lengths
from perfbench.reference import farm as reference_farm
from perfbench.reference import preview as reference_preview
from perfbench.tests.test_perfbench_imports import top_level_imports
from perfbench.tests.test_perfbench_spans import Calls, make_run

CELL = "farmwav44k.jobs8"
SEED = 2**31 + 29
READERS = ("pairs_host_ms", "preview_ms", "padding_share.song")  # new with the cell
HOST_READERS = ("host_decode_ms", "host_stage_ms", "host_checks_ms", "host_fetch_ms", "host_encode_ms",
                "host_reads_per_call", "host_device_mb_per_call", "host_direct_read_share",
                "host_direct_write_share")  # the song cell's, reading the same spans under this root


def small():
    """The cell with a batch of 4 over 2 references of 7-10 s, a bucket of
    2^15, previews of 5.5 s on a 1.5 s grid (``Config`` takes no shorter),
    and the compared call the first, which a window always reaches."""
    cell = harness.Cell.load(CELL)
    cell.traffic.update(batch=4, targets=4, references=2, target_seconds=[7, 10], reference_seconds=[7, 10],
                        compare_among_first=1)
    cell.config["parameters"].update(length_bucketing=1 << 15, preview_size=5.5, preview_analysis_step=1.5,
                                     preview_fade_size=0.25)
    return cell


def test_the_traffic_masters_2160_s_a_call_on_a_third_of_padding():
    cell = harness.Cell.load(CELL)
    traffic, parameters = cell.traffic, cell.config["parameters"]
    song = harness.Cell.load("song44k.process_wav16")
    assert cell.config["batch"] == traffic["batch"] == 8 and cell.config["reduced"] == ["batch"]
    assert {k: v for k, v in parameters.items() if k != "length_bucketing"} == song.config["parameters"]
    assert (parameters["preview_size"], parameters["preview_analysis_step"], parameters["preview_fade_size"]) == (
        30.0, 5.0, 1.0)
    for key in ("targets", "references", "target_seconds", "reference_seconds", "target", "reference"):
        assert traffic[key] == song.traffic[key]
    targets = fixed_lengths(traffic["target_seconds"], traffic["targets"], 44100)
    references = fixed_lengths(traffic["reference_seconds"], traffic["references"], 44100) * 2
    assert [n / 44100 for n in targets] == pytest.approx([138.75 + 37.5 * i for i in range(8)])
    assert sorted({n / 44100 for n in references}) == pytest.approx([157.5, 232.5, 307.5, 382.5])
    assert sum(targets) / 44100 == pytest.approx(2160.0, abs=1e-3)
    n, m = (reference_farm.bucket_length(lengths, parameters["length_bucketing"])
            for lengths in (targets, references))
    assert (n, m) == (17_825_792, 17_039_360)
    padded, true = 8 * (n + m), sum(targets) + sum(references)  # as master_pairs counts them
    assert 100.0 * (padded - true) / padded == pytest.approx(31.70, abs=0.005)


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_a_run_on_the_cpu(trace):
    line = harness.run_cell(CELL, SEED, 1.0, trace, device="cpu", cell=small())
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    assert set(line["metrics"]) == (set() if trace else {"audio_s_per_s.song", "setup_s"})  # none of the card's
    assert line["checks"]["preview_window_mismatch"]["value"] == 0
    assert line["checks"]["missing_files"]["value"] == 0
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("fault", ["altered", "window"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    from matchering_tpu_torch import preview, stages
    from matchering_tpu_torch.parallel import batch

    if fault == "altered":  # every master 0.009 dB louder
        real = stages.master_graph

        def broken(*args, **kwargs):
            out = real(*args, **kwargs)
            return out._replace(result=out.result * 1.001)

        monkeypatch.setattr(batch, "master_graph", broken)
    else:  # the window after the loudest, where there is one
        search = preview._loudest_window_index

        def broken(result, window, step):
            count = (result.shape[0] - window) // step + 1
            return (search(result, window, step) + 1) % count

        monkeypatch.setattr(preview, "_loudest_window_index", broken)
    line = harness.run_cell(CELL, SEED, 1.0, False, device="cpu", cell=small())
    assert line["failed"] == 0 and not line["correct"]
    failing = {k for k, v in line["checks"].items() if v["value"] > v["limit"]}
    assert failing >= ({"code_mismatch_pct"} if fault == "altered" else {"preview_window_mismatch"})


def test_the_reference_cuts_the_loudest_window_and_fades_it():
    """Quiet noise with one loud stretch on the grid: that window is
    chosen, the target's piece is clipped and both pieces fade."""
    window, step = 400, 100
    rng = np.random.default_rng(3)
    result = rng.standard_normal((2000, 2)) * 0.01
    result[700:1100] *= 50.0  # window 7 holds all of it
    target = np.full((2000, 2), 0.9)
    target[::2] = -1.0  # over the threshold
    overrides = {"internal_sample_rate": 1000, "preview_size": 0.4, "preview_analysis_step": 0.1,
                 "preview_fade_size": 0.03, "threshold": 0.95}
    target_piece, result_piece, index, gap = reference_preview.preview(target, result, overrides)
    energies = reference_preview.window_energies(result, window, step)
    assert energies.shape == (17,) and index == 7 == int(np.argmax(energies))
    assert gap == pytest.approx((energies[7] - np.sort(energies)[-2]) / energies[7]) and gap > 0.1
    fade = min(30, int(400 // 8.0))
    ramp = np.linspace(0.0, 1.0, fade)[:, None]
    np.testing.assert_array_equal(result_piece[fade:-fade], result[700 + fade : 1100 - fade])
    np.testing.assert_allclose(result_piece[:fade], result[700 : 700 + fade] * ramp)
    np.testing.assert_allclose(result_piece[-fade:], result[1100 - fade : 1100] * ramp[::-1])
    assert np.abs(target_piece).max() == 0.95 and target_piece[0, 0] == 0.0
    np.testing.assert_array_equal(target_piece[fade:-fade], np.clip(target[700 + fade : 1100 - fade], -0.95, 0.95))


@pytest.mark.parametrize("seconds", [0.4, 0.3], ids=["piece-is-track", "track-shorter"])
def test_a_piece_that_is_the_whole_track_is_not_faded(seconds):
    result = np.random.default_rng(4).standard_normal((int(seconds * 1000), 2)) * 0.1
    overrides = {"internal_sample_rate": 1000, "preview_size": 0.4, "preview_analysis_step": 0.1}
    target_piece, result_piece, index, gap = reference_preview.preview(result, result, overrides)
    assert index == 0 and gap is None
    np.testing.assert_array_equal(result_piece, result)


def test_the_reference_imports_nothing_of_the_program():
    path = os.path.join(harness.HERE, "reference", "preview.py")
    assert top_level_imports(path) <= {"__future__", "typing", "numpy"}


def jobs_call(b, t0, scale, padded, true):
    """A process_batch call at ``t0`` ms: two jobs' loads and checks, the
    buckets, ``pairs`` with a graph's stage, then each job's fetch and
    encode and its preview (which fetches and encodes its pieces)."""
    s = scale
    counters = {"batch.rows": 2, "batch.padded_samples": padded, "batch.true_samples": true, "host_reads": 12,
                "h2d_bytes": 3_000_000, "d2h_bytes": 1_000_000, "direct_bytes": 2_400_000,
                "direct_out_bytes": 900_000}
    b.add(("process_batch", t0, t0 + 30 * s, [
        ("load", t0, t0 + 2 * s, [], None),
        ("check", t0 + 2 * s, t0 + 3 * s, [("stage", t0 + 2 * s, t0 + 2.5 * s, [], None)], None),
        ("load", t0 + 3 * s, t0 + 5 * s, [], None),
        ("check", t0 + 5 * s, t0 + 6 * s, [("stage", t0 + 5 * s, t0 + 5.5 * s, [], None)], None),
        ("equality", t0 + 6 * s, t0 + 7 * s, [], None),
        ("bucket", t0 + 8 * s, t0 + 9 * s, [], 0.5 * s),
        ("pairs", t0 + 9 * s, t0 + 12 * s, [("levels", t0 + 9 * s, t0 + 10 * s, [], 1.0)], None),
        ("fetch", t0 + 12 * s, t0 + 16 * s, [], None),
        ("encode", t0 + 16 * s, t0 + 17 * s, [], None),
        ("preview", t0 + 20 * s, t0 + 22 * s, [("fetch", t0 + 20 * s, t0 + 21 * s, [], None)], None),
        ("preview", t0 + 23 * s, t0 + 25 * s, [("encode", t0 + 24 * s, t0 + 25 * s, [], None)], None),
    ], None), counters=counters)


def jobs_run(monkeypatch, b, calls, device_type="cuda"):
    """A run of ``calls`` calls, each at a ``t0`` of ``calls``, with the
    harness's ``call`` ranges in its trace (``padding_share`` groups by
    them)."""
    run = make_run(len(calls), b.spans, monkeypatch, window=(0, 200 * 1_000_000), device_type=device_type,
                   cell=CELL)
    ranges = [("call", int((t0 - 0.5) * 1_000_000), int((t0 + 30 * s + 0.5) * 1_000_000)) for t0, s in calls]
    run.trace = devtrace.Trace([], [("window", 0, 200 * 1_000_000)] + ranges)
    return run


def test_the_readers_give_medians_per_call(monkeypatch):
    b = Calls()
    calls = ((1, 1.0), (40, 2.0), (110, 0.5))
    for t0, scale in calls:
        jobs_call(b, t0, scale, padded=1000, true=683)
    run = jobs_run(monkeypatch, b, calls)
    read = {name: harness.reader(name)(run) for name in READERS + HOST_READERS}
    assert read == pytest.approx({
        "pairs_host_ms": 3.0, "preview_ms": 4.0, "padding_share.song": 31.7,
        "host_decode_ms": 4.0, "host_stage_ms": 1.0, "host_checks_ms": 2.0, "host_fetch_ms": 5.0,
        "host_encode_ms": 2.0, "host_reads_per_call": 12, "host_device_mb_per_call": 4.0,
        "host_direct_read_share": 80.0, "host_direct_write_share": 90.0,
    })


@pytest.mark.parametrize("case", ["no_root", "off_the_card"])
def test_no_value_from_a_program_without_the_spans(monkeypatch, case):
    """The parent's program runs process_batch with no root span: each
    job's loads and checks, the buckets and each graph's stages are roots.
    The readers give nothing there and do not raise."""
    b = Calls()
    for t0 in (1, 40):
        for k in range(4):
            b.add(("load", t0 + k, t0 + k + 1, [], None), counters={"host_reads": 0})
        b.add(("levels", t0 + 5, t0 + 6, [], 1.0), counters={})
    run = jobs_run(monkeypatch, b, ((1, 1.0), (40, 1.0)))
    if case == "off_the_card":
        b = Calls()
        jobs_call(b, 1, 1.0, 1000, 683)
        run = jobs_run(monkeypatch, b, ((1, 1.0),), device_type="cpu")
    for name in READERS + HOST_READERS:
        assert harness.reader(name)(run) is None
