"""``process_batch`` file to file with previews against the benchmark's
plain float64 reference (``perfbench/reference``), on the CPU.

Three seeded PCM_16 WAV jobs of 6.5-9 s at 44.1 kHz, a bucket of 2^15,
the default dispatch (pipelined on one device), and the song
configuration with previews of 5.5 s on a 1.5 s grid faded over 0.25 s
(``Config`` refuses a preview of 5 s or less, or a step of 1 s or less, as
upstream's does).  Jobs 0 and 1 ask for both previews, job 2 for none.
Each master and preview file must hold the reference's codes of the
unpadded pair (float64: within one code step; float32: within the song
cell's limits), each preview cut at the reference's window.  The call,
recorded, is one ``process_batch`` tree whose counters follow from the
bucket arithmetic.  Imports no JAX."""

import numpy as np
import pytest
import torch

import matchering_tpu_torch as mt
from matchering_tpu_torch import preview, trace
from perfbench import harness, signals, wavfile
from perfbench.entries import jobs as entry
from perfbench.reference import farm as reference_farm
from perfbench.reference import matchering as reference
from perfbench.reference import preview as reference_preview

SR = 44100
BUCKET = 1 << 15
JOBS = 3
PREVIEWS = (True, True, False)  # which jobs ask for both previews
SONG = harness.Cell.load("song44k.process_wav16")
CELL = harness.Cell.load("farmwav44k.jobs8")
PARAMETERS = {**CELL.config["parameters"], "length_bucketing": BUCKET, "preview_size": 5.5,
              "preview_analysis_step": 1.5, "preview_fade_size": 0.25}
OUTPUTS = ("master", "preview_target", "preview_result")


def _codes(rng, gen, role):
    seconds = rng.uniform(6.5, 9.0)
    track = signals.track(int(seconds * SR), SR, CELL.traffic[role], gen, "cpu")
    return signals.pcm16(track).numpy()


@pytest.fixture(scope="module")
def farm(tmp_path_factory):
    """The pairs' codes, the reference's files' codes and windows, and
    each dtype's files, counters and spans (one recorded call each)."""
    folder = tmp_path_factory.mktemp("jobs")
    rng = np.random.default_rng(2**31 + 25)
    gen = signals.generator(2**31 + 25, "cpu")
    pairs = [(_codes(rng, gen, "target"), _codes(rng, gen, "reference")) for _ in range(JOBS)]
    paths = []
    for i, pair in enumerate(pairs):
        paths.append([str(folder / f"{role}{i}.wav") for role in ("target", "reference")])
        for path, codes in zip(paths[-1], pair):
            wavfile.write(path, codes, SR)
    expected = []
    for target, ref in pairs:
        master = reference.master(target / 32768.0, ref / 32768.0, PARAMETERS)
        target_piece, result_piece, index, gap = reference_preview.preview(target / 32768.0, master, PARAMETERS)
        expected.append({"master": reference.pcm16_codes(master), "window": index, "gap": gap,
                         "preview_target": reference.pcm16_codes(target_piece),
                         "preview_result": reference.pcm16_codes(result_piece)})
    out = {"pairs": pairs, "expected": expected}
    for dtype in ("float64", "float32"):
        config = harness.port_config(mt, {**PARAMETERS, "dtype": dtype})
        jobs = []
        for i, (target, ref) in enumerate(paths):
            files = {name: str(folder / f"{dtype}_{i}_{name}.wav") for name in OUTPUTS}
            previews = dict(preview_target=mt.pcm16(files["preview_target"]),
                            preview_result=mt.pcm16(files["preview_result"])) if PREVIEWS[i] else {}
            jobs.append(mt.PairJob(target, ref, [mt.pcm16(files["master"])], **previews))
        trace.clear()
        with trace.recording():
            mt.process_batch(jobs, config, device="cpu")
        out[dtype] = {
            "files": [{name: wavfile.read(str(folder / f"{dtype}_{i}_{name}.wav"))[0]
                       for name in OUTPUTS if name == "master" or PREVIEWS[i]} for i in range(JOBS)],
            "spans": trace.spans(),
        }
    trace.clear()
    return out


def _steps(got, want):
    assert got.shape == want.shape
    return np.abs(got.astype(np.int32) - want)


CASES = [(i, name) for i in range(JOBS) for name in OUTPUTS if name == "master" or PREVIEWS[i]]


@pytest.mark.parametrize("job, name", CASES)
def test_float64_files_hold_the_references_codes(farm, job, name):
    assert _steps(farm["float64"]["files"][job][name], farm["expected"][job][name]).max() <= 1


@pytest.mark.parametrize("job, name", CASES)
def test_float32_files_sit_inside_the_song_cells_limits(farm, job, name):
    steps = _steps(farm["float32"]["files"][job][name], farm["expected"][job][name])
    assert 100.0 * np.count_nonzero(steps) / steps.size <= SONG.limits["code_mismatch_pct"]
    assert steps.max() <= SONG.limits["max_code_steps"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("job", [i for i in range(JOBS) if PREVIEWS[i]])
def test_each_preview_takes_the_references_window(farm, dtype, job):
    want = farm["expected"][job]
    got = entry.window_of(farm[dtype]["files"][job]["preview_target"], farm["pairs"][job][0], PARAMETERS)
    assert got == want["window"]
    assert want["gap"] > 1e-4  # the window is a choice, not a near tie


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_a_recorded_call_is_one_process_batch_tree(farm):
    spans = farm["float32"]["spans"]
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "process_batch" and len({s.call for s in spans}) == 1
    counts = {name: len(_named(spans, name)) for name in ("load", "check", "equality", "pairs", "preview")}
    assert counts == {"load": 2 * JOBS, "check": 2 * JOBS, "equality": JOBS, "pairs": 1, "preview": sum(PREVIEWS)}
    for name in counts:
        assert all(by_id[s.parent] is root for s in _named(spans, name))
    (pairs,) = _named(spans, "pairs")
    assert sum(1 for s in spans if s.parent == pairs.id and s.name == "levels") == JOBS  # one graph a pair
    # each job's master and each preview piece asked for is fetched and encoded
    pieces = sum(PREVIEWS) * 2
    assert len(_named(spans, "encode")) == JOBS + pieces


def test_the_pairs_counters_follow_the_buckets(farm):
    (root,) = [s for s in farm["float32"]["spans"] if s.parent is None]
    lengths = [[codes.shape[0] for codes in role] for role in zip(*farm["pairs"])]
    n, m = (reference_farm.bucket_length(role, BUCKET) for role in lengths)
    assert root.counters["batch.rows"] == JOBS  # one row a graph
    assert root.counters["batch.padded_samples"] == JOBS * (n + m)
    assert root.counters["batch.true_samples"] == sum(map(sum, lengths))


@pytest.mark.parametrize("n, reads", [(SR, 1), (2 * SR // 5, 0)], ids=["windows", "one-window"])
def test_the_window_search_reads_back_once(n, reads):
    """The argmax crosses to the host once where there is a choice."""
    result = torch.from_numpy(np.random.default_rng(7).standard_normal((n, 2)))
    before = trace.counts().get("host_reads", 0)
    preview._loudest_window_index(result, 2 * SR // 5, SR // 10)
    assert trace.counts().get("host_reads", 0) - before == reads
