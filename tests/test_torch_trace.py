"""The port's spans and counters (``matchering_tpu_torch.trace``) on the CPU.

A few-second PCM_16 pair through ``process()`` at ``Config(fft_size=1024)``
(no JAX, 44.1 kHz): nothing is recorded unless a profiler or
``trace.recording()`` asks; a recorded call is one tree of the spans
where the work happens, each inside its parent, on the profiler's clock;
its root carries the counters' change, which equals the reads and bytes
derived from the pair's shapes.  Torch runs on one thread here.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import matchering_tpu_torch as mt
from matchering_tpu_torch import trace
from matchering_tpu_torch.io import wav

SR = 44100
CONFIG = mt.Config(fft_size=1024)
GRAPH = ["levels", "spectra", "convolve", "correction", "finalize"]
# (name, parent's name) of a process() call's spans, in the order they open
PROCESS_TREE = [
    ("process", None),
    ("load", "process"), ("check", "process"), ("stage", "check"),
    ("load", "process"), ("check", "process"), ("stage", "check"),
    ("equality", "process"),
    ("graph", "process"), ("master", "graph"), *((name, "master") for name in GRAPH),
    ("fetch", "process"),
    ("encode", "process"),
]
REPORT_VALUES = 8  # stages.main reads the report: 4 levels and 4 RMS-correction coefficients at Config()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Paths of a 3 s target, a 4 s reference and a 3 s second reference
    (PCM_16 WAV), and an output path."""
    folder = tmp_path_factory.mktemp("trace")
    rng = np.random.default_rng(20261018)
    paths = {}
    for name, seconds, level in (("target", 3, 0.2), ("reference", 4, 0.5), ("same_length", 3, 0.5)):
        noise = rng.standard_normal((seconds * SR, 2)) * level
        paths[name] = str(folder / f"{name}.wav")
        wav.write(paths[name], np.clip(noise, -1, 1), SR, "PCM_16")
    paths["out"] = str(folder / "out.wav")
    mt.process(paths["target"], paths["reference"], [mt.pcm16(paths["out"])], CONFIG, device="cpu")  # warm
    return paths


def run_process(pair, reference="reference"):
    mt.process(pair["target"], pair[reference], [mt.pcm16(pair["out"])], CONFIG, device="cpu")


def tree(spans):
    names = {s.id: s.name for s in spans}
    return [(s.name, names.get(s.parent)) for s in sorted(spans, key=lambda s: (s.start_ns, s.id))]


def check_nesting(spans):
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert len(roots) == 1 and len({s.call for s in spans}) == 1
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns, (s, parent)
        children = sum(c.end_ns - c.start_ns for c in spans if c.parent == s.id)
        assert s.end_ns - s.start_ns - children >= 0, s
    return roots[0]


def test_nothing_is_recorded_without_a_profiler_or_recording(pair):
    trace.clear()
    run_process(pair)
    mt.master(torch.zeros(4096, 2), torch.ones(4096, 2) * 0.1, CONFIG, device="cpu")
    assert trace.spans() == []


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_a_process_call_is_one_tree(pair, how):
    trace.clear()
    if how == "recording":
        with trace.recording():
            run_process(pair)
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            run_process(pair)
    spans = trace.spans()
    assert tree(spans) == PROCESS_TREE
    root = check_nesting(spans)
    assert all(s.device_ms is None for s in spans)  # device time is a card's
    assert root.counters["host_reads"] == REPORT_VALUES + 2 + 1  # the report, the peak count, one fetch


@pytest.mark.parametrize("reference", ["reference", "same_length"])
def test_the_counters_of_a_call_follow_from_its_shapes(pair, reference):
    trace.clear()
    with trace.recording():
        run_process(pair, reference)
    (root,) = [s for s in trace.spans() if s.parent is None]
    n_target = 3 * SR
    n_reference = (4 if reference == "reference" else 3) * SR
    equal_shapes = n_reference == n_target  # check_equality reads its verdict back only then
    assert root.counters["host_reads"] == REPORT_VALUES + 2 + 1 + equal_shapes
    assert root.counters["h2d_bytes"] == 2 * 2 * (n_target + n_reference)  # int16 codes, stereo
    # the result's int16 codes, the report's float32 values, the float64 peak and its int64 count, the verdict
    assert root.counters["d2h_bytes"] == 2 * 2 * n_target + 4 * REPORT_VALUES + 8 + 8 + equal_shapes
    assert root.counters["direct_out_bytes"] == 2 * 2 * n_target  # the PCM_16 payload, written from its block
    assert not any(root.counters.get(f"launch.k{i}") for i in (1, 2, 3))


def test_a_pcm16_pair_is_read_straight_into_its_staging_blocks(pair):
    """Both tracks' payloads are read into the blocks they are staged
    from: every byte staged is a byte read so, and no more than the two
    files' payloads."""
    payload = sum(wav.read(pair[name], raw_int=True)[0].nbytes for name in ("target", "reference"))
    trace.clear()
    with trace.recording():
        run_process(pair)
    (root,) = [s for s in trace.spans() if s.parent is None]
    assert root.counters["direct_bytes"] == root.counters["h2d_bytes"]
    assert root.counters["h2d_bytes"] == payload == 2 * 2 * (3 + 4) * SR


def test_stage_is_recorded_once_per_track(pair):
    trace.clear()
    with trace.recording():
        run_process(pair)
    spans = trace.spans()
    names = {s.id: s.name for s in spans}
    stages = [s for s in spans if s.name == "stage"]
    assert len(stages) == 2 and all(names[s.parent] == "check" for s in stages)
    loads = sorted((s for s in spans if s.name == "load"), key=lambda s: s.start_ns)
    assert [s.end_ns <= t.start_ns for s, t in zip(loads, sorted(stages, key=lambda s: s.start_ns))] == [True, True]


def test_a_master_call_is_its_five_stages_in_order():
    rng = np.random.default_rng(7)
    target = torch.from_numpy(rng.standard_normal((2 * SR, 2)).astype(np.float32) * 0.2)
    reference = torch.from_numpy(rng.standard_normal((2 * SR, 2)).astype(np.float32) * 0.5)
    trace.clear()
    with trace.recording():
        mt.master(target, reference, CONFIG, device="cpu")
    spans = trace.spans()
    assert tree(spans) == [("master", None)] + [(name, "master") for name in GRAPH]
    root = check_nesting(spans)
    stages = sorted((s for s in spans if s.parent == root.id), key=lambda s: s.start_ns)
    assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))


def test_the_root_lies_in_the_profilers_range_around_the_call(pair):
    trace.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):  # a session's first range opens late
            pass
        with torch.profiler.record_function("call"):
            run_process(pair)
    (call,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "call"]
    start, end = call.start_ns(), call.start_ns() + call.duration_ns()
    (root,) = [s for s in trace.spans() if s.parent is None]
    assert start <= root.start_ns < start + 1_000_000
    assert end - 1_000_000 < root.end_ns <= end


def test_a_call_is_recorded_whole_or_not_at_all():
    trace.clear()
    with trace.span("outer"):
        with trace.recording():
            with trace.span("inner"):
                pass
    assert trace.spans() == []
    with trace.recording():
        outer = trace.span("outer")
        outer.__enter__()
    with trace.span("inner"):
        pass
    outer.__exit__(None, None, None)
    assert tree(trace.spans()) == [("outer", None), ("inner", "outer")]


def test_the_buffer_keeps_the_newest_spans():
    trace.clear()
    with trace.recording():
        for _ in range(trace.CAPACITY + 5):
            with trace.span("s"):
                pass
    spans = trace.spans()
    assert len(spans) == trace.CAPACITY and spans[-1].id - spans[0].id == trace.CAPACITY - 1
    trace.clear()
    assert trace.spans() == []


def test_device_spans_reuse_the_events_of_finished_spans(monkeypatch):
    """CUDA events stood in for by fakes: the events of calls the device
    has finished serve later calls; an event is never recorded again
    before the device has passed it."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            made.append(self)
            self.done, self.at = False, None

        def record(self, stream):
            assert self.at is None or self.done, "an event was reused before the device passed it"
            self.done, self.at = False, time.perf_counter()

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

        def elapsed_time(self, end):
            return 1e3 * (end.at - self.at)

    def device_runs():
        for event in made:
            event.done = True

    def call():
        with trace.recording(), trace.span("master", device="cuda"):
            for name in GRAPH:
                with trace.span(name, device="cuda"):
                    pass

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(device_index=0))
    monkeypatch.setattr(trace, "_free_events", {})
    monkeypatch.setattr(trace, "_unresolved", type(trace._unresolved)())
    trace.clear()
    per_call = 2 * (1 + len(GRAPH))
    call()
    call()  # the device has passed nothing yet: each call makes its own events
    assert len(made) == 2 * per_call
    device_runs()
    call()  # its root frees the two calls' events as it closes
    call()
    call()
    assert len(made) == 3 * per_call
    assert all(s.device_ms >= 0 for s in trace.spans())  # a read waits for the device


def test_the_counters_are_the_only_counters():
    from matchering_tpu_torch import utils
    from matchering_tpu_torch.kernels import envelope, scan, sos

    assert not any(hasattr(m, "LAUNCHES") for m in (envelope, scan, sos)) and not hasattr(utils, "HOST_READS")
    track = torch.from_numpy(np.random.default_rng(3).standard_normal((SR, 2)).astype(np.float32))
    before = trace.counts()
    mt.limit(track, CONFIG)  # the plain twins on the CPU launch nothing
    after = trace.counts()
    assert all(after.get(f"launch.k{i}", 0) == before.get(f"launch.k{i}", 0) for i in (1, 2, 3))
    value = torch.tensor(5)
    assert mt.utils.host_int(value) == 5
    assert trace.counts()["host_reads"] == after.get("host_reads", 0) + 1
