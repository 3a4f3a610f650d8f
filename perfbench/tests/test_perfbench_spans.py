"""The readers of the program's spans and counters (``perfbench/spans.py``)
on spans built by hand: medians per call, self time, device time, the
counters' change on the root, and no value where the window's roots are
not one per call, off the card, or in a program without spans."""

import sys
from types import SimpleNamespace

import pytest

from perfbench import devtrace, harness

KIND = "NVIDIA H100 80GB HBM3"
MS = 1_000_000  # ns


def make_run(calls, spans, monkeypatch, window=(0, 100 * MS), device_type="cuda", cell="song44k.process_wav16"):
    from matchering_tpu_torch import trace

    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return harness.Run(
        cell=harness.Cell.load(cell), device_type=device_type, device_kind=KIND, setup_s=1.0,
        window=(0.0, 1.0), calls=[harness.Call(0.0, 1.0, 1.0, 1, 4) for _ in range(calls)], peak_bytes=None,
        trace=devtrace.Trace([], [("window", *window)]), peaks={},
    )


class Calls:
    """Spans of calls, each a tree given as (name, start ms, end ms, children, device ms)."""

    def __init__(self):
        self.spans, self.next_id, self.next_call = [], 1, 1

    def add(self, node, call=None, parent=None, counters=None):
        name, start, end, children, device_ms = node
        if call is None:
            call, self.next_call = self.next_call, self.next_call + 1
        span = SimpleNamespace(call=call, id=self.next_id, parent=parent, name=name, start_ns=int(start * MS),
                               end_ns=int(end * MS), counters=counters, device_ms=device_ms)
        self.next_id += 1
        self.spans.append(span)
        for child in children:
            self.add(child, call, span.id)
        return span


def song_call(t0, scale, counters):
    """A process() call starting at ``t0`` ms whose host steps take ``scale`` times a base."""
    s = scale
    return ("process", t0, t0 + 20 * s, [
        ("load", t0, t0 + 3 * s, [], None),
        ("check", t0 + 3 * s, t0 + 5 * s, [("stage", t0 + 3.5 * s, t0 + 4 * s, [], None)], None),
        ("load", t0 + 5 * s, t0 + 7 * s, [], None),
        ("check", t0 + 7 * s, t0 + 8 * s, [("stage", t0 + 7 * s, t0 + 7.5 * s, [], None)], None),
        ("equality", t0 + 8 * s, t0 + 8.25 * s, [], None),
        ("graph", t0 + 8.25 * s, t0 + 12 * s, [("master", t0 + 8.3 * s, t0 + 9 * s, [], None)], None),
        ("fetch", t0 + 12 * s, t0 + 13 * s, [], None),
        ("encode", t0 + 13 * s, t0 + 19 * s, [], None),
    ], None), counters


def song_run(monkeypatch, **kwargs):
    b = Calls()
    for t0, scale in ((1, 1.0), (30, 2.0), (80, 0.5)):
        node, counters = song_call(t0, scale, {"host_reads": 11, "h2d_bytes": 150_000_000, "d2h_bytes": 40_000_048})
        b.add(node, counters=counters)
    return make_run(3, b.spans, monkeypatch, **kwargs), b


def test_host_spans_give_medians_per_call(monkeypatch):
    run, _ = song_run(monkeypatch)
    read = lambda name: harness.reader(name)(run)  # noqa: E731
    assert read("host_decode_ms") == pytest.approx(5.0)  # both loads: 3 + 2 ms at scale 1
    assert read("host_stage_ms") == pytest.approx(1.0)
    assert read("host_checks_ms") == pytest.approx(2.0 + 0.25)  # checks' self time 1.5 + 0.5, equality 0.25
    assert read("graph_host_ms") == pytest.approx(3.75)  # the graph span, its master child included
    assert read("host_fetch_ms") == pytest.approx(1.0)
    assert read("host_encode_ms") == pytest.approx(6.0)
    assert read("host_reads_per_call") == 11
    assert read("host_device_mb_per_call") == pytest.approx(190.000048)


def test_device_spans_give_their_device_time(monkeypatch):
    b = Calls()
    for i, t0 in enumerate((1, 40)):
        b.add(("master", t0, t0 + 30, [(name, t0 + j, t0 + j + 1, [], 10.0 * (j + 1) + i)
                                       for j, name in enumerate(["levels", "spectra", "convolve", "correction",
                                                                 "finalize"])], 60.0), counters={})
    run = make_run(2, b.spans, monkeypatch, cell="longform96k.master")
    for j, name in enumerate(["levels", "spectra", "convolve", "correction", "finalize"]):
        assert harness.reader(f"{name}_device_ms")(run) == pytest.approx(10.0 * (j + 1) + 0.5)
    b.spans[1].device_ms = None  # a span without its device time: no value
    assert harness.reader("levels_device_ms")(run) is None


def test_only_roots_inside_the_window_count(monkeypatch):
    run, b = song_run(monkeypatch, window=(0, 50 * MS))  # the third call lies past the window
    assert harness.reader("host_encode_ms")(run) is None  # two roots for three calls
    run.calls = run.calls[:2]
    assert harness.reader("host_encode_ms")(run) == pytest.approx(9.0)  # the median of 6 and 12


@pytest.mark.parametrize("case", ["more_roots", "off_the_card", "no_trace", "no_spans_in_the_program"])
def test_no_value_where_the_spans_cannot_be_read(monkeypatch, case):
    run, b = song_run(monkeypatch)
    if case == "more_roots":
        run.calls = run.calls[:2]
    elif case == "off_the_card":
        run.device_type = "cpu"
    elif case == "no_trace":
        run.trace = None
    else:
        monkeypatch.delattr(sys.modules["matchering_tpu_torch"], "trace")
        monkeypatch.setitem(sys.modules, "matchering_tpu_torch.trace", None)
    for name in ("host_decode_ms", "host_reads_per_call", "levels_device_ms"):
        assert harness.reader(name)(run) is None
