"""The reader of the port's ``direct_out_bytes`` counter
(``metrics/host_direct_write_share.py``) on spans built by hand: the
median per call of its share of ``d2h_bytes``, and no value in a program
that lacks the counter."""

import pytest

from perfbench import harness
from perfbench.tests.test_perfbench_spans import Calls, make_run, song_call


def direct_run(monkeypatch, direct):
    b = Calls()
    for (t0, scale), share in zip(((1, 1.0), (30, 2.0), (80, 0.5)), direct):
        counters = {"host_reads": 11, "h2d_bytes": 150_000_000, "d2h_bytes": 40_000_000}
        if share is not None:
            counters["direct_out_bytes"] = int(40_000_000 * share)
        b.add(song_call(t0, scale, counters)[0], counters=counters)
    return make_run(3, b.spans, monkeypatch)


@pytest.mark.parametrize("direct, want", [((1.0, 1.0, 1.0), 100.0), ((1.0, 0.5, 0.0), 50.0), ((0.0,) * 3, 0.0)])
def test_the_share_is_the_median_per_call(monkeypatch, direct, want):
    assert harness.reader("host_direct_write_share")(direct_run(monkeypatch, direct)) == pytest.approx(want)


def test_no_value_without_the_counter(monkeypatch):
    """The counter of a program that writes no result from its codes'
    block is absent from its roots: the reader gives nothing and does not
    raise."""
    assert harness.reader("host_direct_write_share")(direct_run(monkeypatch, (None,) * 3)) is None
