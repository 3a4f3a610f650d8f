"""Median per call of the bytes between the host and the card, MB (1e6
bytes): the port's ``h2d_bytes`` and ``d2h_bytes`` counters, the change
over the call's root span (``trace``; ``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: (call.counter("h2d_bytes") + call.counter("d2h_bytes")) / 1e6)
