"""Median per call of the port's ``host_reads`` counter, the change over
the call's root span: the card's values read into host values, each a
wait for the card (``trace``; ``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.counter("host_reads"))
