"""Median per call of the port's ``graph`` span, ms: ``stages.main``, the
mastering graph's enqueue and the report's read, which waits for the
card to finish it (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.host_ms("graph"))
