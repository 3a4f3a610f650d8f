"""Median per call of the port's ``encode`` spans, ms: each result's
encode and write (``io/saver.save``; ``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.host_ms("encode"))
