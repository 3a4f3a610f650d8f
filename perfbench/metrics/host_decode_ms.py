"""Median per call of the port's ``load`` spans, ms: both tracks' file
read and decode (``io/loader.load``; ``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.host_ms("load"))
