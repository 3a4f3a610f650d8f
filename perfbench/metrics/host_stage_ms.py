"""Median per call of the port's ``stage`` spans, ms: both tracks' fill
of page-locked memory and their enqueued copy to the card
(``utils.to_device``; ``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.host_ms("stage"))
