"""Median per call of the port's ``fetch`` spans, ms: each rendered
variant's copy from the card to page-locked memory (``utils.to_host``;
``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.host_ms("fetch"))
