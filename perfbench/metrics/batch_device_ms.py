"""Median per call of the device time of the port's ``batch`` spans
(``parallel.batch.master_batch``: the lengths' and tracks' staging and
the graph over every row), ms, between the CUDA events they record
(``perfbench/callspans.py``).  None in a program without the span."""

from perfbench import callspans


def read(run):
    return callspans.median_per_call(run, lambda call: call.device_ms("batch"))
