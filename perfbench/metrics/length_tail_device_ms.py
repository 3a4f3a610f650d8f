"""Median per call of the device time of the port's ``length_tail``
spans (``ops.iir._filtfilt_rows``: the attack filtfilt's per-row tail
extension, which only the length path runs), ms, between the CUDA events
they record (``perfbench/callspans.py``).  None in a program without the
span."""

from perfbench import callspans


def read(run):
    return callspans.median_per_call(run, lambda call: call.device_ms("length_tail"))
