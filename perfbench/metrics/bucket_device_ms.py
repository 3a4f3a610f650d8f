"""Median per call of the device time of the port's ``bucket`` spans
(``parallel.batch.bucket_pad``, once per role: the zeroed batch and each
track's copy into its row), ms, between the CUDA events they record
(``perfbench/callspans.py``).  None in a program without the span."""

from perfbench import callspans


def read(run):
    return callspans.median_per_call(run, lambda call: call.device_ms("bucket"))
