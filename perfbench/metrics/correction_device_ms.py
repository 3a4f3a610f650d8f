"""Median per call of the device time of the port's ``correction`` span
(``stages.master_graph``), ms, between the CUDA events it records: stage
3: the RMS-correction passes and the final scale (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.device_ms("correction"))
