"""Median per call of the device time of the port's ``finalize`` span
(``stages.master_graph``), ms, between the CUDA events it records: stage
4: the limiter (K1, K2 and the elementwise tail) and the amplitude
coefficient (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.device_ms("finalize"))
