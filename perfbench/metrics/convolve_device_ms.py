"""Median per call of the device time of the port's ``convolve`` span
(``stages.master_graph``), ms, between the CUDA events it records: the
stacked FFT convolution of mid and side and their return to left and right
(``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.device_ms("convolve"))
