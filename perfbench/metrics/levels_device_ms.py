"""Median per call of the device time of the port's ``levels`` span
(``stages.master_graph``), ms, between the CUDA events it records: stage
1: the normalised reference, the mid and side channels and the loudest-
piece RMS (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.device_ms("levels"))
