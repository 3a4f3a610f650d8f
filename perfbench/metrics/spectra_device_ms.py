"""Median per call of the device time of the port's ``spectra`` span
(``stages.master_graph``), ms, between the CUDA events it records: stage
2: the masked average spectra and the two matching FIRs
(``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.device_ms("spectra"))
