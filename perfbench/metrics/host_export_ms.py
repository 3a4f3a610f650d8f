"""Median per call from ``Code.INFO_EXPORTING`` (2008) to
``Code.INFO_COMPLETED`` (2010), ms: the result's copy to the host (so any
device work still queued lands here), the PCM_16 encode and the write."""

from perfbench import arithmetic


def read(run):
    return arithmetic.median_between(run, 2008, 2010)
