"""Median per call from ``Code.INFO_LOADING`` (2003) to
``Code.INFO_MATCHING_LEVELS`` (2004), ms: both decodes, the checks, the
staging of both tracks on the device and the equality check."""

from perfbench import arithmetic


def read(run):
    return arithmetic.median_between(run, 2003, 2004)
