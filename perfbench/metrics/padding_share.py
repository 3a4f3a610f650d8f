"""Median per call of the share of the padded samples that lie past a
true length, %: the port's ``batch.padded_samples`` less its
``batch.true_samples``, over ``batch.padded_samples``, their change over
the call's ``batch`` roots (targets and references together;
``perfbench/callspans.py``).  None in a program without the counters."""

from perfbench import callspans


def _share(call):
    padded = callspans.root_counter(call, "batch.padded_samples")
    true = callspans.root_counter(call, "batch.true_samples")
    if not padded or true is None:
        return None
    return 100.0 * (padded - true) / padded


def read(run):
    return callspans.median_per_call(run, _share)
