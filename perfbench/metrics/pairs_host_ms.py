"""Median per call of the host wall time of the port's ``pairs`` span,
ms: the staging and the enqueue of every pipelined graph
(``parallel.batch.master_pairs``; ``perfbench/spans.py``).  None in a
program without the span."""

from perfbench import spans


def _ms(call):
    return call.host_ms("pairs") if call.named("pairs") else None


def read(run):
    return spans.median_per_call(run, _ms)
