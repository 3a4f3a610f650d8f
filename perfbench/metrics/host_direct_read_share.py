"""Median per call of the share of the bytes staged on the card that were
read from their file straight into the block they cross from, %: the
port's ``direct_bytes`` counter over its ``h2d_bytes``, their change over
the call's root span (``trace``; ``perfbench/spans.py``).  None in a
program that has no ``direct_bytes`` counter."""

from perfbench import spans


def _share(call):
    counters = call.root.counters or {}
    if "direct_bytes" not in counters or not counters.get("h2d_bytes"):
        return None
    return 100.0 * counters["direct_bytes"] / counters["h2d_bytes"]


def read(run):
    return spans.median_per_call(run, _share)
