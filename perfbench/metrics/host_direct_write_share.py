"""Median per call of the share of the bytes read back from the card that
were written to their file straight from the block they crossed into, %:
the port's ``direct_out_bytes`` counter over its ``d2h_bytes``, their
change over the call's root span (``trace``; ``perfbench/spans.py``).
None in a program that has no ``direct_out_bytes`` counter."""

from perfbench import spans


def _share(call):
    counters = call.root.counters or {}
    if "direct_out_bytes" not in counters or not counters.get("d2h_bytes"):
        return None
    return 100.0 * counters["direct_out_bytes"] / counters["d2h_bytes"]


def read(run):
    return spans.median_per_call(run, _share)
