"""Median per call of the port's checks, ms: the ``check`` spans less
their ``stage`` children (the length bound, the stereo layout, the rate,
the target's peak count and its two host reads), plus the ``equality``
span (``checker.py``; ``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.median_per_call(run, lambda call: call.self_ms("check") + call.host_ms("equality"))
