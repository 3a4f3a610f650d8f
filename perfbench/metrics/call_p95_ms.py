"""95th percentile (linear between ranks, numpy's default) of the wall
time of every call in the window, host clock, in ms; a failed call counts
as never ending, so a tail that reaches one has no value."""

import math


def read(run):
    if not run.calls:
        return None
    times = sorted(1e3 * (c.end - c.start) if c.ok else math.inf for c in run.calls)
    rank = 0.95 * (len(times) - 1)
    lo, hi = math.floor(rank), math.ceil(rank)
    if math.isinf(times[hi]):
        return None
    return times[lo] + (rank - lo) * (times[hi] - times[lo])
