"""The program's spans by call of the entry, where one call of the entry
makes several calls of the program, each its own root span: the farm's
call pads two buckets (``bucket``) and masters one batch (``batch``).

``perfbench/spans.py`` groups a call by its one root; here every root
whose midpoint lies inside the harness's ``call`` range of the traced
window (``devtrace.Trace.calls``, the profiler's clock, which the spans
share) joins that call, with all of its spans.  It reads the card's runs
only, and returns None where the program records no spans or where the
trace's call ranges are not one per call of the run.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Callable, List, Optional

from perfbench import spans


def calls(run) -> Optional[List[spans.Call]]:
    """One ``spans.Call`` per call of the run (its ``root`` None: a call
    may have several), or None."""
    if run.trace is None or run.device_type != "cuda":
        return None
    try:
        from matchering_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    ranges = run.trace.calls
    if not ranges or len(ranges) != len(run.calls):
        return None
    starts = [start for start, _ in ranges]
    recorded = [s for s in trace.spans() if s.end_ns is not None]
    of_call = {}  # a root's call id -> the index of the entry's call it lies in
    for root in (s for s in recorded if s.parent is None):
        middle = (root.start_ns + root.end_ns) // 2
        i = bisect.bisect_right(starts, middle) - 1
        if i >= 0 and middle <= ranges[i][1]:
            of_call[root.call] = i
    grouped = [[] for _ in ranges]
    for s in recorded:
        if s.call in of_call:
            grouped[of_call[s.call]].append(s)
    return [spans.Call(None, group) for group in grouped]


def median_per_call(run, value: Callable[[spans.Call], Optional[float]]) -> Optional[float]:
    """The median over the window's calls of ``value(call)``; None where
    ``calls(run)`` is None or any call's value is."""
    found = calls(run)
    if found is None:
        return None
    values = [value(call) for call in found]
    if any(v is None for v in values):
        return None
    return statistics.median(values)


def root_counter(call: spans.Call, name: str) -> Optional[int]:
    """The counter ``name``'s change summed over the call's roots; None
    where no root has it (a program without the counter)."""
    values = [s.counters[name] for s in call.spans if s.parent is None and s.counters and name in s.counters]
    return sum(values) if values else None
