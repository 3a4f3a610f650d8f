"""The program's own spans (``matchering_tpu_torch.trace``) in a traced
run, by call.

The port records its spans while the profiler records, stamped with
``time.time_ns()``: the clock of the profiler's events, so the window of
``run.trace`` (``devtrace.Trace.window``) selects them.  ``calls(run)``
keeps the calls whose root span lies in the window (its midpoint inside
it) and groups every recorded span by its call.  It reads the card's runs
only (a CPU rehearsal times the kernels' plain twins), and returns None
where the program records no spans (a program without ``trace``) or where
the window's roots are not one per call of the run, so a metric read from
it is the program's own or absent.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Callable, List, Optional


class Call:
    """One call's recorded spans: ``root`` and all of them (``spans``)."""

    def __init__(self, root, spans):
        self.root = root
        self.spans = spans

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def host_ms(self, name: str) -> float:
        """The wall time of every span ``name`` of the call, ms."""
        return sum(s.end_ns - s.start_ns for s in self.named(name)) * 1e-6

    def self_ms(self, name: str) -> float:
        """The wall time of every span ``name`` less that of their
        children, ms."""
        ids = {s.id for s in self.named(name)}
        children = sum(s.end_ns - s.start_ns for s in self.spans if s.parent in ids)
        return self.host_ms(name) - children * 1e-6

    def device_ms(self, name: str) -> Optional[float]:
        """The device time of every span ``name`` of the call, ms; None
        where it has none or one lacks its device time."""
        times = [s.device_ms for s in self.named(name)]
        if not times or any(t is None for t in times):
            return None
        return sum(times)

    def counter(self, name: str) -> int:
        """The counter ``name``'s change over the call (the root's)."""
        return (self.root.counters or {}).get(name, 0)


def calls(run) -> Optional[List[Call]]:
    if run.trace is None or run.device_type != "cuda":
        return None
    try:
        from matchering_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    lo, hi = run.trace.window
    recorded = [s for s in trace.spans() if s.end_ns is not None]
    roots = sorted(
        (s for s in recorded if s.parent is None and lo <= (s.start_ns + s.end_ns) // 2 <= hi),
        key=lambda s: s.start_ns,
    )
    if not roots or len(roots) != len(run.calls):
        return None
    by_call = defaultdict(list)
    for s in recorded:
        by_call[s.call].append(s)
    return [Call(root, by_call[root.call]) for root in roots]


def median_per_call(run, value: Callable[[Call], Optional[float]]) -> Optional[float]:
    """The median over the window's calls of ``value(call)``; None where
    ``calls(run)`` is None or any call's value is."""
    found = calls(run)
    if found is None:
        return None
    values = [value(call) for call in found]
    if any(v is None for v in values):
        return None
    return statistics.median(values)
