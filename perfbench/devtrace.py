"""The traced window: ``torch.profiler`` over the host and the card,
reduced to plain tuples once the window has closed.

``Session`` profiles the window (CPU and CUDA activity; nothing else is
recorded).  ``Trace`` keeps the device's operations (kernels, copies,
memsets: name, start, end in ns), the host's named ranges (the harness's
``window`` and ``call``, and each entry's phases), and answers the
questions the metrics and the breakdown ask: the device's busy time in
the window, time per kernel name, and the idle gaps by what the host was
doing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

OUTSIDE = "between_calls"  # idle time in the window outside every call


class Session:
    """The profiler over the window.  ``spans``: the names of the host
    ranges the harness and the entry open; the profiler may also show
    them on the device's timeline, where they are no operation."""

    def __init__(self, torch, on_card: bool, spans):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=activities)
        self.cuda = torch.autograd.DeviceType.CUDA
        self.spans = set(spans)

    def __enter__(self):
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        return self.profiler.__exit__(*exc)

    def result(self) -> "Trace":
        device, ranges = [], []
        for e in self.profiler.profiler.kineto_results.events():
            name, start = e.name(), e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == self.cuda:
                if name not in self.spans:
                    device.append((name, start, end, _device_kind(name)))
            elif name in self.spans:
                ranges.append((name, start, end))
        self.profiler = None
        return Trace(device, ranges)


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


class Trace:
    def __init__(self, device: List[Tuple[str, int, int, str]], ranges: List[Tuple[str, int, int]]):
        windows = [r for r in ranges if r[0] == "window"]
        self.window = (windows[0][1], windows[0][2]) if windows else (0, 0)
        lo, hi = self.window
        self.device = sorted((d for d in device if d[2] > lo and d[1] < hi), key=lambda d: (d[1], d[2]))
        self.calls = sorted((s, e) for n, s, e in ranges if n == "call")
        self.phases = sorted((s, e, n) for n, s, e in ranges if n not in ("window", "call"))

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [(n, s, e) for n, s, e, kind in self.device if kind == "kernel"]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's operations, clipped to the window."""
        lo, hi = self.window
        merged: List[List[int]] = []
        for _, s, e, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            elif e > s:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def time_by_kernel(self) -> Dict[str, float]:
        totals: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.device:
            totals[name] += (e - s) * 1e-9
        return totals

    def _host_activity(self, t: int) -> str:
        i = bisect.bisect_right(self.phases, (t, float("inf"), "")) - 1
        if i >= 0 and self.phases[i][0] <= t < self.phases[i][1]:
            return self.phases[i][2]
        j = bisect.bisect_right(self.calls, (t, float("inf"))) - 1
        if j >= 0 and self.calls[j][0] <= t < self.calls[j][1]:
            return "call"
        return OUTSIDE

    def idle_by_host_activity(self) -> Dict[str, float]:
        lo, hi = self.window
        totals: Dict[str, float] = defaultdict(float)
        cursor = lo
        for s, e in self.busy_intervals() + [(hi, hi)]:
            if s > cursor:
                totals[self._host_activity((cursor + s) // 2)] += (s - cursor) * 1e-9
            cursor = max(cursor, e)
        return totals

    def breakdown(self) -> dict:
        def top(totals):
            return [[name[:120], value] for name, value in sorted(totals.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(self.time_by_kernel()), "idle_gaps": top(self.idle_by_host_activity())}
