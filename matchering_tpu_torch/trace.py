"""The port's spans and counters.

Counters are always on: ``count(name, n)`` is an integer add on a module
dict, and ``counts()`` a snapshot of it.  The port counts

* ``launch.k1`` to ``launch.k4``: calls that launched K1, K2, K3 or K4
  (``kernels/``; a CPU tensor runs the plain twin and counts none);
* ``host_reads``: reads of a tensor's values into host values (on a card,
  each waits for the device), counted on every device, so a run on the
  CPU counts what the same run counts on a card;
* ``h2d_bytes``: the bytes of host arrays staged on a device, and of
  host tensors staged on a card (``utils.to_device``);
* ``direct_bytes``: the bytes of integer-PCM WAV payloads read straight
  into the block they are staged from (``io.loader.load_staged``): in a
  ``process()`` of two 16-bit WAVs, all of its ``h2d_bytes``;
* ``d2h_bytes``: the bytes read back to the host (``utils.host_copy``,
  the codes of a WAV result or a variant at its dtype, and every host
  read);
* ``direct_out_bytes``: the bytes of WAV payloads written to their file
  straight from the block their codes crossed into (``io.saver.save``):
  in a ``process()`` of one PCM_16 WAV result, its codes' ``d2h_bytes``;
* ``batch.rows``, ``batch.padded_samples``, ``batch.true_samples``: the
  rows of each ``parallel.batch.master_batch`` graph, and the samples per
  channel of its padded targets and references and of their true
  lengths, both roles summed; ``parallel.batch.master_pairs`` counts
  each of its graphs as one row.

Spans record only while a ``torch.profiler`` session records, or inside
``with recording():``.  The choice is made when a call's root span opens,
and every span inside it follows, so a call is recorded whole or not at
all.  Off, ``span()`` costs a flag check and returns a shared context that
allocates nothing.  A recorded span keeps its call's id, its own id, its
parent's id, its name, and its start and end on ``time.time_ns()`` (the
clock of the profiler's events, so a trace's device gaps fall under the
spans open at the time).  A span given a CUDA device also records two CUDA
events on the device's current stream, and ``Span.device_ms`` is the
device time between them.  When a root span closes, the spans whose end
event the device has passed are resolved and their events reused, so a
recorded call creates no event once the first has run: a new event costs
the host more than a recorded one, most of all under the profiler.  A
root span keeps the change of every counter over its call
(``Span.counters``).  Spans open no profiler range: the profiler would
copy such ranges onto the device's timeline.

``spans()`` returns the recorded spans, oldest first, without removing
them; the buffer keeps the newest ``CAPACITY``; ``clear()`` empties it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

CAPACITY = 1 << 15  # spans kept, newest last

_counts: Dict[str, int] = {}
_spans: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_calls = itertools.count(1)
_forced = 0  # open ``recording()`` blocks
_local = threading.local()  # .stack: this thread's open spans (None: a call not recorded)
_unresolved: "collections.deque[Span]" = collections.deque()  # spans with device events, oldest first
_free_events: Dict[int, list] = {}  # resolved spans' CUDA events, by device index


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counts() -> Dict[str, int]:
    """Every counter's value."""
    return dict(_counts)


class Span:
    """One recorded span (times in ns of ``time.time_ns()``)."""

    __slots__ = ("call", "id", "parent", "name", "start_ns", "end_ns", "counters", "_events", "_device_ms")

    def __init__(self, call: int, id: int, parent: Optional[int], name: str, start_ns: int):
        self.call = call
        self.id = id
        self.parent = parent  # None: the call's root
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None  # None while open
        self.counters: Optional[Dict[str, int]] = None  # the root's: each counter's change over the call
        self._events = None  # (start, end, device index) while unresolved
        self._device_ms: Optional[float] = None

    @property
    def device_ms(self) -> Optional[float]:
        """Device time from the span's start event to its end event, ms;
        None for a span with no device or on the CPU.  Read once the
        device has run the span's work (the first read waits for it)."""
        if self._events is not None and self.end_ns is not None:
            self._resolve(wait=True)
        return self._device_ms

    def _resolve(self, wait: bool) -> bool:
        """Read the device time and free the events; False where the
        device has not passed the end event and ``wait`` is False."""
        if self._events is None:
            return True
        start, end, index = self._events
        if wait:
            end.synchronize()
        elif not end.query():
            return False
        self._device_ms = start.elapsed_time(end)
        _free_events.setdefault(index, []).extend((start, end))
        self._events = None
        return True

    def __repr__(self) -> str:
        return f"Span({self.name!r}, call={self.call}, id={self.id}, parent={self.parent})"


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Skipped:
    """A span of a call that is not recorded (one shared instance)."""

    def __enter__(self):
        _stack().append(None)

    def __exit__(self, *exc):
        _local.stack.pop()
        return False


_SKIPPED = _Skipped()


class _Recorded:
    __slots__ = ("name", "device", "span", "before")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self) -> Span:
        stack = _local.stack
        parent = stack[-1] if stack else None
        if parent is None:
            span = Span(next(_calls), next(_ids), None, self.name, time.time_ns())
            self.before = dict(_counts)
        else:
            span = Span(parent.call, next(_ids), parent.id, self.name, time.time_ns())
        if self.device is not None and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            free = _free_events.get(stream.device_index)
            start, end = (free.pop() if free else torch.cuda.Event(enable_timing=True) for _ in range(2))
            span._events = (start, end, stream.device_index)
            start.record(stream)
        self.span = span
        stack.append(span)
        return span

    def __exit__(self, *exc):
        span = self.span
        if span._events is not None:
            span._events[1].record(torch.cuda.current_stream(self.device))
        span.end_ns = time.time_ns()
        _local.stack.pop()
        _spans.append(span)
        if span._events is not None:
            _unresolved.append(span)
        if span.parent is None:
            span.counters = {k: v - self.before.get(k, 0) for k, v in _counts.items()}
            while _unresolved and _unresolved[0]._resolve(wait=False):
                _unresolved.popleft()
        return False


def span(name: str, device=None):
    """A context manager around one step of the port's work.  ``device``:
    the device the step enqueues work on; on a CUDA device the recorded
    span also times that work with CUDA events."""
    stack = _stack()
    if stack:
        return _SKIPPED if stack[-1] is None else _Recorded(name, device)
    if _forced or torch.autograd._profiler_enabled():
        return _Recorded(name, device)
    return _SKIPPED


@contextlib.contextmanager
def recording():
    """Record every call that starts inside the block, with no profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def spans() -> List[Span]:
    """The recorded spans, oldest first (each appended when it closes)."""
    return list(_spans)


def clear() -> None:
    """Empty the span buffer (the counters run on)."""
    _spans.clear()
