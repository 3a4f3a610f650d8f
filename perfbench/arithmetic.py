"""Arithmetic the metric readers share: medians between the port's
events, and a kernel's share of its byte bound."""

from __future__ import annotations

import glob
import json
import os
import re
import statistics
from typing import Optional


def median_between(run, first: int, second: int) -> Optional[float]:
    """Median over the completed calls of the ms from the port's info
    event ``first`` to ``second`` (traced runs record them)."""
    spans = []
    for call in run.calls:
        stamps = dict(call.events)
        if call.ok and first in stamps and second in stamps:
            spans.append(1e3 * (stamps[second] - stamps[first]))
    return statistics.median(spans) if spans else None


def kernel_patterns(reader_file: str):
    """The regular expressions of ``metrics/<metric>/kernels/*.json``, the
    kernels that do a metric's work (a file per kernel, never edited)."""
    folder = os.path.splitext(reader_file)[0]
    return [re.compile(json.load(open(p))["pattern"]) for p in sorted(glob.glob(os.path.join(folder, "kernels", "*.json")))]


def roofline(run, reader_file: str, values_per_sample: int) -> Optional[float]:
    """The byte bound of the work over the device time of the kernels
    that did it, in %.  The work of a call reads and writes
    ``values_per_sample`` values of its working dtype per target sample,
    each once, at the card's published HBM bandwidth."""
    if run.trace is None or run.device_kind not in run.peaks:
        return None
    patterns = kernel_patterns(reader_file)
    seconds = sum(
        (end - start) * 1e-9
        for name, start, end in run.trace.kernels()
        if any(p.search(name) for p in patterns)
    )
    if seconds <= 0:
        return None
    work = sum(values_per_sample * c.samples * c.itemsize for c in run.calls if c.ok)
    return 100.0 * work / run.peaks[run.device_kind]["hbm_bytes_per_s"] / seconds
