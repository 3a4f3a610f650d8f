"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell needs is found by name:

* ``BENCHMARK.json`` (the checkout's root): the cell's configuration and
  traffic names, its chips, and which metrics it reports;
* ``configs/<config>.json``: the deployment (``parameters`` of the
  mastering chain, the sample rate, the port's ``Config`` fields);
* ``traffic/<traffic>.json``: the entry that the window drives
  (``entries/<entry>.py``) and the parameters of its generator;
* ``workloads/<cell>.json``: the limits of the cell's check;
* ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``.

A run builds the program's kernels and codec (timed apart), makes its
inputs from the seed, warms up the cell's own shapes, measures a closed
loop of calls for ``seconds``, frees the program's state, compares the
sampled answers with the plain reference, and returns the result line.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "matchering_tpu")
TORCH_THREADS = 4  # torch's CPU threads in a run: half the host's 8 cores


def load_json(*parts: str):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with the files its names point to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def load(cls, name: str, bench: Optional[dict] = None) -> "Cell":
        bench = bench or benchmark()
        spec = next((w for w in bench["workloads"] if w["name"] == name), None)
        if spec is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")

        def applies(metric):
            return name in metric.get("workloads", [name])

        return cls(
            name=name,
            chips=spec["chips"],
            config=load_json(HERE, "configs", spec["config"] + ".json"),
            traffic=load_json(HERE, "traffic", spec["traffic"] + ".json"),
            limits=load_json(HERE, "workloads", name + ".json")["limits"],
            end_to_end=[m for m in bench["end_to_end"] if applies(m)],
            per_layer=[m for m in bench["per_layer"] if applies(m)],
        )

    def entry(self):
        return importlib.import_module(f"perfbench.entries.{self.traffic['entry']}")


def port_config(mt, parameters: Dict):
    """The port's ``Config`` of a configuration file's ``parameters``."""
    fields = dict(parameters)
    fields["limiter"] = mt.LimiterConfig(**fields.get("limiter", {}))
    return mt.Config(**fields)


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``.  A quantity split by
    cell (``<quantity>.<cells>``, one bound or one ``moves`` each) reads
    with ``metrics/<quantity>.py`` where it has no file of its own."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Call:
    """One call of the window: host-clock start and end (seconds), the
    audio seconds it mastered, the target's samples and the working
    dtype's bytes per sample (the work the rooflines count), and the
    port's log events (code, host-clock seconds) in traced runs."""

    start: float
    end: float
    audio_s: float
    samples: int
    itemsize: int
    ok: bool = True
    events: List[Tuple[int, float]] = field(default_factory=list)


@dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    device_type: str
    device_kind: str
    setup_s: float
    window: Tuple[float, float]
    calls: List[Call]
    peak_bytes: Optional[int]
    trace: Optional[object]  # devtrace.Trace in traced runs
    peaks: dict


@dataclass
class Context:
    """What an entry gets: the cell's files, the seed, the device, a
    scratch folder, the port, and ``span(name)`` (a profiler range in
    traced runs, else nothing)."""

    cell: Cell
    seed: int
    device: object
    workdir: str
    trace: bool
    mt: object
    torch: object

    def span(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(name)


class EventLog:
    """The port's info events of each call (traced runs only), and the
    entry's phase spans opened and closed on them."""

    def __init__(self, torch, phases: Dict[int, Optional[str]]):
        self.torch = torch
        self.phases = phases
        self.current: Optional[List[Tuple[int, float]]] = None
        self.open = None

    def handler(self, message: str) -> None:
        stamp = time.perf_counter()
        code = int(str(message).split(":", 1)[0])
        if self.current is not None:
            self.current.append((code, stamp))
        if code in self.phases:
            self.close()
            name = self.phases[code]
            if name is not None:
                self.open = self.torch.profiler.record_function(name)
                self.open.__enter__()

    def close(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``), else 0."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return 0.0


def io_counters() -> Dict[str, int]:
    """``/proc/self/io``: ``write_bytes`` is what this process sent toward
    storage, ``wchar`` every byte it wrote, ``/dev/null`` included."""
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in (line.split(":") for line in f)}
    except OSError:
        return {}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(
    name: str,
    seed: int,
    seconds: float,
    trace: bool,
    device: str = "cuda",
    started: Optional[float] = None,
    cell: Optional[Cell] = None,
) -> Optional[dict]:
    """Run ``name`` and return its result line as a dict, or None where a
    forbidden module was loaded.  ``started``: the process's start on the
    ``time.perf_counter`` clock (set-up counts from there); ``cell``: a
    cell already loaded (tests pass shrunken ones)."""
    started = time.perf_counter() if started is None else started
    import torch

    import matchering_tpu_torch as mt
    from matchering_tpu_torch.io.native import binding
    from matchering_tpu_torch.kernels import build

    from . import devtrace

    cell = cell or Cell.load(name)
    entry = cell.entry()
    device = torch.device(device)
    on_card = device.type == "cuda"
    torch.set_num_threads(TORCH_THREADS)
    builds = {"codec_s": None, "kernels_s": None}
    binding.available()
    builds["codec_s"] = binding.build_seconds
    if on_card:
        build.library()
        builds["kernels_s"] = build.build_seconds
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    ctx = Context(cell, seed, device, workdir, trace, mt, torch)
    events = EventLog(torch, getattr(entry, "PHASES", {}))
    try:
        stamps = {"entered": time.perf_counter()}
        state = entry.prepare(ctx)
        stamps["prepared"] = time.perf_counter()
        entry.warm(ctx, state)
        stamps["warmed"] = time.perf_counter()
        if on_card:
            torch.cuda.synchronize(device)
            setup_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        if trace:
            mt.log(info_handler=events.handler, show_codes=True)
        spans = {"window", "call", *getattr(entry, "SPANS", ())}
        session = devtrace.Session(torch, on_card, spans) if trace else None
        calls: List[Call] = []
        with session or contextlib.nullcontext(), ctx.span("window"):
            window_start = time.perf_counter()
            setup_s = window_start - started
            while time.perf_counter() - window_start < seconds:
                events.current = []
                start = time.perf_counter()
                try:
                    with ctx.span("call"):
                        work = entry.call(ctx, state, len(calls))
                    ok = True
                except Exception as error:  # a failed call is counted, and the run goes on
                    say(f"call {len(calls)} failed: {error!r}")
                    work, ok = {"audio_s": 0.0, "samples": 0, "itemsize": 0}, False
                end = time.perf_counter()
                events.close()
                calls.append(Call(start, end, ok=ok, events=events.current, **work))
        window_end = calls[-1].end if calls else time.perf_counter()
        if trace:
            mt.log()
        peak = None
        if on_card:
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
        stamps["closed"] = time.perf_counter()
        tr = session.result() if session else None
        stamps["traced"] = time.perf_counter()
        entry.release(ctx, state)
        stamps["released"] = time.perf_counter()
        checks = entry.compare(ctx, state, calls)
        stamps["compared"] = time.perf_counter()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    found = forbidden_modules()
    if found:
        say(f"forbidden modules loaded: {', '.join(found)}")
        return None

    kind = torch.cuda.get_device_name(device) if on_card else device.type
    run = Run(cell, device.type, kind, setup_s, (window_start, window_end), calls, peak, tr,
              load_json(HERE, "peaks.json"))
    metrics = {}
    for spec in cell.per_layer if trace else cell.end_to_end:
        value = reader(spec["name"])(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}

    failed = sum(not c.ok for c in calls)
    correct = failed == 0 and bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks)
    latencies = sorted(1e3 * (c.end - c.start) for c in calls if c.ok)
    if latencies:
        say(json.dumps({
            "calls": len(calls), "failed": failed,
            "call_median_ms": statistics.median(latencies),
            "call_p95_ms": reader("call_p95_ms")(run),
            "window_s": window_end - window_start,
            "setup_s": setup_s,
            "builds": builds, "io": io_counters(),
            "phases_s": {
                "imports_and_builds": stamps["entered"] - started,
                "prepare": stamps["prepared"] - stamps["entered"],
                "warm": stamps["warmed"] - stamps["prepared"],
                "trace_reading": stamps["traced"] - stamps["closed"],
                "release": stamps["released"] - stamps["traced"],
                "reference_and_compare": stamps["compared"] - stamps["released"],
            },
        }))
    device_info = {
        "platform": "gpu" if on_card else device.type,
        "kind": kind,
        "count": 1,
        "memory_peak_bytes": max(setup_peak, peak) if on_card else None,
    }
    line = {"correct": correct, "attempted": len(calls), "failed": failed,
            "metrics": metrics, "device": device_info}
    if tr is not None and on_card:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s()
        line["breakdown"] = tr.breakdown()
    for c in checks:
        say(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})")
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return line
