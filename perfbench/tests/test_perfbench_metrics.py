"""The metric arithmetic on runs built by hand: the p95 over every call,
throughput as all the work over all the window, the byte bounds, and the
trace's busy time and idle gaps."""

import math

import pytest

from perfbench import devtrace, harness

KIND = "NVIDIA H100 80GB HBM3"


def make_run(calls, window=(0.0, 10.0), trace=None, peak=None, cell="longform96k.master"):
    return harness.Run(
        cell=harness.Cell.load(cell), device_type="cuda", device_kind=KIND, setup_s=12.5,
        window=window, calls=calls, peak_bytes=peak, trace=trace,
        peaks=harness.load_json(harness.HERE, "peaks.json"),
    )


def call(start, end, audio_s=100.0, ok=True, samples=1000, itemsize=4, events=()):
    return harness.Call(start, end, audio_s, samples, itemsize, ok, list(events))


def test_throughput_is_all_the_work_over_all_the_window():
    run = make_run([call(0, 4), call(4, 9), call(9, 9.5, ok=False)], window=(0.0, 10.0))
    assert harness.reader("audio_s_per_s")(run) == pytest.approx(20.0)


def test_p95_covers_every_call_and_a_failure_never_ends():
    calls = [call(0, (i + 1) / 1e3) for i in range(100)]  # 1..100 ms
    assert harness.reader("call_p95_ms")(make_run(calls)) == pytest.approx(95.05)
    calls[3] = call(0, 0.004, ok=False)
    assert harness.reader("call_p95_ms")(make_run(calls)) == pytest.approx(96.05)
    assert harness.reader("call_p95_ms")(make_run([call(0, 1, ok=False)] * 3)) is None


def test_memory_and_setup():
    assert harness.reader("peak_mem_gib")(make_run([], peak=3 * 2**30)) == 3.0
    assert harness.reader("peak_mem_gib")(make_run([])) is None
    assert harness.reader("setup_s")(make_run([])) == 12.5


def test_event_medians():
    calls = [call(0, 1, events=[(2003, 0.0), (2004, 0.010 * (i + 1)), (2008, 0.5), (2010, 0.5 + 0.002 * i)])
             for i in range(3)]
    run = make_run(calls, cell="song44k.process_wav16")
    assert harness.reader("host_decode_check_ms")(run) == pytest.approx(20.0)
    assert harness.reader("host_export_ms")(run) == pytest.approx(2.0)
    assert harness.reader("host_export_ms")(make_run([call(0, 1)])) is None


def trace(device, ranges):
    return devtrace.Trace(device, ranges)


def test_busy_time_is_the_union_of_device_operations_in_the_window():
    tr = trace(  # names out of time order: the union follows the clock, not the names
        [("z", 100, 300, "kernel"), ("b", 200, 400, "kernel"), ("a", 600, 700, "gpu_memcpy"),
         ("d", 950, 1200, "kernel"), ("c", 1300, 1400, "kernel")],
        [("window", 0, 1000), ("call", 0, 500), ("call", 550, 1000), ("graph", 50, 450)],
    )
    assert tr.window_s() == pytest.approx(1e-6)
    assert tr.busy_s() == pytest.approx((300 + 100 + 50) * 1e-9)
    idle = tr.idle_by_host_activity()
    assert idle["graph"] == pytest.approx(100e-9)  # gap 0-100: its midpoint lies in the phase
    assert idle[devtrace.OUTSIDE] == pytest.approx(200e-9)  # gap 400-600: between the calls
    assert idle["call"] == pytest.approx(250e-9)  # gap 700-950: in a call, in no phase
    assert sum(idle.values()) == pytest.approx(tr.window_s() - tr.busy_s())
    run = make_run([call(0, 1)], trace=tr)
    assert harness.reader("device_idle_share")(run) == pytest.approx(55.0)
    assert harness.reader("graph_kernels_per_call")(run) == 3  # the copy is no kernel; c lies past the window


def test_breakdown_lists_the_longest_first():
    tr = trace([("k1", 0, 10, "kernel"), ("k2", 20, 50, "kernel"), ("k1", 60, 70, "kernel")],
               [("window", 0, 100), ("call", 0, 100)])
    out = tr.breakdown()
    assert out["device_ops"] == [["k2", pytest.approx(30e-9)], ["k1", pytest.approx(20e-9)]]
    assert out["idle_gaps"][0][0] == "call"


def test_rooflines_count_the_work_and_time_only_their_kernels():
    n, calls = 1_000_000, 3
    k1_s, k2_s = 2e-5, 4e-5
    device = []
    for i in range(calls):
        t0 = i * 1_000_000
        device += [
            ("void envelope_kernel<float>(float const*)", t0, t0 + int(k1_s * 1e9), "kernel"),
            ("void scan_kernel<float>(float const*)", t0 + 100_000, t0 + 100_000 + int(k2_s * 1e9), "kernel"),
            ("void sos_scan_kernel<float>(float const*)", t0 + 200_000, t0 + 300_000, "kernel"),
            ("fft", t0 + 400_000, t0 + 500_000, "kernel"),
        ]
    run = make_run([call(0, 1, samples=n)] * calls, trace=trace(device, [("window", 0, 10**9)]))
    bandwidth = 3.35e12
    assert harness.reader("limiter_front_end_roofline")(run) == pytest.approx(
        100 * calls * 4 * n * 4 / bandwidth / (calls * k1_s))
    assert harness.reader("first_order_scan_roofline")(run) == pytest.approx(
        100 * calls * 8 * n * 4 / bandwidth / (calls * k2_s))
    bare = make_run([call(0, 1)], trace=trace([("fft", 0, 10, "kernel")], [("window", 0, 100)]))
    assert harness.reader("limiter_front_end_roofline")(bare) is None
    assert harness.reader("first_order_scan_roofline")(make_run([call(0, 1)])) is None


def test_orders_above_one_leave_their_scans_to_k3():
    run = make_run([call(0, 1, samples=10)], trace=trace([("void scan_kernel<float>()", 0, 1000, "kernel")],
                                                         [("window", 0, 2000)]))
    run.cell.config["parameters"]["limiter"]["hold_filter_order"] = 2
    assert harness.reader("first_order_scan_roofline")(run) == pytest.approx(
        100 * 6 * 10 * 4 / 3.35e12 / 1e-6)


def test_no_device_metric_without_a_card():
    run = make_run([call(0, 1)], trace=trace([], [("window", 0, 100)]))
    for name in ("device_idle_share", "graph_kernels_per_call", "limiter_front_end_roofline"):
        assert harness.reader(name)(run) is None
    assert not math.isnan(harness.reader("audio_s_per_s")(run))
