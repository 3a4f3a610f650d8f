#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``matchering_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card, ``nvcc``
(CUDA 12, ``sm_90a``) and PyTorch built for CUDA.  In order, it:

1. prints the card's ``nvidia-smi`` name and power limit, the torch and
   CUDA versions and the TF32 settings;
2. builds the CUDA kernels from ``matchering_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch twin on the card, in
   float32 and float64, at awkward shapes (a track of one window, one
   tile and one sample either side of it, ragged multiples of the tile)
   and at the main path's width (n = 7,938,000 samples): K1 (limiter
   front end) to a max error of 0; K2 (first-order IIR scan) over
   rows 1 and 3, forward and reverse, with and without an initial state,
   to one float32 ulp at 1.0 (float32) and 1e-12 relative (float64), and
   three times over at full width, since its look-back may round its
   carries differently from run to run.  It times both at full width in
   float32, K2 at the limiter's three poles, forward and reverse: a call
   (CUDA events over 20 back-to-back calls) and the kernel alone
   (profiler).  Then the kernels' length modes (rows of a zero-padded
   batch, each ending at its own true length): K1 over 4 rows of
   3 * tile + 7 with lengths of one window, one tile less and more one
   sample, and the full row, and over 8 rows of 8,126,464 (the bucket of a
   180 s track) with lengths drawn from the seed; K2 over 3 ragged rows,
   both directions, with and without zi, and over the 8 full-width rows;
   at the same tolerances.  Both are timed over the 8 full-width rows in
   float32 (a call, the kernel alone, the plain twin) beside their byte
   bounds;
4. writes a 180 s PCM_16 WAV pair made from a seed and runs
   ``process()`` on it on the card twice (cold, warm), counting kernel
   launches per run (1 K1, 4 K2 and 0 K3 with ``Config()``), and checks
   the written file; prints the warm run's timeline of log events, the
   bytes one more warm run copies each way, counted under the profiler
   by a dispatch mode beside the trace's copy records (about one copy of
   each track to the card, the result's PCM_16 codes back)
   and a profile of one ``master`` call (device time by op, and the
   device's busy share of its wall time), in which each K2 call must be a
   single kernel.  In every ``process()`` and ``process_batch`` run of
   the script the equality check must compare CUDA tensors;
5. compares ``master`` on the card (float32) with the port's own
   ``master`` on the CPU at float64 on a 30 s pair: at least 95 dB SNR;
6. the user path: writes a 180 s PCM_16 target at 44.1 kHz and a 180 s
   PCM_24 reference at 48 kHz; holds the float64 resampler on the card
   against the same call on the CPU (max abs error 1e-12) and times it and
   its matrix product beside their flop and byte bounds; runs
   ``process()`` twice (cold, warm) with both previews and a PCM_24 AIFF
   result, counting kernel launches, and prints the warm run's timeline
   and the bytes a third run copies each way (each track once; the
   float32 master and the preview pieces' PCM_16 codes back);
   checks that the preview window chosen on the card is the one the CPU
   chooses on the card's result; runs ``python3 -m matchering_tpu_torch``
   on the pair and checks its outputs;
7. the farm path: writes eight PCM_16 WAV jobs from the seed (targets
   150-180 s, references 140-180 s; one job also asks for both previews,
   one for a raw FLOAT variant), runs ``process_batch`` on the card with
   ``dispatch="pipelined"`` and then ``"vmapped"``, each twice (cold,
   warm), with the kernel launches counted per run (8 K1 and 32 K2
   pipelined, 1 and 4 vmapped, no K3), its wall time, pairs and audio seconds per
   wall second, peak device memory and the warm runs' event timelines;
   the bytes one more run of each dispatch copies each way (each job's
   tracks once; back, the payload's codes of each written variant and
   preview piece);
   holds every job's PCM_16 file to what ``process()`` on the card writes
   for the pair (one LSB); runs the dynamic ``master_graph`` on the staged
   batch under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync),
   times it against one graph per pair on the same staged inputs, and
   holds ``master_batch`` on the card at float32 against the CPU at
   float64 on three rows of 20-30 s (>= 95 dB per row);
8. the configs path, every ``Config`` the JAX package honours: K3 (the
   second-order-section scan) against its plain twin at both Butterworth
   cutoffs of the limiter (hold 7 Hz, release 800/3000 Hz), in float32 and
   float64, at awkward shapes, at n = 7,938,000 (three repeats) and over
   8 rows of 8,126,464, to one float32 ulp at 1.0 and 1e-10 relative in
   float64, and in float64 against ``scipy.signal.sosfilt`` run in long
   double on the host (1e-9); K3 timed at full width (a call, the kernel
   alone, the twin) beside its byte bound; ``process()`` on a 180 s pair
   with hold/release orders 2/2 and ``lowess_it=1``, cold and warm, with
   the kernel launches counted (1 K1, 2 K2, 2 K3), and the smoothing
   state's staging timed from the host operators and from its cache; the
   card's float32 ``master`` against the CPU's float64 (>= 95 dB) for
   that config and for ``lowess_exact=True`` with orders 3/4 on 30 s
   pairs; and
   ``master_batch`` of that config on three rows (>= 95 dB per row), its
   dynamic graph run under ``torch.cuda.set_sync_debug_mode("error")``;
9. the time-sharded path (``parallel/timeshard.py``), all shards on this
   one card: ``limit_sharded`` over four shards against ``limit`` on the
   main path's limiter input (phase 4's pair mastered without the
   limiter), in float32 (one float32 ulp at 1.0) and float64 (1e-12
   relative), with its launches per call (1 K1 and 8 K2) and a call timed
   beside ``limit``'s; the long form: a 60-min 96 kHz target and a 200 s
   reference built on the card from the seed, ``master()`` cold and warm
   and ``master_sharded`` over two shards cold and warm, each with its
   wall time, realtime factor and peak device memory, the two results
   >= 95 dB apart; ``master_farm`` over a (pairs=2, time=2) mesh of the
   card on two of phase 7's jobs with their true lengths, each row >= 95 dB
   against ``master`` and 0 past its length; and ``python3 -m
   matchering_tpu_torch --time_sharded`` on phase 4's pair, its PCM_16
   file within one LSB of phase 4's;
10. multi-process runs (``parallel/launch.py``), both processes on this
   one card, ``gloo`` carrying the host integers: the package's self-test
   (``python3 -m matchering_tpu_torch.parallel.launch selftest``) twice in
   float32, with one device per process and with two shards of the card
   per process and a time axis of 2 (``master_farm_distributed``), every
   row >= 95 dB against the single-process float64 master on the card;
   then two worker processes (this script with ``--distributed-worker``)
   on phase 7's eight jobs in the JAX package's layout: ``initialize``,
   each decodes and checks only the jobs it owns, ``agree_bucket``,
   ``bucket_pad``, ``master_batch_distributed``,
   ``local_results``, PCM_16 WAV (the buckets: 7,864,320 for the targets,
   8,126,464 for the references); cold and warm, with each process's wall
   time, pairs per second, peak device memory and launches (1 K1, 4 K2,
   0 K3: one batched graph over its 4 rows), each file within one LSB of
   phase 7's ``process()`` file for the job;
11. the codecs (``io/native``): the native FLAC codec must have built
   (its build time is reported); phase 4's
   180 s result round-trips through FLAC at PCM_16 and PCM_24 to the same
   codes as WAV; ``process()`` from a FLAC target to a FLAC PCM_24 result
   within one PCM_24 step of the WAV run; the PCM_16 WAV encode by
   ``save``'s codes path and by the numpy writer (byte-identical), its
   decode by the direct read and by the numpy reader (the same codes), the
   FLAC encode and decode, timed on the host; the FLAC run's warm timeline and the bytes
   one more run copies each way (the float64 FLAC target once); which
   lossy libraries load, and a round trip through each that does
   (missing ones are reported, not failed);
12. the public op library on the card, at n = 7,938,000 float32 from the
   seed: ``ops.iir.scan_first_order`` at the release pole (float32 and
   float64), ``block_scan_summary``, ``filtfilt_first_order_truncated``
   with a length of n - 12,345 (0 past it), ``scan_first_order_ds`` and
   ``parallel.timeshard.carried_scan`` over four shards of the card,
   each against K2's plain twin on the card (one float32 ulp at 1.0, two
   for the filtfilt's two passes, 1e-12 relative in float64; the carried
   scan against the whole track's scan), with K2's launches counted per
   call (1, 1, 2, 1 and 2 per device) and no call of the twin allowed;
   ``fft_convolve_same`` with a 4096-tap FIR (>= 95 dB) and
   ``masked_average_spectrum_flat`` (1e-5 relative) against the CPU in
   float64; each op timed over 10 calls (CUDA events);
13. the driver entry points (``graft_entry_torch.py``) and ``bench.py``'s
   graph body on the card: ``entry()``'s forward step on its 1.5 s /
   1.2 s example tensors (launches counted: 1 K1, 4 K2, 0 K3; >= 95 dB
   against the port's float64 ``master_graph`` of the pair on the CPU),
   ``dryrun_multichip(4)`` (``master_farm`` twice over a (2, 2) mesh of
   the card, its launches counted), and ``master_graph(...,
   need_default=True, interp_ops=ops)`` on bench's first 180 s pair
   with ``ops`` from ``operator_arrays_for_config``, bit for bit the
   result of ``interp_ops=None``; each call warm, CUDA-synchronised,
   with its wall time, and no call of a kernel's plain twin allowed;
14. the measurement drivers in this process, on the card, no call of a
   kernel's plain twin allowed: ``bench_torch.py`` at its defaults (16
   pairs of 180 s built on host threads and staged once, 3 timed reps of
   the pipelined round, the per-pair-fetch round and the single pair;
   launches (16, 64, 0) per round and (131, 524, 0) per run), bench's
   graph on pair 0 at s = 1 bit for bit phase 13's checksum, one round
   enqueued under ``torch.cuda.set_sync_debug_mode("error")`` (a host
   sync is recorded, with the line that made it, not failed) and the
   device's busy share of one profiled round; then
   ``tools_record_bench_torch.py``'s ``bench_single``, ``bench_stages``
   and ``bench_batch_sweep`` on bench's seed-42 pair, (1, 4, 0) launches
   per graph, per ``limit()`` and per ``master_batch`` call, and, where
   the host has the memory its docstring names, ``bench_longform`` (the
   int16 and float32 masters bit-identical);
15. the JAX package's per-track length forms at full width, on phase 4's
   180 s pair with ``Config()``, the target zero-padded to a multiple of
   262,144 samples: ``master_graph(target_padded, reference, config,
   target_length=L_t, reference_length=L_r)`` with the lengths as the
   one-row ``RowInts``, as ints and as 0-d card tensors, each bit for bit
   the ``RowInts`` form and > 100 dB against ``master()`` on the unpadded
   pair (the JAX package's gate for bucket-padded rows); then
   ``limit(track, config, length=L)`` on the padded 180 s limiter input
   with an int and a 0-d length, bit for bit the one-row batch; each call
   with its launches (1 K1, 4 K2, 0 K3), its host reads of the lengths
   (none with ints, one per 0-d length) and its copies each way, timed
   over 10 calls (CUDA events) beside the ``RowInts`` form, the forms in
   turns and then in reverse, no call of a kernel's plain twin allowed;
16. the smoothing forms at full width, on phase 4's 180 s pair in float32
   with ``Config()``, ``lowess_delta=1e-4``, ``fft_size=2048,
   lin_log_oversampling=1`` (the two configs whose folded LOWESS keeps
   every grid point as an anchor) and orders 2/2 with ``lowess_it=1``
   (K3, the device LOWESS): ``master()`` and ``master_graph`` with
   ``interp_ops`` None, the ``Smoothing`` and the port's pair (bench's
   call form), each within one float32 ulp at 1.0 of ``master()`` (bit
   for bit but where K2's look-back rounds a carry otherwise), with
   ``expected_launches(config)``, no host read and no copy from the card
   per call, timed over 10 calls (CUDA events) in turns and then in
   reverse; the pair form on a 30 s excerpt >= 95 dB against the CPU's
   float64 ``master``; then bench's graph at ``Config()`` on its pair 0,
   bit for bit phase 13's checksum; no call of a kernel's plain twin
   allowed;
17. the input walk (``tests/test_torch_input_walk.py``'s classes) at full
   width: ten result-bearing classes written at 180 s from a seed (a mono
   target, one silent channel, R = -L, a DC offset, -80 dBFS PCM_24
   noise, a PCM_24 WAV target, a PCM_24 FLAC target, a FLOAT WAV target
   over full scale, a mono reference, a 48 kHz PCM_24 reference), each
   through ``process()`` on the card once untimed and three times timed
   (host clock around a synchronise), with (1, 4, 0) launches a call, the
   equality check on the card and no call of a kernel's plain twin, and
   once on the CPU: the same info and warning codes; the mono target's
   side exactly 0; on a 30 s excerpt of each class, the card's PCM_16
   file within one step of the CPU's float64 ``master`` exported at
   PCM_16 and the card's float32 ``master`` >= 95 dB against it (R = -L:
   each RMS-correction step ``reference_match_rms / min_value``, 1e-6
   relative in float32, 1e-12 on the CPU in float64); then
   ``process_batch`` on the mono target (180 s) and a 150 s DC-offset
   target, both dispatches, launches (2, 8, 0) pipelined and (1, 4, 0)
   vmapped, each row within one step of its ``process()`` file;
18. the port's spans and counters (``matchering_tpu_torch.trace``): one
   ``process()`` of a 240 s target against a 300 s reference (PCM_16 WAV,
   ``Config()``) under ``trace.recording()``, with
   ``torch.cuda.set_sync_debug_mode("warn")`` and :func:`copy_counter`
   watching: one root, the ``host_reads`` it counts equal to the syncs the
   mode reports, its ``h2d_bytes`` and ``d2h_bytes`` equal to the copy
   counter's, and its ``load``, ``check``, ``equality``, ``graph``,
   ``fetch`` and ``encode`` spans >= 95 % of its wall time, and every byte
   it staged read straight from its file into the page-locked block it
   crossed from (``direct_bytes`` equal to ``h2d_bytes``), and its
   result's PCM_16 payload written from the block its codes crossed into
   (``direct_out_bytes`` equal to the payload); a 240 s float32 result on
   the card saved as WAV at PCM_16, PCM_24, PCM_32 and FLOAT, each file
   the numpy writer's for the same samples and each payload counted in
   ``direct_out_bytes`` (:func:`direct_write`); two tracks of
   one page-locked size class staged back to back behind a busy card
   (:func:`staging_reuse`), the first still holding its file's codes once
   the card has run; one recorded
   ``master()`` of a 60-min 96 kHz target against a 200 s reference built
   on the card, whose five stage spans' device times are >= 97 % of its
   ``master`` span's; and the cost of recording, calls of both with
   recording off and on in turns (three runs of five calls each);
19. K4 (limiter back end) against its plain twin on the card, bit for
   bit (NaN where the twin is NaN), in float32 and float64 at 3 rows of
   1,000,003 samples (with and without lengths and a scale, a NaN gain, a
   row that passes, a batch off 16 bytes, and the attack gain a view
   into rows n + 6 wide) and in float32 at the long form's 1 x
   345,600,000 and the farm's 16 x 18,350,080 with seeded lengths, the
   attack gain laid out as the graph hands it over; K4's time there (a call,
   the kernel alone, the twin) beside its bound of 32 bytes a sample; then
   ``launch.k4`` once per ``limit()`` on the card through ``limit``,
   ``process``, ``master``, ``master_batch`` and ``stages.main`` with
   ``length_bucketing``, with K1-K3 at ``expected_launches``, and none in
   a ``master()`` on the CPU; no call of a kernel's plain twin allowed;
20. prints one JSON line of per-kernel numbers (K1, K2, K3, K4; with each
   kernel's batched numbers from phases 3, 7 and 8, its launches in one
   sharded ``limit()`` (phase 9), per process of phase 10's full-width
   run, per call of phase 13, per round, run and call of phase 14, per
   call of phase 15, of each config of phase 16 and of phase 17's
   ``process()`` and farm batches and, for K2, per public scan of phase
   12,
   and each launch's registers, shared
   memory and resident blocks per SM from the kernels' info queries,
   beside the grid its wrapper recorded for the timed launches), then,
   last, the device line ``{"ok": true, "device": {...}}``.

Any failed phase ends the run with a non-zero exit code and no device line.
It imports nothing of JAX or ``matchering_tpu``.
"""

import contextlib
import ctypes
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 44100
FULL_SECONDS = 180
FULL_N = FULL_SECONDS * SR  # 7,938,000 samples per track
SNR_SECONDS = 30
SNR_GATE_DB = 95.0  # the JAX package's float32 gate (tests/test_dtype_gates.py)
SCAN_TOL = 2.0**-23  # one float32 ulp at 1.0: the two differ only in the final rounding
SCAN_REL_TOL_F64 = 1e-12  # float64: the kernel and the twin combine their spans in other orders
# K3 in float64: both combine with compensated products, in other orders and
# through other powers; near-double poles amplify what one rounding leaves
SOS_REL_TOL_F64 = 1e-10
SOSFILT_TOL = 1e-9  # K3 in float64 against sosfilt in long double, inputs in [0, 1)
SEED = 20260
USER_RATE = 48000  # the user path's reference rate (video and DAW exports)
RESAMPLE_TOL = 1e-12  # float64 on both: the two sum the product in other orders
PCM24_LSB = 2.0**-23
BUCKET = 1 << 18  # process_batch's default bucket multiple
BUCKET_N = 31 * BUCKET  # 8,126,464 samples: the bucket of a 180 s track
BATCH_ROWS = 8
FARM_JOBS = 8
BATCH_SNR_SECONDS = (20, 30)  # the card-vs-CPU master_batch rows
K3_SHAPES = [1, 2, 255, 256, 257, 3 * 256 + 5, 4095, 4096, 4097, 3 * 4096 + 5, 200_000]
CUTOFFS = {"hold": 7.0, "release": 800.0 / 3000.0}  # LimiterConfig()'s Butterworth cutoffs
LIMIT_SHARDS = 4  # phase 9: limit_sharded over four shards of one card
LONG_SECONDS = 3600  # phase 9: the long form, the JAX README's 60-min 96 kHz master
LONG_RATE = 96000
LONG_REFERENCE_SECONDS = 200
LONG_SHARDS = 2
SHARDED_LAUNCHES = (1, 8, 0)  # (K1, K2, K3) of one sharded limit() per card (parallel/timeshard.py)
PUBLIC_SHARDS = 4  # phase 12: carried_scan over four shards of one card
PUBLIC_CUT = 12_345  # phase 12: the truncated filtfilt ends this many samples before the track
K2_PERF_MS = 0.0412  # K2's kernel time at n = 7,938,000 in PERF.md (float32, H100 80GB HBM3, 700 W)
SPECTRUM_REL_TOL = 1e-5  # float32 |rFFT| averages against float64, relative to the largest bin
# H100 peaks (NVIDIA data sheet, SXM part; the PCIe part is slower)
HBM_BYTES_PER_S = {"sxm": 3.35e12, "pcie": 2.0e12}
F32_FLOPS = 67e12  # float32 outside the tensor cores
F64_FLOPS = 34e12  # float64 outside the tensor cores
F64_TENSOR_FLOPS = {"sxm": 67e12, "pcie": 51e12}  # float64 on the tensor cores (DGEMM)


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(condition: bool, message: str) -> None:
    if not condition:
        fail(message)


def launch_numbers(query: str, *args, grid: int) -> dict:
    """A kernel's launch: what its info query reads (csrc/info.cuh:
    registers a thread, shared memory, resident blocks per SM), and
    ``grid``, the blocks of its last timed launch as its wrapper recorded
    them (``LAST_GRID``)."""
    from matchering_tpu_torch.kernels import build

    out = (ctypes.c_longlong * 6)()
    build.check(getattr(build.library(), query)(*args, out), query)
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes", "resident_blocks_per_sm",
            "threads_per_block", "local_bytes")
    return {**dict(zip(keys, (int(v) for v in out))), "grid": grid}


COUNTS_FROM = {}  # the port's counters (``trace.counts()``) at the last zero_counts()


def zero_counts() -> None:
    """Count the port's counters (kernel launches, host reads, bytes
    copied) from 0 here."""
    from matchering_tpu_torch import trace

    COUNTS_FROM.clear()
    COUNTS_FROM.update(trace.counts())


def count_since(name: str) -> int:
    """The port's counter ``name`` (``trace``) since the last zero_counts()."""
    from matchering_tpu_torch import trace

    return trace.counts().get(name, 0) - COUNTS_FROM.get(name, 0)


def launch_counts():
    """The kernels' (K1, K2, K3) launches since the last zero_counts()."""
    return tuple(count_since(f"launch.k{i}") for i in (1, 2, 3))


@contextlib.contextmanager
def plain_twins_forbidden(label):
    """Records every call of a kernel's plain twin inside the block; any
    such call fails the phase when the block ends."""
    from matchering_tpu_torch.kernels import back_end, envelope, scan, sos

    twins = [(envelope, "limiter_front_end_plain"), (scan, "first_order_filter_plain"), (sos, "sos_filter_plain"),
             (back_end, "limiter_back_end_plain")]
    real = [getattr(module, name) for module, name in twins]
    calls = []

    def spy(name, function):
        def call(*args, **kwargs):
            calls.append(name)
            return function(*args, **kwargs)

        return call

    for (module, name), function in zip(twins, real):
        setattr(module, name, spy(name, function))
    try:
        yield
    finally:
        for (module, name), function in zip(twins, real):
            setattr(module, name, function)
    require(not calls, f"{label} ran the plain twins {sorted(set(calls))} on the card")


def make_pair(seconds: int, sr: int, seed: int):
    """A target/reference stereo pair from a seed (the workload of the
    repository's bench.py: a soft two-tone target and a square-wave
    reference under a slow envelope, with noise)."""
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = 0.6 + 0.4 * np.sin(2 * np.pi * t * 0.25) ** 2
    target = np.stack(
        [
            (0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(n)) * env,
            (0.38 * np.sin(2 * np.pi * 221 * t) + 0.05 * rng.randn(n)) * env,
        ],
        axis=1,
    )
    reference = np.stack(
        [
            (0.7 * np.sign(np.sin(2 * np.pi * 110 * t)) + 0.05 * rng.randn(n)) * env,
            (0.7 * np.sign(np.sin(2 * np.pi * 110 * t)) + 0.05 * rng.randn(n)) * env,
        ],
        axis=1,
    )
    return target.astype(np.float32), reference.astype(np.float32)


def snr_db(reference, test) -> float:
    reference = np.asarray(reference, np.float64)
    err = reference - np.asarray(test, np.float64)
    denom = float(np.sum(err * err))
    if denom == 0.0:
        return float("inf")
    return 10.0 * np.log10(float(np.sum(reference * reference)) / denom)


def profile_device(torch, fn, sessions=3):
    """One call of ``fn`` under the profiler, synchronised: its wall time
    in ms and the device's events, ``{"op", "device_ms", "calls"}`` sorted
    by device time (kernels and copies; host ops would count them twice).
    A profiler session now and then delivers no device records at all, so
    an empty session is repeated, up to ``sessions`` in all."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for session in range(sessions):
        with torch.profiler.profile(activities=activities) as prof:
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - start)
        ops = [
            {"op": e.key, "device_ms": e.self_device_time_total / 1e3, "calls": e.count}
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("Activity")
        ]
        if ops:
            return wall_ms, sorted(ops, key=lambda o: -o["device_ms"])
        print(f"profiler session {session + 1} saw no device events", flush=True)
    fail(f"the profiler saw no device events in {sessions} sessions")


def top(ops, count, width):
    return [{**o, "op": o["op"][:width]} for o in ops[:count]]


# (target, reference) device types of each check_equality call of process()
# and process_batch (``watch_equality``), cleared before each run
EQUALITY_INPUTS = []


def watch_equality(torch):
    """Route the host shell's ``check_equality`` (``core``, ``farm``)
    through a spy that records its inputs' device types in
    ``EQUALITY_INPUTS``, then runs it."""
    from matchering_tpu_torch import core, farm

    for module in (core, farm):
        def spy(target, reference, real=module.check_equality):
            EQUALITY_INPUTS.append(tuple(
                a.device.type if isinstance(a, torch.Tensor) else type(a).__name__
                for a in (target, reference)
            ))
            return real(target, reference)

        module.check_equality = spy


def require_equality_on_card(label, calls):
    """The run's ``calls`` equality checks each compared two CUDA tensors."""
    require(EQUALITY_INPUTS == [("cuda", "cuda")] * calls,
            f"{label}: the equality check's inputs were {EQUALITY_INPUTS}, not {calls} pairs of CUDA tensors")


def copy_counter(torch, moved):
    """A dispatch mode that adds each copy between the host and the card to
    ``moved`` (``h2d_bytes``, ``h2d_copies``, ``d2h_bytes``,
    ``d2h_copies``): each ``_to_copy`` and ``copy_`` across, and each
    scalar read back (``_local_scalar_dense``), at the bytes of its
    source."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class CopyCounter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten._to_copy.default:
                src, dst = args[0].device.type, out.device.type
            elif func is aten.copy_.default:
                src, dst = args[1].device.type, args[0].device.type
            elif func is aten._local_scalar_dense.default:
                src, dst = args[0].device.type, "cpu"
            else:
                return out
            way = {("cpu", "cuda"): "h2d", ("cuda", "cpu"): "d2h"}.get((src, dst))
            if way:
                source = args[1] if func is aten.copy_.default else args[0]
                moved[f"{way}_bytes"] += source.numel() * source.element_size()
                moved[f"{way}_copies"] += 1
            return out

    return CopyCounter()


def transfer_bytes(torch, fn):
    """The host-to-device and device-to-host copies of one call of ``fn``
    under the profiler, counted two ways.  The count that is checked
    (``h2d_bytes``, ``d2h_bytes`` and their copies) comes from
    :func:`copy_counter`, which sees every tensor op of the call.  The
    profiler's trace gives ``profiled``: the bytes of its copy records
    (``gpu_memcpy``, each record's ``bytes``), each copy of a MB or more,
    and the runtime copy calls that have no record.  In this script's
    process the trace has lacked the records of a session's first
    host-to-device copies while their runtime calls were there, so it
    only stands beside the count."""
    moved = {"h2d_bytes": 0, "h2d_copies": 0, "d2h_bytes": 0, "d2h_copies": 0}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with copy_counter(torch, moved):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    records = {e["args"].get("correlation"): e for e in events if e.get("cat") == "gpu_memcpy"}
    calls = [e for e in events if e.get("cat") == "cuda_runtime" and str(e.get("name", "")).startswith("cudaMemcpy")]
    profiled = {"h2d_bytes": 0, "d2h_bytes": 0, "large": [],
                "unrecorded_copies": sum(e["args"].get("correlation") not in records for e in calls)}
    for event in records.values():
        way = "h2d" if "HtoD" in event["name"] else "d2h" if "DtoH" in event["name"] else None
        if way:
            nbytes = int(event["args"]["bytes"])
            profiled[f"{way}_bytes"] += nbytes
            if nbytes >= 1 << 20:
                profiled["large"].append({"copy": event["name"], "bytes": nbytes, "us": event.get("dur")})
    moved["profiled"] = profiled
    return moved


def traced_run(torch, label, fn, pairs, tracks_bytes, written_bytes):
    """One more warm run of ``fn`` (``process()`` or ``process_batch``
    on ``pairs`` pairs) with its copies counted (``transfer_bytes``): its
    equality checks must compare CUDA tensors, and it must copy about one
    copy of each track to the card (``tracks_bytes``, as decoded; scalars
    and small tables on top) and one copy of each written variant and
    preview piece back (``written_bytes``; scalars on top): the payload's
    codes of a WAV file of a subtype the card quantises
    (``io.saver.writes_codes``), else the float32 samples.  Returns the
    counts."""
    def run():
        EQUALITY_INPUTS.clear()
        fn()

    moved = transfer_bytes(torch, run)
    require_equality_on_card(label, pairs)
    moved.update(tracks_bytes=tracks_bytes, written_bytes=written_bytes,
                 h2d_per_track_copy=moved["h2d_bytes"] / tracks_bytes,
                 d2h_per_written_copy=moved["d2h_bytes"] / written_bytes)
    require(tracks_bytes <= moved["h2d_bytes"] <= 1.25 * tracks_bytes,
            f"{label}: {moved['h2d_bytes']} bytes crossed to the card for {tracks_bytes} bytes of tracks: {moved}")
    require(written_bytes <= moved["d2h_bytes"] <= 1.1 * written_bytes,
            f"{label}: {moved['d2h_bytes']} bytes came back for {written_bytes} bytes written: {moved}")
    return moved


def user_path(mt, torch, device, config, here, cuda_ms, run_process, bandwidth, f64_flops):
    """Phase 6: the inputs and outputs users send (see the module's
    docstring).  Returns the phase's numbers; fails on any mismatch."""
    from matchering_tpu_torch import preview
    from matchering_tpu_torch.io import codecs, wav
    from matchering_tpu_torch.ops import resample

    numbers = {"reference_rate": USER_RATE, "audio_seconds": FULL_SECONDS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_user_") as tmp:
        path = {
            name: os.path.join(tmp, name)
            for name in ("t.wav", "r48.wav", "master.aiff", "pt.wav", "pr.wav", "cli.wav", "cli_pr.wav")
        }
        target, _ = make_pair(FULL_SECONDS, SR, SEED + 2)
        wav.write(path["t.wav"], target, SR, "PCM_16")
        _, reference = make_pair(FULL_SECONDS, USER_RATE, SEED + 2)
        wav.write(path["r48.wav"], reference, USER_RATE, "PCM_24")
        del target, reference

        # the resampler on the card against the same call on the CPU, on the
        # staged PCM_24 codes (int32), which convert on the device
        reference_pcm, rate = mt.load(path["r48.wav"], "reference", tmp, True)
        require(rate == USER_RATE and reference_pcm.dtype == np.int32,
                f"the 48 kHz reference decoded as {reference_pcm.dtype} at {rate} Hz")
        staged = torch.from_numpy(reference_pcm).to(device)
        on_card = resample.resample(staged, USER_RATE, SR)
        on_cpu = resample.resample(torch.from_numpy(reference_pcm), USER_RATE, SR)
        require(tuple(on_card.shape) == tuple(on_cpu.shape) == (FULL_N, 2),
                f"resampled to {tuple(on_card.shape)} on the card, {tuple(on_cpu.shape)} on the CPU")
        err = float((on_card.cpu() - on_cpu).abs().max())
        require(err <= RESAMPLE_TOL, f"card resample off the CPU's by {err} > {RESAMPLE_TOL}")
        del on_card, on_cpu
        plan = resample.plan_resample(USER_RATE, SR)
        block_out, width = plan.weights.shape
        nblocks = -(-FULL_N // block_out)
        flops = 2 * 2 * nblocks * width * block_out  # the product as shaped: (2 * nblocks, width) @ (width, block_out)
        moved = reference_pcm.nbytes + plan.weights.nbytes + FULL_N * 2 * 8
        windows = torch.rand((2, nblocks, width), dtype=torch.float64, device=device)
        weights = torch.from_numpy(plan.weights.T.copy()).to(device)
        numbers["resample"] = {
            "max_abs_err_card_vs_cpu": err, "tolerance": RESAMPLE_TOL,
            "up": plan.up, "down": plan.down, "c": plan.c, "reach": plan.reach,
            "weights": [width, block_out], "gemm": [2 * nblocks, width, block_out],
            "flops": flops, "bytes": moved,
            "ms": cuda_ms(lambda: resample.resample(staged, USER_RATE, SR), 10),
            "gemm_ms": cuda_ms(lambda: torch.matmul(windows, weights), 10),
            "flop_bound_ms": 1e3 * flops / f64_flops,
            "byte_bound_ms": 1e3 * moved / bandwidth,
        }
        del windows, staged

        # process() with both previews and a PCM_24 AIFF result
        runs, events = [], []
        for label in ("cold", "warm"):
            timeline = run_process(
                label, runs, events, path["t.wav"], path["r48.wav"], [mt.pcm24(path["master.aiff"])],
                config, mt.pcm16(path["pt.wav"]), mt.pcm16(path["pr.wav"]),
            )
        numbers["process"] = runs
        numbers["realtime_factor_warm"] = FULL_SECONDS / runs[-1]["wall_s"]
        numbers["warm_timeline"] = timeline
        # the int16 target and the int32 (PCM_24) reference in; the float32
        # master (AIFF) and its two preview pieces' PCM_16 codes out
        numbers["transfers"] = traced_run(
            torch, "user path process()",
            lambda: mt.process(path["t.wav"], path["r48.wav"], [mt.pcm24(path["master.aiff"])], config,
                               mt.pcm16(path["pt.wav"]), mt.pcm16(path["pr.wav"]), device="cuda"),
            1, FULL_N * 2 * 2 + FULL_SECONDS * USER_RATE * 2 * 4,
            FULL_N * 2 * 4 + 2 * config.preview_size * 2 * 2,
        )
        master, rate = codecs.read(path["master.aiff"])
        require(rate == SR and master.shape == (FULL_N, 2), f"the AIFF master is {master.shape} at {rate} Hz")
        require(bool(np.all(np.isfinite(master))), "the AIFF master holds non-finite samples")
        peak = float(np.max(np.abs(master)))
        # the limiter's ceiling is the threshold to within its smoothing; at
        # PCM_24 a few steps over it show, so hold the master below full scale
        require(peak < 1.0, f"the AIFF master peaks at {peak}")
        for name in ("pt.wav", "pr.wav"):
            piece, rate = wav.read(path[name])
            require(rate == SR and piece.shape == (config.preview_size, 2),
                    f"preview {name} is {piece.shape} at {rate} Hz")

        # the preview window the card chooses, and the CPU's on the card's result
        target_pcm, _ = mt.load(path["t.wav"], "target", tmp, True)
        reference_track, _ = mt.check(reference_pcm, USER_RATE, config, "reference", device=device)
        result = mt.master(target_pcm, reference_track, config, device=device).result
        window, step = config.preview_size, config.preview_analysis_step
        index = preview._loudest_window_index(result, window, step)
        cpu_index = preview._loudest_window_index(result.cpu(), window, step)
        require(index == cpu_index, f"preview window {index} on the card, {cpu_index} on the CPU")
        numbers["preview"] = {
            "index": index, "cpu_index": cpu_index, "windows": (FULL_N - window) // step + 1,
            "search_ms": cuda_ms(lambda: preview._loudest_window_index(result, window, step), 10),
        }
        del result, reference_track

        # the command line, in a process of its own
        start = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "matchering_tpu_torch", path["t.wav"], path["r48.wav"], path["cli.wav"],
             "-b", "24", "--preview_result", path["cli_pr.wav"], "--quiet"],
            cwd=here, capture_output=True, text=True, timeout=300,
        )
        require(cli.returncode == 0, f"the CLI exited {cli.returncode}: {cli.stderr.strip()[-2000:]}")
        numbers["cli_wall_s"] = time.perf_counter() - start
        cli_master, rate = wav.read(path["cli.wav"])
        require(rate == SR and cli_master.shape == (FULL_N, 2), f"the CLI master is {cli_master.shape} at {rate} Hz")
        # the same pair and Config as process() above: the same PCM_24 master
        cli_err = float(np.max(np.abs(cli_master - master)))
        require(cli_err <= PCM24_LSB, f"the CLI master is {cli_err} off process()'s > one PCM_24 step")
        piece, rate = wav.read(path["cli_pr.wav"])
        require(rate == SR and piece.shape == (config.preview_size, 2), f"the CLI preview is {piece.shape}")
        numbers["cli_vs_process_max_abs_err"] = cli_err
    return numbers


def length_modes(torch, device, config, rng, release, k2_error, cuda_ms, kernel_ms, bandwidth):
    """Phase 3, second part: K1 and K2 on the rows of a zero-padded batch,
    each row ending at its own true length (see the module's docstring).
    Returns each kernel's ``batched`` numbers; fails on any mismatch."""
    from matchering_tpu_torch.kernels import envelope, scan
    from matchering_tpu_torch.utils import RowInts, ms_to_samples

    attack = ms_to_samples(config.limiter.attack, SR)
    window = envelope.window_for(attack)
    tile, threshold = envelope.TILE, config.threshold
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    # the lengths of 150-180 s songs padded to one bucket, and one full row
    full_lengths = sorted(int(v) for v in rng.randint(150 * SR, BUCKET_N, BATCH_ROWS - 1))
    full_lengths.append(BUCKET_N)
    full = RowInts.of(full_lengths, device)

    def k1_error(track, lengths):
        got = envelope.limiter_front_end(track, threshold, attack, lengths)
        want = envelope.limiter_front_end_plain(track, threshold, attack, lengths)
        torch.cuda.synchronize()
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    short_n = 3 * tile + 7
    short_lengths = [window, tile - 1, tile + 1, short_n]
    k1_err = 0.0
    for dtype in (torch.float32, torch.float64):
        for n, lengths in ((short_n, short_lengths), (BUCKET_N, full_lengths)):
            track = torch.randn((len(lengths), n, 2), generator=gen, device=device, dtype=dtype) * 0.5
            err = k1_error(track, RowInts.of(lengths, device))
            require(err == 0.0, f"K1 with lengths {lengths} at n={n}, {dtype}: max abs err {err}")
            k1_err = max(k1_err, err)
    print(f"K1 length mode checked: lengths {short_lengths} at n={short_n}, {full_lengths} at "
          f"n={BUCKET_N}, float32 and float64: max abs err {k1_err}", flush=True)

    scan_n = 3 * scan.TILE + 5
    scan_lengths = [1, scan.TILE + 1, scan_n - 3]
    k2_worst = {torch.float32: 0.0, torch.float64: 0.0}
    for dtype, tol in ((torch.float32, SCAN_TOL), (torch.float64, SCAN_REL_TOL_F64)):
        x = torch.rand((3, scan_n), generator=gen, device=device, dtype=dtype)
        zi_rows = torch.rand(3, generator=gen, device=device, dtype=torch.float64) * 0.5
        for zi in (None, zi_rows):
            for reverse in (False, True):
                err, _ = k2_error(x, release, zi, reverse, lengths=RowInts.of(scan_lengths, device))
                require(err <= tol, f"K2 with lengths {scan_lengths}, {dtype}, zi={zi is not None}, "
                                    f"reverse={reverse}: error {err} > {tol}")
                k2_worst[dtype] = max(k2_worst[dtype], err)

    # the 8 full-width rows in float32: checked, then timed
    track = torch.randn((BATCH_ROWS, BUCKET_N, 2), generator=gen, device=device) * 0.5
    x = torch.rand((BATCH_ROWS, BUCKET_N), generator=gen, device=device)
    zi = torch.rand(BATCH_ROWS, generator=gen, device=device, dtype=torch.float64) * 0.5
    cases = []
    for reverse in (False, True):
        err, _ = k2_error(x, release, zi, reverse, lengths=full)
        require(err <= SCAN_TOL, f"K2 over {BATCH_ROWS} full-width rows, reverse={reverse}: {err}")
        k2_worst[torch.float32] = max(k2_worst[torch.float32], err)

        def call(plain=False):
            fn = scan.first_order_filter_plain if plain else scan.first_order_filter
            return fn(x, *release, zi=zi, reverse=reverse, lengths=full)

        cases.append({
            "reverse": reverse, "max_abs_err": err, "ms": cuda_ms(call, 20),
            "kernel_ms": kernel_ms(call, "scan_kernel"), "plain_ms": cuda_ms(lambda: call(True), 2),
        })
    print(f"K2 length mode checked: lengths {scan_lengths} at n={scan_n} and {BATCH_ROWS} rows at "
          f"n={BUCKET_N}: worst float32 abs err {k2_worst[torch.float32]}, worst float64 rel err "
          f"{k2_worst[torch.float64]}", flush=True)

    true_samples, padded = sum(full_lengths), BATCH_ROWS * BUCKET_N

    def bound(moved, ops, flops):
        return {
            "bytes": moved, "bound_ms": 1e3 * max(moved / bandwidth, ops / flops),
            "bound_by": "bytes" if moved / bandwidth >= ops / flops else "operations",
        }

    common = {"rows": BATCH_ROWS, "n": BUCKET_N, "lengths": full_lengths, "dtype": "float32"}
    # each row read to its length once, every output written over the padded rows
    k1_batched = {
        **common, "max_abs_err": k1_err, "tolerance": 0.0,
        "ms": cuda_ms(lambda: envelope.limiter_front_end(track, threshold, attack, full), 20),
        "kernel_ms": kernel_ms(
            lambda: envelope.limiter_front_end(track, threshold, attack, full), "envelope_kernel"
        ),
        "plain_ms": cuda_ms(lambda: envelope.limiter_front_end_plain(track, threshold, attack, full), 3),
        **bound(true_samples * 8 + padded * 8, true_samples * (7 + window - 1), F32_FLOPS),
        "bound_ms_padded": 1e3 * padded * 16 / bandwidth,
        "library_ms": None,
        "launch": launch_numbers("mtpu_envelope_info", 0, window, grid=envelope.LAST_GRID),
    }
    k2_batched = {
        **common, "max_abs_err": k2_worst[torch.float32], "tolerance": SCAN_TOL,
        "max_rel_err_f64": k2_worst[torch.float64], "tolerance_rel_f64": SCAN_REL_TOL_F64,
        "ms": sum(c["ms"] for c in cases) / len(cases),
        "kernel_ms": sum(c["kernel_ms"] for c in cases) / len(cases),
        "plain_ms": sum(c["plain_ms"] for c in cases) / len(cases),
        **bound(true_samples * 4 + padded * 4, true_samples * 4, F64_FLOPS),
        "bound_ms_padded": 1e3 * padded * 8 / bandwidth,
        "library_ms": None, "cases": cases,
        "launch": launch_numbers("mtpu_scan_info", 0, grid=scan.LAST_GRID),
    }
    for name, numbers in (("K1", k1_batched), ("K2", k2_batched)):
        print(f"{name} over {BATCH_ROWS} rows of {BUCKET_N}: {numbers['ms']:.4f} ms a call, "
              f"{numbers['kernel_ms']:.4f} ms of kernel, bound {numbers['bound_ms']:.4f} ms", flush=True)
    return k1_batched, k2_batched


def farm_path(mt, torch, device, config, recorder, tmp):
    """Phase 7: ``process_batch`` on eight jobs, both dispatches (see the
    module's docstring).  ``recorder(events)`` installs log handlers that
    append (time, message) to ``events``.  The jobs and ``process()``'s
    file for each (``t{i}.wav``, ``r{i}.wav``, ``single{i}.wav``) stay in
    the folder ``tmp`` for phase 10.  Returns the phase's numbers; fails on
    any mismatch."""
    from matchering_tpu_torch import stages, state
    from matchering_tpu_torch.io import wav
    from matchering_tpu_torch.parallel import batch
    from matchering_tpu_torch.utils import RowInts

    rng = np.random.RandomState(SEED + 5)
    t_seconds, r_seconds = farm_seconds(rng)
    numbers = {"jobs": FARM_JOBS, "target_seconds": t_seconds.tolist(),
               "reference_seconds": r_seconds.tolist(), "bucket": BUCKET}
    audio_seconds = float(np.sum(np.floor(t_seconds * SR))) / SR

    def at(name):
        return os.path.join(tmp, name)

    for i in range(FARM_JOBS):
        wav.write(at(f"t{i}.wav"), make_pair(t_seconds[i], SR, SEED + 10 + i)[0], SR, "PCM_16")
        wav.write(at(f"r{i}.wav"), make_pair(r_seconds[i], SR, SEED + 30 + i)[1], SR, "PCM_16")

    def jobs(tag):
        """One pcm16 result each; job 0 also asks for both previews, job 1
        for a raw FLOAT variant."""
        out = []
        for i in range(FARM_JOBS):
            results = [mt.pcm16(at(f"{tag}{i}.wav"))]
            if i == 1:
                results.append(mt.Result(at(f"{tag}{i}_raw.wav"), "FLOAT", use_limiter=False,
                                         normalize=False))
            previews = {}
            if i == 0:
                previews = {"preview_target": mt.pcm16(at(f"{tag}_pt.wav")),
                            "preview_result": mt.pcm16(at(f"{tag}_pr.wav"))}
            out.append(mt.PairJob(at(f"t{i}.wav"), at(f"r{i}.wav"), results, **previews))
        return out

    runs, timelines = [], {}
    expected = {"pipelined": (FARM_JOBS, 4 * FARM_JOBS, 0), "vmapped": (1, 4, 0)}
    for dispatch in ("pipelined", "vmapped"):
        for label in ("cold", "warm"):
            events = []
            recorder(events)
            zero_counts()
            EQUALITY_INPUTS.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            try:
                mt.process_batch(jobs(f"{dispatch}_{label}_"), config, dispatch=dispatch, device=device)
                torch.cuda.synchronize()
            finally:
                mt.log()
            wall = time.perf_counter() - start
            launches = launch_counts()
            require(launches == expected[dispatch],
                    f"{dispatch} {label} process_batch launched K1, K2 and K3 {launches} times, "
                    f"not {expected[dispatch]}")
            require_equality_on_card(f"{dispatch} {label} process_batch", FARM_JOBS)
            runs.append({
                "dispatch": dispatch, "run": label, "wall_s": wall, "pairs_per_s": FARM_JOBS / wall,
                "audio_s_per_wall_s": audio_seconds / wall, "k1": launches[0], "k2": launches[1],
                "k3": launches[2],
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            })
            print(json.dumps({"farm_run": runs[-1]}), flush=True)
            if label == "warm":
                timelines[dispatch] = [
                    {"t_s": round(t - start, 4), "event": message[:48]} for t, message in events
                ]
    numbers["runs"] = runs
    numbers["warm_timelines"] = timelines

    # one warm run of each dispatch under the profiler: each job's int16
    # tracks to the card once; back, each job's PCM_16 codes, job 1's raw
    # variant as FLOAT codes and job 0's two preview pieces' PCM_16 codes
    t_n = [int(seconds * SR) for seconds in t_seconds]
    r_n = [int(seconds * SR) for seconds in r_seconds]
    numbers["transfers"] = {}
    for dispatch in ("pipelined", "vmapped"):
        numbers["transfers"][dispatch] = traced_run(
            torch, f"{dispatch} process_batch",
            lambda: mt.process_batch(jobs(f"{dispatch}_traced_"), config, dispatch=dispatch, device=device),
            FARM_JOBS, 2 * 2 * (sum(t_n) + sum(r_n)),
            2 * 2 * sum(t_n) + 2 * 4 * t_n[1] + 2 * config.preview_size * 2 * 2,
        )

    # every job's PCM_16 master against process() on the card
    worst = 0
    for i in range(FARM_JOBS):
        mt.process(at(f"t{i}.wav"), at(f"r{i}.wav"), [mt.pcm16(at(f"single{i}.wav"))], config,
                   device=device)
        single, _ = wav.read(at(f"single{i}.wav"), raw_int=True)
        for dispatch in ("pipelined", "vmapped"):
            farmed, rate = wav.read(at(f"{dispatch}_warm_{i}.wav"), raw_int=True)
            require(rate == SR and farmed.shape == single.shape,
                    f"job {i} ({dispatch}) wrote {farmed.shape} at {rate} Hz, process() {single.shape}")
            diff = int(np.max(np.abs(farmed.astype(np.int32) - single)))
            require(diff <= 1, f"job {i} ({dispatch}) is {diff} PCM_16 steps off process()")
            worst = max(worst, diff)
    for name in ("_pt.wav", "_pr.wav"):
        piece, rate = wav.read(at(f"vmapped_warm_{name}"))
        require(rate == SR and piece.shape == (config.preview_size, 2), f"preview {name} is {piece.shape}")
    raw, _ = wav.read(at("vmapped_warm_1_raw.wav"))
    require(bool(np.all(np.isfinite(raw))), "the raw FLOAT variant holds non-finite samples")
    numbers["max_pcm16_steps_vs_process"] = worst

    # the dynamic graph on staged inputs: no host sync, and batched
    # against one graph per pair on the same inputs
    tracks = [(wav.read(at(f"t{i}.wav"), raw_int=True)[0], wav.read(at(f"r{i}.wav"), raw_int=True)[0])
              for i in range(FARM_JOBS)]
    t_batch, t_lens = batch.bucket_pad([t for t, _ in tracks], BUCKET, device=device)
    r_batch, r_lens = batch.bucket_pad([r for _, r in tracks], BUCKET, device=device)
    del tracks
    t_rows, r_rows = RowInts.of(t_lens, device), RowInts.of(r_lens, device)
    per_pair = [(RowInts.of([a], device), RowInts.of([b], device)) for a, b in zip(t_lens, r_lens)]
    operators = state.operators_for_config(config, device)

    def batched():
        return stages.master_graph(t_batch, r_batch, config, interp_ops=operators,
                                   target_length=t_rows, reference_length=r_rows)

    def pairs():
        return [stages.master_graph(t_batch[i], r_batch[i], config, interp_ops=operators,
                                    target_length=a, reference_length=b)
                for i, (a, b) in enumerate(per_pair)]

    def wall_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - start) / reps

    numbers["graph_ms"] = {"batched": wall_ms(batched), "pairs": wall_ms(pairs)}
    numbers["graph_ms"]["batched_again"] = wall_ms(batched)
    torch.cuda.set_sync_debug_mode("error")
    try:
        batched()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    numbers["sync_free_master_graph"] = True
    graph_ms, ops = profile_device(torch, batched)
    device_ms = sum(o["device_ms"] for o in ops)
    numbers["graph_profiled"] = {"wall_ms": graph_ms, "device_ms": device_ms,
                                 "device_busy_share": device_ms / graph_ms, "top_ops": top(ops, 8, 50)}
    del t_batch, r_batch, operators

    # master_batch on the card (float32) against the CPU (float64)
    lo, hi = BATCH_SNR_SECONDS
    seconds = rng.uniform(lo, hi, (2, 3))
    targets = [make_pair(s, SR, SEED + 50 + i)[0] for i, s in enumerate(seconds[0])]
    references = [make_pair(s, SR, SEED + 60 + i)[1] for i, s in enumerate(seconds[1])]
    t_batch, t_lens = batch.bucket_pad(targets, BUCKET, device="cpu")
    r_batch, r_lens = batch.bucket_pad(references, BUCKET, device="cpu")
    lengths = dict(target_lengths=t_lens, reference_lengths=r_lens)
    card = batch.master_batch(t_batch, r_batch, mt.Config(), **lengths, device=device).result.cpu()
    cpu = batch.master_batch(t_batch, r_batch, mt.Config(dtype="float64"), **lengths, device="cpu").result
    snrs = []
    for i, length in enumerate(t_lens):
        require(not bool(card[i, length:].any()), f"master_batch row {i} is not 0 past its length")
        snrs.append(snr_db(cpu[i, :length].numpy(), card[i, :length].numpy()))
        require(snrs[-1] >= SNR_GATE_DB, f"master_batch row {i}: {snrs[-1]} dB < {SNR_GATE_DB} dB")
    numbers["master_batch_snr_db_f32_card_vs_f64_cpu"] = snrs
    numbers["master_batch_snr_seconds"] = seconds.tolist()
    return numbers


def card_track(torch, device, seconds, sr, seed, role, chunk=1 << 24):
    """One track of ``make_pair`` built on the card in chunks (float64
    phases, float32 samples, the noise from a generator seeded with
    ``seed``): a 60-min 96 kHz pair in float64 on the host would take
    over 10 GB.  ``role``: "target" or "reference"."""
    n = int(seconds * sr)
    gen = torch.Generator(device=device).manual_seed(seed)
    track = torch.empty((n, 2), dtype=torch.float32, device=device)
    two_pi = 2 * np.pi
    for start in range(0, n, chunk):
        t = torch.arange(start, min(start + chunk, n), dtype=torch.float64, device=device) / sr
        env = 0.6 + 0.4 * torch.sin(two_pi * t * 0.25) ** 2
        noise = 0.05 * torch.randn((2, t.shape[0]), generator=gen, dtype=torch.float64, device=device)
        if role == "target":
            left = 0.4 * torch.sin(two_pi * 220 * t)
            right = 0.38 * torch.sin(two_pi * 221 * t)
        else:
            left = right = 0.7 * torch.sign(torch.sin(two_pi * 110 * t))
        track[start:start + t.shape[0], 0] = (left + noise[0]) * env
        track[start:start + t.shape[0], 1] = (right + noise[1]) * env
    return track


def card_snr_db(torch, reference, test, chunk=1 << 24) -> float:
    """SNR of ``test`` against ``reference`` on the card, in float64 over
    chunks; one value read back."""
    signal = torch.zeros((), dtype=torch.float64, device=reference.device)
    error = torch.zeros_like(signal)
    for start in range(0, reference.shape[0], chunk):
        a = reference[start:start + chunk].double()
        e = a - test[start:start + chunk].double()
        signal += torch.sum(a * a)
        error += torch.sum(e * e)
    return float(10.0 * torch.log10(signal / error))


def timeshard_path(mt, torch, device, config, here, cuda_ms, phase4):
    """Phase 9: time sharding on one card (see the module's docstring).
    ``phase4``: the paths of phase 4's target, reference and
    ``process()`` output.  Returns the phase's numbers and the (K1, K2,
    K3) launches of one sharded ``limit()``; fails on any mismatch."""
    from matchering_tpu_torch.io import wav
    from matchering_tpu_torch.parallel import batch, mesh, timeshard

    def counted(fn):
        zero_counts()
        out = fn()
        return out, launch_counts()

    def timed(fn):
        """``fn()`` with the wall time and the peak device memory of the
        call, counted from 0 and above what was allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        start = time.perf_counter()
        out, launches = counted(fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        return out, launches, {
            "wall_s": wall, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "peak_above_inputs_bytes": torch.cuda.max_memory_allocated() - before,
            "k1": launches[0], "k2": launches[1], "k3": launches[2],
        }

    numbers = {}

    # limit_sharded over four shards of the card against limit(), on the
    # main path's limiter input (the unlimited master of phase 4's pair)
    target, reference = make_pair(FULL_SECONDS, SR, SEED)
    loud = mt.master(target, reference, config, need_default=False, need_no_limiter=True,
                     device=device).result_no_limiter
    del target, reference
    grid = timeshard.TimeGrid([device] * LIMIT_SHARDS)
    block = FULL_N // LIMIT_SHARDS
    checks = {}
    for dtype, tol in ((torch.float32, SCAN_TOL), (torch.float64, SCAN_REL_TOL_F64)):
        cfg = mt.Config(dtype="float32" if dtype == torch.float32 else "float64")
        x = loud.to(dtype)
        parts = grid.split(x, block)
        want = mt.limit(x, cfg)
        sharded, launches = counted(lambda: timeshard.limit_sharded(parts, cfg, grid))
        got = grid.join(sharded, FULL_N, device)
        torch.cuda.synchronize()
        require(launches == SHARDED_LAUNCHES,
                f"limit_sharded launched K1, K2 and K3 {launches} times, not {SHARDED_LAUNCHES}")
        require(bool(torch.isfinite(got).all()), "limit_sharded gave non-finite values")
        diff = (got.double() - want.double()).abs()
        if dtype == torch.float32:
            err = float(diff.max())
        else:
            err = float((diff / want.double().abs().clamp_min(1e-300)).max())
        require(err <= tol, f"limit_sharded on {LIMIT_SHARDS} shards off limit() by {err} > {tol} ({dtype})")
        checks[str(dtype).replace("torch.", "")] = {
            "error": err, "tolerance": tol, "relative": dtype == torch.float64,
            "over_threshold_share": float((x.abs().amax(-1) > cfg.threshold).double().mean()),
        }
        if dtype == torch.float32:
            checks["float32"]["sharded_ms"] = cuda_ms(lambda: timeshard.limit_sharded(parts, cfg, grid), 10)
            checks["float32"]["limit_ms"] = cuda_ms(lambda: mt.limit(x, cfg), 10)
        del x, parts, want, sharded, got, diff
    numbers["limit_sharded"] = {"shards": LIMIT_SHARDS, "n": FULL_N, "launches": list(SHARDED_LAUNCHES),
                                **checks}
    del loud
    print(json.dumps({"timeshard_limit": numbers["limit_sharded"]}), flush=True)

    # the long form: a 60-min 96 kHz target against a 200 s reference
    long_config = mt.Config(internal_sample_rate=LONG_RATE, max_length=LONG_SECONDS + 1)
    target = card_track(torch, device, LONG_SECONDS, LONG_RATE, SEED + 70, "target")
    reference = card_track(torch, device, LONG_REFERENCE_SECONDS, LONG_RATE, SEED + 71, "reference")
    long_mesh = mesh.single_axis_mesh("time", devices=[device] * LONG_SHARDS)
    runs = []
    for label in ("cold", "warm"):
        single, launches, run = timed(lambda: mt.master(target, reference, long_config, device=device).result)
        require(launches == expected_launches(long_config),
                f"the long-form master() launched {launches}, not {expected_launches(long_config)}")
        runs.append({"call": "master", "run": label, **run})
        print(json.dumps({"long_form_run": runs[-1]}), flush=True)
        if label == "cold":
            del single
    for label in ("cold", "warm"):
        sharded, launches, run = timed(
            lambda: timeshard.master_sharded(target, reference, long_config, mesh=long_mesh).result
        )
        require(launches == SHARDED_LAUNCHES,
                f"the long-form master_sharded launched {launches}, not {SHARDED_LAUNCHES}")
        runs.append({"call": f"master_sharded ({LONG_SHARDS} shards)", "run": label, **run})
        print(json.dumps({"long_form_run": runs[-1]}), flush=True)
        if label == "cold":
            del sharded
    samples = LONG_SECONDS * LONG_RATE
    require(tuple(single.shape) == tuple(sharded.shape) == (samples, 2),
            f"long-form results {tuple(single.shape)} and {tuple(sharded.shape)}")
    require(bool(torch.isfinite(sharded).all()), "the long-form sharded master holds non-finite samples")
    long_snr = card_snr_db(torch, single, sharded)
    require(long_snr >= SNR_GATE_DB, f"long-form master_sharded vs master: {long_snr} dB < {SNR_GATE_DB} dB")
    for run in runs:
        run["realtime_factor"] = LONG_SECONDS / run["wall_s"]
    numbers["long_form"] = {
        "audio_seconds": LONG_SECONDS, "rate": LONG_RATE, "samples": samples,
        "reference_seconds": LONG_REFERENCE_SECONDS, "shards": LONG_SHARDS, "runs": runs,
        "snr_db_sharded_vs_master": long_snr, "gate_db": SNR_GATE_DB,
    }
    del target, reference, single, sharded
    torch.cuda.empty_cache()

    # master_farm over (pairs=2, time=2) of the card: two of phase 7's jobs
    # (rebuilt from its seeds), bucketed, with their true lengths
    t_seconds, r_seconds = farm_seconds(np.random.RandomState(SEED + 5))
    targets = [make_pair(t_seconds[i], SR, SEED + 10 + i)[0] for i in (0, 1)]
    references = [make_pair(r_seconds[i], SR, SEED + 30 + i)[1] for i in (0, 1)]
    t_batch, t_lens = batch.bucket_pad(targets, BUCKET, device=device)
    r_batch, r_lens = batch.bucket_pad(references, BUCKET, device=device)
    farm_mesh = mesh.make_mesh(pairs=2, time=2, devices=[device] * 4)
    farm, launches, run = timed(lambda: timeshard.master_farm(
        t_batch, r_batch, config, mesh=farm_mesh, target_lengths=t_lens, reference_lengths=r_lens
    ).result)
    expected = tuple(2 * k for k in SHARDED_LAUNCHES)
    require(launches == expected, f"master_farm launched {launches}, not {expected}")
    snrs = []
    for i, length in enumerate(t_lens):
        require(not bool(farm[i, length:].any()), f"master_farm row {i} is not 0 past its length")
        single = mt.master(targets[i], references[i], config, device=device).result
        snrs.append(card_snr_db(torch, single, farm[i, :length]))
        require(snrs[-1] >= SNR_GATE_DB, f"master_farm row {i}: {snrs[-1]} dB < {SNR_GATE_DB} dB")
    numbers["master_farm"] = {"mesh": farm_mesh.shape, "lengths": t_lens, "snr_db_vs_master": snrs, **run}
    del t_batch, r_batch, farm

    # the command line with --time_sharded on phase 4's pair
    target_path, reference_path, process_out = phase4
    out_path = os.path.join(os.path.dirname(process_out), "sharded_cli.wav")
    start = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "matchering_tpu_torch", target_path, reference_path, out_path,
         "--time_sharded", "--quiet"],
        cwd=here, capture_output=True, text=True, timeout=300,
    )
    require(cli.returncode == 0, f"the --time_sharded CLI exited {cli.returncode}: {cli.stderr.strip()[-2000:]}")
    sharded_out, rate = wav.read(out_path, raw_int=True)
    single_out, _ = wav.read(process_out, raw_int=True)
    require(rate == SR and sharded_out.shape == single_out.shape,
            f"the --time_sharded CLI wrote {sharded_out.shape} at {rate} Hz, process() {single_out.shape}")
    steps = int(np.max(np.abs(sharded_out.astype(np.int32) - single_out)))
    require(steps <= 1, f"the --time_sharded CLI is {steps} PCM_16 steps off process()")
    numbers["cli"] = {"wall_s": time.perf_counter() - start, "max_pcm16_steps_vs_process": steps,
                      "devices": torch.cuda.device_count()}
    return numbers


def farm_seconds(rng):
    """Phase 7's target and reference durations: the first draws of its
    generator, seeded with SEED + 5."""
    return rng.uniform(150, 180, FARM_JOBS), rng.uniform(140, 180, FARM_JOBS)


def expected_launches(config):
    """(K1, K2, K3) launches of one ``limit()`` under ``config``: one K1,
    the attack filtfilt's two K2, and per Butterworth low-pass of order h
    one K2 at order 1, else one K3 per scipy section, ``ceil(h / 2)``."""
    k2, k3 = 2, 0
    for order in (config.limiter.hold_filter_order, config.limiter.release_filter_order):
        if order == 1:
            k2 += 1
        else:
            k3 += -(-order // 2)
    return 1, k2, k3


def sosfilt_ld(section, x):
    """``scipy.signal.sosfilt`` of one section in long double on the host,
    rounded to float64: the reference K3 is held to."""
    from scipy import signal

    row = np.asarray([[section.b0, section.b1, section.b2, 1.0, section.a1, section.a2]], np.longdouble)
    return signal.sosfilt(row, np.asarray(x, np.longdouble), axis=-1).astype(np.float64)


def configs_path(mt, torch, device, cuda_ms, kernel_ms, run_process, bandwidth):
    """Phase 8: K3 and the non-default configs (see the module's
    docstring).  Returns K3's line of the kernels' numbers and the phase's
    numbers; fails on any mismatch."""
    from matchering_tpu_torch import stages, state
    from matchering_tpu_torch.io import wav
    from matchering_tpu_torch.kernels import sos
    from matchering_tpu_torch.ops import iir, smoothing
    from matchering_tpu_torch.parallel import batch
    from matchering_tpu_torch.utils import RowInts
    from scipy import signal

    rng = np.random.RandomState(SEED + 7)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    sections = {name: iir.butter_sos(2, cutoff, float(SR))[0] for name, cutoff in CUTOFFS.items()}
    f32, f64 = torch.float32, torch.float64
    tolerance = {f32: SCAN_TOL, f64: SOS_REL_TOL_F64}

    def check(x, section, label, want=None):
        """K3 against its twin (``want``, computed unless given): the max
        error, absolute in float32 (outputs below 2, so one ulp is at most
        2^-23), relative in float64, held to its tolerance."""
        got = sos.sos_filter(x, *section)
        if want is None:
            want = sos.sos_filter_plain(x, *section)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), "K3 gave non-finite values")
        diff = (got.double() - want.double()).abs()
        if x.dtype == f32:
            require(float(want.abs().max()) < 2.0, "K3's float32 check needs outputs below 2")
            err = float(diff.max())
        else:
            err = float((diff / want.double().abs().clamp_min(1e-300)).max())
        require(err <= tolerance[x.dtype], f"K3 disagrees with its twin ({label}, {x.dtype}): "
                                           f"error {err} > {tolerance[x.dtype]}")
        worst[x.dtype] = max(worst[x.dtype], err)
        return err, got, want

    worst = {f32: 0.0, f64: 0.0}
    checked = 0
    for name, section in sections.items():
        for dtype in (f32, f64):
            for n in K3_SHAPES:
                for rows in (1, 3):
                    x = torch.from_numpy(rng.rand(rows, n)).to(device, dtype)
                    check(x[0] if rows == 1 else x, section, f"{name}, n={n}, rows={rows}")
                    checked += 1

    # full width: one track (three repeats: the look-back's carries may round
    # differently each run) and 8 rows; float64 also against sosfilt on the host
    track = torch.rand(FULL_N, generator=gen, device=device, dtype=f64)
    rows8 = torch.rand((BATCH_ROWS, BUCKET_N), generator=gen, device=device, dtype=f64)
    repeats, host_err = {f32: [], f64: []}, 0.0
    for name, section in sections.items():
        for dtype in (f32, f64):
            x, want = track.to(dtype), None
            for _ in range(3):
                err, got, want = check(x, section, f"{name}, n={FULL_N}, repeated", want)
                repeats[dtype].append(err)
            _, got8, _ = check(rows8.to(dtype), section, f"{name}, {BATCH_ROWS} rows of {BUCKET_N}")
            if dtype == f64:
                for inputs, outputs in ((x, got), (rows8, got8)):
                    diff = outputs.cpu().numpy() - sosfilt_ld(section, inputs.cpu().numpy())
                    host_err = max(host_err, float(np.max(np.abs(diff))))
            del x, want, got, got8
    require(host_err <= SOSFILT_TOL, f"K3 float64 is {host_err} off sosfilt (long double) > {SOSFILT_TOL}")
    release, host_track = sections["release"], track.cpu().numpy()
    sosfilt_f64_err = float(np.max(np.abs(
        signal.sosfilt([[*release[:3], 1.0, *release[3:]]], host_track) - sosfilt_ld(release, host_track)
    )))
    del host_track
    print(f"K3 checked at n={K3_SHAPES}, rows 1 and 3, n={FULL_N} (3 repeats) and {BATCH_ROWS} rows "
          f"of {BUCKET_N}, both cutoffs: {checked} awkward cases, worst float32 abs err {worst[f32]}, "
          f"worst float64 rel err {worst[f64]}, float64 vs sosfilt (long double) {host_err} "
          f"(sosfilt in float64: {sosfilt_f64_err})", flush=True)

    # timed at full width in float32, beside the byte bound
    x = track.to(f32)
    x8 = rows8.to(f32)
    del track, rows8
    cases, batched_cases = [], []
    for name, section in sections.items():
        cases.append({
            "cutoff": name, "section": list(section),
            "ms": cuda_ms(lambda: sos.sos_filter(x, *section), 20),
            "kernel_ms": kernel_ms(lambda: sos.sos_filter(x, *section), "sos_scan_kernel"),
            "grid": sos.LAST_GRID,
            "plain_ms": cuda_ms(lambda: sos.sos_filter_plain(x, *section), 2),
        })
        batched_cases.append({
            "cutoff": name,
            "ms": cuda_ms(lambda: sos.sos_filter(x8, *section), 10),
            "kernel_ms": kernel_ms(lambda: sos.sos_filter(x8, *section), "sos_scan_kernel", reps=10),
            "grid": sos.LAST_GRID,
            "plain_ms": cuda_ms(lambda: sos.sos_filter_plain(x8, *section), 1),
        })
        print(f"K3 timed: {name}: {cases[-1]['ms']:.4f} ms a call, {cases[-1]['kernel_ms']:.4f} ms "
              f"of kernel; {BATCH_ROWS} rows {batched_cases[-1]['kernel_ms']:.4f} ms of kernel", flush=True)
    del x, x8

    def mean(rows, key):
        return sum(r[key] for r in rows) / len(rows)

    def bound(samples):
        moved, ops = samples * 8, samples * 9  # float32 in and out; y, z1, z2 in float64
        return {"bytes": moved, "bound_ms": 1e3 * max(moved / bandwidth, ops / F64_FLOPS),
                "bound_by": "bytes" if moved / bandwidth >= ops / F64_FLOPS else "operations"}

    k3 = {
        "name": "sos_scan", "route": "cuda", "source": "matchering_tpu_torch/csrc/sos_scan.cu",
        "replaces": "matchering_tpu/ops/iir.py:992",
        "max_abs_err": worst[f32], "tolerance": SCAN_TOL,
        "max_rel_err_f64": worst[f64], "tolerance_rel_f64": SOS_REL_TOL_F64,
        "max_abs_err_vs_sosfilt_long_double": host_err, "tolerance_vs_sosfilt": SOSFILT_TOL,
        "sosfilt_f64_vs_long_double": sosfilt_f64_err,
        "ms": mean(cases, "ms"), "kernel_ms": mean(cases, "kernel_ms"), "plain_ms": mean(cases, "plain_ms"),
        **bound(FULL_N),
        "library_ms": None, "n": FULL_N, "dtype": "float32",
        "shapes": K3_SHAPES, "checked_cases": checked,
        "repeat_abs_errs_f32": repeats[f32], "repeat_rel_errs_f64": repeats[f64], "cases": cases,
        "launch": launch_numbers("mtpu_sos_info", 0, grid=cases[-1]["grid"]),
        "batched": {"rows": BATCH_ROWS, "n": BUCKET_N, "dtype": "float32",
                    "ms": mean(batched_cases, "ms"), "kernel_ms": mean(batched_cases, "kernel_ms"),
                    "plain_ms": mean(batched_cases, "plain_ms"), **bound(BATCH_ROWS * BUCKET_N),
                    "library_ms": None, "cases": batched_cases,
                    "launch": launch_numbers("mtpu_sos_info", 0, grid=batched_cases[-1]["grid"])},
    }

    # process() on a 180 s pair with orders 2/2 and lowess_it=1
    config = mt.Config(lowess_it=1, limiter=mt.LimiterConfig(hold_filter_order=2, release_filter_order=2))
    expected = expected_launches(config)
    numbers = {"config": {"lowess_it": 1, "hold_filter_order": 2, "release_filter_order": 2},
               "expected_launches": expected}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_configs_") as tmp:
        paths = [os.path.join(tmp, name) for name in ("t.wav", "r.wav", "master.wav")]
        target, reference = make_pair(FULL_SECONDS, SR, SEED + 3)
        wav.write(paths[0], target, SR, "PCM_16")
        wav.write(paths[1], reference, SR, "PCM_16")
        del target, reference
        runs, events = [], []
        for label in ("cold", "warm"):
            timeline = run_process(label, runs, events, paths[0], paths[1], [mt.pcm16(paths[2])], config,
                                   expected=expected)
        out, rate = wav.read(paths[2])
        require(rate == SR and out.shape == (FULL_N, 2), f"configs output is {out.shape} at {rate} Hz")
        require(bool(np.all(np.isfinite(out))), "the configs output holds non-finite samples")
        peak = float(np.max(np.abs(out)))
        require(peak <= config.threshold, f"configs output peak {peak} exceeds {config.threshold}")
        # where master()'s device time goes with this config, on the staged int16 pair
        target_pcm, _ = mt.load(paths[0], "target", raw_int=True)
        reference_pcm, _ = mt.load(paths[1], "reference", raw_int=True)
        mt.master(target_pcm, reference_pcm, config, device=device)

        def profiled_master():
            zero_counts()
            mt.master(target_pcm, reference_pcm, config, device=device)

        master_ms, ops = profile_device(torch, profiled_master)
        sos_kernels = sum(o["calls"] for o in ops if "sos_scan_kernel" in o["op"])
        k3_calls = launch_counts()[2]
        require(sos_kernels == k3_calls == expected[2],
                f"master() made {k3_calls} K3 calls but the profile shows {sos_kernels} sos_scan kernels")
        device_ms = sum(o["device_ms"] for o in ops)
        numbers["master_profiled"] = {"wall_ms": master_ms, "device_ms": device_ms,
                                      "device_busy_share": device_ms / master_ms, "k3_kernels": sos_kernels,
                                      "top_ops": top(ops, 15, 60)}
        # the smoothing state's staging on its own: built from the host
        # operators (float32 conversion and copy to the card), and as each
        # master() call now takes it, from the per-device cache
        host_ops = smoothing.host_operators_for_config(config)
        staging = {}
        for label, stage in (
            ("uncached", lambda: smoothing.as_smoothing(host_ops, config.log_grid_size,
                                                        smoothing.lowess_parameters(config),
                                                        config.torch_dtype, device)),
            ("cached", lambda: state.operators_for_config(config, device)),
        ):
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                start = time.perf_counter()
                stage()
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - start))
            staging[f"{label}_ms"] = walls
        staging["operator_bytes"] = sum(a.size for a in host_ops) * config.torch_dtype.itemsize
        numbers["smoothing_staging"] = staging
        print(f"smoothing state staged in {staging['uncached_ms']} ms uncached, {staging['cached_ms']} ms "
              f"cached ({staging['operator_bytes']} bytes of operators)", flush=True)
        del host_ops
        del target_pcm, reference_pcm, out
    numbers.update(process=runs, realtime_factor_warm=FULL_SECONDS / runs[-1]["wall_s"],
                   output_peak=peak, warm_timeline=timeline)
    k3["launches"] = runs[-1]["k3"]

    # the card's float32 master against the CPU's float64, two configs
    snrs = {}
    others = {"orders-2-2+lowess_it=1": dict(lowess_it=1, limiter=config.limiter),
              "orders-3-4+lowess_exact": dict(lowess_exact=True, limiter=mt.LimiterConfig(
                  hold_filter_order=3, release_filter_order=4))}
    for i, (name, kwargs) in enumerate(others.items()):
        target, reference = make_pair(SNR_SECONDS, SR, SEED + 40 + i)
        card_out = mt.master(target, reference, mt.Config(**kwargs), device=device).result.cpu().numpy()
        cpu_out = mt.master(target, reference, mt.Config(dtype="float64", **kwargs), device="cpu").result.numpy()
        snrs[name] = snr_db(cpu_out, card_out)
        require(snrs[name] >= SNR_GATE_DB, f"{name}: card float32 master at {snrs[name]} dB < {SNR_GATE_DB} dB")
    numbers["snr_db_f32_card_vs_f64_cpu"] = snrs

    # master_batch on three rows of the config; its dynamic graph without a host sync
    lo, hi = BATCH_SNR_SECONDS
    seconds = rng.uniform(lo, hi, (2, 3))
    targets = [make_pair(v, SR, SEED + 70 + i)[0] for i, v in enumerate(seconds[0])]
    references = [make_pair(v, SR, SEED + 80 + i)[1] for i, v in enumerate(seconds[1])]
    t_batch, t_lens = batch.bucket_pad(targets, BUCKET, device="cpu")
    r_batch, r_lens = batch.bucket_pad(references, BUCKET, device="cpu")
    lengths = dict(target_lengths=t_lens, reference_lengths=r_lens)
    card = batch.master_batch(t_batch, r_batch, config, **lengths, device=device).result.cpu()
    cpu = batch.master_batch(t_batch, r_batch, mt.Config(dtype="float64", lowess_it=1, limiter=config.limiter),
                             **lengths, device="cpu").result
    staged_t, staged_r = t_batch.to(device), r_batch.to(device)
    operators = state.operators_for_config(config, device)
    t_rows, r_rows = RowInts.of(t_lens, device), RowInts.of(r_lens, device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph = stages.master_graph(staged_t, staged_r, config, interp_ops=operators,
                                    target_length=t_rows, reference_length=r_rows).result
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graph = graph.cpu()
    batch_snrs = []
    for i, length in enumerate(t_lens):
        for name, rows in (("master_batch", card), ("sync-free graph", graph)):
            require(not bool(rows[i, length:].any()), f"{name} row {i} is not 0 past its length")
            measured = snr_db(cpu[i, :length].numpy(), rows[i, :length].numpy())
            require(measured >= SNR_GATE_DB, f"{name} row {i}: {measured} dB < {SNR_GATE_DB} dB")
            batch_snrs.append(measured)
    numbers["master_batch_snr_db_f32_card_vs_f64_cpu"] = batch_snrs[0::2]
    numbers["sync_free_graph_snr_db"] = batch_snrs[1::2]
    numbers["master_batch_seconds"] = seconds.tolist()
    return k3, numbers


def distributed_worker(argv) -> None:
    """Phase 10's full-width worker, one of ``--processes`` (run by
    ``distributed_path`` as ``chip_smoke.py --distributed-worker ...``): the
    JAX package's multi-process layout on phase 7's jobs.  Per run (cold,
    warm): ``initialize``'s group is up; the process decodes and checks
    only the jobs it owns, agrees the buckets with its peers, pads,
    masters its rows with ``master_batch_distributed``, pulls them with
    ``local_results`` and writes each as PCM_16 WAV.  Writes its numbers
    to ``--report``; raises on any failure."""
    import argparse

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import matchering_tpu_torch as mt
    from matchering_tpu_torch.kernels import build
    from matchering_tpu_torch.parallel import batch, launch

    parser = argparse.ArgumentParser()
    for name in ("--process_id", "--processes", "--port"):
        parser.add_argument(name, type=int, required=True)
    parser.add_argument("--jobs", required=True)
    parser.add_argument("--report", required=True)
    args = parser.parse_args(argv)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build.library()  # phase 2 built it: loaded, not rebuilt
    launch.initialize(f"localhost:{args.port}", args.processes, args.process_id, timeout_s=600)
    try:
        config = mt.Config()
        mesh = launch.global_mesh(devices=[device])
        start, stop = launch.local_pair_slice(mesh, FARM_JOBS)
        runs = []
        for label in ("cold", "warm"):
            zero_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            begin = time.perf_counter()
            tracks = {"target": [], "reference": []}
            for i in range(start, stop):
                for role, name in (("target", f"t{i}.wav"), ("reference", f"r{i}.wav")):
                    audio, rate = mt.load(os.path.join(args.jobs, name), role, args.jobs, raw_int=True)
                    tracks[role].append(mt.check(audio, rate, config, role, device=device)[0])
            buckets = {role: launch.agree_bucket(max(len(t) for t in rows), BUCKET)
                       for role, rows in tracks.items()}
            # each role's bucket is the agreed one: pad to it as the multiple
            t_batch, t_lens = batch.bucket_pad(tracks["target"], buckets["target"], device=device)
            r_batch, r_lens = batch.bucket_pad(tracks["reference"], buckets["reference"], device=device)
            out = launch.master_batch_distributed(t_batch, r_batch, t_lens, r_lens, config, mesh)
            for row, result in launch.local_results(out):
                mt.save(os.path.join(args.jobs, f"dist_{label}_{row}.wav"), result[: t_lens[row - start]],
                        SR, "PCM_16")
            torch.cuda.synchronize()
            wall = time.perf_counter() - begin
            launches = launch_counts()
            runs.append({
                "run": label, "wall_s": wall, "pairs_per_s": (stop - start) / wall,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                "k1": launches[0], "k2": launches[1], "k3": launches[2],
                "buckets": buckets, "bucket_shapes": [list(t_batch.shape), list(r_batch.shape)],
            })
            del t_batch, r_batch, out, tracks
        report = {"process": args.process_id, "processes": args.processes, "rows": [start, stop],
                  "mesh": dict(mesh.shape), "kernels_rebuilt": build.build_seconds is not None,
                  "runs": runs}
        with open(args.report, "w") as f:
            json.dump(report, f)
    finally:
        launch.shutdown()


def distributed_path(torch, here, farm_dir, farm):
    """Phase 10: multi-process runs on the card (see the module's
    docstring).  ``farm_dir`` holds phase 7's jobs and ``process()``'s file
    for each; ``farm``, phase 7's numbers.  Returns the phase's numbers
    and the per-process (K1, K2, K3) launches of the full-width run; fails
    on any mismatch."""
    from matchering_tpu_torch.io import wav
    from matchering_tpu_torch.parallel import launch

    numbers = {}
    torch.cuda.empty_cache()  # the workers share the card with this process
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        # (a) the package's self-test, float32 on the card against the
        # single-process float64 master on the card
        selftests = []
        for label, extra in (("pairs", ["--devices_per_process", "1"]),
                             ("pairs_time", ["--devices_per_process", "2", "--time", "2"])):
            report = os.path.join(tmp, label)
            start = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "matchering_tpu_torch.parallel.launch", "selftest",
                 "--processes", "2", *extra, "--device", "cuda", "--dtype", "float32",
                 "--report_path", report, "--timeout", "300"],
                cwd=here, capture_output=True, text=True, timeout=360,
            )
            require(run.returncode == 0,
                    f"the {label} self-test exited {run.returncode}: {run.stderr.strip()[-2000:]}")
            rows = [json.load(open(f"{report}.proc{p}.json")) for p in range(2)]
            for row in rows:
                require(row["min_snr_db"] is not None and row["min_snr_db"] >= SNR_GATE_DB,
                        f"the {label} self-test's process {row['process']}: {row['min_snr_db']} dB "
                        f"< {SNR_GATE_DB} dB")
            selftests.append({"mesh": label, "command_s": time.perf_counter() - start, "processes": [
                {k: row[k] for k in ("process", "device", "devices_per_process", "time_axis", "owned_rows",
                                     "bucket_samples", "agreed_bucket", "wall_s", "min_snr_db")}
                for row in rows]})
            print(json.dumps({"selftest": selftests[-1]}), flush=True)
        numbers["selftests"] = selftests

        # (b) two processes on the JAX layout at full width, phase 7's jobs
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = launch.worker_env(2)
        reports = [os.path.join(tmp, f"worker{p}.json") for p in range(2)]
        workers = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--distributed-worker", "--process_id", str(p),
                 "--processes", "2", "--port", str(port), "--jobs", farm_dir, "--report", reports[p]],
                cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for p in range(2)
        ]
        start = time.perf_counter()
        try:
            outputs = [w.communicate(timeout=600) for w in workers]
        finally:
            for w in workers:
                if w.poll() is None:
                    w.kill()
                    w.wait()
        command_s = time.perf_counter() - start
        for p, (w, (_, err)) in enumerate(zip(workers, outputs)):
            require(w.returncode == 0, f"distributed worker {p} exited {w.returncode}: {err.strip()[-2000:]}")
        processes = [json.load(open(path)) for path in reports]
    want_buckets = {
        role: -(-int(max(np.floor(np.asarray(farm[f"{role}_seconds"]) * SR))) // BUCKET) * BUCKET
        for role in ("target", "reference")
    }
    worst = 0
    for report in processes:
        require(not report["kernels_rebuilt"], f"process {report['process']} rebuilt the kernels")
        for run in report["runs"]:
            launches = (run["k1"], run["k2"], run["k3"])
            require(launches == (1, 4, 0),
                    f"process {report['process']} ({run['run']}) launched K1, K2 and K3 {launches} times, "
                    "not (1, 4, 0)")
            require(run["buckets"] == want_buckets,
                    f"process {report['process']} agreed on buckets {run['buckets']}, not {want_buckets}")
        for row in range(*report["rows"]):
            single, _ = wav.read(os.path.join(farm_dir, f"single{row}.wav"), raw_int=True)
            for label in ("cold", "warm"):
                got, rate = wav.read(os.path.join(farm_dir, f"dist_{label}_{row}.wav"), raw_int=True)
                require(rate == SR and got.shape == single.shape,
                        f"job {row} ({label}) wrote {got.shape} at {rate} Hz, process() {single.shape}")
                diff = int(np.max(np.abs(got.astype(np.int32) - single)))
                require(diff <= 1, f"job {row} ({label}) is {diff} PCM_16 steps off process()")
                worst = max(worst, diff)
        for run in report["runs"]:
            print(f"process {report['process']} rows {report['rows']} {run['run']}: {run['wall_s']:.4f} s, "
                  f"{run['pairs_per_s']:.4f} pairs/s, peak {run['max_memory_allocated_bytes']} B, "
                  f"K1 {run['k1']}, K2 {run['k2']}, K3 {run['k3']}", flush=True)
    numbers["full_width"] = {"jobs": FARM_JOBS, "want_buckets": want_buckets, "command_s": command_s,
                             "max_pcm16_steps_vs_process": worst, "processes": processes}
    warm = [next(r for r in report["runs"] if r["run"] == "warm") for report in processes]
    return numbers, [(r["k1"], r["k2"], r["k3"]) for r in warm]


def codecs_path(mt, torch, run_process, phase4):
    """Phase 11: the codecs and the lossy libraries (see the module's
    docstring).  ``phase4``: the paths of phase 4's target, reference and
    ``process()`` output.  Returns the phase's numbers; fails on any
    mismatch."""
    from matchering_tpu_torch.io import codecs, loader, wav
    from matchering_tpu_torch.io.native import binding, mp3, opus, vorbis

    target_path, reference_path, process_out = phase4
    # the first FLAC use loads the codec, building it where it is missing
    require(binding.available(), "the native codec did not build (see the debug log)")
    numbers = {"native_build_s": binding.build_seconds, "library": binding._lib_path()}
    result, rate = codecs.read(process_out)
    require(rate == SR and result.shape == (FULL_N, 2), f"phase 4's result is {result.shape} at {rate} Hz")

    def best_s(fn, reps=3):
        times = []
        for _ in range(reps):
            begin = time.perf_counter()
            fn()
            times.append(time.perf_counter() - begin)
        return min(times)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_codecs_") as tmp:
        def at(name):
            return os.path.join(tmp, name)

        # the FLAC round trip: the same PCM codes as WAV, at 16 and 24 bits
        roundtrip = {}
        for subtype in ("PCM_16", "PCM_24"):
            codecs.write(at(f"r.{subtype}.wav"), result, SR, subtype)
            codecs.write(at(f"r.{subtype}.flac"), result, SR, subtype)
            want, _ = wav.read(at(f"r.{subtype}.wav"), raw_int=True)
            got, got_rate = codecs.read(at(f"r.{subtype}.flac"))
            scale = 2.0 ** (15 if subtype == "PCM_16" else 23)
            if subtype == "PCM_24":
                want = want >> 8  # the 24-bit codes, stored in the top of int32
            codes = np.rint(got * scale).astype(np.int64)
            require(got_rate == SR and codes.shape == want.shape and np.array_equal(codes, want),
                    f"FLAC {subtype} does not round-trip phase 4's result exactly")
            roundtrip[subtype] = {"wav_bytes": os.path.getsize(at(f"r.{subtype}.wav")),
                                  "flac_bytes": os.path.getsize(at(f"r.{subtype}.flac"))}
        numbers["flac_roundtrip_exact"] = roundtrip

        # encode and decode times on the 180 s result (host)
        numbers["times_s"] = {
            "wav_pcm16_encode_codes": best_s(lambda: mt.save(at("n.wav"), result, SR, "PCM_16")),
            "wav_pcm16_encode_numpy": best_s(lambda: wav.write(at("p.wav"), result, SR, "PCM_16")),
            "flac_pcm16_encode": best_s(lambda: binding.write_flac(at("f.flac"), result, SR, "PCM_16")),
            "flac_pcm16_decode": best_s(lambda: binding.read_flac(at("f.flac"))),
            "wav_pcm16_decode_direct": best_s(lambda: loader.load_staged(at("n.wav"), "result", device="cpu")),
            "wav_pcm16_decode_numpy": best_s(lambda: wav.read(at("p.wav"))),
        }
        require(open(at("n.wav"), "rb").read() == open(at("p.wav"), "rb").read(),
                "save's codes path and the numpy PCM_16 WAV writer disagree")
        require(np.array_equal(loader.load_staged(at("n.wav"), "result", device="cpu")[0],
                               wav.read(at("p.wav"), raw_int=True)[0]),
                "the direct PCM_16 WAV read and the numpy reader disagree")

        # process() from a FLAC target to a FLAC PCM_24 result, against WAV
        target, _ = codecs.read(target_path)
        codecs.write(at("t.flac"), target, SR, "PCM_16")
        del target
        runs, events = [], []
        run_process("wav", runs, events, target_path, reference_path, [mt.pcm24(at("o.wav"))])
        timeline = run_process("flac", runs, events, at("t.flac"), reference_path,
                               [mt.Result(at("o.flac"), "PCM_24")])
        # the FLAC target decodes to float64, the WAV reference stays int16
        transfers = traced_run(
            torch, "FLAC process()",
            lambda: mt.process(at("t.flac"), reference_path, [mt.Result(at("o.flac"), "PCM_24")],
                               device="cuda"),
            1, FULL_N * 2 * 8 + FULL_N * 2 * 2, FULL_N * 2 * 4,
        )
        from_wav, _ = codecs.read(at("o.wav"))
        from_flac, flac_rate = codecs.read(at("o.flac"))
        require(flac_rate == SR and from_flac.shape == from_wav.shape == (FULL_N, 2),
                f"the FLAC run wrote {from_flac.shape} at {flac_rate} Hz")
        steps = float(np.max(np.abs(from_flac - from_wav))) * 2.0**23
        require(steps <= 1.0, f"the FLAC run is {steps} PCM_24 steps off the WAV run")
        numbers["process_flac"] = {"runs": runs, "max_pcm24_steps_vs_wav": steps,
                                   "warm_timeline": timeline, "transfers": transfers}

        # the lossy libraries: reported, round-tripped where they load
        piece = result[: 10 * SR]
        lossy = {"vorbis": vorbis.available(), "mp3_read": mp3.available(),
                 "mp3_write": mp3.write_available(), "opus_read": opus.available(),
                 "opus_write": opus.write_available()}
        for ext, subtype, ok in (("ogg", "VORBIS", lossy["vorbis"]),
                                 ("mp3", "MPEG_LAYER_III", lossy["mp3_read"] and lossy["mp3_write"]),
                                 ("opus", "OPUS", lossy["opus_read"] and lossy["opus_write"])):
            if not ok:
                lossy[f"{ext}_roundtrip"] = "library missing"
                continue
            codecs.write(at(f"l.{ext}"), piece, SR, subtype)
            decoded, decoded_rate = codecs.read(at(f"l.{ext}"))
            require(decoded.ndim == 2 and decoded.shape[1] == 2 and bool(np.all(np.isfinite(decoded)))
                    and decoded.shape[0] >= 0.9 * 10 * decoded_rate,
                    f"{ext} decoded to {decoded.shape} at {decoded_rate} Hz")
            lossy[f"{ext}_roundtrip"] = {"rate": decoded_rate, "frames": decoded.shape[0],
                                         "bytes": os.path.getsize(at(f"l.{ext}"))}
        numbers["lossy"] = lossy
        print(f"lossy libraries: {json.dumps(lossy)}", flush=True)
    return numbers


def public_ops_path(torch, device, cuda_ms, release):
    """Phase 12: the public op library on the card (see the module's
    docstring).  ``release``: the limiter's release filter, whose pole the
    scans run at.  Returns the phase's numbers, with the K2 launches of
    each public scan; fails on any mismatch."""
    from matchering_tpu_torch.kernels import scan
    from matchering_tpu_torch.ops import convolve, iir, spectrum
    from matchering_tpu_torch.parallel import timeshard
    from matchering_tpu_torch.stages import piece_division

    pole = release.pole
    rng = np.random.RandomState(SEED + 12)
    # a drive of (1 - pole) * [0, 1) keeps every scan's output below 1
    drive = torch.from_numpy((rng.rand(FULL_N) * (1.0 - pole)).astype(np.float32)).to(device)
    drive64 = drive.double()
    twin_calls = []
    real_twin = scan.first_order_filter_plain

    def spy(*args, **kwargs):
        twin_calls.append(1)
        return real_twin(*args, **kwargs)

    def counted(label, fn, expected):
        """``fn()`` with K2's launches counted from 0; a call of the plain
        twin inside it fails the phase."""
        zero_counts()
        twin_calls.clear()
        scan.first_order_filter_plain = spy
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            scan.first_order_filter_plain = real_twin
        require(not twin_calls, f"{label} ran K2's plain twin on the card")
        k2_calls = launch_counts()[1]
        require(k2_calls == expected, f"{label} launched K2 {k2_calls} times, not {expected}")
        return out

    def twin(fn):
        """``fn()`` with K2's plain twin in the kernel's place, on the card."""
        kernel = scan.first_order_filter
        scan.first_order_filter = real_twin
        try:
            return fn()
        finally:
            scan.first_order_filter = kernel

    def abs_err(got, want):
        require(bool(torch.isfinite(got).all()), "non-finite values")
        return float((got.double() - want.double()).abs().max())

    def rel_err(got, want):
        return float(((got - want).abs() / want.abs().clamp_min(1e-300)).max())

    ops = {}

    def record(name, launches, err, tol, fn):
        require(err <= tol, f"{name}: error {err} > {tol}")
        ms = cuda_ms(fn, 10)
        ops[name] = {"k2_launches": launches, "max_err": err, "tolerance": tol, "ms": ms}
        print(f"public op {name}: {ms:.4f} ms a call (10 calls), {launches} K2 launches, "
              f"error {err:.3e} (K2 in PERF.md: {K2_PERF_MS} ms of kernel)", flush=True)

    # scan_first_order: one launch, in float32 and float64
    got = counted("scan_first_order", lambda: iir.scan_first_order(drive, pole), 1)
    want = real_twin(drive, 1.0, 0.0, -pole)
    record("scan_first_order", 1, abs_err(got, want), SCAN_TOL, lambda: iir.scan_first_order(drive, pole))
    got64 = counted("scan_first_order (float64)", lambda: iir.scan_first_order(drive64, pole), 1)
    want64 = real_twin(drive64, 1.0, 0.0, -pole)
    record("scan_first_order_f64", 1, rel_err(got64, want64), SCAN_REL_TOL_F64,
           lambda: iir.scan_first_order(drive64, pole))
    del got64

    # block_scan_summary: the same scan, and its carry map
    local, (a_total, last) = counted("block_scan_summary", lambda: iir.block_scan_summary(drive, pole), 1)
    require(float(a_total) == np.float32(pole ** FULL_N), f"block_scan_summary's pole**n is {float(a_total)}")
    require(float(last) == float(local[-1]), "block_scan_summary's carry is not the scan's last value")
    record("block_scan_summary", 1, abs_err(local, want), SCAN_TOL, lambda: iir.block_scan_summary(drive, pole))
    del local

    # filtfilt_first_order_truncated: two launches; each pass may round
    # its float32 output one ulp off the twin's, so two ulps
    smoother = iir.one_pole_filter(-2.0, 44.0)  # the limiter's attack smoother
    signal = torch.from_numpy(rng.rand(FULL_N).astype(np.float32)).to(device)
    length = FULL_N - PUBLIC_CUT
    got = counted("filtfilt_first_order_truncated",
                  lambda: iir.filtfilt_first_order_truncated(smoother, signal, length), 2)
    want_ff = twin(lambda: iir.filtfilt_first_order_truncated(smoother, signal, length))
    require(bool((got[length:] == 0).all()), "filtfilt_first_order_truncated is not 0 past its length")
    record("filtfilt_first_order_truncated", 2, abs_err(got, want_ff), 2 * SCAN_TOL,
           lambda: iir.filtfilt_first_order_truncated(smoother, signal, length))
    del signal, want_ff

    # scan_first_order_ds: hi + lo against the float64 twin
    lo = torch.from_numpy((rng.randn(FULL_N) * 1e-9).astype(np.float32)).to(device)
    hi_out, lo_out = counted("scan_first_order_ds", lambda: iir.scan_first_order_ds(drive, lo, pole), 1)
    want_ds = real_twin(drive64 + lo.double(), 1.0, 0.0, -pole)
    record("scan_first_order_ds", 1, rel_err(hi_out.double() + lo_out.double(), want_ds), SCAN_REL_TOL_F64,
           lambda: iir.scan_first_order_ds(drive, lo, pole))
    del lo, hi_out, lo_out, want_ds

    # carried_scan over four shards of the card against the whole track's scan
    grid = timeshard.TimeGrid([device] * PUBLIC_SHARDS)
    parts = grid.split(drive, FULL_N // PUBLIC_SHARDS)
    expected = 2 * len(grid.devices)
    got = counted("carried_scan", lambda: grid.join(timeshard.carried_scan(parts, pole, grid), FULL_N, device),
                  expected)
    whole = iir.scan_first_order(drive, pole)
    record("carried_scan", expected, abs_err(got, whole), SCAN_TOL,
           lambda: timeshard.carried_scan(parts, pole, grid))
    del parts, got, whole, want, drive64

    # fft_convolve_same with a 4096-tap FIR, and masked_average_spectrum_flat,
    # against the same calls on the CPU in float64
    config_fft = 4096
    x = rng.randn(FULL_N) * 0.3
    fir = rng.randn(config_fft) * np.hanning(config_fft) / 64.0
    x_card = torch.from_numpy(x.astype(np.float32)).to(device)
    fir_card = torch.from_numpy(fir.astype(np.float32)).to(device)
    got = convolve.fft_convolve_same(x_card, fir_card).cpu().numpy()
    want_conv = convolve.fft_convolve_same(torch.from_numpy(x), torch.from_numpy(fir)).numpy()
    conv_snr = snr_db(want_conv, got)
    require(conv_snr >= SNR_GATE_DB, f"fft_convolve_same at {conv_snr} dB < {SNR_GATE_DB} dB")
    ms = cuda_ms(lambda: convolve.fft_convolve_same(x_card, fir_card), 10)
    ops["fft_convolve_same"] = {"k2_launches": 0, "snr_db": conv_snr, "gate_db": SNR_GATE_DB, "ms": ms}
    print(f"public op fft_convolve_same: {ms:.4f} ms a call (10 calls), {conv_snr:.1f} dB", flush=True)
    del got, want_conv, fir_card

    divisions, piece = piece_division(FULL_N, 15 * SR)
    mask = (rng.rand(divisions) > 0.4).astype(np.float32)
    mask_card = torch.from_numpy(mask).to(device)
    got = spectrum.masked_average_spectrum_flat(x_card, mask_card, piece, divisions, config_fft)
    want_spec = spectrum.masked_average_spectrum_flat(
        torch.from_numpy(x), torch.from_numpy(mask.astype(np.float64)), piece, divisions, config_fft
    )
    err = float((got.cpu().double() - want_spec).abs().max() / want_spec.abs().max())
    require(err <= SPECTRUM_REL_TOL, f"masked_average_spectrum_flat: error {err} > {SPECTRUM_REL_TOL}")
    ms = cuda_ms(lambda: spectrum.masked_average_spectrum_flat(x_card, mask_card, piece, divisions, config_fft), 10)
    ops["masked_average_spectrum_flat"] = {"k2_launches": 0, "max_rel_err": err, "tolerance": SPECTRUM_REL_TOL,
                                           "ms": ms}
    print(f"public op masked_average_spectrum_flat: {ms:.4f} ms a call (10 calls), error {err:.3e}", flush=True)
    return {"n": FULL_N, "pole": pole, "shards": PUBLIC_SHARDS, "length": length, "ops": ops}


def entry_path(mt, torch, device):
    """Phase 13: the driver entry points of ``graft_entry_torch.py`` and
    ``bench.py``'s graph body on the card (see the module's docstring).
    Returns the phase's numbers, with the (K1, K2, K3) launches of each
    call; fails on any mismatch, and on any call of a kernel's plain
    twin."""
    import graft_entry_torch
    from matchering_tpu_torch.ops import smoothing

    def counted(label, fn):
        """``fn()`` once, warm (it ran once before, uncounted), CUDA
        synchronised: its output, its launches counted from 0 and its wall
        time; a call of a plain twin fails the phase."""
        fn()
        torch.cuda.synchronize()
        zero_counts()
        with plain_twins_forbidden(label):
            start = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        launches = launch_counts()
        require(launches[0] >= 1 and launches[1] >= 1, f"{label} launched K1, K2 and K3 {launches} times")
        print(f"entry path {label}: {wall:.4f} s warm, (K1, K2, K3) launches {launches}", flush=True)
        return out, {"wall_s": wall, "k1": launches[0], "k2": launches[1], "k3": launches[2]}

    numbers = {}
    expected = expected_launches(mt.Config())

    # entry(): the flagship forward step on its example tensors on the card,
    # against the port's float64 master_graph of the same pair on the CPU
    forward, (target, reference) = graft_entry_torch.entry()
    require(target.device.type == "cuda", f"entry()'s example tensors are on {target.device}")
    got, run = counted("entry() forward", lambda: forward(target, reference))
    require((run["k1"], run["k2"], run["k3"]) == expected,
            f"entry()'s forward launched {(run['k1'], run['k2'], run['k3'])}, not {expected}")
    want = mt.master_graph(target.cpu(), reference.cpu(), mt.Config(dtype="float64"), need_default=True).result
    measured = snr_db(want.numpy(), got.cpu().numpy())
    require(measured >= SNR_GATE_DB, f"entry()'s forward at {measured} dB < {SNR_GATE_DB} dB")
    numbers["entry"] = {"samples": list(target.shape), "snr_db_vs_cpu_f64": measured, "gate_db": SNR_GATE_DB, **run}

    # dryrun_multichip(4): master_farm twice over a (2, 2) mesh of the card
    _, run = counted("dryrun_multichip(4)", lambda: graft_entry_torch.dryrun_multichip(4))
    # two master_farm calls of 4 pairs, each pair one sharded limit() on the card
    farm_expected = tuple(2 * 4 * k for k in SHARDED_LAUNCHES)
    require((run["k1"], run["k2"], run["k3"]) == farm_expected,
            f"dryrun_multichip(4) launched {(run['k1'], run['k2'], run['k3'])}, not {farm_expected}")
    numbers["dryrun_multichip"] = {"n_devices": 4, "mesh": [2, 2], **run}

    # bench.py's graph body with the import swapped, on its first 180 s pair:
    # the staged operators passed in give the result of interp_ops=None bit for bit
    config = mt.Config()
    interp_ops = smoothing.operator_arrays_for_config(config)
    t_pair, r_pair = (torch.from_numpy(x).to(device) for x in make_pair(FULL_SECONDS, SR, 42))
    scale = torch.tensor(1.0, device=device)

    def graph(ops):
        return mt.master_graph(
            t_pair * (1.0 + 1e-7 * scale), r_pair, config, need_default=True, interp_ops=ops,
        ).result

    with_ops, run = counted("bench graph (interp_ops passed)", lambda: graph(interp_ops))
    require((run["k1"], run["k2"], run["k3"]) == expected,
            f"bench's graph launched {(run['k1'], run['k2'], run['k3'])}, not {expected}")
    without, run_none = counted("bench graph (interp_ops=None)", lambda: graph(None))
    require(bool(torch.isfinite(with_ops).all()), "bench's graph gave non-finite values")
    require(bool(torch.equal(with_ops, without)), "bench's graph differs between interp_ops passed and None")
    checksum = float(torch.sum(torch.abs(with_ops)))
    numbers["bench_graph"] = {"seconds": FULL_SECONDS, "checksum": checksum, "equal_to_interp_ops_none": True,
                              "interp_ops_passed": run, "interp_ops_none": run_none}
    return numbers


def host_available_bytes() -> int:
    """The host memory the kernel reports as available (0 where unknown)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def drivers_path(mt, torch, device, bench_checksum):
    """Phase 14: the measurement drivers ``bench_torch.py`` and
    ``tools_record_bench_torch.py`` in this process, on the card (see the
    module's docstring).  ``bench_checksum``: phase 13's checksum of
    bench's graph on its first pair.  Returns the phase's numbers, with
    the (K1, K2, K3) launches of each run; fails on any mismatch, and on
    any call of a kernel's plain twin."""
    import traceback

    import bench_torch
    import tools_record_bench_torch as record

    per_graph = expected_launches(mt.Config())  # one graph, one limit(), one master_batch call

    def times(count):
        return tuple(count * k for k in per_graph)

    def peak_gb():
        return torch.cuda.max_memory_allocated(device) / 1e9

    numbers = {}
    phase_start = time.perf_counter()
    with plain_twins_forbidden("phase 14"):
        # bench_torch at its defaults: 16 pairs of 180 s, staged once
        start = time.perf_counter()
        host_pairs = bench_torch.make_pairs(bench_torch.B, bench_torch.SECONDS)
        build_s = time.perf_counter() - start
        start = time.perf_counter()
        driver = bench_torch.Bench(host_pairs, bench_torch.SECONDS, device=device)
        staging_s = time.perf_counter() - start
        zero_counts()
        throughput, rows = bench_torch.measure(driver, bench_torch.REPS)
        run_launches = launch_counts()
        graphs = (2 + 2 * bench_torch.REPS) * bench_torch.B + bench_torch.REPS
        require(run_launches == times(graphs),
                f"bench_torch's run launched {run_launches}, not {times(graphs)} ({graphs} graphs)")
        zero_counts()
        driver.run(7)
        round_launches = launch_counts()
        require(round_launches == times(bench_torch.B),
                f"one bench_torch round launched {round_launches}, not {times(bench_torch.B)}")
        checksum = driver.single(1)
        require(checksum == bench_checksum,
                f"bench's graph on pair 0 at s = 1 gave {checksum!r}, phase 13 {bench_checksum!r}")

        # one round enqueued under the sync debug mode: a host sync raises
        scale = driver.scale(9)
        torch.cuda.synchronize()
        sync = {"passed": True}
        torch.cuda.set_sync_debug_mode("error")
        try:
            total = torch.stack(driver.enqueue(scale)).sum()
        except RuntimeError as error:
            frames = [f for f in traceback.extract_tb(error.__traceback__) if "matchering_tpu" in f.filename]
            frame = frames[-1] if frames else traceback.extract_tb(error.__traceback__)[-1]
            sync = {"passed": False, "error": str(error).strip().splitlines()[0],
                    "where": f"{os.path.relpath(frame.filename)}:{frame.lineno}: {frame.line}"}
            total = None
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if total is not None:
            value = total.item()
            require(np.isfinite(value) and value > 0, f"the round under the sync debug mode gave {value}")
        print(f"drivers path: one bench round under the sync debug mode: {sync}", flush=True)

        # the device's busy share of one profiled round
        round_ms, ops = profile_device(torch, lambda: driver.run(11))
        round_device_ms = sum(o["device_ms"] for o in ops)
        numbers["bench_torch"] = {
            "line": bench_torch.result_line(throughput, bench_torch.B),
            "rows": rows,
            "host_build_s": build_s,
            "staging_s": staging_s,
            "launches_run": list(run_launches),
            "launches_round": list(round_launches),
            "pair0_checksum_s1": checksum,
            "equal_to_phase13": True,
            "sync_debug_mode": sync,
            "profiled_round": {"wall_ms": round_ms, "device_ms": round_device_ms,
                               "device_busy_share": round_device_ms / round_ms, "top_ops": top(ops, 8, 60)},
        }
        print(f"drivers path: bench_torch {throughput:.1f} audio-sec/s, rows "
              f"{json.dumps({k: v for k, v in rows.items() if k != 'workload'})}", flush=True)
        pair = host_pairs[0]  # seed 42: the record driver's pair
        del driver, host_pairs, scale, total
        torch.cuda.empty_cache()

        # tools_record_bench_torch at its defaults, on bench's seed-42 pair
        config = mt.Config()
        record_numbers = {}
        for name, fn, calls in (
            ("single", lambda: record.bench_single(config, device=device, pair=pair), record.VARIANTS),
            ("stages", lambda: record.bench_stages(config, device=device, pair=pair), 1 + record.STAGE_RUNS),
            ("batch_sweep", lambda: record.bench_batch_sweep(config, sizes=record.SWEEP_SIZES, device=device,
                                                             pair=pair),
             len(record.SWEEP_SIZES) * record.VARIANTS),
        ):
            torch.cuda.reset_peak_memory_stats(device)
            zero_counts()
            start = time.perf_counter()
            result = fn()
            launches = launch_counts()
            require(launches == times(calls), f"record {name} launched {launches}, not {times(calls)}")
            record_numbers[name] = {"result": result, "launches": list(launches), "calls": calls,
                                    "seconds": time.perf_counter() - start, "peak_device_gb": peak_gb()}
            print(f"drivers path: record {name}: {json.dumps(result)}", flush=True)
        for size, row in record_numbers["batch_sweep"]["result"].items():
            require(np.isfinite(row["checksum"]) and row["checksum"] > 0, f"the sweep's B={size} checksum is {row}")
        del pair
        torch.cuda.empty_cache()

        available = host_available_bytes()
        if available >= record.LONGFORM_HOST_BYTES:
            zero_counts()
            start = time.perf_counter()
            longform = record.bench_longform(device=device)
            launches = launch_counts()
            require(launches == times(4), f"the long form launched {launches}, not {times(4)}")
            block = longform["int16_staging"]
            require(block["bit_identical"] and block["results_equal"],
                    f"the long form's int16 and float32 masters differ: {block}")
            record_numbers["longform"] = {"result": longform, "launches": list(launches),
                                          "seconds": time.perf_counter() - start}
            print(f"drivers path: record longform: {json.dumps(longform)}", flush=True)
        else:
            record_numbers["longform"] = {"skipped": f"{available} bytes of host memory available, "
                                                     f"{record.LONGFORM_HOST_BYTES} needed"}
        torch.cuda.empty_cache()
    numbers["tools_record_bench_torch"] = record_numbers
    numbers["seconds"] = time.perf_counter() - phase_start
    return numbers


def jax_forms_path(mt, torch, device, cuda_ms, card):
    """Phase 15: the JAX package's per-track length forms on the card, at
    full width (see the module's docstring).  ``card``: the card's name
    and power limit from ``nvidia-smi``, stamped on the times.  Returns the
    phase's numbers; fails on any mismatch, and on any call of a kernel's
    plain twin."""
    from matchering_tpu_torch.utils import RowInts

    config = mt.Config()
    expected = expected_launches(config)
    target, reference = make_pair(FULL_SECONDS, SR, SEED)  # phase 4's pair, before its PCM_16 encode
    n_pad = -(-FULL_N // BUCKET) * BUCKET
    t_pad = torch.zeros((n_pad, 2), dtype=torch.float32, device=device)
    t_pad[:FULL_N] = torch.from_numpy(target).to(device)
    r_card = torch.from_numpy(reference).to(device)
    # each form's lengths, staged before any timed call
    forms = {
        "rowints": (RowInts.of([FULL_N], device), RowInts.of([FULL_N], device)),
        "int": (FULL_N, FULL_N),
        "0-d": (torch.tensor(FULL_N, device=device), torch.tensor(FULL_N, device=device)),
    }
    reads_expected = {"rowints": 0, "int": 0, "0-d": 2}

    def counted(label, fn, reads):
        """``fn()`` once with its launches and host reads counted from 0 and
        its host-device copies traced (``transfer_bytes``), under
        ``plain_twins_forbidden``: (output, numbers)."""
        zero_counts()
        with plain_twins_forbidden(f"phase 15 {label}"):
            out = fn()
            torch.cuda.synchronize()
            launches = launch_counts()
            host_reads = count_since("host_reads")
            copies = transfer_bytes(torch, fn)
        require(launches == expected, f"{label} launched (K1, K2, K3) {launches}, not {expected}")
        require(host_reads == reads, f"{label} read {host_reads} lengths back from the card, not {reads}")
        require(copies["d2h_copies"] == reads,
                f"{label} copied {copies['d2h_copies']} times from the card, not {reads}")
        numbers = {"k1": launches[0], "k2": launches[1], "k3": launches[2], "host_reads": host_reads,
                   "d2h_copies": copies["d2h_copies"], "h2d_copies": copies["h2d_copies"],
                   "h2d_bytes": copies["h2d_bytes"]}
        print(f"phase 15 {label}: (K1, K2, K3) launches {launches}, host reads {host_reads}, "
              f"copies to the card {copies['h2d_copies']} ({copies['h2d_bytes']} B), "
              f"from it {copies['d2h_copies']}", flush=True)
        return out, numbers

    def in_turns(name, calls):
        """Each form's time over 10 calls (CUDA events), in turns: the
        forms in order, then in reverse."""
        order = list(calls) + list(reversed(calls))
        for form in order:
            numbers[name][form].setdefault("ms", []).append(cuda_ms(calls[form], 10))

    numbers = {"card": card, "samples": FULL_N, "padded": n_pad, "master_graph": {}, "limit": {}}
    outputs, graphs = {}, {}
    for form, (t_len, r_len) in forms.items():
        def graph(t_len=t_len, r_len=r_len):
            return mt.master_graph(t_pad, r_card, config, need_default=True, need_no_limiter=True,
                                   target_length=t_len, reference_length=r_len)

        outputs[form], numbers["master_graph"][form] = counted(
            f"master_graph {form} lengths", graph, reads_expected[form])
        graphs[form] = graph
    in_turns("master_graph", graphs)
    for form in ("int", "0-d"):
        for key in ("result", "result_no_limiter"):
            require(bool(torch.equal(getattr(outputs[form], key), getattr(outputs["rowints"], key))),
                    f"master_graph's {key} with {form} lengths differs from the RowInts form")
    result = outputs["rowints"].result
    require(bool(torch.isfinite(result).all()), "master_graph's padded result holds non-finite values")
    require(not bool(result[FULL_N:].any()), "master_graph's padded result is not 0 past the target's length")
    unpadded = mt.master(target, reference, config, device=device).result
    measured = card_snr_db(torch, unpadded, result[:FULL_N])
    require(measured > 100.0, f"the padded master_graph is {measured} dB from master() on the unpadded pair")
    numbers["master_graph"]["snr_db_vs_unpadded_master"] = measured
    numbers["master_graph"]["gate_db"] = 100.0
    # limit() on the padded 180 s limiter input: the master's unlimited result
    track = outputs["rowints"].result_no_limiter
    del unpadded, outputs, result

    limited, calls = {}, {}
    for form, length in (("rowints", forms["rowints"][0]), ("int", FULL_N), ("0-d", forms["0-d"][0])):
        if form == "rowints":
            def call(length=length):
                return mt.limit(track[None], config, length=length)[0]
        else:
            def call(length=length):
                return mt.limit(track, config, length=length)

        limited[form], numbers["limit"][form] = counted(
            f"limit {form} length", call, 1 if form == "0-d" else 0)
        calls[form] = call
    in_turns("limit", calls)
    for form in ("int", "0-d"):
        require(bool(torch.equal(limited[form], limited["rowints"])),
                f"limit() with an {form} length differs from the one-row batch")
    require(bool(torch.isfinite(limited["int"]).all()), "limit() gave non-finite values")
    require(not bool(limited["int"][FULL_N:].any()), "limit() is not 0 past the length")
    numbers["limit"]["peak"] = float(torch.max(torch.abs(limited["int"])))
    print(f"phase 15 times on {card} (in turns, then reversed): " + ", ".join(
        f"{name} {form} " + " / ".join(f"{ms:.3f}" for ms in run["ms"]) + " ms"
        for name in ("master_graph", "limit") for form, run in numbers[name].items() if isinstance(run, dict)
    ), flush=True)
    return numbers


# phase 16: Config() and the two configs whose folded LOWESS keeps every
# grid point as an anchor (the JAX package smooths twice there), and orders
# 2/2 with lowess_it=1 (K3, the device LOWESS)
WALK_CONFIGS = {
    "default": {},
    "lowess_delta=1e-4": {"lowess_delta": 1e-4},
    "fft_size=2048,lin_log_oversampling=1": {"fft_size": 2048, "lin_log_oversampling": 1},
    "orders 2/2,lowess_it=1": {"lowess_it": 1, "limiter": {"hold_filter_order": 2, "release_filter_order": 2}},
}
BENCH_CHECKSUM_RECORDED = 3975024.0  # phase 13's bench checksum on the H100 (PERF.md §6)


def walk_config(mt, kwargs, dtype="float32"):
    """The ``Config`` of a ``WALK_CONFIGS`` entry in ``dtype``."""
    kwargs = dict(kwargs)
    limiter = mt.LimiterConfig(**kwargs.pop("limiter", {}))
    return mt.Config(dtype=dtype, limiter=limiter, **kwargs)


def config_walk_path(mt, torch, device, cuda_ms, card, bench_checksum):
    """Phase 16: every smoothing form on the configs of ``WALK_CONFIGS`` at
    full width (see the module's docstring).  ``card``: the card's name
    and power limit from ``nvidia-smi``, stamped on the times;
    ``bench_checksum``: phase 13's.  Returns the phase's numbers; fails on
    any mismatch, and on any call of a kernel's plain twin."""
    from matchering_tpu_torch import state
    from matchering_tpu_torch.ops import smoothing

    start = time.perf_counter()
    target, reference = make_pair(FULL_SECONDS, SR, SEED)  # phase 4's pair, before its PCM_16 encode
    t_card, r_card = (torch.from_numpy(x).to(device) for x in (target, reference))
    excerpt = SNR_SECONDS * SR
    numbers = {"card": card, "samples": FULL_N, "snr_samples": excerpt, "gate_db": SNR_GATE_DB, "configs": {}}
    for name, kwargs in WALK_CONFIGS.items():
        config = walk_config(mt, kwargs)
        expected = expected_launches(config)
        smoothing_state = state.operators_for_config(config, device)
        pair = smoothing.operator_arrays_for_config(config)

        def graph(interp_ops, t=t_card, r=r_card, config=config):
            return mt.master_graph(t, r, config, need_default=True, interp_ops=interp_ops).result

        forms = {
            "master()": lambda config=config: mt.master(t_card, r_card, config, device=device).result,
            "interp_ops=None": lambda: graph(None),
            "interp_ops=Smoothing": lambda ops=smoothing_state: graph(ops),
            # bench's call form (bench_torch.py's Bench.graph)
            "interp_ops=pair": lambda ops=pair: graph(ops),
        }
        for fn in forms.values():
            fn()  # warm: the operators of a new config are built and staged here
        torch.cuda.synchronize()
        outputs, runs = {}, {}
        for form, fn in forms.items():
            zero_counts()
            moved = {"h2d_bytes": 0, "h2d_copies": 0, "d2h_bytes": 0, "d2h_copies": 0}
            with plain_twins_forbidden(f"phase 16 {name} {form}"):
                with copy_counter(torch, moved):
                    outputs[form] = fn()
                torch.cuda.synchronize()
            launches, host_reads = launch_counts(), count_since("host_reads")
            require(launches == expected, f"phase 16 {name} {form} launched (K1, K2, K3) {launches}, not {expected}")
            require(host_reads == 0 and moved["d2h_copies"] == 0,
                    f"phase 16 {name} {form} read the card back: {host_reads} host reads, {moved}")
            runs[form] = {"k1": launches[0], "k2": launches[1], "k3": launches[2], "host_reads": host_reads,
                          "d2h_copies": moved["d2h_copies"], "h2d_copies": moved["h2d_copies"], "ms": []}
        first = outputs["master()"]
        require(bool(torch.isfinite(first).all()), f"phase 16 {name}: non-finite values")
        # K2's look-back may round its carries differently from run to run
        diffs = {form: float((out - first).abs().max()) for form, out in outputs.items()}
        require(max(diffs.values()) <= SCAN_TOL, f"phase 16 {name}: the forms differ from master() by {diffs}")
        del outputs, first
        order = list(forms) + list(reversed(forms))
        for form in order:
            runs[form]["ms"].append(cuda_ms(forms[form], 10))
        # the card's float32 pair form against the CPU's float64 master, on an excerpt
        card_out = mt.master_graph(t_card[:excerpt], r_card[:excerpt], config, need_default=True,
                                   interp_ops=pair).result.cpu().numpy()
        cpu_out = mt.master(target[:excerpt], reference[:excerpt], walk_config(mt, kwargs, "float64"),
                            device="cpu").result.numpy()
        measured = snr_db(cpu_out, card_out)
        require(measured >= SNR_GATE_DB, f"phase 16 {name}: card float32 at {measured} dB < {SNR_GATE_DB} dB")
        numbers["configs"][name] = {"expected_launches": list(expected), "forms": runs,
                                    "max_abs_diff_vs_master": diffs, "snr_db_vs_cpu_f64": measured}
        print(f"phase 16 {name}: forms vs master() max abs diff {diffs}, {measured:.2f} dB vs CPU f64, "
              f"launches {expected}, on {card}: " + ", ".join(
                  f"{form} " + " / ".join(f"{ms:.3f}" for ms in run["ms"]) + " ms" for form, run in runs.items()),
              flush=True)
    # bench's graph at Config() on its pair 0, as phase 13 ran it: the same bits
    config = mt.Config()
    t_pair, r_pair = (torch.from_numpy(x).to(device) for x in make_pair(FULL_SECONDS, SR, 42))
    scale = torch.tensor(1.0, device=device)
    result = mt.master_graph(t_pair * (1.0 + 1e-7 * scale), r_pair, config, need_default=True,
                             interp_ops=smoothing.operator_arrays_for_config(config)).result
    checksum = float(torch.sum(torch.abs(result)))
    require(checksum == bench_checksum, f"phase 16: bench's checksum {checksum!r}, phase 13 {bench_checksum!r}")
    numbers["bench_checksum"] = checksum
    numbers["bench_checksum_equals_recorded"] = checksum == BENCH_CHECKSUM_RECORDED
    numbers["seconds"] = time.perf_counter() - start
    print(f"phase 16: bench's checksum {checksum!r} (recorded {BENCH_CHECKSUM_RECORDED!r}), "
          f"{numbers['seconds']:.2f} s", flush=True)
    return numbers


# phase 17: the input walk's result-bearing classes (tests/test_torch_input_walk.py) at full width
WALK_CALLS = 3  # warm process() calls timed per class, after one untimed
WALK_FARM_SECONDS = (180, 150)  # the mixed farm batch: the mono target and a shorter DC-offset target
WALK_ALGEBRA_RTOL_F32 = 1e-6  # R = -L: each RMS-correction step against reference_match_rms / min_value


def walk_pair(seconds, sr, seed):
    """The input walk's pair (``tests/test_torch_input_walk.py``'s
    ``_base``) at ``seconds`` and ``sr``: a target of 1/f-like noise, its
    channels distinct, and bench.py's square-wave reference with noise,
    under bench.py's slow envelope."""
    from scipy import signal

    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = (0.6 + 0.4 * np.sin(2 * np.pi * t * 0.25) ** 2)[:, None]
    target = 0.02 * signal.lfilter([1.0], [1.0, -0.97], rng.randn(n, 2), axis=0) * env
    square = 0.7 * np.sign(np.sin(2 * np.pi * 110 * t))[:, None]
    reference = (square + 0.05 * rng.randn(n, 2)) * env
    return target, reference


def walk_classes(seconds):
    """The walk's result-bearing classes that phase 17 runs, at
    ``seconds``: name -> ((target array, rate, extension, subtype),
    (reference ...)), from one seed."""
    target, reference = walk_pair(seconds, SR, SEED + 17)
    reference_48k = walk_pair(seconds, USER_RATE, SEED + 18)[1]
    noise = 1e-4 * np.random.RandomState(SEED + 19).randn(*target.shape)  # -80 dBFS

    def wav16(x):
        return (x, SR, "wav", "PCM_16")

    return {
        "mono target": (wav16(target[:, :1]), wav16(reference)),
        "one silent channel target": (wav16(target * [1.0, 0.0]), wav16(reference)),
        "R = -L target": (wav16(np.stack([target[:, 0], -target[:, 0]], axis=1)), wav16(reference)),
        "DC offset target": (wav16(target + 0.4), wav16(reference)),
        "-80 dBFS noise target": ((noise, SR, "wav", "PCM_24"), wav16(reference)),
        "PCM_24 WAV target": ((target, SR, "wav", "PCM_24"), wav16(reference)),
        "FLAC target": ((target, SR, "flac", "PCM_24"), wav16(reference)),
        "float over full scale target": ((4.0 * target, SR, "wav", "FLOAT"), wav16(reference)),
        "mono reference": (wav16(target), wav16(reference[:, :1])),
        "48 kHz PCM_24 reference": (wav16(target), (reference_48k, USER_RATE, "wav", "PCM_24")),
    }


def input_walk_path(mt, torch, device, card):
    """Phase 17: the input walk on the card (see the module's docstring).
    ``card``: the card's name and power limit from ``nvidia-smi``, stamped
    on the times.  Returns the phase's numbers; fails on any mismatch, and
    on any call of a kernel's plain twin on the card."""
    from matchering_tpu_torch.io import codecs

    start = time.perf_counter()
    config = mt.Config()
    expected = expected_launches(config)
    folder = tempfile.TemporaryDirectory(prefix="chip_smoke_walk_")

    def at(name):
        return os.path.join(folder.name, name)

    def write(spec, path):
        array, rate, ext, subtype = spec
        path = f"{path}.{ext}"
        codecs.write(path, array, rate, subtype)
        return path

    def pcm16_codes(path):
        audio, rate = codecs.read(path, raw_int=True)
        require(rate == SR and audio.dtype == np.int16, f"{path} is {audio.dtype} at {rate} Hz")
        return audio

    def lsb_apart(a, b):
        require(a.shape == b.shape, f"the files hold {a.shape} and {b.shape} samples")
        return int(np.max(np.abs(a.astype(np.int32) - b.astype(np.int32))))

    def processed(label, paths, out, on_card=True):
        """One ``process()`` call: the info and warning codes it logged and
        its wall time; on the card with its launches counted from 0, none of
        a plain twin, and the equality check on the card."""
        codes = []

        def record(message):
            codes.append(int(str(message).split(":")[0]))

        mt.log(info_handler=record, warning_handler=record, show_codes=True)
        zero_counts()
        EQUALITY_INPUTS.clear()
        try:
            if on_card:
                with plain_twins_forbidden(f"phase 17 {label}"):
                    torch.cuda.synchronize()
                    begin = time.perf_counter()
                    mt.process(*paths, [mt.pcm16(out)], config, device=device)
                    torch.cuda.synchronize()
            else:
                begin = time.perf_counter()
                mt.process(*paths, [mt.pcm16(out)], config, device="cpu")
        finally:
            mt.log()
        wall = time.perf_counter() - begin
        if on_card:
            launches = launch_counts()
            require(launches == expected, f"phase 17 {label} launched (K1, K2, K3) {launches}, not {expected}")
            require_equality_on_card(f"phase 17 {label}", 1)
        return codes, wall

    def staged(paths, where):
        """The pair as ``process()`` hands it to the graph, on ``where``."""
        mt.log()
        return [mt.check(*mt.load(path, role, raw_int=True), config, role, device=where)[0]
                for path, role in zip(paths, ("target", "reference"))]

    numbers = {"card": card, "seconds": FULL_SECONDS, "excerpt_seconds": SNR_SECONDS, "gate_db": SNR_GATE_DB,
               "expected_launches": list(expected), "classes": {}}
    full = walk_classes(FULL_SECONDS)
    excerpt = {name: [(array[:SNR_SECONDS * rate], rate, ext, subtype) for array, rate, ext, subtype in specs]
               for name, specs in full.items()}
    card_files = {}
    for index, (name, specs) in enumerate(full.items()):
        row = {}
        paths = [write(spec, at(f"c{index}_{role}")) for spec, role in zip(specs, ("t", "r"))]
        out = at(f"c{index}_card.wav")
        processed(f"{name} (untimed)", paths, out)
        walls = []
        for call in range(WALK_CALLS):
            codes, wall = processed(f"{name} call {call + 1}", paths, out)
            walls.append(wall)
        cpu_codes, cpu_wall = processed(f"{name} on the CPU", paths, at(f"c{index}_cpu.wav"), on_card=False)
        require(codes == cpu_codes, f"phase 17 {name}: the card's events {codes}, the CPU's {cpu_codes}")
        result = pcm16_codes(out)
        require(result.shape == (FULL_N, 2), f"phase 17 {name}: the card wrote {result.shape} samples")
        card_files[name] = (paths, out)
        mono_target = specs[0][0].shape[1] == 1
        row.update(codes=codes, k1_k2_k3_per_call=list(expected), walls_s=walls, cpu_wall_s=cpu_wall)
        if mono_target:  # doubled by the checker: the side is exactly 0
            side = np.abs(result[:, 0].astype(np.int32) - result[:, 1].astype(np.int32)) / 2 / 32768
            row["side_peak"] = float(side.max())
            require(row["side_peak"] == 0.0, f"phase 17 {name}: the card's side peaks at {row['side_peak']}")

        # the 30 s excerpt: the card's file against the CPU's float64 master exported at PCM_16
        short = [write(spec, at(f"e{index}_{role}")) for spec, role in zip(excerpt[name], ("t", "r"))]
        short_out = at(f"e{index}_card.wav")
        processed(f"{name} excerpt", short, short_out)
        cpu64 = mt.master(*staged(short, "cpu"), mt.Config(dtype="float64"), device="cpu")
        with plain_twins_forbidden(f"phase 17 {name} excerpt master"):
            card32 = mt.master(*staged(short, device), config, device=device)
        if name == "R = -L target":
            # the reference's algebra where the mid is exactly 0
            for label, report, rtol in (("card float32", card32.report, WALK_ALGEBRA_RTOL_F32),
                                        ("CPU float64", cpu64.report, 1e-12)):
                want = float(report["reference_match_rms"]) / config.min_value
                steps = [float(report[f"rms_correction_{k + 1}"]) for k in range(config.rms_correction_steps)]
                require(all(abs(step - want) <= rtol * want for step in steps),
                        f"phase 17 {name}: {label} steps {steps}, not {want}")
                row[f"rms_steps_{label.replace(' ', '_')}"] = steps
            row["algebra_value"] = float(cpu64.report["reference_match_rms"]) / config.min_value
        else:
            measured = snr_db(cpu64.result.numpy(), card32.result.cpu().double().numpy())
            require(measured >= SNR_GATE_DB, f"phase 17 {name}: card float32 at {measured} dB < {SNR_GATE_DB} dB")
            export = at(f"e{index}_cpu64.wav")
            codecs.write(export, cpu64.result.numpy(), SR, "PCM_16")
            lsb = lsb_apart(pcm16_codes(short_out), pcm16_codes(export))
            require(lsb <= 1, f"phase 17 {name}: the card's file is {lsb} steps from the CPU's float64 master")
            row.update(snr_db_vs_cpu_f64=measured, lsb_vs_cpu_f64=lsb)
        if mono_target:
            require(bool(torch.equal(card32.result[:, 0], card32.result[:, 1])),
                    f"phase 17 {name}: the card's float32 master has a side")
        del cpu64, card32
        numbers["classes"][name] = row
        print(f"phase 17 {name}: events equal the CPU's ({len(codes)} codes), (K1, K2, K3) {expected} a call, "
              f"warm walls " + " / ".join(f"{w:.4f}" for w in walls) + f" s (CPU {cpu_wall:.2f} s), "
              + (f"{row['snr_db_vs_cpu_f64']:.2f} dB and {row['lsb_vs_cpu_f64']} LSB vs the CPU's float64 master"
                 if "snr_db_vs_cpu_f64" in row else f"RMS steps at {row['algebra_value']:.2f} (the algebra)")
              + (f", side peak {row['side_peak']}" if mono_target else "") + f", on {card}", flush=True)

    # the farm: the mono target beside a shorter DC-offset target, both dispatches
    target = walk_pair(WALK_FARM_SECONDS[1], SR, SEED + 17)[0]
    dc_paths = [write((target + 0.4, SR, "wav", "PCM_16"), at("farm_t")), card_files["mono target"][0][1]]
    dc_out = at("farm_dc_card.wav")
    processed("farm job 1 alone", dc_paths, dc_out)
    jobs = [(card_files["mono target"][0], card_files["mono target"][1]), (dc_paths, dc_out)]
    numbers["farm"] = {"target_seconds": list(WALK_FARM_SECONDS)}
    for dispatch, launches_expected in (("pipelined", (2, 8, 0)), ("vmapped", (1, 4, 0))):
        outs = [at(f"farm_{dispatch}_{i}.wav") for i in range(len(jobs))]
        zero_counts()
        EQUALITY_INPUTS.clear()
        with plain_twins_forbidden(f"phase 17 farm {dispatch}"):
            torch.cuda.synchronize()
            begin = time.perf_counter()
            mt.process_batch([mt.PairJob(*paths, [mt.pcm16(o)]) for (paths, _), o in zip(jobs, outs)], config,
                             dispatch=dispatch, device=device)
            torch.cuda.synchronize()
        wall = time.perf_counter() - begin
        launches = launch_counts()
        require(launches == launches_expected,
                f"phase 17 farm {dispatch} launched (K1, K2, K3) {launches}, not {launches_expected}")
        require_equality_on_card(f"phase 17 farm {dispatch}", len(jobs))
        lsbs = [lsb_apart(pcm16_codes(o), pcm16_codes(single)) for o, (_, single) in zip(outs, jobs)]
        require(max(lsbs) <= 1, f"phase 17 farm {dispatch}: rows {lsbs} steps from their process() files")
        mono = pcm16_codes(outs[0])
        require(bool(np.array_equal(mono[:, 0], mono[:, 1])), f"phase 17 farm {dispatch}: the mono row has a side")
        numbers["farm"][dispatch] = {"wall_s": wall, "k1": launches[0], "k2": launches[1], "k3": launches[2],
                                     "lsb_vs_process": lsbs}
        print(f"phase 17 farm {dispatch}: {wall:.4f} s, (K1, K2, K3) {launches}, rows {lsbs} LSB from "
              f"process(), on {card}", flush=True)
    folder.cleanup()
    numbers["seconds"] = time.perf_counter() - start
    print(f"phase 17: {numbers['seconds']:.2f} s on {card}", flush=True)
    return numbers



# phase 18: a song pair of the benchmark's lengths, and the cost of recording spans
TRACE_SECONDS = (240, 300)  # the target's and the reference's
TRACE_RUNS = 3  # runs of each arm, in turns
TRACE_CALLS = 5  # calls a run; its median is the run's
SYNC_WARNING = "called a synchronizing CUDA operation"
REUSE_SECONDS = 235  # a second track of the target's page-locked size class (64 MiB for 240 s)
REUSE_SLEEP_CYCLES = 2_000_000_000  # about a second of the card's clock ahead of the first copy


def staging_reuse(mt, torch, device, paths):
    """The hazard of reading a file straight into a page-locked block: two
    tracks (``paths``, two PCM_16 WAVs of one size class) go through the
    port's ingest back to back, with no sync between them, behind a second
    of work on the card, so the first track's copy is still queued when the
    second's block is handed out and filled.  The host allocator's cache
    is emptied first where torch can, so the first block is the only one of
    its size class.  The caching host allocator must not hand out the first
    block before that copy has run: the second block must be another, and
    once the card has run each device tensor must equal its file's codes;
    each block must be page-locked.  Returns the phase's numbers."""
    from matchering_tpu_torch import core
    from matchering_tpu_torch.io import loader, wav

    blocks = []
    allocate = loader.staging_block

    def watched(shape, dtype, on):
        block = allocate(shape, dtype, on)
        blocks.append((block.is_pinned(), block.data_ptr(), tuple(block.shape)))
        return block

    loader.staging_block = watched
    try:
        torch.cuda.synchronize()
        empty = getattr(torch._C, "_host_emptyCache", None) or getattr(torch._C, "_accelerator_emptyHostCache", None)
        if empty is not None:
            empty()
        torch.cuda._sleep(REUSE_SLEEP_CYCLES)
        staged = [core._ingest(path, "reference", mt.Config(), os.path.dirname(path), device)[0] for path in paths]
        queued = torch.cuda.current_stream(device).query() is False
        torch.cuda.synchronize()
    finally:
        loader.staging_block = allocate
    require(len(blocks) == 2 and all(pinned for pinned, _, _ in blocks) and blocks[0][1] != blocks[1][1] and queued,
            f"phase 18: the ingest staged from {blocks} (page-locked, address, shape); the card "
            f"{'was' if queued else 'was not'} still busy after the second ingest")
    for path, tensor in zip(paths, staged):
        codes = torch.from_numpy(np.ascontiguousarray(wav.read(path, raw_int=True)[0]))
        require(torch.equal(tensor.cpu(), codes.repeat(1, 2) if codes.shape[1] == 1 else codes),
                f"phase 18: the track staged from {os.path.basename(path)} differs from its file's codes")
    return {"blocks": [{"pinned": p, "shape": list(shape)} for p, _, shape in blocks],
            "host_cache_emptied": empty is not None, "queued_at_second_ingest": queued}


def direct_write(torch, device, tmp):
    """A 240 s float32 result on the card (``make_pair``'s target at 1.1
    times its level, so some samples clip) written by ``io.saver.save`` at
    each subtype the card quantises: each file must be the numpy writer's
    for the same samples fetched as float32 (``wav.write``, which widens
    them to float64), and its payload must count in
    ``direct_out_bytes``.  Times each way once warm (host clock, ms).
    Returns the phase's numbers."""
    from matchering_tpu_torch import trace
    from matchering_tpu_torch.io import pcm, saver, wav

    samples = 1.1 * make_pair(TRACE_SECONDS[0], SR, SEED + 23)[0]
    result = torch.from_numpy(samples.astype(np.float32)).to(device)
    host = result.cpu().numpy()
    numbers = {"frames": int(result.shape[0])}
    for subtype in saver.DIRECT_SUBTYPES:
        got, want = os.path.join(tmp, "direct.wav"), os.path.join(tmp, "numpy.wav")
        ms = {"direct": [], "numpy": []}
        for _ in range(2):
            before = trace.counts().get("direct_out_bytes", 0)
            begin = time.perf_counter()
            saver.save(got, result, SR, subtype)
            ms["direct"].append(1e3 * (time.perf_counter() - begin))
            written = trace.counts().get("direct_out_bytes", 0) - before
            begin = time.perf_counter()
            wav.write(want, host, SR, subtype)
            ms["numpy"].append(1e3 * (time.perf_counter() - begin))
        payload = result.numel() * pcm.SUBTYPES[subtype]
        with open(got, "rb") as f, open(want, "rb") as g:
            same = f.read() == g.read()
        require(same, f"phase 18: the card's {subtype} file differs from the numpy writer's")
        require(written == payload, f"phase 18: {subtype}: {written} direct_out_bytes for a {payload}-byte payload")
        numbers[subtype] = {"payload_bytes": payload, "direct_ms_warm": ms["direct"][-1],
                            "numpy_ms_warm": ms["numpy"][-1]}
    return numbers


def trace_path(mt, torch, device, card):
    """Phase 18: the port's spans and counters (``trace``) on the card
    (see the module's docstring).  ``card``: the card's name and power
    limit from ``nvidia-smi``, stamped on the times.  Returns the phase's
    numbers; fails on any mismatch."""
    import warnings

    from matchering_tpu_torch import trace
    from matchering_tpu_torch.io import wav

    start = time.perf_counter()
    config = mt.Config()
    host = ("load", "check", "equality", "graph", "fetch", "encode")
    stages = ("levels", "spectra", "convolve", "correction", "finalize")
    numbers = {"card": card, "song_seconds": list(TRACE_SECONDS), "long_seconds": LONG_SECONDS,
               "long_rate": LONG_RATE}

    def recorded(fn):
        """``fn()`` once under ``trace.recording()``: its spans, the root first."""
        trace.clear()
        with trace.recording():
            fn()
        spans = trace.spans()
        roots = [s for s in spans if s.parent is None]
        require(len(roots) == 1 and len({s.call for s in spans}) == 1,
                f"phase 18: one call gave {len(roots)} roots over {len({s.call for s in spans})} calls")
        return roots + [s for s in spans if s.parent is not None]

    def total_ms(spans, names):
        return {name: sum(s.end_ns - s.start_ns for s in spans if s.name == name) * 1e-6 for name in names}

    def in_turns(fn):
        """Median wall ms of ``TRACE_CALLS`` calls a run, recording off and
        on in turns, ``TRACE_RUNS`` runs each."""
        arms = {"off": [], "on": []}
        for _ in range(TRACE_RUNS):
            for arm in arms:
                walls = []
                for _ in range(TRACE_CALLS):
                    trace.clear()
                    with trace.recording() if arm == "on" else contextlib.nullcontext():
                        begin = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        walls.append(1e3 * (time.perf_counter() - begin))
                arms[arm].append(float(np.median(walls)))
        trace.clear()
        return arms

    with tempfile.TemporaryDirectory(prefix="chip_smoke_spans_") as tmp:
        paths = [os.path.join(tmp, name) for name in ("target.wav", "reference.wav", "result.wav")]
        wav.write(paths[0], make_pair(TRACE_SECONDS[0], SR, SEED + 18)[0], SR, "PCM_16")
        wav.write(paths[1], make_pair(TRACE_SECONDS[1], SR, SEED + 19)[1], SR, "PCM_16")

        def song():
            mt.process(paths[0], paths[1], [mt.pcm16(paths[2])], config, device=device)

        song()  # warm
        moved = {"h2d_bytes": 0, "h2d_copies": 0, "d2h_bytes": 0, "d2h_copies": 0}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with copy_counter(torch, moved):
                    spans = recorded(song)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
        root = spans[0]
        counters = {k: root.counters.get(k, 0) for k in ("host_reads", "h2d_bytes", "d2h_bytes")}
        require(counters["host_reads"] == syncs,
                f"phase 18: process() counted {counters['host_reads']} host reads; the sync debug mode saw {syncs}")
        for way in ("h2d_bytes", "d2h_bytes"):
            require(counters[way] == moved[way],
                    f"phase 18: process() counted {counters[way]} {way}; the copy counter saw {moved[way]}: {moved}")
        root_ms = (root.end_ns - root.start_ns) * 1e-6
        spans_ms = total_ms(spans, host + ("stage", "master") + stages)
        covered = sum(spans_ms[name] for name in host) / root_ms
        require(covered >= 0.95, f"phase 18: the host spans cover {covered:.4f} of process(): {spans_ms}")
        direct = root.counters.get("direct_bytes", 0)
        require(direct == counters["h2d_bytes"],
                f"phase 18: process() read {direct} bytes straight into staging memory of {counters['h2d_bytes']} staged")
        payload = wav.read(paths[2], raw_int=True)[0].nbytes
        direct_out = root.counters.get("direct_out_bytes", 0)
        require(direct_out == payload,
                f"phase 18: process() wrote {direct_out} bytes straight from the codes' block of a {payload}-byte payload")
        numbers["song"] = {"names": [s.name for s in spans], "root_ms": root_ms, "spans_ms": spans_ms,
                           "host_spans_cover": covered, "counters": counters, "direct_bytes": direct,
                           "direct_out_bytes": direct_out, "syncs": syncs, "copy_counter": moved,
                           "recording_ms": in_turns(song)}
        numbers["direct_write"] = direct_write(torch, device, tmp)
        second = os.path.join(tmp, "second.wav")
        wav.write(second, make_pair(REUSE_SECONDS, SR, SEED + 22)[0], SR, "PCM_16")
        numbers["staging_reuse"] = staging_reuse(mt, torch, device, (paths[0], second))

    target = card_track(torch, device, LONG_SECONDS, LONG_RATE, SEED + 20, "target")
    reference = card_track(torch, device, LONG_REFERENCE_SECONDS, LONG_RATE, SEED + 21, "reference")

    def long_form():
        mt.master(target, reference, config, need_default=True, device=device)

    long_form()  # warm
    torch.cuda.synchronize()
    spans = recorded(long_form)
    torch.cuda.synchronize()
    root = spans[0]
    require([s.name for s in spans] == ["master", *stages] and all(s.parent == root.id for s in spans[1:]),
            f"phase 18: master() recorded {[(s.name, s.parent) for s in spans]}")
    device_ms = {s.name: s.device_ms for s in spans}
    covered = sum(device_ms[name] for name in stages) / device_ms["master"]
    require(covered >= 0.97, f"phase 18: the graph's stages cover {covered:.4f} of master()'s device time: {device_ms}")
    numbers["long_form"] = {"device_ms": device_ms, "stages_cover": covered,
                            "host_ms": total_ms(spans, ("master",) + stages),
                            "recording_ms": in_turns(long_form)}
    del target, reference
    numbers["seconds"] = time.perf_counter() - start
    print(f"phase 18 on {card}: process() {counters}, {syncs} syncs, copies {moved}, "
          f"staging reuse {numbers['staging_reuse']}, host spans cover "
          f"{numbers['song']['host_spans_cover']:.4f}; master() stages cover {covered:.4f} of its device time "
          f"{device_ms}; recording off/on: process() {numbers['song']['recording_ms']}, "
          f"master() {numbers['long_form']['recording_ms']} ms", flush=True)
    return numbers


# phase 19: K4, the limiter back end, at the benchmark's shapes
LONG_N = LONG_SECONDS * LONG_RATE  # 345,600,000: the long form's target
FARM_ROWS, FARM_N = 16, 70 * BUCKET  # 18,350,080: the farm cell's padded targets
BACK_END_ODD = (3, 1_000_003)  # n % 4 == 3: rows start off the float4 grid
BACK_END_BYTES = 32  # a float32 sample: four gains and the stereo in, the stereo out
BACK_END_SECONDS = 10  # the pair of the launch checks


def back_end_inputs(torch, device, rows, n, dtype, seed, offset=0, nan=False, attack_view=None):
    """A stereo batch and its four gains made on the card from ``seed``
    (gains in [0, 1), the first half of each row quantised to eighths so
    the maxima tie and meet 0), a flag per row (row 1 passes where there
    are three rows or more) and a scale per row.  ``offset``: each tensor
    starts that many elements into its storage, off 16 bytes.  ``nan``: a
    NaN in a gain of row 0, inside every length.  ``attack_view`` (pad,
    start): the attack gain is columns [start, start + n) of rows n + pad
    wide, as the filtfilt hands it over (static: (12, 6); with lengths:
    (6, 6))."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def placed(values):
        if not offset:
            return values
        storage = torch.empty(values.numel() + offset, dtype=dtype, device=device)
        storage[offset:].copy_(values.reshape(-1))
        return storage[offset:].view(values.shape)

    x = placed(torch.randn(rows, n, 2, generator=gen, device=device, dtype=dtype) * 0.7)
    gains = []
    for k in range(4):
        g = torch.rand(rows, n, generator=gen, device=device, dtype=dtype)
        g[:, : n // 2] = torch.floor(g[:, : n // 2] * 8) / 8
        if k == 1 and attack_view:
            pad, first = attack_view
            wide = torch.zeros(rows, n + pad, device=device, dtype=dtype)
            wide[:, first:first + n] = g
            gains.append(wide[:, first:first + n])
        else:
            gains.append(placed(g))
    if nan:
        gains[2][0, 10] = float("nan")
    passes = torch.zeros(rows, dtype=torch.bool, device=device)
    if rows >= 3:
        passes[1] = True
    scale = torch.rand(rows, generator=gen, device=device, dtype=dtype) + 0.5
    return x, gains, passes, scale


def same_bits(torch, got, want) -> bool:
    """NaN where the other is NaN (the card's arithmetic gives one NaN),
    and every other element's bits equal."""
    ints = torch.int32 if got.dtype == torch.float32 else torch.int64
    nan = torch.isnan(got)
    if got.shape != want.shape or not torch.equal(nan, torch.isnan(want)):
        return False
    return torch.equal(torch.where(nan, 0, got.view(ints)), torch.where(nan, 0, want.view(ints)))


def back_end_path(mt, torch, device, cuda_ms, kernel_ms, bandwidth):
    """Phase 19: K4 against its plain twin on the card, bit for bit, in
    float32 and float64 at an odd n (rows off the float4 grid, a NaN gain,
    and a batch off 16 bytes), at the long form's shape (1 x 345.6 M, the
    static path with the graph's scale) and at the farm's (16 x 18,350,080
    with seeded lengths and a scale); K4's time at both beside its 32 bytes
    a sample bound and the twin's time; then ``launch.k4`` once per
    ``limit()`` on each card path (``limit``, ``process``, ``master``,
    ``master_batch``, ``stages.main`` with ``length_bucketing``) and never
    on the CPU.  Returns K4's numbers for the kernels' line; fails on any
    mismatch."""
    from matchering_tpu_torch import stages
    from matchering_tpu_torch.io import wav
    from matchering_tpu_torch.kernels import back_end
    from matchering_tpu_torch.parallel import batch
    from matchering_tpu_torch.utils import RowInts

    start = time.perf_counter()
    config = mt.Config()
    rng = np.random.RandomState(SEED + 19)
    shortest = stages.minimum_length(config)

    def check(label, x, gains, passes, lengths, scale):
        got = back_end.limiter_back_end(x, *gains, passes, lengths, scale)
        want = back_end.limiter_back_end_plain(x, *gains, passes, lengths, scale)
        require(same_bits(torch, got, want), f"phase 19: K4 differs from its twin at {label}")
        return got

    checked = []
    rows, n = BACK_END_ODD
    for dtype in (torch.float32, torch.float64):
        for offset, view in ((0, None), (1, None), (0, (6, 6))):
            x, gains, passes, scale = back_end_inputs(torch, device, rows, n, dtype, SEED + offset,
                                                      offset, nan=True, attack_view=view)
            lengths = RowInts.of([n, shortest, int(rng.randint(shortest, n))], device)
            for with_lengths in (False, True):
                for scaled in (False, True):
                    label = (f"{rows} x {n}, {dtype}, offset {offset}, attack view {view}, "
                             f"lengths {with_lengths}, scale {scaled}")
                    got = check(label, x, gains, passes, lengths if with_lengths else None,
                                scale if scaled else None)
                    require(bool(torch.isnan(got[0, 10]).all()), f"phase 19: the NaN gain vanished at {label}")
                    checked.append(label)
            x1, gains1 = x[0], [g[0] for g in gains]
            check(f"one track of {n}, {dtype}, offset {offset}, attack view {view}", x1, gains1,
                  passes[0], None, None)
    del x, gains, got

    def timed(x, gains, passes, lengths, scale, samples):
        call = lambda: back_end.limiter_back_end(x, *gains, passes, lengths, scale)  # noqa: E731
        plain = lambda: back_end.limiter_back_end_plain(x, *gains, passes, lengths, scale)  # noqa: E731
        numbers = {
            "ms": cuda_ms(call, 10),
            "kernel_ms": kernel_ms(call, "back_end_kernel", reps=10),
            "plain_ms": cuda_ms(plain, 3),
            "bound_ms": 1e3 * BACK_END_BYTES * samples / bandwidth,
            "grid": back_end.LAST_GRID,
        }
        numbers["share_of_bound"] = numbers["bound_ms"] / numbers["kernel_ms"]
        return numbers

    # the long form: one row, the static path, the graph's scale, the
    # attack gain where the static filtfilt leaves it
    x, gains, passes, scale = back_end_inputs(torch, device, 1, LONG_N, torch.float32, SEED + 2,
                                              attack_view=(12, 6))
    for scaled in (False, True):
        check(f"1 x {LONG_N}, scale {scaled}", x, gains, passes, None, scale if scaled else None)
    long_form = timed(x, gains, passes, None, scale, LONG_N)
    del x, gains
    torch.cuda.empty_cache()
    print(f"K4 long form: {long_form}", flush=True)

    # the farm: 16 rows with seeded lengths of 120-420 s (and the shortest and
    # a full row), the attack gain's rows where the length-aware filtfilt leaves them
    x, gains, passes, scale = back_end_inputs(torch, device, FARM_ROWS, FARM_N, torch.float32, SEED + 3,
                                              attack_view=(6, 6))
    drawn = np.minimum(rng.uniform(120, 420, FARM_ROWS) * SR, FARM_N).astype(np.int64)
    drawn[0], drawn[-1] = shortest, FARM_N
    lengths = RowInts.of(drawn.tolist(), device)
    for scaled in (False, True):
        check(f"{FARM_ROWS} x {FARM_N} with lengths, scale {scaled}", x, gains, passes, lengths,
              scale if scaled else None)
    farm = timed(x, gains, passes, lengths, scale, FARM_ROWS * FARM_N)
    farm["lengths"] = drawn.tolist()
    del x, gains
    torch.cuda.empty_cache()
    print(f"K4 farm: {farm}", flush=True)

    # launch.k4: one per limit() on every card path, none on the CPU
    launches = {}

    def counted(label, fn):
        zero_counts()
        fn()
        torch.cuda.synchronize()
        launches[label] = [count_since(f"launch.k{i}") for i in (1, 2, 3, 4)]
        require(launches[label] == [*expected_launches(config), 1],
                f"phase 19: {label} launched K1-K4 {launches[label]} times, not "
                f"{[*expected_launches(config), 1]}")

    target, reference = make_pair(BACK_END_SECONDS, SR, SEED + 19)
    staged = torch.from_numpy(target).to(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_k4_") as tmp, plain_twins_forbidden("phase 19"):
        paths = [os.path.join(tmp, name) for name in ("target.wav", "reference.wav", "out.wav")]
        wav.write(paths[0], target, SR, "PCM_16")
        wav.write(paths[1], reference, SR, "PCM_16")
        counted("limit", lambda: mt.limit(staged, config))
        counted("process", lambda: mt.process(paths[0], paths[1], [mt.pcm16(paths[2])], device="cuda"))
        counted("master", lambda: mt.master(target, reference, config, device="cuda"))
        tracks = [target, target[: len(target) * 2 // 3]]
        t_batch, t_lens = batch.bucket_pad(tracks, BUCKET, device=device)
        r_batch, r_lens = batch.bucket_pad([reference, reference], BUCKET, device=device)
        counted("master_batch", lambda: batch.master_batch(
            t_batch, r_batch, config, target_lengths=t_lens, reference_lengths=r_lens, device=device))
        bucketed = mt.Config(length_bucketing=BUCKET)
        counted("stages.main bucketed", lambda: stages.main(target, reference, bucketed, device="cuda"))
    zero_counts()
    mt.master(target, reference, config, device="cpu")
    launches["master on the CPU"] = [count_since(f"launch.k{i}") for i in (1, 2, 3, 4)]
    require(launches["master on the CPU"] == [0, 0, 0, 0],
            f"phase 19: master() on the CPU launched {launches['master on the CPU']}")
    print(f"K4 launches: {launches}", flush=True)

    return {
        "name": "limiter_back_end",
        "route": "cuda",
        "source": "matchering_tpu_torch/csrc/back_end.cu",
        "replaces": "no Pallas kernel: the XLA ops of matchering_tpu/limiter.py:138",
        "max_abs_err": 0.0,
        "tolerance": 0.0,
        **long_form,
        "bound_by": "bytes",
        "library_ms": None,
        "n": LONG_N,
        "shapes": [list(BACK_END_ODD), [1, LONG_N], [FARM_ROWS, FARM_N]],
        "checked_cases": checked,
        "launch": launch_numbers("mtpu_back_end_info", 0, grid=long_form["grid"]),
        "batched": farm,
        "launches_per_path": launches,
        "seconds": time.perf_counter() - start,
    }


def main() -> None:
    script_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    require(torch.cuda.is_available(), "no CUDA device is available")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import matchering_tpu_torch as mt
        from matchering_tpu_torch.io import wav
        from matchering_tpu_torch.kernels import build, envelope, scan, sos
        from matchering_tpu_torch.ops import iir
        from matchering_tpu_torch.utils import ms_to_samples
    except ImportError as error:
        fail(f"the matchering_tpu_torch package is not beside this script ({error})")
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "matchering_tpu")]
    require(not leaked, f"the port imported {leaked}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    watch_equality(torch)

    # --- 1. the card ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; matmul allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}",
        flush=True,
    )
    part = "pcie" if "PCIe" in card else "sxm"
    bandwidth = HBM_BYTES_PER_S[part]

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def run_process(label, runs, events, *args, expected=(1, 4, 0), **kwargs):
        """One ``process()`` call on the card, its log events recorded in
        ``events`` and its kernel launches counted from 0: ``expected``
        (K1, K2, K3) launches, those of ``Config()`` unless given
        (``expected_launches``)."""
        events.clear()

        def record(*parts, **_kwargs):
            events.append((time.perf_counter(), " ".join(str(p) for p in parts)))

        mt.log(info_handler=record, warning_handler=record, debug_handler=record)
        zero_counts()
        EQUALITY_INPUTS.clear()
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            mt.process(*args, device="cuda", **kwargs)
            torch.cuda.synchronize()
        finally:
            mt.log()
        wall = time.perf_counter() - start
        launches = launch_counts()
        runs.append({"run": label, "wall_s": wall, "k1": launches[0], "k2": launches[1], "k3": launches[2],
                     "equality_inputs": list(EQUALITY_INPUTS)})
        require(launches == tuple(expected),
                f"{label} process() launched K1, K2 and K3 {launches} times, not {tuple(expected)}")
        require_equality_on_card(f"{label} process()", 1)
        # where the wall time went: each event's offset from the start
        return [{"t_s": round(t - start, 6), "event": message[:70]} for t, message in events]

    def kernel_ms(fn, name, reps=20, sessions=3):
        """Device time per launch of the kernel whose name holds `name`, from
        the profiler: the kernel alone, without the wrapper's host time.  A
        profiler session now and then delivers no kernel records at all
        (seen once in a run that had passed before on the same tree), so an
        empty session is repeated, up to `sessions` in all."""
        fn()
        torch.cuda.synchronize()
        for session in range(sessions):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if name in e.key and e.count]
            if events:
                return sum(e.self_device_time_total for e in events) / 1e3 / sum(e.count for e in events)
            print(f"profiler session {session + 1} saw no {name} launches", flush=True)
        fail(f"the profiler saw no {name} launches in {sessions} sessions")

    # --- 2. build ---
    start = time.perf_counter()
    build.library()
    print(
        f"build: {time.perf_counter() - start:.3f} s "
        f"(nvcc {'ran' if build.build_seconds is not None else 'skipped: library present'})",
        flush=True,
    )

    # --- 3. kernels against their plain twins, at awkward shapes and at full width ---
    config = mt.Config()
    attack = ms_to_samples(config.limiter.attack, SR)
    window = envelope.window_for(attack)
    rng = np.random.RandomState(SEED)
    stereo = torch.from_numpy((rng.randn(FULL_N, 2) * 0.5).astype(np.float32)).to(device)

    def k1_error(track):
        got = envelope.limiter_front_end(track, config.threshold, attack)
        want = envelope.limiter_front_end_plain(track, config.threshold, attack)
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    tile = envelope.TILE
    k1_shapes = [window, window + 1, tile - 1, tile, tile + 1, 3 * tile + 7, FULL_N]
    k1_err = 0.0
    for dtype in (torch.float32, torch.float64):
        for n in k1_shapes:
            track = stereo[:n] if dtype == torch.float32 and n == FULL_N else torch.from_numpy(
                rng.randn(n, 2) * 0.5
            ).to(device, dtype)
            err = k1_error(track)
            torch.cuda.synchronize()
            require(err == 0.0, f"K1 disagrees with its plain twin at n={n}, {dtype}: max abs err {err}")
            k1_err = max(k1_err, err)
    del track
    print(f"K1 checked at n={k1_shapes} in float32 and float64: max abs err {k1_err}", flush=True)
    k1_bytes = FULL_N * 2 * 4 + 2 * FULL_N * 4
    k1_ops = FULL_N * (7 + (window - 1))  # gain arithmetic + the window's comparisons
    k1 = {
        "name": "limiter_front_end",
        "route": "cuda",
        "source": "matchering_tpu_torch/csrc/envelope.cu",
        "replaces": "matchering_tpu/ops/pallas_envelope.py:116",
        "max_abs_err": k1_err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: envelope.limiter_front_end(stereo, config.threshold, attack), 20),
        "kernel_ms": kernel_ms(
            lambda: envelope.limiter_front_end(stereo, config.threshold, attack), "envelope_kernel"
        ),
        "plain_ms": cuda_ms(
            lambda: envelope.limiter_front_end_plain(stereo, config.threshold, attack), 5
        ),
        "bound_ms": 1e3 * max(k1_bytes / bandwidth, k1_ops / F32_FLOPS),
        "bound_by": "bytes" if k1_bytes / bandwidth >= k1_ops / F32_FLOPS else "operations",
        "library_ms": None,
        "n": FULL_N,
        "shapes": k1_shapes,
        "launch": launch_numbers("mtpu_envelope_info", 0, window, grid=envelope.LAST_GRID),
    }
    del stereo
    print(f"K1: {k1['ms']:.4f} ms a call, {k1['kernel_ms']:.4f} ms of kernel", flush=True)

    poles = {
        "attack": iir.one_pole_filter(config.limiter.attack_filter_coefficient, attack),
        "hold": iir.butter1_coefficients(config.limiter.hold_filter_coefficient, SR),
        "release": iir.butter1_coefficients(
            config.limiter.release_filter_coefficient / config.limiter.release, SR
        ),
    }

    def k2_error(x, filt, zi, reverse, want=None, lengths=None):
        """Max error of K2 against its twin: absolute in float32 (outputs
        below 2, so one ulp is at most 2^-23), relative in float64."""
        got = scan.first_order_filter(x, *filt, zi=zi, reverse=reverse, lengths=lengths)
        if want is None:
            want = scan.first_order_filter_plain(x, *filt, zi=zi, reverse=reverse, lengths=lengths)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), "K2 gave non-finite values")
        diff = (got.double() - want.double()).abs()
        if x.dtype == torch.float32:
            require(float(want.abs().max()) < 2.0, "K2's float32 check needs outputs below 2")
            return float(diff.max()), want
        return float((diff / want.double().abs().clamp_min(1e-300)).max()), want

    run, scan_tile = scan.RUN, scan.TILE
    k2_shapes = [1, 2, run - 1, scan_tile - 1, scan_tile, scan_tile + 1, 3 * scan_tile + 5, FULL_N]
    k2_worst = {torch.float32: 0.0, torch.float64: 0.0}
    k2_checked = 0
    release = poles["release"]
    for dtype, tol in ((torch.float32, SCAN_TOL), (torch.float64, SCAN_REL_TOL_F64)):
        for n in k2_shapes:
            for rows in (1, 3):
                x = torch.from_numpy(rng.rand(rows, n)).to(device, dtype)
                x = x[0] if rows == 1 else x
                zi_rows = torch.from_numpy(rng.rand(rows) * 0.5).to(device)
                for zi in (None, zi_rows):
                    for reverse in (False, True):
                        err, _ = k2_error(x, release, zi, reverse)
                        require(
                            err <= tol,
                            f"K2 disagrees with its plain twin at n={n}, rows={rows}, {dtype}, "
                            f"zi={zi is not None}, reverse={reverse}: error {err} > {tol}",
                        )
                        k2_worst[dtype] = max(k2_worst[dtype], err)
                        k2_checked += 1
    del x
    print(
        f"K2 checked at n={k2_shapes}, rows 1 and 3, both directions, with and without zi: "
        f"{k2_checked} cases, worst float32 abs err {k2_worst[torch.float32]}, "
        f"worst float64 rel err {k2_worst[torch.float64]}",
        flush=True,
    )

    x = torch.from_numpy(rng.rand(FULL_N).astype(np.float32)).to(device)
    zi = torch.tensor([0.3], dtype=torch.float64, device=device)
    want = None
    repeats = []
    for _ in range(3):  # the look-back's carries may round differently each run
        err, want = k2_error(x, release, zi, False, want)
        require(err <= SCAN_TOL, f"K2 at the release pole, repeated: max abs err {err} > {SCAN_TOL}")
        repeats.append(err)
    del want
    cases = []
    for name, filt in poles.items():
        for reverse in (False, True):
            err, _ = k2_error(x, filt, zi, reverse)
            require(
                err <= SCAN_TOL,
                f"K2 disagrees with its plain twin at the {name} pole "
                f"(reverse={reverse}): max abs err {err} > {SCAN_TOL}",
            )
            cases.append({
                "pole": name, "p": filt.pole, "reverse": reverse, "max_abs_err": err,
                "ms": cuda_ms(lambda: scan.first_order_filter(x, *filt, zi=zi, reverse=reverse), 20),
                "kernel_ms": kernel_ms(
                    lambda: scan.first_order_filter(x, *filt, zi=zi, reverse=reverse), "scan_kernel"
                ),
                "plain_ms": cuda_ms(
                    lambda: scan.first_order_filter_plain(x, *filt, zi=zi, reverse=reverse), 2
                ),
            })
            print(
                f"K2 timed: {name} reverse={reverse}: {cases[-1]['ms']:.4f} ms a call, "
                f"{cases[-1]['kernel_ms']:.4f} ms of kernel",
                flush=True,
            )
    del x
    k2_bytes = FULL_N * 4 + FULL_N * 4
    k2_ops = FULL_N * 4  # the drive (2 multiplies, 1 add) and the state update, in float64
    k2 = {
        "name": "first_order_scan",
        "route": "cuda",
        "source": "matchering_tpu_torch/csrc/scan.cu",
        "replaces": "matchering_tpu/ops/iir.py:105",
        "max_abs_err": max(k2_worst[torch.float32], *repeats, *(c["max_abs_err"] for c in cases)),
        "tolerance": SCAN_TOL,
        "max_rel_err_f64": k2_worst[torch.float64],
        "tolerance_rel_f64": SCAN_REL_TOL_F64,
        "ms": sum(c["ms"] for c in cases) / len(cases),
        "kernel_ms": sum(c["kernel_ms"] for c in cases) / len(cases),
        "plain_ms": sum(c["plain_ms"] for c in cases) / len(cases),
        "bound_ms": 1e3 * max(k2_bytes / bandwidth, k2_ops / F64_FLOPS),
        "bound_by": "bytes" if k2_bytes / bandwidth >= k2_ops / F64_FLOPS else "operations",
        "library_ms": None,
        "n": FULL_N,
        "shapes": k2_shapes,
        "launch": launch_numbers("mtpu_scan_info", 0, grid=scan.LAST_GRID),
        "checked_cases": k2_checked,
        "repeat_errs": repeats,
        "cases": cases,
    }

    # the length modes: rows of a zero-padded batch
    k1_batched, k2_batched = length_modes(
        torch, device, config, rng, release, k2_error, cuda_ms, kernel_ms, bandwidth
    )

    # --- 4. the main path: process() on a 180 s WAV pair ---
    # phase 9 reads phase 4's files again: the folder lives to the end of the run
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = workdir.name
    target, reference = make_pair(FULL_SECONDS, SR, SEED)
    target_path = os.path.join(tmp, "target.wav")
    reference_path = os.path.join(tmp, "reference.wav")
    out_path = os.path.join(tmp, "master.wav")
    wav.write(target_path, target, SR, "PCM_16")
    wav.write(reference_path, reference, SR, "PCM_16")
    del target, reference
    runs = []
    events = []  # (time, message) of process()'s own log events
    for label in ("cold", "warm"):
        timeline = run_process(
            label, runs, events, target_path, reference_path, [mt.pcm16(out_path)]
        )
    # one more warm process(): what crossed each way
    transfers = traced_run(
        torch, "process()",
        lambda: mt.process(target_path, reference_path, [mt.pcm16(out_path)], device="cuda"),
        1, 2 * FULL_N * 2 * 2, FULL_N * 2 * 2,
    )
    # the device's share of master(): one profiled call on the staged int16 pair
    target_pcm, _ = mt.load(target_path, "target", raw_int=True)
    reference_pcm, _ = mt.load(reference_path, "reference", raw_int=True)
    mt.master(target_pcm, reference_pcm, config, device="cuda")
    torch.cuda.synchronize()
    def profiled_master():
        zero_counts()
        mt.master(target_pcm, reference_pcm, config, device="cuda")

    master_ms, ops = profile_device(torch, profiled_master)
    # K2's device kernels in the profile, one per call, and no K3
    sos_kernels = sum(o["calls"] for o in ops if "sos_scan_kernel" in o["op"])
    scan_kernels = sum(o["calls"] for o in ops if "scan_kernel" in o["op"]) - sos_kernels
    device_ms = sum(o["device_ms"] for o in ops)
    require(device_ms > 0, "the profiler saw no device time in master()")
    _, k2_expected, k3_expected = expected_launches(config)
    _, k2_calls, k3_calls = launch_counts()
    require(
        scan_kernels == k2_calls == k2_expected and sos_kernels == k3_calls == k3_expected,
        f"master() made {k2_calls} K2 and {k3_calls} K3 calls but the profile shows "
        f"{scan_kernels} scan and {sos_kernels} sos_scan kernels",
    )
    del target_pcm, reference_pcm
    out, rate = wav.read(out_path)
    require(rate == SR and out.shape == (FULL_N, 2), f"output is {out.shape} at {rate} Hz")
    require(bool(np.all(np.isfinite(out))), "the output holds non-finite samples")
    peak = float(np.max(np.abs(out)))
    require(peak <= config.threshold, f"output peak {peak} exceeds {config.threshold}")
    warm = runs[-1]["wall_s"]
    print(json.dumps({
        "process": runs, "audio_seconds": FULL_SECONDS, "realtime_factor_warm": FULL_SECONDS / warm,
        "output_peak": peak, "threshold": config.threshold,
    }), flush=True)
    print(json.dumps({"warm_timeline": timeline}), flush=True)
    print(json.dumps({"transfers": transfers}), flush=True)
    print(json.dumps({
        "master_profiled": {
            "wall_ms": master_ms, "device_ms": device_ms, "device_busy_share": device_ms / master_ms,
            "k2_calls": k2_calls, "k2_kernels": scan_kernels, "k3_kernels": sos_kernels,
            "top_ops": top(ops, 15, 60),
        }
    }), flush=True)
    k1["launches"] = runs[-1]["k1"]
    k2["launches"] = runs[-1]["k2"]

    # --- 5. the card's float32 master against the CPU's float64 master ---
    target, reference = make_pair(SNR_SECONDS, SR, SEED + 1)
    card_out = mt.master(target, reference, mt.Config(), device="cuda").result.cpu().numpy()
    cpu_out = mt.master(target, reference, mt.Config(dtype="float64"), device="cpu").result.numpy()
    measured = snr_db(cpu_out, card_out)
    print(json.dumps({"snr_db_f32_card_vs_f64_cpu": measured, "gate_db": SNR_GATE_DB}), flush=True)
    require(measured >= SNR_GATE_DB, f"card float32 master at {measured} dB < {SNR_GATE_DB} dB")

    # --- 6. the user path: a 48 kHz reference, previews, an AIFF result, the CLI ---
    print(json.dumps({"user_path": user_path(mt, torch, device, config, here, cuda_ms, run_process,
                                             bandwidth, F64_TENSOR_FLOPS[part])}), flush=True)

    # --- 7. the farm path: process_batch, both dispatches ---
    def recorder(events):
        def record(*parts, **_kwargs):
            events.append((time.perf_counter(), " ".join(str(p) for p in parts)))

        mt.log(info_handler=record, warning_handler=record, debug_handler=record)

    # phase 10 reads phase 7's jobs and files again: the folder lives to the end of the run
    farm_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_farm_")
    farm = farm_path(mt, torch, device, config, recorder, farm_dir.name)
    print(json.dumps({"farm_path": farm}), flush=True)
    launches = {(r["dispatch"], r["run"]): (r["k1"], r["k2"]) for r in farm["runs"]}
    for index, numbers in enumerate((k1_batched, k2_batched)):
        numbers["launches"] = launches[("vmapped", "warm")][index]
        numbers["launches_pipelined"] = launches[("pipelined", "warm")][index]
    k1["batched"] = k1_batched
    k2["batched"] = k2_batched

    # --- 8. the configs path: K3, Butterworth orders above 1, the device LOWESS ---
    k3, configs = configs_path(mt, torch, device, cuda_ms, kernel_ms, run_process, bandwidth)
    print(json.dumps({"configs_path": configs}), flush=True)

    # --- 9. the time-sharded path: limit_sharded, the long form, master_farm, --time_sharded ---
    sharded = timeshard_path(mt, torch, device, config, here, cuda_ms, (target_path, reference_path, out_path))
    print(json.dumps({"timeshard_path": sharded}), flush=True)
    for numbers, launches in zip((k1, k2, k3), SHARDED_LAUNCHES):
        numbers["launches_sharded"] = launches  # one sharded limit() on one card

    # --- 10. multi-process: the package's self-tests, then two processes at full width ---
    distributed, per_process = distributed_path(torch, here, farm_dir.name, farm)
    print(json.dumps({"distributed_path": distributed}), flush=True)
    farm_dir.cleanup()
    for index, numbers in enumerate((k1, k2, k3)):
        # each process's warm run of master_batch_distributed over its 4 rows
        numbers["launches_distributed"] = [launches[index] for launches in per_process]

    # --- 11. the codecs: FLAC, the WAV writers and readers, the lossy libraries ---
    codecs = codecs_path(mt, torch, run_process, (target_path, reference_path, out_path))
    print(json.dumps({"codecs_path": codecs}), flush=True)
    workdir.cleanup()

    # --- 12. the public op library on the card: the scans on K2, the FFT ops ---
    public = public_ops_path(torch, device, cuda_ms, release)
    print(json.dumps({"public_ops": public}), flush=True)
    k2["launches_public_ops"] = {name: op["k2_launches"] for name, op in public["ops"].items()
                                 if op["k2_launches"]}

    # --- 13. the driver entry points: entry(), dryrun_multichip(4), bench.py's graph body ---
    entry = entry_path(mt, torch, device)
    print(json.dumps({"entry_path": entry}), flush=True)
    for index, numbers in enumerate((k1, k2, k3)):
        numbers["launches_entry_path"] = {name: [run["k1"], run["k2"], run["k3"]][index]
                                          for name, run in (("entry", entry["entry"]),
                                                            ("dryrun_multichip", entry["dryrun_multichip"]),
                                                            ("bench_graph", entry["bench_graph"]["interp_ops_passed"]))}

    # --- 14. the measurement drivers: bench_torch.py, tools_record_bench_torch.py ---
    drivers = drivers_path(mt, torch, device, entry["bench_graph"]["checksum"])
    print(json.dumps({"drivers_path": drivers}), flush=True)
    record_runs = drivers["tools_record_bench_torch"]
    for index, numbers in enumerate((k1, k2, k3)):
        numbers["launches_drivers_path"] = {
            "bench_round": drivers["bench_torch"]["launches_round"][index],
            "bench_run": drivers["bench_torch"]["launches_run"][index],
            **{f"record_{name}_per_call": run["launches"][index] // run["calls"]
               for name, run in record_runs.items() if "calls" in run},
        }

    # --- 15. the JAX package's length forms: int and 0-d lengths, as the one-row batch ---
    jax_forms = jax_forms_path(mt, torch, device, cuda_ms, card)
    print(json.dumps({"jax_forms_path": jax_forms}), flush=True)
    for index, numbers in enumerate((k1, k2, k3)):
        numbers["launches_jax_forms"] = {
            f"{name}_{form}": run[("k1", "k2", "k3")[index]]
            for name in ("master_graph", "limit") for form, run in jax_forms[name].items()
            if isinstance(run, dict) and "k1" in run
        }

    # --- 16. the smoothing forms on the configs that broke, at full width ---
    walk = config_walk_path(mt, torch, device, cuda_ms, card, entry["bench_graph"]["checksum"])
    print(json.dumps({"config_walk_path": walk}), flush=True)
    for index, numbers in enumerate((k1, k2, k3)):
        numbers["launches_config_walk"] = {name: run["expected_launches"][index]
                                           for name, run in walk["configs"].items()}

    # --- 17. the input walk: the classes users send, at full width ---
    walk_inputs = input_walk_path(mt, torch, device, card)
    print(json.dumps({"input_walk_path": walk_inputs}), flush=True)
    for index, numbers in enumerate((k1, k2, k3)):
        numbers["launches_input_walk"] = {
            "process_per_call": walk_inputs["expected_launches"][index],
            **{f"farm_{dispatch}": walk_inputs["farm"][dispatch][("k1", "k2", "k3")[index]]
               for dispatch in ("pipelined", "vmapped")},
        }

    # --- 18. the port's spans and counters: one recorded call each, their cost ---
    traced = trace_path(mt, torch, device, card)
    print(json.dumps({"trace_path": traced}), flush=True)

    # --- 19. K4, the limiter back end: bit for bit, timed, one launch per limit() ---
    k4 = back_end_path(mt, torch, device, cuda_ms, kernel_ms, bandwidth)
    print(json.dumps({"back_end_path_seconds": k4["seconds"]}), flush=True)

    # --- 20. results ---
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "matchering_tpu")]
    require(not leaked, f"the port imported {leaked} on its way")
    print(json.dumps({"script_seconds": time.perf_counter() - script_start,
                      "drivers_path_seconds": drivers["seconds"],
                      "config_walk_path_seconds": walk["seconds"],
                      "input_walk_path_seconds": walk_inputs["seconds"],
                      "trace_path_seconds": traced["seconds"]}), flush=True)
    print(json.dumps({"kernels": [k1, k2, k3, k4]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-worker"]:
        distributed_worker(sys.argv[2:])
    else:
        main()
