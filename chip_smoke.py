#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``matchering_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card, ``nvcc``
(CUDA 12, ``sm_90a``) and PyTorch built for CUDA.  In order, it:

1. prints the card's ``nvidia-smi`` name and power limit, the torch and
   CUDA versions and the TF32 settings;
2. builds the CUDA kernels from ``matchering_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch twin on the card at the
   main path's width (n = 7,938,000 samples, float32) and times both:
   K1 (limiter front end) to a max error of 0, K2 (first-order IIR scan)
   at the limiter's three poles, forward and reverse, to one float32 ulp
   at 1.0;
4. writes a 180 s PCM_16 WAV pair made from a seed and runs
   ``process()`` on it on the card twice (cold, warm), counting kernel
   launches per run, and checks the written file; prints the warm run's
   timeline of log events and a profile of one ``master`` call (device
   time by op, and the device's busy share of its wall time);
5. compares ``master`` on the card (float32) with the port's own
   ``master`` on the CPU at float64 on a 30 s pair: at least 95 dB SNR;
6. prints one JSON line of per-kernel numbers, then, last, the device line
   ``{"ok": true, "device": {...}}``.

Any failed phase ends the run with a non-zero exit code and no device line.
It imports nothing of JAX or ``matchering_tpu``.
"""

import json
import os
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
SEED = 20260
# H100 peaks (NVIDIA data sheet, SXM part; the PCIe part's memory is slower)
HBM_BYTES_PER_S = {"sxm": 3.35e12, "pcie": 2.0e12}
F32_FLOPS = 67e12  # float32 outside the tensor cores
F64_FLOPS = 34e12  # float64 outside the tensor cores


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(condition: bool, message: str) -> None:
    if not condition:
        fail(message)


def make_pair(seconds: int, sr: int, seed: int):
    """A target/reference stereo pair from a seed (the workload of the
    repository's bench.py: a soft two-tone target and a square-wave
    reference under a slow envelope, with noise)."""
    rng = np.random.RandomState(seed)
    n = seconds * sr
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


def main() -> None:
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
        from matchering_tpu_torch.kernels import build, envelope, scan
        from matchering_tpu_torch.ops import iir
        from matchering_tpu_torch.utils import ms_to_samples
    except ImportError as error:
        fail(f"the matchering_tpu_torch package is not beside this script ({error})")
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "matchering_tpu")]
    require(not leaked, f"the port imported {leaked}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

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
    bandwidth = HBM_BYTES_PER_S["pcie" if "PCIe" in card else "sxm"]

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

    # --- 2. build ---
    start = time.perf_counter()
    build.library()
    print(
        f"build: {time.perf_counter() - start:.3f} s "
        f"(nvcc {'ran' if build.build_seconds is not None else 'skipped: library present'})",
        flush=True,
    )

    # --- 3. kernels against their plain twins at the main path's width ---
    config = mt.Config()
    attack = ms_to_samples(config.limiter.attack, SR)
    rng = np.random.RandomState(SEED)
    stereo = torch.from_numpy((rng.randn(FULL_N, 2) * 0.5).astype(np.float32)).to(device)
    gain, slided = envelope.limiter_front_end(stereo, config.threshold, attack)
    plain_gain, plain_slided = envelope.limiter_front_end_plain(stereo, config.threshold, attack)
    torch.cuda.synchronize()
    k1_err = max(
        float((gain - plain_gain).abs().max()), float((slided - plain_slided).abs().max())
    )
    require(k1_err == 0.0, f"K1 disagrees with its plain twin: max abs err {k1_err}")
    window = envelope.window_for(attack)
    k1_bytes = FULL_N * 2 * 4 + 2 * FULL_N * 4
    k1_ops = FULL_N * (7 + (window - 1))  # gain arithmetic + the window's comparisons
    k1 = {
        "name": "limiter_front_end",
        "route": "cuda",
        "source": "matchering_tpu_torch/csrc/envelope.cu",
        "replaces": "matchering_tpu/ops/pallas_envelope.py:115",
        "max_abs_err": k1_err,
        "tolerance": 0.0,
        "ms": cuda_ms(lambda: envelope.limiter_front_end(stereo, config.threshold, attack), 20),
        "plain_ms": cuda_ms(
            lambda: envelope.limiter_front_end_plain(stereo, config.threshold, attack), 5
        ),
        "bound_ms": 1e3 * max(k1_bytes / bandwidth, k1_ops / F32_FLOPS),
        "bound_by": "bytes" if k1_bytes / bandwidth >= k1_ops / F32_FLOPS else "operations",
        "library_ms": None,
        "n": FULL_N,
    }
    del stereo, gain, slided, plain_gain, plain_slided
    print(f"K1 checked: max abs err {k1_err}, {k1['ms']:.4f} ms", flush=True)

    poles = {
        "attack": iir.one_pole_filter(config.limiter.attack_filter_coefficient, attack),
        "hold": iir.butter1_coefficients(config.limiter.hold_filter_coefficient, SR),
        "release": iir.butter1_coefficients(
            config.limiter.release_filter_coefficient / config.limiter.release, SR
        ),
    }
    x = torch.from_numpy(rng.rand(FULL_N).astype(np.float32)).to(device)
    zi = torch.tensor([0.3], dtype=torch.float64, device=device)
    cases = []
    for name, filt in poles.items():
        for reverse in (False, True):
            got = scan.first_order_filter(x, *filt, zi=zi, reverse=reverse)
            want = scan.first_order_filter_plain(x, *filt, zi=zi, reverse=reverse)
            err = float((got - want).abs().max())
            require(
                err <= SCAN_TOL,
                f"K2 disagrees with its plain twin at the {name} pole "
                f"(reverse={reverse}): max abs err {err} > {SCAN_TOL}",
            )
            cases.append({
                "pole": name, "p": filt.pole, "reverse": reverse, "max_abs_err": err,
                "ms": cuda_ms(lambda: scan.first_order_filter(x, *filt, zi=zi, reverse=reverse), 20),
                "plain_ms": cuda_ms(
                    lambda: scan.first_order_filter_plain(x, *filt, zi=zi, reverse=reverse), 2
                ),
            })
            print(f"K2 checked: {name} reverse={reverse}: max abs err {err}", flush=True)
    del x, got, want
    k2_bytes = FULL_N * 4 + FULL_N * 4
    k2_ops = FULL_N * 4  # the drive (2 multiplies, 1 add) and the state update, in float64
    k2 = {
        "name": "first_order_scan",
        "route": "cuda",
        "source": "matchering_tpu_torch/csrc/scan.cu",
        "replaces": "matchering_tpu/ops/iir.py:105",
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": SCAN_TOL,
        "ms": sum(c["ms"] for c in cases) / len(cases),
        "plain_ms": sum(c["plain_ms"] for c in cases) / len(cases),
        "bound_ms": 1e3 * max(k2_bytes / bandwidth, k2_ops / F64_FLOPS),
        "bound_by": "bytes" if k2_bytes / bandwidth >= k2_ops / F64_FLOPS else "operations",
        "library_ms": None,
        "n": FULL_N,
        "cases": cases,
    }

    # --- 4. the main path: process() on a 180 s WAV pair ---
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        target, reference = make_pair(FULL_SECONDS, SR, SEED)
        target_path = os.path.join(tmp, "target.wav")
        reference_path = os.path.join(tmp, "reference.wav")
        out_path = os.path.join(tmp, "master.wav")
        wav.write(target_path, target, SR, "PCM_16")
        wav.write(reference_path, reference, SR, "PCM_16")
        del target, reference
        runs = []
        events = []  # (time, message) of process()'s own log events

        def record(*args, **_kwargs):
            events.append((time.perf_counter(), " ".join(str(a) for a in args)))

        for label in ("cold", "warm"):
            events.clear()
            mt.log(info_handler=record, warning_handler=record, debug_handler=record)
            envelope.LAUNCHES = 0
            scan.LAUNCHES = 0
            torch.cuda.synchronize()
            start = time.perf_counter()
            mt.process(target_path, reference_path, [mt.pcm16(out_path)], device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            mt.log()
            runs.append({"run": label, "wall_s": wall, "k1": envelope.LAUNCHES, "k2": scan.LAUNCHES})
            require(envelope.LAUNCHES >= 1, f"{label} process() launched K1 {envelope.LAUNCHES} times")
            require(scan.LAUNCHES >= 4, f"{label} process() launched K2 {scan.LAUNCHES} times")
        # where the warm run's wall time went: each event's offset from the start
        timeline = [
            {"t_s": round(t - start, 6), "event": message[:70]} for t, message in events
        ]
        # the device's share of master(): one profiled call on the staged int16 pair
        target_pcm, _ = mt.load(target_path, "target", raw_int=True)
        reference_pcm, _ = mt.load(reference_path, "reference", raw_int=True)
        mt.master(target_pcm, reference_pcm, config, device="cuda")
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            start = time.perf_counter()
            mt.master(target_pcm, reference_pcm, config, device="cuda")
            torch.cuda.synchronize()
            master_ms = 1e3 * (time.perf_counter() - start)
        ops = []  # device-side events only (kernels, copies): host ops would count them twice
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA or evt.key.startswith("Activity"):
                continue
            ops.append(
                {"op": evt.key[:60], "device_ms": evt.self_device_time_total / 1e3, "calls": evt.count}
            )
        ops.sort(key=lambda o: -o["device_ms"])
        device_ms = sum(o["device_ms"] for o in ops)
        require(device_ms > 0, "the profiler saw no device time in master()")
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
    print(json.dumps({
        "master_profiled": {
            "wall_ms": master_ms, "device_ms": device_ms, "device_busy_share": device_ms / master_ms,
            "top_ops": ops[:15],
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

    # --- 6. results ---
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
