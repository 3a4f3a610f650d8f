"""Extended measurements of the PyTorch port on one card (the twin of
``tools_record_bench.py``): the single-pair flagship, a batch-size sweep,
a per-stage split and, with ``--longform``, the 60-min 96 kHz master.

    python3 tools_record_bench_torch.py [--skip-sweep] [--longform | --longform-only]
                                        [--out PATH] [--device cuda]

Prints one JSON line per section on stdout: ``device`` (the card's
``nvidia-smi`` name and power limit, the torch and CUDA versions, the
TF32 flags), then ``single_pair_180s_44k``, ``per_stage_180s_44k``,
``batch_sweep_180s_44k`` and ``longform_60min_96k`` as they run.  With
``--out PATH`` it also writes them, merged into what PATH held, to PATH;
without it, it writes no file.  Progress goes to stderr.

Each timing stages its inputs on the card outside the timed region,
ends in a host fetch of a checksum (``.item()``), and is the median of 3
runs on perturbed inputs after one warm run.  Without ``--device`` it
raises when no card is present.  It imports numpy, torch and
``matchering_tpu_torch``, nothing of JAX.

The long form builds a 60-min 96 kHz stereo target (2.76 GB in float32)
and a 180 s reference on the host, in chunks on up to 8 threads, and
stages them from there.
It needs about 16 GB of host memory: the float32 target, its int16 codes
(1.38 GB) and their float32 copy (2.76 GB), and the page-locked staging
blocks of the caching host allocator (4 GiB for a float32 target, 2 GiB
for its int16 codes, 256 MiB for the reference), which it keeps for the
life of the process.
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import matchering_tpu_torch as mt
from bench_torch import device_info, synchronize
from matchering_tpu_torch import stages
from matchering_tpu_torch.ops import basics, convolve, smoothing
from matchering_tpu_torch.parallel import batch as pbatch
from matchering_tpu_torch.utils import resolve_device, to_device

SECONDS = 180
SR = 44100
VARIANTS = 4  # perturbed inputs of each timing: one warm run, then the median of 3
STAGE_RUNS = 3  # timed runs of each stage after its warm run
SWEEP_SIZES = (1, 2, 4, 8)  # bench_batch_sweep's batch sizes
LONGFORM_HOST_BYTES = 16 * 10**9  # the long form's host memory (the docstring's figure)
LONGFORM_CHUNK = 1 << 22  # rows of the long-form target built at a time


def _checksum_time(fn, variants):
    """Warm on variants[0], then the median wall time over the rest; also
    every call's checksum, in order."""
    checksums = [fn(*variants[0])]
    times = []
    for pair in variants[1:]:
        t0 = time.perf_counter()
        checksums.append(fn(*pair))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], checksums


def _make_pair(seconds, sr, seed=42):
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
    ).astype(np.float32)
    reference = np.stack(
        [
            (0.7 * np.sign(np.sin(2 * np.pi * 110 * t)) + 0.05 * rng.randn(n)) * env,
            (0.7 * np.sign(np.sin(2 * np.pi * 110 * t)) + 0.05 * rng.randn(n)) * env,
        ],
        axis=1,
    ).astype(np.float32)
    return target, reference


def _unfolded_operators(config, device):
    """The plain interpolation operators of ``config`` in its dtype on
    ``device``, as the JAX tool passes them: their inner dimension is the
    log grid's, so the graph runs the LOWESS between the two products
    (the device LOWESS plan, staged beside them)."""
    return smoothing.interpolation_operator_arrays(
        config.internal_sample_rate,
        config.fft_size,
        config.lin_log_oversampling,
        config.torch_dtype,
        device=device,
    )


def bench_single(config, seconds=180, sr=44100, *, device=None, pair=None):
    """The warm wall time of one pair's ``master_graph`` with the unfolded
    operators (slower than ``bench_torch``'s folded ``single_pair``: it
    runs the device LOWESS), the median of 3 runs on perturbed pairs.
    ``pair``: the (target, reference) of ``_make_pair(seconds, sr)``,
    when the caller has it."""
    device = resolve_device(device)
    target, reference = _make_pair(seconds, sr) if pair is None else pair
    interp_ops = _unfolded_operators(config, device)

    def graph(t, r):
        out = mt.master_graph(t, r, config, need_default=True, interp_ops=interp_ops)
        return torch.sum(torch.abs(out.result)).item()

    variants = [
        (to_device(target * (1.0 + 0.01 * i), device), to_device(reference * (1.0 - 0.01 * i), device))
        for i in range(VARIANTS)
    ]
    synchronize(device)
    median, checksums = _checksum_time(graph, variants)
    return {
        "seconds_audio": seconds,
        "wall_s": median,
        "realtime_factor": seconds / median,
        "checksum": checksums[0],
        "operators": "unfolded (device LOWESS)",
    }


def bench_batch_sweep(config, seconds=180, sr=44100, sizes=(1, 2, 4, 8), *, device=None, pair=None):
    """``parallel.batch.master_batch`` over B = ``sizes`` rows of the pair
    (row i: target x (1 + 0.02 i), reference x (1 - 0.01 i)), each size's
    4 perturbed batches staged on the device and freed before the next
    size: the median wall time, pairs and audio seconds per second, and
    the first batch's checksum."""
    device = resolve_device(device)
    target, reference = _make_pair(seconds, sr) if pair is None else pair
    out = {}
    for size in sizes:
        targets = np.stack([target * (1 + 0.02 * i) for i in range(size)])
        references = np.stack([reference * (1 - 0.01 * i) for i in range(size)])

        def run(tb, rb):
            res = pbatch.master_batch(tb, rb, config, device=device)
            return torch.sum(torch.abs(res.result)).item()

        variants = [
            (to_device(targets * (1 + 0.001 * i), device), to_device(references, device))
            for i in range(VARIANTS)
        ]
        del targets, references
        synchronize(device)
        median, checksums = _checksum_time(run, variants)
        del variants
        out[str(size)] = {
            "wall_s": median,
            "pairs_per_s": size / median,
            "audio_sec_per_s": size * seconds / median,
            "checksum": checksums[0],
        }
        print(f"batch B={size}: {out[str(size)]}", file=sys.stderr, flush=True)
    return out


def _stages(config, interp_ops):
    """``master_graph``'s static path on one pair as four calls, in its
    order and with its own steps: (name, fn) each, where fn takes what
    the stage before returned as its carry and returns (a 0-d checksum,
    the carry for the next); the first takes (target, reference), the
    last returns the limited result, ``master_graph(...).result``."""
    dtype = config.torch_dtype

    def analysis_and_fir(target, reference):
        operators = smoothing.as_smoothing(
            interp_ops, config.log_grid_size, smoothing.lowess_parameters(config), dtype, target.device
        )
        target = basics.to_working_float(target[None], dtype)
        reference = basics.to_working_float(reference[None], dtype)
        reference, amplitude = basics.normalize(
            reference, config.threshold, config.min_value, normalize_clipped=False
        )
        t_division = stages._Division.static(target.shape[1], config.max_piece_size)
        r_division = stages._Division.static(reference.shape[1], config.max_piece_size)
        target_mid, target_side = basics.lr_to_ms(target)
        reference_mid, reference_side = basics.lr_to_ms(reference)
        t_mask, t_rms = stages._analyze_levels(target_mid, t_division)
        r_mask, r_rms = stages._analyze_levels(reference_mid, r_division)
        coefficient = (r_rms / torch.clamp(t_rms, min=config.min_value))[:, None]
        t_mid_fft, t_side_fft = stages._masked_spectrum_pair(target_mid, target_side, t_mask, t_division, config)
        r_mid_fft, r_side_fft = stages._masked_spectrum_pair(
            reference_mid, reference_side, r_mask, r_division, config
        )
        mid_fir = stages._fir_from_spectra(t_mid_fft * coefficient, r_mid_fft, config, operators)
        side_fir = stages._fir_from_spectra(t_side_fft * coefficient, r_side_fft, config, operators)
        carry = {
            "mid": target_mid * coefficient, "side": target_side * coefficient,
            "mid_fir": mid_fir, "side_fir": side_fir,
            "division": t_division, "reference_rms": r_rms, "amplitude": amplitude,
        }
        return torch.sum(mid_fir) + torch.sum(side_fir), carry

    def convolution(carry):
        rows, n = carry["mid"].shape
        convolved = convolve.fft_convolve_same_batch(
            torch.stack([carry["mid"], carry["side"]], dim=1).reshape(2 * rows, n),
            torch.stack([carry["mid_fir"], carry["side_fir"]], dim=1).reshape(2 * rows, -1),
        ).reshape(rows, 2, n)
        return torch.sum(torch.abs(convolved)), {**carry, "convolved": convolved}

    def rms_correction_x4(carry):
        # the graph's homogeneous form: each step clips the unscaled mid
        # channel at a scaled threshold, one final scale of the stereo track
        convolved = carry["convolved"]
        result_mid = convolved[:, 0]
        result = basics.ms_to_lr(result_mid, convolved[:, 1])
        c_total = torch.ones(result.shape[0], dtype=dtype, device=result.device)
        for _ in range(config.rms_correction_steps):
            clipped = basics.clip(result_mid, 1.0 / c_total)
            _, clipped_match_rms = stages._analyze_levels(clipped, carry["division"])
            c_total = c_total * (
                carry["reference_rms"] / torch.clamp(c_total * clipped_match_rms, min=config.min_value)
            )
        result = result * c_total[:, None, None]
        return torch.sum(torch.abs(result)), {**carry, "result": result}

    def limiter(carry):
        result = mt.limit(carry["result"], config) * carry["amplitude"][:, None, None]
        return torch.sum(torch.abs(result)), result[0]

    return (
        ("analysis_and_fir", analysis_and_fir),
        ("convolution", convolution),
        ("rms_correction_x4", rms_correction_x4),
        ("limiter", limiter),
    )


def bench_stages(config, seconds=180, sr=44100, *, device=None, pair=None):
    """Each stage of the graph as its own call ending in a fetch of its
    checksum (the graph runs them back to back, so the sum here exceeds
    its total by design): the median wall time of 3 warm runs, and the
    median of their CUDA-event times on a card (None elsewhere)."""
    device = resolve_device(device)
    target, reference = _make_pair(seconds, sr) if pair is None else pair
    t_dev, r_dev = to_device(target, device), to_device(reference, device)
    interp_ops = _unfolded_operators(config, device)
    timings = {}
    carry = (t_dev, r_dev)
    for name, fn in _stages(config, interp_ops):
        checksum, out = fn(*carry)
        checksum.item()  # warm
        walls, events = [], []
        for _ in range(STAGE_RUNS):
            if device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            checksum, out = fn(*carry)
            if device.type == "cuda":
                end.record()
            checksum.item()
            walls.append(time.perf_counter() - t0)
            if device.type == "cuda":
                events.append(start.elapsed_time(end) / 1e3)
        timings[name] = {
            "wall_s": sorted(walls)[len(walls) // 2],
            "cuda_event_s": sorted(events)[len(events) // 2] if events else None,
        }
        carry = (out,)
    timings["sum_wall_s"] = sum(stage["wall_s"] for stage in timings.values())
    return timings


def _longform_tracks(seconds, sr, ref_seconds):
    """The JAX tool's long-form pair, built in chunks of ``LONGFORM_CHUNK`` rows:
    the envelope and the noise's scaling on host threads (numpy releases
    the interpreter lock), the noise drawn in order on this one, so the
    arrays are those of the JAX tool's whole-track form."""
    rng = np.random.RandomState(3)
    n = int(seconds * sr)
    target = np.empty((n, 2), np.float32)
    bounds = [(start, min(n, start + LONGFORM_CHUNK)) for start in range(0, n, LONGFORM_CHUNK)]

    def envelope(start, stop):
        t = np.arange(start, stop, dtype=np.float64) / sr
        env = (0.6 + 0.4 * np.sin(2 * np.pi * t * 0.05) ** 2).astype(np.float32)
        target[start:stop] = (env * 0.4)[:, None]

    def add_noise(start, stop, noise):
        target[start:stop] += (0.05 * noise).astype(np.float32)

    workers = max(1, min(8, os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        for done in [pool.submit(envelope, *b) for b in bounds]:
            done.result()
        pending = []
        for start, stop in bounds:
            pending.append(pool.submit(add_noise, start, stop, rng.randn(stop - start, 2)))
            if len(pending) > workers:  # bound the noise chunks held in memory
                pending.pop(0).result()
        for done in pending:
            done.result()
    n_ref = int(ref_seconds * sr)
    t_ref = np.arange(n_ref) / sr
    reference = np.stack(
        [(0.7 * np.sign(np.sin(2 * np.pi * 98 * t_ref))).astype(np.float32)] * 2,
        axis=1,
    )
    reference += (0.05 * rng.randn(n_ref, 2)).astype(np.float32)
    return target, reference


def bench_longform(minutes=60, sr=96000, ref_seconds=180, *, device=None):
    """The 60-min 96 kHz master through ``stages.master`` against a 180 s
    reference (analysis needs only the reference's loudest pieces), both
    built on the host (see the module's docstring for the memory) and
    staged through page-locked memory, the staging timed apart from the
    runs: a first run, a warm run on the target x 1.01, then the target
    quantised to int16, mastered from its raw codes (converted on the
    device) and from their float32 copy; the two must agree bit for bit.
    ``master`` does not donate its inputs, so the reference is staged
    once."""
    device = resolve_device(device)
    config = mt.Config(internal_sample_rate=sr, max_length=2 * 3600)
    seconds = minutes * 60
    t0 = time.perf_counter()
    target, reference = _longform_tracks(seconds, sr, ref_seconds)
    build_s = time.perf_counter() - t0

    def stage(arr):
        t0 = time.perf_counter()
        dev = to_device(arr, device)
        synchronize(device)
        return dev, time.perf_counter() - t0

    def run(t_in, r_in):
        t0 = time.perf_counter()
        out = mt.master(t_in, r_in, config, need_default=True, device=device)
        checksum = torch.sum(torch.abs(out.result[:: 1 << 10])).item()
        return checksum, time.perf_counter() - t0, out.result

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_dev, h2d_t = stage(target)
    r_dev, h2d_r = stage(reference)
    checksum, first_s, _ = run(t_dev, r_dev)
    # a distinct warm-run input (x1.01), as in the JAX tool
    np.multiply(target, 1.01, out=target)
    t_dev, _ = stage(target)
    checksum, warm_s, _ = run(t_dev, r_dev)
    del t_dev

    # int16 staging: the target quantised to int16, mastered from the raw
    # codes (half the bytes to the device) and from the float32 of the
    # same codes; the graph converts integers with the same full scale
    np.clip(target, -0.999969, 0.999969, out=target)  # int16 headroom
    np.multiply(target, 32768.0, out=target)
    np.rint(target, out=target)
    np.clip(target, -32768, 32767, out=target)
    t_i16 = target.astype(np.int16)
    del target
    t_dev_int, h2d_int = stage(t_i16)
    checksum_int, int_run_s, result_int = run(t_dev_int, r_dev)
    del t_dev_int
    t_f32 = t_i16.astype(np.float32)
    del t_i16
    t_f32 /= 32768.0
    t_dev_f, h2d_f = stage(t_f32)
    del t_f32
    checksum_f, float_run_s, result_f = run(t_dev_f, r_dev)
    results_equal = bool(torch.equal(result_int, result_f))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {
        "minutes_audio": minutes,
        "sample_rate": sr,
        "reference_seconds": ref_seconds,
        "host_build_s": build_s,
        "h2d_staging_s": h2d_t + h2d_r,
        "first_run_s": first_s,
        "warm_run_s": warm_s,
        "realtime_factor_warm": seconds / warm_s,
        "checksum": checksum,
        "peak_device_memory_bytes": peak,
        "int16_staging": {
            "h2d_int16_s": h2d_int,
            "h2d_float32_s": h2d_f,
            "h2d_speedup": h2d_f / h2d_int,
            "run_int16_s": int_run_s,
            "run_float32_s": float_run_s,
            "checksum_int16": checksum_int,
            "checksum_float32": checksum_f,
            "bit_identical": checksum_int == checksum_f,
            "results_equal": results_equal,
        },
    }


def _load_artifact(path):
    """Existing artifact to merge into; tolerate a missing or corrupt file
    (e.g. a previous run killed mid-write)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--longform", action="store_true")
    parser.add_argument(
        "--longform-only",
        action="store_true",
        help="run only the long-form bench (merged into --out where given)",
    )
    parser.add_argument("--out", default=None, help="also write the sections to this JSON file")
    parser.add_argument("--skip-sweep", action="store_true")
    parser.add_argument("--device", default=None, help="cuda unless named; no CPU fallback")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    config = mt.Config()

    artifact = {}

    def section(key, value):
        artifact[key] = value
        print(json.dumps({key: value}), flush=True)

    section("device", device_info(device))
    if not args.longform_only:
        section("single_pair_180s_44k", bench_single(config, SECONDS, SR, device=device))
        section("per_stage_180s_44k", bench_stages(config, SECONDS, SR, device=device))
        if not args.skip_sweep:
            section("batch_sweep_180s_44k", bench_batch_sweep(config, SECONDS, SR, device=device))
    if args.longform or args.longform_only:
        section("longform_60min_96k", bench_longform(device=device))

    if args.out:
        merged = {**_load_artifact(args.out), **artifact}
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
