"""Benchmark of the PyTorch port: full-chain mastering throughput on one card
(the twin of ``bench.py``).

    python3 bench_torch.py [--pairs 16] [--seconds 180] [--reps 3] [--device cuda]

Prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline"}, with ``bench.py``'s keys and meaning, and one JSON line of
rows on stderr (``bench.py``'s rows, the card's ``nvidia-smi`` name and
power limit, the torch and CUDA versions, the TF32 flags and the peak
device memory of the timed region).  It writes no file.

The workload is ``bench.py``'s: sixteen distinct 180 s stereo 44.1 kHz
target/reference pairs (seeds 42-57) through the complete chain (level
match, FIR EQ by overlap-save FFT convolution, 4-step RMS correction, the
limiter on the K1 and K2 kernels), staged on the card once, outside any
timed region, through page-locked memory.  A round enqueues one
``master_graph`` per pair, each perturbed by a 0-d scalar made on the card
once per rep (so no two reps compute the same thing), sums the 16
checksums on the card and fetches that one scalar.  The metric is
throughput (audio seconds mastered per wall second), the median of 3
timed rounds; ``vs_baseline`` is against the 50x realtime per chip of
``BASELINE.json``'s north star.

With no flags it runs on the card and does exactly ``bench.py``'s work;
the flags let the work shrink (``--device cpu`` runs the kernels' plain
versions, for tests).  Without ``--device`` it raises when no card is
present.  The kernels build at their first launch; there is no compile
cache (``bench.py``'s ``enable_compile_cache`` acts on XLA).  It imports
numpy, torch and ``matchering_tpu_torch``, nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import matchering_tpu_torch as mt
from matchering_tpu_torch.ops import smoothing
from matchering_tpu_torch.utils import resolve_device, to_device

B = 16  # pairs per timed dispatch round
REPS = 3
SECONDS = 180
SR = 44100
FIRST_SEED = 42
BASELINE = 50.0  # BASELINE.json's north star: 50x realtime per chip


def make_pair(seconds: int, sr: int, seed: int):
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


def make_pairs(count: int, seconds: int, sr: int = SR, first_seed: int = FIRST_SEED):
    """``make_pair`` of seeds ``first_seed`` to ``first_seed + count - 1``,
    built on host threads (numpy's arrays and generators release the
    interpreter lock; each pair has its own generator, so the arrays are
    those of a loop)."""
    with ThreadPoolExecutor(max(1, min(count, os.cpu_count() or 1))) as pool:
        return list(pool.map(lambda seed: make_pair(seconds, sr, seed),
                             range(first_seed, first_seed + count)))


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device) -> dict:
    """What ran the numbers: the card's ``nvidia-smi`` name and power
    limit (None off a card), the torch and CUDA versions, the TF32 flags."""
    card = None
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    return {
        "device": str(device),
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }


class Bench:
    """``bench.py``'s pairs staged on ``device`` (``cuda`` unless named),
    with its graph, its rounds and its single pair."""

    def __init__(self, host_pairs, seconds: int, *, device=None):
        self.device = resolve_device(device)
        self.seconds = seconds
        self.config = mt.Config()
        # the staged operators of the config, as production entry points
        # run them (the it=0 LOWESS folded in), passed into every graph
        self.interp_ops = smoothing.operator_arrays_for_config(self.config, device=self.device)
        self.staged = [(to_device(t, self.device), to_device(r, self.device)) for t, r in host_pairs]
        synchronize(self.device)

    def graph(self, target, reference, s):
        """One pair's master, perturbed by the 0-d scalar ``s``, reduced
        to a 0-d checksum on the device."""
        out = mt.master_graph(
            target * (1.0 + 1e-7 * s), reference, self.config,
            need_default=True, interp_ops=self.interp_ops,
        )
        return torch.sum(torch.abs(out.result))

    def scale(self, rep):
        """The rep's perturbation, filled on the device (no copy from the
        host, no sync)."""
        return torch.full((), float(rep), dtype=torch.float32, device=self.device)

    def enqueue(self, s):
        """Every pair's graph: the checksums, not yet waited for."""
        return [self.graph(t, r, s) for t, r in self.staged]

    def run(self, rep) -> float:
        """One round: one device-side sum of the checksums, one fetch."""
        return torch.stack(self.enqueue(self.scale(rep))).sum().item()

    def run_perpair(self, rep):
        """The same round, each pair's checksum fetched on its own."""
        return [h.item() for h in self.enqueue(self.scale(rep))]

    def single(self, rep) -> float:
        """The first pair alone, its checksum fetched."""
        target, reference = self.staged[0]
        return self.graph(target, reference, self.scale(rep)).item()


def _timed(fn) -> float:
    start = time.perf_counter()
    fn()
    return time.perf_counter() - start


def measure(bench: Bench, reps: int = REPS):
    """``bench.py``'s timing: one warm round of each kind, then ``reps``
    timed rounds of each and ``reps`` single pairs, each ending in its
    fetch.  Returns (throughput in audio seconds per second, rows)."""
    bench.run(0)
    bench.run_perpair(100)
    if bench.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(bench.device)
    times = [_timed(lambda: bench.run(rep)) for rep in range(1, reps + 1)]
    perpair_times = [_timed(lambda: bench.run_perpair(200 + rep)) for rep in range(1, reps + 1)]
    single_times = [_timed(lambda: bench.single(300.0 + rep)) for rep in range(1, reps + 1)]
    peak = torch.cuda.max_memory_allocated(bench.device) if bench.device.type == "cuda" else None

    pairs, seconds = len(bench.staged), bench.seconds
    median = sorted(times)[len(times) // 2]
    perpair_median = sorted(perpair_times)[len(perpair_times) // 2]
    single = sorted(single_times)[len(single_times) // 2]
    throughput = pairs * seconds / median
    rows = {
        f"pipelined_B{pairs}": {
            "times_s": times,
            "median_s": median,
            "audio_sec_per_s": throughput,
            "pairs_per_s": pairs / median,
        },
        f"pipelined_B{pairs}_perpair_fetch": {
            "times_s": perpair_times,
            "median_s": perpair_median,
            "audio_sec_per_s": pairs * seconds / perpair_median,
            "pairs_per_s": pairs / perpair_median,
            "note": "same work, one checksum fetched per pair: each fetch waits "
            "on the host for the pair just enqueued, so the launch queue stalls "
            "behind every pair",
        },
        "single_pair": {
            "times_s": single_times,
            "median_wall_s": single,
            "realtime_factor": seconds / single,
        },
        "workload": {"seconds": seconds, "sample_rate": SR, "pairs": pairs},
        "peak_device_memory_bytes": peak,
    }
    return throughput, rows


def result_line(throughput: float, pairs: int) -> dict:
    """``bench.py``'s stdout line."""
    value = round(throughput, 2)
    return {
        "metric": f"full-chain mastering throughput (1 chip, {pairs}-pair pipelined)",
        "value": value,
        "unit": "audio-sec/sec",
        "vs_baseline": round(value / BASELINE, 3),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda unless named; no CPU fallback")
    parser.add_argument("--pairs", type=int, default=B)
    parser.add_argument("--seconds", type=int, default=SECONDS)
    parser.add_argument("--reps", type=int, default=REPS)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    bench = Bench(make_pairs(args.pairs, args.seconds), args.seconds, device=device)
    throughput, rows = measure(bench, args.reps)
    rows["device"] = device_info(bench.device)
    print(json.dumps(rows), file=sys.stderr, flush=True)
    print(json.dumps(result_line(throughput, args.pairs)), flush=True)


if __name__ == "__main__":
    main()
