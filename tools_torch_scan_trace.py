#!/usr/bin/env python3
"""Trace and tile variants of the port's K2 scan kernel on one NVIDIA card.

    python3 tools_torch_scan_trace.py [--n 7938000]

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA.  It writes text-substituted copies of
``matchering_tpu_torch/csrc/scan.cu`` into ``matchering_tpu_torch/_build/
scan_trace/`` (git-ignored), builds them all at once with the port's nvcc
flags, and on a float32 row of n samples at the limiter's release pole:

1. times each variant's kernel alone (the profiler, 20 launches) and a
   call (CUDA events over 20 back-to-back calls, the zeroing of the status
   array included), and holds its output to one float32 ulp at 1.0 against
   the plain twin, except ``no_lookback``, which drops the carry between
   tiles (its output is wrong; its time is the kernel without the wait):

   - ``design``: the kernel as it stands;
   - ``no_lookback``: carry = 0 in place of the look-back;
   - ``run8``: 8 samples per thread, 2048-sample tiles;
   - ``threads512``: 512 threads per block, 8192-sample tiles (float32
     only: its float64 tile does not fit static shared memory);

2. runs a copy of ``design`` in which thread 0 of each block stamps
   ``%globaltimer`` as the block takes its tile, after the tile's load,
   after its runs are scanned, once its carry is known (the look-back) and
   after its store, with its SM and its look-back steps (32 tiles a step),
   and prints per-phase times, the look-back steps, and the share of the
   kernel's span in which any block loads or stores (device memory busy)
   or waits on its look-back.

Prints one JSON line per variant and one for the trace.  It imports
nothing of JAX or ``matchering_tpu``.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 2.0**-23
WORDS = 8  # stamp words per tile: 5 times, SM, look-back steps, unused
MAX_TILES = 1 << 14

_STAMP = (
    "  if (tid == 0) {{ unsigned long long t; "
    'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); '
    "g_stamps[tile_id * {words} + {k}] = t; }}\n"
)


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"scan.cu no longer holds exactly one {old!r}")
    return text.replace(old, new)


def variant_sources(source: str) -> dict:
    """name -> the text of a variant of scan.cu."""
    out = {"design": source}
    out["no_lookback"] = _replace(
        source,
        "      carry = look_back(aggregates, prefixes, row_base, b, pw, lane);\n",
        "      carry = 0.0;\n",
    )
    # other tilings change the resident blocks the design asserts
    retiled = _replace(
        source,
        "static_assert(min_blocks(sizeof(float)) == 8 && min_blocks(sizeof(double)) == 6,\n"
        '              "resident blocks per SM");\n',
        "",
    )
    out["run8"] = _replace(retiled, "constexpr int kRun = 16;", "constexpr int kRun = 8;")
    wide = _replace(retiled, "constexpr int kTileLog = 8;", "constexpr int kTileLog = 9;")
    wide = _replace(
        wide,
        "(kTile + kThreads) * sizeof(double) <= 48",
        "(kTile + kThreads) * sizeof(float) <= 48",
    )
    start = wide.index("int mtpu_scan_f64(")
    body = wide.index("{\n", start)
    end = wide.index("\n}\n", body)
    unsupported = "  return static_cast<int>(cudaErrorNotSupported);"
    out["threads512"] = wide[: body + 2] + unsupported + wide[end:]

    traced = _replace(
        source,
        "namespace {\n",
        f"namespace {{\n\n__device__ unsigned long long g_stamps[{MAX_TILES * WORDS}];\n",
    )
    stamp = lambda k: _STAMP.format(words=WORDS, k=k)  # noqa: E731
    taken = "atomicAdd(counter, 1ULL));\n  __syncthreads();\n"
    traced = _replace(
        traced,
        taken,
        taken
        + stamp(0)
        + '  if (tid == 0) { unsigned sm; asm volatile("mov.u32 %0, %%smid;" : "=r"(sm)); '
        f"g_stamps[tile_id * {WORDS} + 5] = sm; g_stamps[tile_id * {WORDS} + 6] = 0; }}\n",
    )
    loaded = "v; });\n  __syncthreads();\n"
    traced = _replace(traced, loaded, loaded + stamp(1))
    traced = _replace(
        traced,
        "  if (lane == 31) warp_state[warp] = inclusive;\n  __syncthreads();\n",
        "  if (lane == 31) warp_state[warp] = inclusive;\n  __syncthreads();\n" + stamp(2),
    )
    traced = _replace(
        traced,
        "* carry;\n  }\n  __syncthreads();\n",
        "* carry;\n  }\n  __syncthreads();\n" + stamp(3),
    )
    traced = _replace(
        traced,
        "[&](int m) { return buf[slot(reverse ? len - 1 - m : m)]; });\n}\n",
        "[&](int m) { return buf[slot(reverse ? len - 1 - m : m)]; });\n  __syncthreads();\n"
        + stamp(4)
        + "}\n",
    )
    traced = _replace(
        traced,
        "    if (stops) return carry;\n",
        "    if (stops) {\n"
        f"      if (lane == 0) g_stamps[(row_base + b) * {WORDS} + 6] = (b - 1 - last) / 32 + 1;\n"
        "      return carry;\n    }\n",
    )
    traced = _replace(
        traced,
        'extern "C" {\n',
        'extern "C" {\n\n'
        "int mtpu_trace_copy(void* dst, long long words) {\n"
        "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, words * 8));\n}\n",
    )
    out["design_traced"] = traced
    return out


def build_all(sources: dict, nvcc: str, flags, csrc: str, directory: str) -> dict:
    """Compile every variant at once; name -> path of its shared library."""
    os.makedirs(directory, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = os.path.join(directory, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(directory, f"{name}.so")
        cmd = [nvcc, *flags, "-I", csrc, "-shared", path, "-o", lib]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err.decode(errors='replace')}")
        libs[name] = lib
    return libs


def phase_shares(stamps: np.ndarray, bins: int = 2000) -> dict:
    """Share of the span from the first block's start to the last block's
    store in which at least one block is in each phase."""
    edges = np.linspace(stamps[:, 0].min(), stamps[:, 4].max(), bins + 1)
    mids = (edges[:-1] + edges[1:]) / 2

    def busy(a, b):
        hit = np.zeros(bins, bool)
        for lo, hi in zip(stamps[:, a], stamps[:, b]):
            hit[(mids >= lo) & (mids < hi)] = True
        return hit

    load, store = busy(0, 1), busy(3, 4)
    return {
        "load": float(load.mean()), "scan": float(busy(1, 2).mean()),
        "look_back": float(busy(2, 3).mean()), "rescan_store": float(store.mean()),
        "load_or_rescan_store": float((load | store).mean()),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=180 * 44100)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools_torch_scan_trace: no CUDA device is available")
    sys.path.insert(0, HERE)
    import matchering_tpu_torch as mt
    from matchering_tpu_torch.kernels import build, scan
    from matchering_tpu_torch.ops import iir

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with open(os.path.join(build.CSRC, "scan.cu")) as f:
        sources = variant_sources(f.read())
    libs = build_all(
        sources, build._nvcc(), build.NVCC_FLAGS, build.CSRC,
        os.path.join(build.BUILD_DIR, "scan_trace"),
    )

    device = torch.device("cuda", 0)
    config = mt.Config()
    filt = iir.butter1_coefficients(
        config.limiter.release_filter_coefficient / config.limiter.release, 44100
    )
    n = args.n
    rng = np.random.RandomState(20260)
    x = torch.from_numpy(rng.rand(n).astype(np.float32)).to(device)
    zi = torch.tensor([0.3], dtype=torch.float64, device=device)
    want = scan.first_order_filter_plain(x, *filt, zi=zi).double()
    stream = torch.cuda.current_stream(device).cuda_stream

    def entry(path):
        lib = ctypes.CDLL(path)
        fn = lib.mtpu_scan_f32
        fn.restype, fn.argtypes = build._SIGNATURES["mtpu_scan_f32"]
        run, tile, count = lib.mtpu_scan_run(), lib.mtpu_scan_tile(), lib.mtpu_scan_powers()
        powers = (ctypes.c_double * count)(*[filt.pole ** (run << k) for k in range(count)])
        y = torch.empty_like(x)

        def call():
            scratch = torch.zeros(2 * -(-n // tile) + 1, dtype=torch.int64, device=device)
            status = fn(
                x.data_ptr(), y.data_ptr(), zi.data_ptr(), 1, n, filt.b0, filt.b1, filt.a1, 0,
                ctypes.addressof(powers), scratch.data_ptr(), stream,
            )
            build.check(status, path)
            return y

        return lib, tile, call

    def kernel_ms(call, reps=20):
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if "scan_kernel" in e.key and e.count]
        return sum(e.self_device_time_total for e in events) / 1e3 / sum(e.count for e in events)

    def call_ms(call, reps=20):
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    failed = []
    for name, path in libs.items():
        lib, tile, call = entry(path)
        err = float((call().double() - want).abs().max())
        torch.cuda.synchronize()
        checked = name != "no_lookback"
        if checked and not err <= TOL:
            failed.append(name)
        row = {
            "variant": name, "tile": tile, "n": n, "kernel_ms": kernel_ms(call),
            "call_ms": call_ms(call), "max_abs_err": err, "checked": checked,
        }
        if name == "design_traced":
            tiles = -(-n // tile)
            if tiles > MAX_TILES:
                sys.exit(f"tools_torch_scan_trace: {tiles} tiles exceed the trace's {MAX_TILES}")
            call()
            torch.cuda.synchronize()
            raw = np.zeros(tiles * WORDS, np.uint64)
            fn = lib.mtpu_trace_copy
            fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p, ctypes.c_longlong]
            build.check(fn(raw.ctypes.data, raw.size), "trace copy")
            table = raw.reshape(tiles, WORDS)
            stamps = (table[:, :5] - table[:, 0].min()).astype(np.float64) / 1e3  # us
            steps = table[:, 6].astype(np.int64)
            phases = np.diff(stamps, axis=1)
            names = ("load", "scan", "look_back", "rescan_store")
            counts = zip(*np.unique(steps, return_counts=True))
            row["trace"] = {
                "span_us": float(stamps[:, 4].max()),
                "phase_us_median": dict(zip(names, np.median(phases, 0).tolist())),
                "phase_us_p90": dict(zip(names, np.percentile(phases, 90, 0).tolist())),
                "busy_share": phase_shares(stamps),
                "look_back_steps": {str(k): int(v) for k, v in counts},
                "sms": int(len(np.unique(table[:, 5]))),
                "tiles": tiles,
            }
        print(json.dumps(row), flush=True)
    if failed:
        sys.exit(f"tools_torch_scan_trace: {failed} disagree with the plain twin beyond {TOL}")


if __name__ == "__main__":
    main()
