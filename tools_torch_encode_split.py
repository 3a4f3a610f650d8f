#!/usr/bin/env python3
"""Time the parts of a song's WAV export on the card's host, old path and new.

    python3 tools_torch_encode_split.py [--seconds 270] [--repeats 9]

Run from the repository root on a machine with a CUDA card and g++.  For
a float32 stereo result of ``--seconds`` at 44.1 kHz on the card it times,
in turns, ``--repeats`` times each (warm: two untimed rounds first):

- ``native``: the float32 result's copy into page-locked memory
  (``utils.to_host``) and the native writer (``binding.write_wav``, PCM_16);
- ``native_split``: the same writer's steps, compiled here from a copy of
  its PCM_16 loop with a clock between them: the output vector's
  ``reserve`` and header, its ``resize`` (the zero-fill, which also takes
  the page faults), the quantise loop, and ``fopen``/``fwrite``/``fclose``;
- ``direct``: ``io.saver.save`` on the tensor (the quantise on the card,
  the codes' copy into page-locked memory, one gathered write).

Each runs after each of two ingests of a PCM_16 file of the same length,
so the heap the encode allocates from is the one a ``process()`` call
leaves: ``direct_read`` (``io.loader.load_staged``, one ``readinto`` into
a page-locked block) and ``decoded_read`` (``wav.read(raw_int=True)``
and a writable copy, the decode before the direct read).  Each result is
written to a link to ``/dev/null`` (what the benchmark's song cell does
for most calls) and to a file under the system's temporary folder.  The
script prints one JSON line: the card's name and power limit, and per
way, ingest and destination the median ms of each part and the minor page
faults of the process over the encode (``getrusage``).
"""

import argparse
import ctypes
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 44100

SPLIT_SOURCE = r"""
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

static double Now() {
  return std::chrono::duration<double, std::milli>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
}

static double ClipRound(double x, double lo, double hi) {
  double r = std::nearbyint(x);
  return r < lo ? lo : (r > hi ? hi : r);
}

// The native writer's PCM_16 path (io/native/codec.cpp, WriteWav) from
// float32 samples, with the time of each step in ms[0..3].
extern "C" int split_write_pcm16(const char* path, const float* data, long long frames,
                                 int channels, int rate, double* ms) {
  double t0 = Now();
  long long count = frames * channels;
  long long payload_bytes = count * 2;
  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(payload_bytes) + 64);
  out.resize(44);
  std::memcpy(out.data(), "RIFF\0\0\0\0WAVEfmt ", 16);
  double t1 = Now();
  size_t base = out.size();
  out.resize(base + static_cast<size_t>(payload_bytes));
  uint8_t* p = out.data() + base;
  double t2 = Now();
  for (long long i = 0; i < count; ++i) {
    int16_t v = static_cast<int16_t>(ClipRound(static_cast<double>(data[i]) * 32768.0, -32768.0, 32767.0));
    std::memcpy(p + 2 * i, &v, 2);
  }
  double t3 = Now();
  FILE* f = std::fopen(path, "wb");
  if (!f) return 10;
  size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  double t4 = Now();
  ms[0] = t1 - t0;
  ms[1] = t2 - t1;
  ms[2] = t3 - t2;
  ms[3] = t4 - t3;
  return wrote == out.size() ? 0 : 11;
}
"""
SPLIT_PARTS = ("reserve_ms", "zero_fill_ms", "quantise_ms", "write_ms")


def build_split(folder: str) -> ctypes.CDLL:
    source, library = os.path.join(folder, "split.cpp"), os.path.join(folder, "split.so")
    with open(source, "w") as f:
        f.write(SPLIT_SOURCE)
    subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", source, "-o", library],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(library)
    lib.split_write_pcm16.restype = ctypes.c_int
    lib.split_write_pcm16.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
    return lib


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seconds", type=float, default=270)
    parser.add_argument("--repeats", type=int, default=9)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from matchering_tpu_torch.io import loader, saver, wav
    from matchering_tpu_torch.io.native import binding
    from matchering_tpu_torch.utils import to_host

    if not binding.available():
        sys.exit("the native codec is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    frames = int(args.seconds * SR)
    rng = np.random.default_rng(0)
    samples = np.clip(rng.normal(0, 0.3, (frames, 2)), -1.2, 1.2).astype(np.float32)
    result = torch.from_numpy(samples).cuda()

    with tempfile.TemporaryDirectory(prefix="encode_split_") as tmp:
        lib = build_split(tmp)
        source = os.path.join(tmp, "in.wav")
        wav.write(source, samples, SR, "PCM_16")
        sinks = {"devnull": os.path.join(tmp, "null.wav"), "file": os.path.join(tmp, "out.wav")}
        os.symlink(os.devnull, sinks["devnull"])
        ingests = {
            "direct_read": lambda: loader.load_staged(source, "target", tmp, device="cuda"),
            "decoded_read": lambda: np.require(wav.read(source, raw_int=True)[0], requirements=["C", "W"]),
        }

        def native(path):
            binding.write_wav(path, to_host(result), SR, "PCM_16")
            return {}

        def native_split(path):
            host = to_host(result)
            ms = (ctypes.c_double * 4)()
            rc = lib.split_write_pcm16(path.encode(), host.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                       frames, 2, SR, ms)
            if rc:
                sys.exit(f"the split writer failed (rc={rc})")
            return dict(zip(SPLIT_PARTS, ms))

        def direct(path):
            saver.save(path, result, SR, "PCM_16")
            return {}

        ways = {"native": native, "native_split": native_split, "direct": direct}
        cases = [(w, i, s) for w in ways for i in ingests for s in sinks]
        times = {case: [] for case in cases}
        for round_ in range(2 + args.repeats):
            for way, ingest, sink in cases:
                held = ingests[ingest]()
                torch.cuda.synchronize()
                faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
                begin = time.perf_counter()
                parts = ways[way](sinks[sink])
                parts["total_ms"] = 1e3 * (time.perf_counter() - begin)
                parts["minor_faults"] = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - faults
                del held
                if round_ >= 2:
                    times[(way, ingest, sink)].append(parts)
        with open(sinks["file"], "rb") as f:
            direct_bytes = f.read()
        native(sinks["file"])
        with open(sinks["file"], "rb") as f:
            same = f.read() == direct_bytes
    report = {"card": smi.stdout.strip(), "torch": torch.__version__, "frames": frames,
              "repeats": args.repeats, "direct_equals_native": same}
    for (way, ingest, sink), runs in times.items():
        report[f"{way}.{ingest}.{sink}"] = {
            key: statistics.median(run[key] for run in runs) for key in runs[0]
        }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
