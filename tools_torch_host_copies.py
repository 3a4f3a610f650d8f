#!/usr/bin/env python3
"""Time the port's host-device copies of one 180 s track on the card.

    python3 tools_torch_host_copies.py [--repeats 7]

Run from the repository root on a machine with a CUDA card.  For a 180 s
stereo track at 44.1 kHz (7,938,000 frames) it times, in turns, each way
the port could copy it:

- to the card, the int16 PCM as a decoded WAV holds it (a read-only
  buffer): from pageable memory (a writable copy, then ``.to``) and through
  page-locked memory (``utils.to_device``);
- back to the host, the float32 master: into fresh pageable memory
  (``.cpu().numpy()``) and into page-locked memory (``utils.to_host``).

Each copy is timed on the host clock up to a synchronised card, warm
(two untimed copies first), ``--repeats`` times; the script prints one JSON
line with the card's name and power limit, each way's times in ms and its
rate in GB/s at the median.  Nothing else of the package runs.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

FRAMES = 180 * 44100


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repeats", type=int, default=7)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from matchering_tpu_torch.utils import to_device, to_host

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    rng = np.random.RandomState(0)
    pcm = rng.randint(-(2**15), 2**15, (FRAMES, 2)).astype(np.int16)
    decoded = np.frombuffer(pcm.tobytes(), dtype=np.int16).reshape(FRAMES, 2)  # read-only, as wav.read
    master = torch.from_numpy(rng.uniform(-1, 1, (FRAMES, 2)).astype(np.float32)).cuda()

    ways = {
        "h2d_int16_pageable": lambda: torch.from_numpy(np.require(decoded, requirements=["C", "W"])).to("cuda"),
        "h2d_int16_pinned": lambda: to_device(decoded, "cuda"),
        "d2h_float32_pageable": lambda: master.cpu().numpy(),
        "d2h_float32_pinned": lambda: to_host(master),
    }
    times = {name: [] for name in ways}
    for fn in ways.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    for _ in range(args.repeats):
        for name, fn in ways.items():
            start = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - start))
            del out
    report = {"card": smi.stdout.strip(), "torch": torch.__version__, "frames": FRAMES, "repeats": args.repeats}
    for name, ms in times.items():
        nbytes = FRAMES * 2 * (2 if "int16" in name else 4)
        median = float(np.median(ms))
        report[name] = {"bytes": nbytes, "ms": ms, "median_ms": median, "gb_per_s": nbytes / median / 1e6}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
