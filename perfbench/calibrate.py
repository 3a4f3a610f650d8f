"""The readings a cell's limits are set from: the numbers its check
compares, for sound runs of the program and for the control, over many
seeds in one process, on the card, at the cell's own size.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6

For each seed the cell's own entry makes the inputs, drives the compared
calls through the timed call (``entry.call``) and runs the cell's check
(``entry.compare``); no window is timed.  The control is the program with
its float32 matmuls (the smoothing operators) in TF32: the next
precision down from what the configurations state.  One JSON line per
(seed, kind) on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time


def to_tf32(x):
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away
    from zero), as a tensor core reads its inputs."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def tf32_on(torch):
    """The port's float32 matmuls in TF32: each float32 ``@`` reads its
    operands at TF32's precision and accumulates in float32, as a TF32
    tensor core does.  TF32 switched on in torch is not enough: cuBLAS
    runs the smoothing products (two rows) without tensor cores, so no
    bit changes."""
    matmul = torch.Tensor.__matmul__

    def matmul_tf32(a, b):
        if a.dtype == torch.float32 and getattr(b, "dtype", None) == torch.float32:
            return matmul(to_tf32(a), to_tf32(b))
        return matmul(a, b)

    torch.Tensor.__matmul__ = matmul_tf32
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = matmul


def readings(cell, seed: int, control: bool, device: str) -> dict:
    """One seed's compared numbers, sound or under the control."""
    import torch

    import matchering_tpu_torch as mt
    from perfbench import harness

    entry = cell.entry()
    workdir = tempfile.mkdtemp(prefix="perfbench-calibrate-")
    ctx = harness.Context(cell, seed, torch.device(device), workdir, False, mt, torch)
    start = time.perf_counter()
    try:
        with tf32_on(torch) if control else contextlib.nullcontext():
            state = entry.prepare(ctx)
            indices = entry.compared_indices(state)
            for index in range(max(indices) + 1):
                if index in indices:
                    entry.call(ctx, state, index)
        entry.release(ctx, state)
        checks = entry.compare(ctx, state, [None] * (max(indices) + 1))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {
        "workload": cell.name, "seed": seed, "kind": "control" if control else "sound",
        "checks": {c["name"]: c["value"] for c in checks},
        "seconds": time.perf_counter() - start,
    }


def main(argv=None) -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from perfbench import harness

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = harness.Cell.load(args.workload)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        harness.say("calibrate needs a CUDA device")
        return 2
    torch.set_num_threads(harness.TORCH_THREADS)
    for kind, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            print(json.dumps(readings(cell, seed, kind, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
