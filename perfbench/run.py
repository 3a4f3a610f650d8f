"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit).
Standard error ends with the same numbers, one line each.  The run needs
as many CUDA devices as the cell asks for: without them it prints no
result and exits with 2; it exits with 3 where JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    clock = time.perf_counter()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.join(root, "perfbench")]
    from perfbench import harness

    started = clock - harness.process_age()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = harness.Cell.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.say(f"{args.workload} needs {cell.chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            device="cuda", started=started, cell=cell)
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
