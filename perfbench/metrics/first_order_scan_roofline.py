"""The first-order IIR scans (the attack smoother forward and back, and
the hold and release low-passes where their order is 1) against their
byte bound, in %.  Work per call on a target of n samples: each scan
reads its n values once and writes n values once; time: the kernels named
in ``first_order_scan_roofline/kernels/``."""

from perfbench import arithmetic


def read(run):
    limiter = run.cell.config["parameters"].get("limiter", {})
    scans = 2 + sum(limiter.get(key, 1) == 1 for key in ("hold_filter_order", "release_filter_order"))
    return arithmetic.roofline(run, __file__, values_per_sample=2 * scans)
