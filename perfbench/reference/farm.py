"""Plain float64 batch mastering: each pair of a batch mastered alone at
its true length by :func:`matchering.master`, then zero-padded to the
batch's bucket.

What a length-aware batch master must give: row i equals the master of
unpadded pair i, and every sample past the target's true length is 0.
Independent of the program under test, as ``matchering.py`` is.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .matchering import master


def bucket_length(lengths: Sequence[int], multiple: int) -> int:
    """The longest length rounded up to a multiple of ``multiple``."""
    return -(-max(lengths) // multiple) * multiple


def master_rows(targets: Sequence[np.ndarray], references: Sequence[np.ndarray], overrides: Dict,
                n_pad: int) -> np.ndarray:
    """(B, n_pad, 2) float64: the master of each unpadded (target,
    reference) pair, zero past the target's length."""
    if len(targets) != len(references):
        raise ValueError("targets and references differ in count")
    out = np.zeros((len(targets), n_pad, 2))
    for row, (target, reference) in zip(out, zip(targets, references)):
        if target.shape[0] > n_pad:
            raise ValueError(f"a target of {target.shape[0]} samples does not fit a bucket of {n_pad}")
        row[: target.shape[0]] = master(target, reference, overrides)
    return out
