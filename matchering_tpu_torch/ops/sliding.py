"""Sliding-window maxima (PyTorch).

Counterpart of ``matchering_tpu.ops.sliding`` (reference
``scipy.ndimage.maximum_filter1d`` in ``matchering/limiter/hyrax.py:32-40``):

* ``max_filter1d`` reproduces ndimage exactly — window
  ``[i - size//2, i + size - size//2 - 1]`` and 'reflect' edges, which
  duplicate the edge sample (numpy's ``symmetric``; ``F.pad``'s 'reflect'
  does not, so the mirrored edges are built with ``flip`` and ``cat``);
* ``sliding_max_attack`` / ``sliding_max_hold`` are the limiter's two
  window modes (centred odd window; causal left-zero-padded window).

The max over a window is built by shift doubling: ceil(log2(window))
full-length ``torch.maximum`` passes.
"""

from __future__ import annotations

import torch

from ..utils import make_odd


def _start_max(padded: torch.Tensor, window: int) -> torch.Tensor:
    """max over padded[j : j + window] for every valid start j
    (length len(padded) - window + 1)."""
    out = padded
    span = 1
    while span < window:
        step = min(span, window - span)
        cur = out.shape[0]
        out = torch.maximum(out[: cur - step], out[step:])
        span += step
    return out


def max_filter1d(array: torch.Tensor, size: int) -> torch.Tensor:
    """``scipy.ndimage.maximum_filter1d(array, size, mode='reflect')``."""
    left = size // 2
    right = size - left - 1
    head = torch.flip(array[:left], (0,))
    tail = torch.flip(array[array.shape[0] - right :], (0,))
    return _start_max(torch.cat([head, array, tail]), size)


def sliding_max_attack(array: torch.Tensor, window_size: int) -> torch.Tensor:
    """Centred sliding max of the attack stage (reference
    ``hyrax.py:35-37``): odd window of ``2*make_odd(window_size) - 1`` with
    reflect edges."""
    return max_filter1d(array, 2 * make_odd(window_size) - 1)


def sliding_max_hold(array: torch.Tensor, window_size: int) -> torch.Tensor:
    """Causal sliding max of the hold stage (reference ``hyrax.py:38-40``):
    max over the trailing window ``[i - (window_size + half) + 1, i]`` with
    zeros before sample 0, ``half = (window_size - 1) // 2``.  (The
    reference's zero pad plus ndimage's left edge reduce to one zero pad;
    gain envelopes are non-negative, so that is exact.)"""
    half = (window_size - 1) // 2
    left = window_size // 2
    pad_left = torch.zeros(half + left, dtype=array.dtype, device=array.device)
    return _start_max(torch.cat([pad_left, array]), window_size)
