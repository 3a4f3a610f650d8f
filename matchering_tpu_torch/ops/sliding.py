"""Sliding-window maxima (PyTorch).

Counterpart of ``matchering_tpu.ops.sliding`` (reference
``scipy.ndimage.maximum_filter1d`` in ``matchering/limiter/hyrax.py:32-40``):

* ``max_filter1d`` reproduces ndimage exactly — window
  ``[i - size//2, i + size - size//2 - 1]`` and 'reflect' edges, which
  duplicate the edge sample (numpy's ``symmetric``; ``F.pad``'s 'reflect'
  does not, so the mirrored edges are built with ``flip`` and ``cat``);
* ``sliding_max_attack`` / ``sliding_max_hold`` are the limiter's two
  window modes (centred odd window; causal left-zero-padded window);
* ``sliding_max_attack_truncated`` is the centred window reflected at a
  track's true length: each row of a zero-padded batch at its own, or one
  track at one length as in the JAX package (then run as rows with that
  length).

Every function works along the last axis, so (n,) and (B, n) take the same
call.  The max over a window is built by shift doubling: ceil(log2(window))
full-length ``torch.maximum`` passes.
"""

from __future__ import annotations

from typing import Union

import torch

from ..utils import RowInts, host_int, make_odd, stage_host_arrays


def _start_max(padded: torch.Tensor, window: int) -> torch.Tensor:
    """max over padded[..., j : j + window] for every valid start j
    (length len(padded) - window + 1)."""
    out = padded
    span = 1
    while span < window:
        step = min(span, window - span)
        cur = out.shape[-1]
        out = torch.maximum(out[..., : cur - step], out[..., step:])
        span += step
    return out


@stage_host_arrays
def max_filter1d(array: torch.Tensor, size: int) -> torch.Tensor:
    """``scipy.ndimage.maximum_filter1d(array, size, mode='reflect')``."""
    left = size // 2
    right = size - left - 1
    head = torch.flip(array[..., :left], (-1,))
    tail = torch.flip(array[..., array.shape[-1] - right :], (-1,))
    return _start_max(torch.cat([head, array, tail], dim=-1), size)


@stage_host_arrays
def sliding_max_attack(array: torch.Tensor, window_size: int) -> torch.Tensor:
    """Centred sliding max of the attack stage (reference
    ``hyrax.py:35-37``): odd window of ``2*make_odd(window_size) - 1`` with
    reflect edges."""
    return max_filter1d(array, 2 * make_odd(window_size) - 1)


@stage_host_arrays
def sliding_max_attack_truncated(
    array: torch.Tensor, window_size: int, length: Union[RowInts, int, torch.Tensor]
) -> torch.Tensor:
    """:func:`sliding_max_attack` as if the track ended at its true length
    L ('reflect' at the exact track end, reference ``hyrax.py:35-37``): on
    [0, L) the output is ``sliding_max_attack(array[..., :L])``.  Every L
    must be at least the window, ``2 * make_odd(window_size) - 1``.

    ``length`` a ``RowInts`` (the port's form, one L per row of a (B, n)
    batch): the row is read through a mirror at L (index ``j >= L`` reads
    ``2L - j - 1``), and the output is 0 at and past L.  This is the plain
    twin of K1's length mode.

    ``length`` an int, a numpy int or a 0-d array or tensor (the JAX
    package's form, one L for a track (n,) or for every row; a tensor on a
    card is read back to the host once): the port's form with that L on
    every row, and past L what ``matchering_tpu.ops.sliding`` returns
    there, the max filter of the track as given (the caller zeroes it past
    L).  The JAX package recomputes the outputs before L from the
    ``2 * window`` samples before L, which is right only for L >= 2 *
    window; this form is right for every L it takes."""
    size = 2 * make_odd(window_size) - 1
    left = size // 2
    right = size - left - 1
    n = array.shape[-1]
    if not isinstance(length, RowInts):
        length = host_int(length)
        if not size <= length <= n:
            raise ValueError(f"length {length} is outside [{size}, {n}]")
        rows = array.reshape(-1, n)
        exact = sliding_max_attack_truncated(
            rows, window_size, RowInts.of([length] * rows.shape[0], array.device)
        ).reshape(array.shape)
        inside = torch.arange(n, device=array.device) < length
        return torch.where(inside, exact, max_filter1d(array, size))
    j = torch.arange(n + right, device=array.device)
    lengths_col = length.device[:, None]
    mirrored = torch.where(j < lengths_col, j, 2 * lengths_col - 1 - j).clamp(0, n - 1)
    extended = torch.gather(array, -1, mirrored)  # (B, n + right)
    head = torch.flip(array[..., :left], (-1,))
    out = _start_max(torch.cat([head, extended], dim=-1), size)
    return out * length.mask(n, out.dtype)


@stage_host_arrays
def sliding_max_hold(array: torch.Tensor, window_size: int) -> torch.Tensor:
    """Causal sliding max of the hold stage (reference ``hyrax.py:38-40``):
    max over the trailing window ``[i - (window_size + half) + 1, i]`` with
    zeros before sample 0, ``half = (window_size - 1) // 2``.  (The
    reference's zero pad plus ndimage's left edge reduce to one zero pad;
    gain envelopes are non-negative, so that is exact.)"""
    half = (window_size - 1) // 2
    left = window_size // 2
    pad_left = array.new_zeros(array.shape[:-1] + (half + left,))
    return _start_max(torch.cat([pad_left, array], dim=-1), window_size)
