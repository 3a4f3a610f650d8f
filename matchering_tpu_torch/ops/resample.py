"""Polyphase band-limited resampler (PyTorch).

Counterpart of ``matchering_tpu.ops.resample``, the replacement for
``resampy.resample`` (kaiser_best) in the reference's checker
(``matchering/checker.py:42``).  For integer rates the ratio is rational,
so there are only ``up = sr_out / gcd`` distinct filter phases: the host
walks resampy's table arithmetic once per phase into a dense weight matrix
(``plan_resample``, copied from the JAX package), and the device computes
each group of ``c * up`` outputs as one row of a single matrix product
between overlapping input windows and that matrix.

The product runs in float64 on every device (DGEMM on the H100's float64
tensor cores), so a track resampled on the card equals the CPU's to
rounding.  Rate pairs whose plan would not fit (``_PLAN_BYTES_CAP``) take
the host's windowed evaluation, ``_resample_windowed``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import stage_host_arrays
from .basics import to_working_float

# resampy's kaiser_best design constants
_NUM_ZEROS = 64
_PRECISION = 9
_ROLLOFF = 0.9475937167399596
_KAISER_BETA = 14.769656459379492


@functools.lru_cache(maxsize=4)
def _half_window() -> tuple[np.ndarray, np.ndarray]:
    """One-sided interpolation table and its forward differences
    (resampy ``filters.sinc_window`` with the kaiser_best parameters)."""
    num_bits = 2**_PRECISION
    n = num_bits * _NUM_ZEROS
    taps = np.arange(-n, n + 1) / num_bits
    sinc_win = _ROLLOFF * np.sinc(_ROLLOFF * taps)
    interp_win = (np.kaiser(2 * n + 1, _KAISER_BETA) * sinc_win)[n:]
    interp_delta = np.zeros_like(interp_win)
    interp_delta[:-1] = np.diff(interp_win)
    return interp_win, interp_delta


class ResamplePlan(NamedTuple):
    sr_in: int
    sr_out: int
    up: int  # output phases per window (L)
    down: int  # input samples consumed per L outputs (M)
    c: int  # window grouping factor
    reach: int  # max tap offset on either side of the center sample
    weights: np.ndarray  # (c*up, c*down + 2*reach + 1) float64


@functools.lru_cache(maxsize=32)
def plan_resample(sr_in: int, sr_out: int) -> ResamplePlan:
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    interp_win, interp_delta = _half_window()
    num_bits = 2**_PRECISION
    nwin = interp_win.shape[0]

    scale = min(1.0, sr_out / sr_in)
    index_step = int(scale * num_bits)
    reach = int(np.ceil(nwin / max(index_step, 1)))

    # group enough windows that each matmul strip consumes >=256 inputs
    c = max(1, -(-256 // down))
    width = c * down + 2 * reach + 1
    weights = np.zeros((c * up, width), dtype=np.float64)

    for m in range(c * up):
        t = m * down / up  # output time in input-sample units
        n0 = int(t)
        frac = scale * (t - n0)
        index_frac = frac * num_bits
        offset = int(index_frac)
        eta = index_frac - offset
        # left wing: taps at input samples n0, n0-1, ...
        i_max = (nwin - offset + index_step - 1) // index_step
        for i in range(i_max):
            idx = offset + i * index_step
            if idx >= nwin:
                break
            w = interp_win[idx] + eta * interp_delta[idx]
            weights[m, reach + n0 - i] += w
        # right wing: taps at input samples n0+1, n0+2, ...
        frac2 = scale - frac
        index_frac2 = frac2 * num_bits
        offset2 = int(index_frac2)
        eta2 = index_frac2 - offset2
        k_max = (nwin - offset2 + index_step - 1) // index_step
        for k in range(k_max):
            idx = offset2 + k * index_step
            if idx >= nwin:
                break
            w = interp_win[idx] + eta2 * interp_delta[idx]
            col = reach + n0 + 1 + k
            if col < width:
                weights[m, col] += w

    if scale < 1.0:
        weights *= scale  # resampy multiplies the output by scale on downsample

    return ResamplePlan(
        sr_in=sr_in, sr_out=sr_out, up=up, down=down, c=c, reach=reach, weights=weights
    )


# The polyphase weight matrix has up = sr_out/gcd rows per group; for
# near-coprime rate pairs (44100 -> 44101: up = 44101) it would be
# gigabytes.  Above this cap the rate pair routes to the windowed
# per-output evaluation below (host-side, bounded memory).
_PLAN_BYTES_CAP = 1 << 25  # 32 MB


def _plan_bytes(sr_in: int, sr_out: int) -> int:
    """Size of the polyphase weight matrix, computed without building it."""
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    num_bits = 2**_PRECISION
    nwin = _half_window()[0].shape[0]
    index_step = int(min(1.0, sr_out / sr_in) * num_bits)
    reach = int(np.ceil(nwin / max(index_step, 1)))
    c = max(1, -(-256 // down))
    return (c * up) * (c * down + 2 * reach + 1) * 8


def _resample_windowed(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Per-output windowed evaluation of the same kaiser_best arithmetic
    (resampy's own scheme: float time register, quantized table index with
    linear interpolation, wings truncated at the signal edges), vectorized
    over output chunks on the host.  O(window) memory for any rate ratio —
    the fallback for rate pairs whose polyphase plan would not fit."""
    interp_win, interp_delta = _half_window()
    num_bits = 2**_PRECISION
    scale = min(1.0, sr_out / sr_in)
    win, delta = (
        (interp_win * scale, interp_delta * scale)
        if scale < 1.0
        else (interp_win, interp_delta)
    )
    index_step = int(scale * num_bits)
    nwin = win.shape[0]
    n = x.shape[0]
    n_out = int(np.ceil(n * sr_out / sr_in))
    time_increment = sr_in / sr_out
    max_taps = nwin // max(index_step, 1) + 1
    y = np.zeros((n_out,) + x.shape[1:], dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    expand = (slice(None),) + (None,) * (x.ndim - 1)

    for j0 in range(0, n_out, 1 << 16):
        m = np.arange(j0, min(j0 + (1 << 16), n_out))
        time_register = m * time_increment
        n0 = time_register.astype(np.int64)
        frac = scale * (time_register - n0)
        acc = np.zeros((m.size,) + x.shape[1:], dtype=np.float64)
        for sign, base_frac, start in ((-1, frac, n0), (+1, scale - frac, n0 + 1)):
            index_frac = base_frac * num_bits
            offset = index_frac.astype(np.int64)
            eta = index_frac - offset
            count = (nwin - offset) // index_step  # resampy's wing tap count
            for i in range(max_taps):
                src = start + sign * i
                valid = (i < count) & (src >= 0) & (src < n)
                if not valid.any():
                    break
                idx = np.minimum(offset + i * index_step, nwin - 1)
                w = np.where(valid, win[idx] + eta * delta[idx], 0.0)
                acc += w[expand] * x[np.clip(src, 0, n - 1)]
        y[j0 : j0 + m.size] = acc
    return y


# The product reads each block's window as a row of one matrix, so the
# overlapping windows are materialised: (width / block_in) ~ 1.4-1.9x the
# input.  A 15-minute 96 kHz stereo track would need ~2.6 GB of them at
# once; chunks of at most 1 GiB of windows keep the resampler's peak at a
# small share of an 80 GB H100 (a 15-minute pair through the float32
# mastering graph needs a few GB more) and still give each product
# thousands of rows.
_WINDOW_BYTES_CAP = 1 << 30


@stage_host_arrays
def resample(x, sr_in: int, sr_out: int) -> torch.Tensor:
    """Resample ``x`` ((n,) or (n, channels); raw integer PCM converts at
    full scale) along axis 0, in float64 on the tensor's device (a host
    array is staged on the card, ``utils.stage_host_arrays``).

    Output length is ``ceil(n * sr_out / sr_in)`` (resampy convention), and
    samples beyond either edge of the input are treated as zero (resampy
    truncates the filter wings at the edges, which is equivalent).
    """
    x = to_working_float(x, torch.float64)
    if sr_in == sr_out:
        return x
    if _plan_bytes(sr_in, sr_out) > _PLAN_BYTES_CAP:
        out = _resample_windowed(x.cpu().numpy(), sr_in, sr_out)
        return torch.from_numpy(out).to(x.device)
    plan = plan_resample(sr_in, sr_out)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n, channels = x.shape
    n_out = int(np.ceil(n * sr_out / sr_in))

    block_in = plan.c * plan.down
    block_out = plan.c * plan.up
    nblocks = -(-n_out // block_out)
    width = plan.weights.shape[1]

    # window b reads input samples [b*block_in - reach, b*block_in + block_in + reach]
    pad_right = max(0, (nblocks - 1) * block_in + width - plan.reach - n)
    padded = torch.nn.functional.pad(x.T, (plan.reach, pad_right))  # (channels, time)
    weights_t = torch.from_numpy(plan.weights.T.copy()).to(x.device)  # (width, block_out)

    out = torch.empty((channels, nblocks, block_out), dtype=torch.float64, device=x.device)
    step = max(1, _WINDOW_BYTES_CAP // (channels * width * 8))
    for b0 in range(0, nblocks, step):
        b1 = min(nblocks, b0 + step)
        span = padded[:, b0 * block_in : (b1 - 1) * block_in + width]
        windows = span.unfold(1, width, block_in)  # (channels, b1 - b0, width), a view
        out[:, b0:b1] = torch.matmul(windows, weights_t)
    out = out.reshape(channels, nblocks * block_out)[:, :n_out]
    return out[0] if squeeze else out.T.contiguous()
