"""Elementwise and reduction DSP ops (PyTorch).

Counterpart of ``matchering_tpu.ops.basics`` (reference
``matchering/dsp.py:25-152``).  Every function takes and returns tensors on
the caller's device and never synchronises with the host: scalars such as
the normalisation coefficient stay 0-dim tensors.  The reference's
boolean-index reductions are masked arithmetic, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

# ---------------------------------------------------------------------------
# Channel transforms


def lr_to_ms(array: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stereo (n, 2) -> mid/side pair of (n,) tensors:
    mid = (L + R) / 2, side = mid - R (reference ``dsp.py:57-64``)."""
    mid = (array[:, 0] + array[:, 1]) * 0.5
    side = mid - array[:, 1]
    return mid, side


def ms_to_lr(mid: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """Mid/side -> stereo (n, 2): L = mid + side, R = mid - side
    (reference ``dsp.py:67-68``)."""
    return torch.stack([mid + side, mid - side], dim=-1)


# ---------------------------------------------------------------------------
# Gain / amplitude


def clip(array: torch.Tensor, to=1.0) -> torch.Tensor:
    """Clamp to [-to, to]; ``to`` may be a float or a 0-dim tensor."""
    if isinstance(to, torch.Tensor):
        return torch.minimum(torch.maximum(array, -to), to)
    return torch.clamp(array, -to, to)


def flip(array: torch.Tensor) -> torch.Tensor:
    return 1.0 - array


def max_mix(*arrays: torch.Tensor) -> torch.Tensor:
    out = arrays[0]
    for a in arrays[1:]:
        out = torch.maximum(out, a)
    return out


def rectify(array: torch.Tensor, threshold: float) -> torch.Tensor:
    """Cross-channel peak envelope floored at ``threshold`` and normalised
    to it (reference ``dsp.py:117-121``): >= 1, and 1 where the signal
    stays below the threshold.

    The threshold is a tensor on the array's device, so the division is a
    true division on every device (a host scalar divisor may be turned
    into a multiplication by its reciprocal, which rounds differently)."""
    peak = torch.amax(torch.abs(array), dim=1)
    thr = torch.full((), threshold, dtype=array.dtype, device=array.device)
    return torch.maximum(peak, thr) / thr


def normalize(
    array: torch.Tensor, threshold: float, epsilon: float, normalize_clipped: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak-normalise to ``threshold`` (reference ``dsp.py:89-100``).

    Quiet material is boosted so its peak lands on the threshold; material
    at or above it is left alone unless ``normalize_clipped``.  Returns the
    scaled array and the 0-dim coefficient that was divided out."""
    max_value = torch.amax(torch.abs(array))
    coefficient = torch.clamp(max_value / threshold, min=epsilon)
    if not normalize_clipped:
        coefficient = torch.where(
            max_value < threshold, coefficient, torch.ones_like(coefficient)
        )
    return array / coefficient, coefficient


def fade(array: torch.Tensor, fade_size: int) -> torch.Tensor:
    """Linear fade-in/out over ``fade_size`` samples (reference
    ``dsp.py:146-152``)."""
    n = array.shape[0]
    ramp_in = torch.linspace(0.0, 1.0, fade_size, dtype=array.dtype, device=array.device)
    ramp_in = ramp_in.reshape((fade_size,) + (1,) * (array.ndim - 1))
    head = array[:fade_size] * ramp_in
    tail = array[n - fade_size :] * ramp_in.flip(0)
    return torch.cat([head, array[fade_size : n - fade_size], tail], dim=0)


# ---------------------------------------------------------------------------
# RMS statistics


def rms(array: torch.Tensor) -> torch.Tensor:
    """Root mean square of a 1-D tensor (reference ``dsp.py:76-77``)."""
    return torch.sqrt(torch.dot(array, array) / array.shape[0])


def piece_rms_flat(array: torch.Tensor, piece_size: int, divisions: int) -> torch.Tensor:
    """Per-piece RMS of the first ``divisions * piece_size`` samples
    (reference ``dsp.py:71-86``: unfold, then a row-wise RMS)."""
    pieces = array[: piece_size * divisions].reshape(divisions, piece_size)
    return torch.sqrt(torch.mean(torch.square(pieces), dim=-1))


def masked_rms(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RMS over the entries selected by a 0/1 ``mask``:
    sqrt(sum(mask*v^2) / max(sum(mask), 1))."""
    weight = torch.clamp(torch.sum(mask), min=1.0)
    total = torch.sum(torch.square(values) * mask)
    return torch.sqrt(total / weight)


def loudest_piece_stats(rmses: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loudest-piece mask and match RMS (reference ``match_levels.py:62-71``):
    a piece is "loudest" when its RMS >= the RMS of all piece RMSes; the
    match RMS is the RMS of the selected pieces' RMSes."""
    average_rms = rms(rmses)
    mask = (rmses >= average_rms).to(rmses.dtype)
    return mask, masked_rms(rmses, mask)


# ---------------------------------------------------------------------------
# Integer PCM and peak statistics


def pcm_int_scale(dtype) -> float:
    """Full-scale divisor for an integer PCM dtype, the libsndfile
    convention (int16 -> 2^15, int32 -> 2^31)."""
    return float(1 << (dtype.itemsize * 8 - 1))


def to_working_float(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast to the working float dtype; integer PCM codes scale by
    ``pcm_int_scale``, so raw int16/int32 payloads convert on the device."""
    if not x.dtype.is_floating_point:
        return x.to(dtype) * (1.0 / pcm_int_scale(x.dtype))
    return x.to(dtype)


def count_max_peaks(array: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global peak magnitude and how many samples sit at it, with
    ``np.isclose`` tolerances (reference ``dsp.py:49-54``).  Integer PCM is
    scaled to full-scale float64 first."""
    if not array.dtype.is_floating_point:
        array = to_working_float(array, torch.float64)
    magnitude = torch.abs(array)
    max_value = torch.amax(magnitude)
    tol = 1e-8 + 1e-5 * max_value
    near = torch.abs(magnitude - max_value) <= tol
    return max_value, torch.sum(near)
