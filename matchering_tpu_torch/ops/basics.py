"""Elementwise and reduction DSP ops (PyTorch).

Counterpart of ``matchering_tpu.ops.basics`` (reference
``matchering/dsp.py:25-152``).  Every function takes and returns tensors on
the caller's device and never synchronises with the host: scalars such as
the normalisation coefficient stay tensors.  The reference's boolean-index
reductions are masked arithmetic, as in the JAX package.

Batch-first: a track is (..., n, 2), a channel (..., n), and a per-track
scalar has the leading shape (...), so one call serves a single pair (no
leading axis) and a batch of B rows alike.  The JAX package ``vmap``s its
single-track functions instead.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import RowInts, stage_host_arrays, torch_dtype

# ---------------------------------------------------------------------------
# Channel transforms


def per_row(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-track value of shape (...) reshaped to broadcast against
    ``like`` of shape (..., n) or (..., n, 2)."""
    return value.reshape(value.shape + (1,) * (like.ndim - value.ndim))


@stage_host_arrays
def lr_to_ms(array: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stereo (..., n, 2) -> mid/side pair of (..., n) tensors:
    mid = (L + R) / 2, side = mid - R (reference ``dsp.py:57-64``)."""
    mid = (array[..., 0] + array[..., 1]) * 0.5
    side = mid - array[..., 1]
    return mid, side


@stage_host_arrays
def ms_to_lr(mid: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """Mid/side -> stereo (..., n, 2): L = mid + side, R = mid - side
    (reference ``dsp.py:67-68``)."""
    return torch.stack([mid + side, mid - side], dim=-1)


@stage_host_arrays
def mono_to_stereo(array: torch.Tensor) -> torch.Tensor:
    """(..., n, 1) -> (..., n, 2): each channel repeated twice along the
    last axis (the JAX package's ``jnp.repeat(array, 2, axis=1)``)."""
    return torch.repeat_interleave(array, 2, dim=-1)


# ---------------------------------------------------------------------------
# Gain / amplitude


@stage_host_arrays
def amplify(array: torch.Tensor, gain) -> torch.Tensor:
    return array * gain


@stage_host_arrays
def clip(array: torch.Tensor, to=1.0) -> torch.Tensor:
    """Clamp to [-to, to]; ``to`` may be a float or a tensor of one
    threshold per track (shape (...) of ``array``'s leading axes)."""
    if isinstance(to, torch.Tensor):
        to = per_row(to, array)
        return torch.minimum(torch.maximum(array, -to), to)
    return torch.clamp(array, -to, to)


@stage_host_arrays
def flip(array: torch.Tensor) -> torch.Tensor:
    return 1.0 - array


@stage_host_arrays
def max_mix(*arrays: torch.Tensor) -> torch.Tensor:
    out = arrays[0]
    for a in arrays[1:]:
        out = torch.maximum(out, a)
    return out


@stage_host_arrays
def rectify(array: torch.Tensor, threshold: float) -> torch.Tensor:
    """Cross-channel peak envelope floored at ``threshold`` and normalised
    to it (reference ``dsp.py:117-121``): >= 1, and 1 where the signal
    stays below the threshold.

    The threshold is a tensor on the array's device, so the division is a
    true division on every device (a host scalar divisor may be turned
    into a multiplication by its reciprocal, which rounds differently)."""
    peak = torch.amax(torch.abs(array), dim=-1)
    thr = torch.full((), threshold, dtype=array.dtype, device=array.device)
    return torch.maximum(peak, thr) / thr


@stage_host_arrays
def normalize(
    array: torch.Tensor, threshold: float, epsilon: float, normalize_clipped: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak-normalise each stereo track (..., n, 2) to ``threshold``
    (reference ``dsp.py:89-100``).

    Quiet material is boosted so its peak lands on the threshold; material
    at or above it is left alone unless ``normalize_clipped``.  Returns the
    scaled array and the per-track coefficient (...) that was divided out."""
    max_value = torch.amax(torch.abs(array), dim=(-2, -1))
    coefficient = torch.clamp(max_value / threshold, min=epsilon)
    if not normalize_clipped:
        coefficient = torch.where(
            max_value < threshold, coefficient, torch.ones_like(coefficient)
        )
    return array / per_row(coefficient, array), coefficient


@stage_host_arrays
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


@stage_host_arrays
def rms(array: torch.Tensor) -> torch.Tensor:
    """Root mean square along the last axis (reference ``dsp.py:76-77``)."""
    return torch.sqrt(torch.sum(torch.square(array), dim=-1) / array.shape[-1])


@stage_host_arrays
def unfold(array: torch.Tensor, piece_size: int, divisions: int) -> torch.Tensor:
    """(..., n) -> (..., divisions, piece_size), truncating the tail
    (reference ``dsp.py:71-73``)."""
    pieces = array[..., : piece_size * divisions]
    return pieces.reshape(pieces.shape[:-1] + (divisions, piece_size))


@stage_host_arrays
def batch_rms(pieces: torch.Tensor) -> torch.Tensor:
    """RMS of each row of (..., divisions, piece_size) pieces (reference
    ``dsp.py:80-86``, there a batched matmul; here a reduction)."""
    return torch.sqrt(torch.mean(torch.square(pieces), dim=-1))


@stage_host_arrays
def piece_rms_flat(array: torch.Tensor, piece_size: int, divisions: int) -> torch.Tensor:
    """Per-piece RMS (..., divisions) of the first ``divisions * piece_size``
    samples of each channel: ``batch_rms(unfold(...))``.  The JAX package
    sums aligned chunks instead, for its compiler; a view needs no such
    detour."""
    return batch_rms(unfold(array, piece_size, divisions))


def _row_geometry(value, device) -> torch.Tensor:
    """Per-row piece geometry as a (B,) tensor on ``device``: ``RowInts``'
    device side, or a tensor or int (0-d: one row), never read back."""
    if isinstance(value, RowInts):
        return value.device
    return torch.as_tensor(value, device=device).reshape(-1)


_CHUNK = 4096  # the aligned chunk of the dynamic piece sums (the JAX package's)


@stage_host_arrays
def piece_rms_dynamic(
    array: torch.Tensor, piece_size, divisions, div_max: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`piece_rms_flat` with per-row piece geometry, for the channels
    (B, n) of a zero-padded batch (``matchering_tpu.ops.basics``
    ``piece_rms_dynamic``; reference exact-length analysis,
    ``match_levels.py:47-59``).  ``piece_size`` and ``divisions`` are (B,)
    int tensors (or ``RowInts``); ``div_max`` bounds ``divisions`` on the
    host.  A (n,) channel with 0-d or int geometry, the JAX package's
    form, runs as a batch of one row and returns (div_max,) outputs.  The
    geometry is never read back to the host.

    The energy is summed over aligned chunks of 4096 samples and each piece
    total is the difference of two entries of the chunks' cumulative sum
    plus two partial-chunk corrections, gathered from the (div_max + 1)
    boundary chunks of each row.  The cumulative sum and the corrections
    are taken in float64 whatever the working dtype: in float32 a sum over millions
    of samples would lose the difference of two large partial sums.
    Returns ``(rmses, valid)``, each (B, div_max); entries at or past a
    row's division count are meaningless and 0 in ``valid``."""
    if array.ndim == 1:
        rmses, valid = piece_rms_dynamic(array[None], piece_size, divisions, div_max)
        return rmses[0], valid[0]
    piece_size = _row_geometry(piece_size, array.device)
    divisions = _row_geometry(divisions, array.device)
    dtype = array.dtype
    rows, n = array.shape
    m = -(-n // _CHUNK)
    n_used = piece_size * divisions
    energy = torch.square(array) * (torch.arange(n, device=array.device) < n_used[:, None])
    chunks = torch.nn.functional.pad(energy, (0, m * _CHUNK - n)).reshape(rows, m, _CHUNK)
    chunk_sums = torch.sum(chunks, dim=-1).to(torch.float64)
    cum = torch.nn.functional.pad(torch.cumsum(chunk_sums, dim=-1), (1, 0))  # (B, m + 1)

    bounds = torch.arange(div_max + 1, device=array.device) * piece_size[:, None]
    j = torch.clamp(bounds // _CHUNK, max=m)
    o = bounds % _CHUNK
    flat = (torch.arange(rows, device=array.device)[:, None] * m + torch.clamp(j, max=m - 1))
    boundary = chunks.reshape(rows * m, _CHUNK).index_select(0, flat.reshape(-1))
    boundary = boundary.reshape(rows, div_max + 1, _CHUNK)
    before = torch.arange(_CHUNK, device=array.device) < o[..., None]
    partial = torch.sum(boundary * before, dim=-1).to(torch.float64)

    ends = torch.gather(cum, 1, j)
    totals = (ends[:, 1:] - ends[:, :-1]) - partial[:, :-1] + partial[:, 1:]
    rmses = torch.sqrt(torch.clamp(totals, min=0.0) / piece_size[:, None]).to(dtype)
    valid = (torch.arange(div_max, device=array.device) < divisions[:, None]).to(dtype)
    return rmses, valid


@stage_host_arrays
def masked_rms(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RMS over the entries selected by a 0/1 ``mask`` along the last axis:
    sqrt(sum(mask*v^2) / max(sum(mask), 1))."""
    weight = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    total = torch.sum(torch.square(values) * mask, dim=-1)
    return torch.sqrt(total / weight)


@stage_host_arrays
def loudest_piece_stats(rmses: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loudest-piece mask and match RMS (reference ``match_levels.py:62-71``):
    a piece is "loudest" when its RMS >= the RMS of all piece RMSes; the
    match RMS is the RMS of the selected pieces' RMSes.  ``rmses`` is
    (..., divisions)."""
    average_rms = rms(rmses)
    mask = (rmses >= average_rms[..., None]).to(rmses.dtype)
    return mask, masked_rms(rmses, mask)


@stage_host_arrays
def loudest_piece_stats_masked(
    rmses: torch.Tensor, valid: torch.Tensor, divisions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`loudest_piece_stats` over the ``valid`` prefix of each row of
    (B, div_max) piece RMSes: the average divides by the row's own
    ``divisions`` (B,), and invalid pieces are never selected.  One
    track's (div_max,) RMSes with 0-d or int ``divisions`` (the JAX
    package's form) run as a batch of one row."""
    if rmses.ndim == 1:
        mask, match_rms = loudest_piece_stats_masked(rmses[None], valid[None], divisions)
        return mask[0], match_rms[0]
    divisions = _row_geometry(divisions, rmses.device)
    average_rms = torch.sqrt(torch.sum(torch.square(rmses) * valid, dim=-1) / divisions)
    mask = (rmses >= average_rms[:, None]).to(rmses.dtype) * valid
    return mask, masked_rms(rmses, mask)


# ---------------------------------------------------------------------------
# Integer PCM and peak statistics


def pcm_int_scale(dtype) -> float:
    """Full-scale divisor for an integer PCM dtype, the libsndfile
    convention (int16 -> 2^15, int32 -> 2^31)."""
    return float(1 << (dtype.itemsize * 8 - 1))


@stage_host_arrays
def to_working_float(x: torch.Tensor, dtype) -> torch.Tensor:
    """Cast to the working float dtype (a torch or numpy dtype, or its
    name); integer PCM codes scale by ``pcm_int_scale``, so raw
    int16/int32 payloads convert on the device."""
    dtype = torch_dtype(dtype)
    if not x.dtype.is_floating_point:
        return x.to(dtype) * (1.0 / pcm_int_scale(x.dtype))
    return x.to(dtype)


@stage_host_arrays
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
