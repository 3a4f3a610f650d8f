"""Framed spectrum analysis (PyTorch, ``torch.fft``).

Counterpart of ``matchering_tpu.ops.spectrum`` (reference
``matchering/stage_helpers/match_frequencies.py:30-42``): non-overlapping
boxcar frames of ``fft_size`` samples taken from the start of every piece,
|rFFT| scaled by ``1/fft_size``, averaged over the frames of the
mask-selected pieces.  Each channel is its own real FFT here; the JAX
package's ``_pair`` forms pack both into one complex transform for its
backend.  Channels are (..., n) or (B, n); masks and spectra carry the same
leading axes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import RowInts, stage_host_arrays


def _frames(signal: torch.Tensor, piece_size: int, divisions: int, fft_size: int):
    """(..., divisions * frames_per_piece, fft_size) frames, each piece's
    tail dropped (``boundary=None, padded=False``)."""
    frames_per_piece = piece_size // fft_size
    lead = signal.shape[:-1]
    pieces = signal[..., : piece_size * divisions].reshape(lead + (divisions, piece_size))
    return pieces[..., : frames_per_piece * fft_size].reshape(lead + (-1, fft_size))


@stage_host_arrays
def framed_magnitude_mean(pieces: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Per-piece mean boxcar |rFFT|/fft_size spectrum:
    (..., divisions, piece_size) -> (..., divisions, fft_size//2 + 1)."""
    frames_per_piece = pieces.shape[-1] // fft_size
    frames = pieces[..., : frames_per_piece * fft_size]
    frames = frames.reshape(pieces.shape[:-1] + (frames_per_piece, fft_size))
    return torch.mean(torch.abs(torch.fft.rfft(frames, dim=-1)) / fft_size, dim=-2)


@stage_host_arrays
def masked_average_spectrum(pieces: torch.Tensor, mask: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Average |rFFT| spectrum over the frames of the mask-selected pieces
    of (..., divisions, piece_size) ``pieces``; ``mask`` is (..., divisions)
    0/1 weights.  Returns (..., fft_size//2 + 1)."""
    per_piece = framed_magnitude_mean(pieces, fft_size)
    weight = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return torch.sum(per_piece * mask[..., None], dim=-2) / weight[..., None]


@stage_host_arrays
def masked_average_spectrum_flat(
    array: torch.Tensor, mask: torch.Tensor, piece_size: int, divisions: int, fft_size: int
) -> torch.Tensor:
    """:func:`masked_average_spectrum` straight from the (..., n) signal:
    the pieces' frames are a view of it, with no (divisions, piece_size)
    copy.  Returns (..., fft_size//2 + 1)."""
    frames_per_piece = piece_size // fft_size
    weights = torch.repeat_interleave(mask, frames_per_piece, dim=-1)
    selected = torch.clamp(torch.sum(mask, dim=-1), min=1.0) * frames_per_piece
    frames = _frames(array, piece_size, divisions, fft_size)
    mag = torch.abs(torch.fft.rfft(frames, dim=-1)) / fft_size
    return torch.sum(mag * weights[..., None], dim=-2) / selected[..., None]


@stage_host_arrays
def masked_average_spectrum_dynamic(
    array: torch.Tensor,
    mask: torch.Tensor,
    piece_size,
    div_max: int,
    fft_size: int,
    fpp_max: int,
) -> torch.Tensor:
    """:func:`masked_average_spectrum_flat` of a (n,) signal whose piece
    size is a 0-d int tensor (or an int): the true-length analysis of a
    zero-padded track.  The tensor is never read back to the host: frame
    (p, f) starts at ``p * piece_size + f * fft_size`` and the frames are
    gathered through an index built on the device, over the signal padded
    by ``fpp_max * fft_size`` zeros.  Frames past ``piece_size //
    fft_size`` carry zero weight, and ``mask`` (div_max,) must already be
    zero past the division count (``basics.loudest_piece_stats_masked``),
    as in the JAX package.  Returns (fft_size//2 + 1,)."""
    dtype = array.dtype
    slice_len = fpp_max * fft_size
    piece_size = torch.as_tensor(piece_size, device=array.device)
    padded = torch.nn.functional.pad(array, (0, slice_len))
    # clamped into the padded signal, as ``lax.dynamic_slice`` clamps its start
    starts = torch.clamp(torch.arange(div_max, device=array.device) * piece_size, max=array.shape[-1])
    index = starts[:, None] + torch.arange(slice_len, device=array.device)
    frames = padded[index].reshape(div_max, fpp_max, fft_size)
    mag = torch.abs(torch.fft.rfft(frames, dim=-1)) / fft_size
    frames_per_piece = piece_size // fft_size
    frame_valid = (torch.arange(fpp_max, device=array.device) < frames_per_piece).to(dtype)
    weights = mask[:, None] * frame_valid[None, :]
    total = torch.sum(mag * weights[:, :, None], dim=(0, 1))
    selected = torch.clamp(torch.sum(mask), min=1.0)
    return total / (selected * torch.clamp(frames_per_piece, min=1))


@stage_host_arrays
def masked_average_spectrum_flat_pair(
    signal_a: torch.Tensor,
    signal_b: torch.Tensor,
    mask: torch.Tensor,
    piece_size: int,
    divisions: int,
    fft_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`masked_average_spectrum_flat` of two channels, each
    ``(..., fft_size//2 + 1)``; ``mask`` is the (..., divisions) 0/1 piece
    mask, and the geometry is the same for every row."""
    return tuple(
        masked_average_spectrum_flat(signal, mask, piece_size, divisions, fft_size)
        for signal in (signal_a, signal_b)
    )


@stage_host_arrays
def masked_average_spectrum_dynamic_pair(
    signal_a: torch.Tensor,
    signal_b: torch.Tensor,
    mask: torch.Tensor,
    piece_size,
    div_max: int,
    fft_size: int,
    fpp_max: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked average magnitude spectra (B, fft_size//2 + 1) of two (B, n)
    channels whose rows each have their own piece size (bucket-padded
    tracks at their true lengths).

    ``piece_size`` holds the rows' piece sizes, host ints and a device
    tensor (``RowInts``); ``mask`` is the (B, div_max) piece mask, already
    zero past each row's division count
    (``basics.loudest_piece_stats_masked``).  Two (n,) channels with a
    (div_max,) mask and an int or 0-d piece size (the JAX package's form)
    run as a batch of one row; a 0-d tensor on a card is read back to the
    host once (``RowInts.per_row``), since the frames are views sized on
    the host.  Frame
    (p, f) of row r starts at ``p * piece_size[r] + f * fft_size``: for one
    row that is a strided view of the zero-padded row, strides
    ``(piece_size[r], fft_size, 1)`` from the host ints, so no index tensor
    is built (an int64 gather index would take twice the bytes of the
    frames).  Frames past a row's ``piece_size // fft_size`` carry zero
    weight, as in the JAX package."""
    if signal_a.ndim == 1:
        a, b = masked_average_spectrum_dynamic_pair(
            signal_a[None], signal_b[None], mask[None], piece_size, div_max, fft_size, fpp_max
        )
        return a[0], b[0]
    piece_size = RowInts.per_row(piece_size, signal_a.device)
    rows = signal_a.shape[0]
    slice_len = fpp_max * fft_size
    frames_per_piece = piece_size.device // fft_size
    frame_valid = torch.arange(fpp_max, device=mask.device) < frames_per_piece[:, None]
    weights = mask[:, :, None] * frame_valid[:, None, :]  # (B, div_max, fpp_max)
    selected = torch.clamp(torch.sum(mask, dim=-1), min=1.0) * torch.clamp(frames_per_piece, min=1)

    def average(signal):
        padded = torch.nn.functional.pad(signal, (0, slice_len)).contiguous()
        width = padded.shape[1]
        frames = torch.stack([
            torch.as_strided(
                padded, (div_max, fpp_max, fft_size), (piece_size.host[r], fft_size, 1),
                padded.storage_offset() + r * width,
            )
            for r in range(rows)
        ])  # (B, div_max, fpp_max, fft_size)
        mag = torch.abs(torch.fft.rfft(frames, dim=-1)) / fft_size
        total = torch.einsum("bpfk,bpf->bk", mag, weights)
        return total / selected[:, None]

    return average(signal_a), average(signal_b)
