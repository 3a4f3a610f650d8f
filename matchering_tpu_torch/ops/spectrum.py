"""Framed spectrum analysis (PyTorch, ``torch.fft``).

Counterpart of ``masked_average_spectrum_flat_pair`` and
``masked_average_spectrum_dynamic_pair`` of ``matchering_tpu.ops.spectrum`` (reference
``matchering/stage_helpers/match_frequencies.py:30-42``): non-overlapping
boxcar frames of ``fft_size`` samples taken from the start of every piece,
|rFFT| scaled by ``1/fft_size``, averaged over the frames of the
mask-selected pieces.  Each channel is its own real FFT here; the JAX
package packs both into one complex transform for its backend.  Channels
are (..., n) or (B, n); masks and spectra carry the same leading axes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import RowInts


def _frames(signal: torch.Tensor, piece_size: int, divisions: int, fft_size: int):
    """(..., divisions * frames_per_piece, fft_size) frames, each piece's
    tail dropped (``boundary=None, padded=False``)."""
    frames_per_piece = piece_size // fft_size
    lead = signal.shape[:-1]
    pieces = signal[..., : piece_size * divisions].reshape(lead + (divisions, piece_size))
    return pieces[..., : frames_per_piece * fft_size].reshape(lead + (-1, fft_size))


def masked_average_spectrum_flat_pair(
    signal_a: torch.Tensor,
    signal_b: torch.Tensor,
    mask: torch.Tensor,
    piece_size: int,
    divisions: int,
    fft_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked average magnitude spectra of two channels, each
    ``(..., fft_size//2 + 1)``; ``mask`` is the (..., divisions) 0/1 piece
    mask, and the geometry is the same for every row."""
    frames_per_piece = piece_size // fft_size
    weights = torch.repeat_interleave(mask, frames_per_piece, dim=-1)
    selected = torch.clamp(torch.sum(mask, dim=-1), min=1.0) * frames_per_piece

    def average(signal):
        frames = _frames(signal, piece_size, divisions, fft_size)
        mag = torch.abs(torch.fft.rfft(frames, dim=-1)) / fft_size
        return torch.sum(mag * weights[..., None], dim=-2) / selected[..., None]

    return average(signal_a), average(signal_b)


def masked_average_spectrum_dynamic_pair(
    signal_a: torch.Tensor,
    signal_b: torch.Tensor,
    mask: torch.Tensor,
    piece_size: RowInts,
    div_max: int,
    fft_size: int,
    fpp_max: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked average magnitude spectra (B, fft_size//2 + 1) of two (B, n)
    channels whose rows each have their own piece size (bucket-padded
    tracks at their true lengths).

    ``piece_size`` holds the rows' piece sizes, host ints and a device
    tensor; ``mask`` is the (B, div_max) piece mask, already zero past each
    row's division count (``basics.loudest_piece_stats_masked``).  Frame
    (p, f) of row r starts at ``p * piece_size[r] + f * fft_size``: for one
    row that is a strided view of the zero-padded row, strides
    ``(piece_size[r], fft_size, 1)`` from the host ints, so no index tensor
    is built (an int64 gather index would take twice the bytes of the
    frames).  Frames past a row's ``piece_size // fft_size`` carry zero
    weight, as in the JAX package."""
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
