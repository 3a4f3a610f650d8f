"""Framed spectrum analysis (PyTorch, ``torch.fft``).

Counterpart of ``matchering_tpu.ops.spectrum.masked_average_spectrum_flat_pair``
(reference ``matchering/stage_helpers/match_frequencies.py:30-42``):
non-overlapping boxcar frames of ``fft_size`` samples taken from the start
of every piece, |rFFT| scaled by ``1/fft_size``, averaged over the frames of
the mask-selected pieces.  Each channel is its own real FFT here; the JAX
package packs both into one complex transform for its backend.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _frames(signal: torch.Tensor, piece_size: int, divisions: int, fft_size: int):
    """(divisions * frames_per_piece, fft_size) frames, each piece's tail
    dropped (``boundary=None, padded=False``)."""
    frames_per_piece = piece_size // fft_size
    pieces = signal[: piece_size * divisions].reshape(divisions, piece_size)
    return pieces[:, : frames_per_piece * fft_size].reshape(-1, fft_size)


def masked_average_spectrum_flat_pair(
    signal_a: torch.Tensor,
    signal_b: torch.Tensor,
    mask: torch.Tensor,
    piece_size: int,
    divisions: int,
    fft_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked average magnitude spectra of two channels, each
    ``(fft_size//2 + 1,)``; ``mask`` is the (divisions,) 0/1 piece mask."""
    frames_per_piece = piece_size // fft_size
    weights = torch.repeat_interleave(mask, frames_per_piece)
    selected = torch.clamp(torch.sum(mask), min=1.0) * frames_per_piece

    def average(signal):
        frames = _frames(signal, piece_size, divisions, fft_size)
        mag = torch.abs(torch.fft.rfft(frames, dim=-1)) / fft_size
        return torch.sum(mag * weights[:, None], dim=0) / selected

    return average(signal_a), average(signal_b)
