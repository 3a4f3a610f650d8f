"""Long FIR convolution via overlap-save block FFTs (PyTorch, ``torch.fft``).

Counterpart of ``matchering_tpu.ops.convolve`` (reference
``scipy.signal.fftconvolve(x, fir, "same")``,
``matchering/stage_helpers/match_frequencies.py:104-119``).  Short signals
take one FFT; longer ones are cut into overlapping blocks of ``block_fft``
points, each run through rFFT -> spectral multiply -> irFFT as one batch.
Overlap-save is exact, so both branches give the same linear convolution.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import stage_host_arrays


# the overlap-save block where the caller names none
_BLOCK_FFT = 1 << 16


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@stage_host_arrays
def fft_convolve_same_batch(
    signals: torch.Tensor, firs: torch.Tensor, block_fft: Optional[int] = None
) -> torch.Tensor:
    """'same' convolution of each row of ``signals`` (c, n) with the
    matching row of ``firs`` (c, taps) -> (c, n).  ``block_fft=None``
    picks the port's block, ``1 << 16``."""
    block_fft = block_fft or _BLOCK_FFT
    c, n = signals.shape
    taps = firs.shape[1]
    if taps > block_fft // 2:
        block_fft = _next_pow2(2 * taps)
    full = n + taps - 1
    start = (taps - 1) // 2  # "same" keeps the centred n samples

    single = _next_pow2(full)
    if single <= block_fft:
        spec = torch.fft.rfft(signals, n=single) * torch.fft.rfft(firs, n=single)
        return torch.fft.irfft(spec, n=single)[:, start : start + n]

    # block b reads padded samples [b*hop, b*hop + nfft), where padded has
    # `discard` leading zeros, and keeps its last `hop` outputs (the first
    # `discard` carry the circular wrap)
    nfft = block_fft
    discard = taps - 1
    hop = nfft - discard
    nblocks = -(-full // hop)
    padded = torch.nn.functional.pad(
        signals, (discard, (nblocks - 1) * hop + nfft - n - discard)
    )
    blocks = padded.unfold(1, nfft, hop)  # (c, nblocks, nfft) view
    h = torch.fft.rfft(firs, n=nfft)[:, None, :]
    segs = torch.fft.irfft(torch.fft.rfft(blocks) * h, n=nfft)[..., discard:]
    return segs.reshape(c, -1)[:, start : start + n]


@stage_host_arrays
def fft_convolve_same(x: torch.Tensor, fir: torch.Tensor, block_fft: int = 1 << 16) -> torch.Tensor:
    """``scipy.signal.fftconvolve(x, fir, mode="same")`` for 1-D inputs:
    one FFT for a short signal, else overlap-save blocks of ``block_fft``
    points, raised to the next power of two of ``2 * taps`` where the FIR
    needs more room than ``block_fft // 2``."""
    return fft_convolve_same_batch(x[None], fir[None], block_fft)[0]
