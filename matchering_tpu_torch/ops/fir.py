"""Linear-phase FIR synthesis from a magnitude curve (PyTorch).

Reference ``matchering/stage_helpers/match_frequencies.py:98-99``:
``fir = ifftshift(irfft(curve)) * hann(len(fir))``.
"""

from __future__ import annotations

import math

import torch

from ..utils import resolve_device, stage_host_arrays, torch_dtype


def hann_symmetric(n: int, dtype, *, device=None) -> torch.Tensor:
    """``scipy.signal.windows.hann(n)`` (symmetric):
    0.5 - 0.5*cos(2*pi*k/(n-1)), of ``dtype`` (a torch dtype or its numpy
    name) on ``device`` (``cuda`` unless named)."""
    k = torch.arange(n, dtype=torch_dtype(dtype), device=resolve_device(device))
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / (n - 1))


@stage_host_arrays
def fir_from_magnitude(curve: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Magnitude curves (..., fft_size//2+1) -> windowed linear-phase FIRs
    (..., fft_size); the shift moves the last axis only."""
    impulse = torch.fft.ifftshift(torch.fft.irfft(curve, n=fft_size), dim=-1)
    return impulse * hann_symmetric(fft_size, impulse.dtype, device=impulse.device)
