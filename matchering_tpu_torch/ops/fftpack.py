"""FFT helpers (PyTorch, ``torch.fft``).

Counterpart of ``matchering_tpu.ops.fftpack``: ``irfft`` and
``four_step_fft`` compute what the JAX functions compute.  Their TPU
algorithms are not carried over: the JAX package builds the inverse real
FFT from a Hermitian extension and a complex inverse FFT because its
backend's ``irfft`` fails to compile, and runs the complex FFT as two
dense DFT matrices applied on the matrix units (Bailey's four-step form)
because that beat its backend's FFT.  ``torch.fft`` (cuFFT on the card)
has neither limitation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import stage_host_arrays

rfft = torch.fft.rfft


@stage_host_arrays
def irfft(spectrum: torch.Tensor, n: int, axis: int = -1) -> torch.Tensor:
    """``numpy.fft.irfft(spectrum, n, axis)``."""
    return torch.fft.irfft(spectrum, n=n, dim=axis)


@stage_host_arrays
def four_step_fft(
    x_re: torch.Tensor, x_im: torch.Tensor, inverse: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex FFT along the last axis, (re, im) in and out.
    ``inverse=True`` is the unnormalised inverse (``ifft(x) * n``); callers
    divide by n."""
    z = torch.complex(x_re, x_im)
    out = torch.fft.ifft(z, norm="forward") if inverse else torch.fft.fft(z)
    return out.real.contiguous(), out.imag.contiguous()
