"""DSP ops of the port: plain PyTorch on the caller's device, with the
hand-written CUDA kernels behind the limiter's ``iir`` calls (see
``matchering_tpu_torch.kernels``).

The JAX package's ``blocks`` (the 128-aligned block discards) and
``fftpack`` (the Hermitian-extension irfft and the four-step FFT as
matrix-unit products) are not ported: both work around the TPU compiler,
and ``torch.fft`` needs neither.
"""

from . import (
    basics,
    convolve,
    fir,
    iir,
    lowess,
    resample,
    sliding,
    smoothing,
    spectrum,
)

__all__ = [
    "basics",
    "convolve",
    "fir",
    "iir",
    "lowess",
    "resample",
    "sliding",
    "smoothing",
    "spectrum",
]
