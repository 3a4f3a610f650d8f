"""DSP ops of the port: plain PyTorch on the caller's device, with the
hand-written CUDA kernels behind the limiter's ``iir`` calls (see
``matchering_tpu_torch.kernels``).  Every module and public function of
``matchering_tpu.ops`` has its counterpart here under the same name; the
JAX package's ``pallas_envelope`` (K1) is ``kernels.envelope``.

``blocks`` and ``fftpack`` compute what the JAX functions compute on
``torch.fft`` and strided views: the TPU algorithms behind them (windows
from shifted reshapes, the Hermitian-extension irfft, the four-step FFT as
matrix-unit products) work around the TPU compiler, and ``torch.fft``
needs none of them.
"""

from . import (
    basics,
    blocks,
    convolve,
    fftpack,
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
    "blocks",
    "fftpack",
    "convolve",
    "fir",
    "iir",
    "lowess",
    "resample",
    "sliding",
    "smoothing",
    "spectrum",
]
