"""First-order IIR filtering of the limiter (PyTorch + kernel K2).

Counterpart of the first-order parts of ``matchering_tpu.ops.iir``
(reference ``matchering/limiter/hyrax.py:48-75``).  Every pass runs through
``kernels.scan.first_order_filter``: kernel K2 on a CUDA tensor, its plain
float64 twin on a CPU tensor.  Filter coefficients are host floats.

Semantics kept exactly:

* ``lfilter_first_order`` — ``scipy.signal.lfilter(b, a, x, zi=[zi])`` for a
  (b0, b1) / (1, a1) section, DF2T state;
* ``filtfilt_first_order`` — ``scipy.signal.filtfilt(b, a, x)`` with its
  default odd extension of padlen = 6 samples and ``lfilter_zi`` scaling;
* ``butter1_coefficients`` — ``scipy.signal.butter(1, wn, fs=fs)``.

Higher Butterworth orders (an SOS cascade in the JAX package) are not
ported yet: ``butter_lowpass`` raises for them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import scan


class FirstOrderFilter(NamedTuple):
    """Transfer function b = (b0, b1), a = (1, a1), all host floats."""

    b0: float
    b1: float
    a1: float

    @property
    def pole(self) -> float:
        return -self.a1

    def zi(self) -> float:
        """``scipy.signal.lfilter_zi(b, a)`` of a first-order section: the
        steady-state z of z = b1 - a1*(b0 + z), i.e.
        (b1 - a1*b0) / (1 + a1)."""
        return (self.b1 - self.a1 * self.b0) / (1.0 + self.a1)


def one_pole_filter(coefficient: float, time_samples: float) -> FirstOrderFilter:
    """The attack smoother: b = [1-c], a = [1, -c] with
    c = exp(coefficient / time_samples) (reference ``hyrax.py:48-50``)."""
    c = math.exp(coefficient / time_samples)
    return FirstOrderFilter(b0=1.0 - c, b1=0.0, a1=-c)


def butter1_coefficients(cutoff_hz: float, fs: float) -> FirstOrderFilter:
    """First-order digital Butterworth low-pass (bilinear transform), equal
    to ``scipy.signal.butter(1, cutoff_hz, fs=fs)``."""
    warped = math.tan(math.pi * cutoff_hz / fs)
    k = warped / (1.0 + warped)
    a1 = (warped - 1.0) / (warped + 1.0)
    return FirstOrderFilter(b0=k, b1=k, a1=a1)


def lfilter_first_order(
    filt: FirstOrderFilter, x: torch.Tensor, zi=None, reverse: bool = False
) -> torch.Tensor:
    """``scipy.signal.lfilter([b0, b1], [1, a1], x, zi=[zi])`` (output
    only); with ``reverse`` the filter runs from the end of ``x``, i.e.
    ``lfilter(..., x[::-1], zi)[::-1]``."""
    return scan.first_order_filter(x, filt.b0, filt.b1, filt.a1, zi, reverse)


def filtfilt_first_order(filt: FirstOrderFilter, x: torch.Tensor) -> torch.Tensor:
    """``scipy.signal.filtfilt(b, a, x)`` with scipy's defaults: an odd
    extension of padlen = 6 samples at both ends and ``lfilter_zi`` state
    scaling.  The backward pass scans from the end instead of flipping."""
    padlen = 6
    # odd extension 2*x[edge] - x[mirrored]; the mirrored samples are
    # x[6], ..., x[1] at the head and x[-2], ..., x[-7] at the tail
    head = 2.0 * x[:1] - torch.flip(x[1 : padlen + 1], (0,))
    n = x.shape[0]
    tail = 2.0 * x[-1:] - torch.flip(x[n - padlen - 1 : n - 1], (0,))
    ext = torch.cat([head, x, tail])
    zi = filt.zi()
    y = lfilter_first_order(filt, ext, zi=zi * ext[:1])
    y = lfilter_first_order(filt, y, zi=zi * y[-1:], reverse=True)
    return y[padlen:-padlen]


def butter_lowpass(order: int, cutoff_hz: float, fs: float, x: torch.Tensor) -> torch.Tensor:
    """``scipy.signal.lfilter(*scipy.signal.butter(order, f, fs=fs), x)``
    with zero initial state — order 1 only in this port."""
    if order != 1:
        raise NotImplementedError("Butterworth orders above 1 are not ported yet")
    return lfilter_first_order(butter1_coefficients(cutoff_hz, fs), x)
