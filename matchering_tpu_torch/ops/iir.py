"""First-order IIR filtering of the limiter (PyTorch + kernel K2).

Counterpart of the first-order parts of ``matchering_tpu.ops.iir``
(reference ``matchering/limiter/hyrax.py:48-75``).  Every pass runs through
``kernels.scan.first_order_filter``: kernel K2 on a CUDA tensor, its plain
float64 twin on a CPU tensor.  Filter coefficients are host floats.

Semantics kept exactly:

* ``lfilter_first_order`` — ``scipy.signal.lfilter(b, a, x, zi=[zi])`` for a
  (b0, b1) / (1, a1) section, DF2T state;
* ``filtfilt_first_order`` — ``scipy.signal.filtfilt(b, a, x)`` with its
  default odd extension of padlen = 6 samples and ``lfilter_zi`` scaling,
  along the last axis of (n,) or (B, n); with ``lengths``,
  ``filtfilt(b, a, x[r, :L_r])`` for every row r of a zero-padded batch
  (the counterpart of ``filtfilt_first_order_truncated``);
* ``butter1_coefficients`` — ``scipy.signal.butter(1, wn, fs=fs)``.

Higher Butterworth orders (an SOS cascade in the JAX package) are not
ported yet: ``butter_lowpass`` raises for them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..kernels import scan
from ..utils import RowInts


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
    filt: FirstOrderFilter,
    x: torch.Tensor,
    zi=None,
    reverse: bool = False,
    lengths: Optional[RowInts] = None,
) -> torch.Tensor:
    """``scipy.signal.lfilter([b0, b1], [1, a1], x, zi=[zi])`` (output
    only); with ``reverse`` the filter runs from the end of ``x``, i.e.
    ``lfilter(..., x[::-1], zi)[::-1]``; with ``lengths`` each row of x
    ends at its own length (``scan.first_order_filter``)."""
    return scan.first_order_filter(x, filt.b0, filt.b1, filt.a1, zi, reverse, lengths)


_PADLEN = 6  # scipy.signal.filtfilt's default odd extension for a first-order filter


def filtfilt_first_order(
    filt: FirstOrderFilter, x: torch.Tensor, lengths: Optional[RowInts] = None
) -> torch.Tensor:
    """``scipy.signal.filtfilt(b, a, x)`` along the last axis, with scipy's
    defaults: an odd extension of padlen = 6 samples at both ends and
    ``lfilter_zi`` state scaling.  The backward pass scans from the end
    instead of flipping.  With ``lengths`` see :func:`_filtfilt_rows`."""
    padlen = _PADLEN
    # odd extension 2*x[edge] - x[mirrored]; the mirrored samples are
    # x[6], ..., x[1] at the head and x[-2], ..., x[-7] at the tail
    head = 2.0 * x[..., :1] - torch.flip(x[..., 1 : padlen + 1], (-1,))
    if lengths is not None:
        return _filtfilt_rows(filt, x, head, lengths)
    n = x.shape[-1]
    tail = 2.0 * x[..., -1:] - torch.flip(x[..., n - padlen - 1 : n - 1], (-1,))
    ext = torch.cat([head, x, tail], dim=-1)
    zi = filt.zi()
    y = lfilter_first_order(filt, ext, zi=zi * ext[..., :1])
    y = lfilter_first_order(filt, y, zi=zi * y[..., -1:], reverse=True)
    return y[..., padlen:-padlen]


def _filtfilt_rows(
    filt: FirstOrderFilter, x: torch.Tensor, head: torch.Tensor, lengths: RowInts
) -> torch.Tensor:
    """``filtfilt(b, a, x[r, :L_r])`` for each row of a (B, n) batch, 0 at
    and past L_r (``matchering_tpu.ops.iir.filtfilt_first_order_truncated``,
    iir.py:874-935).

    The forward pass runs over [head extension | row] up to L_r + 6; it is
    causal, so it is the true-length run there.  The tail extension needs
    x[L-7 .. L-1] of each row: its six forward steps and the six backward
    warm-up steps over the extension run on (B,) float64 tensors, and their
    state enters the reverse pass as its per-row ``zi`` at the row's last
    sample.  The JAX package injects that state as a one-hot drive impulse
    at a traced position; a per-row start gives the same result.  Needs
    every L >= 7 (checked by the caller on the host)."""
    padlen = _PADLEN
    b0, b1, a1 = filt
    zi_coef = filt.zi()
    ext = torch.cat([head, x], dim=-1)
    ext_lengths = lengths.plus(padlen)
    y_fwd = lfilter_first_order(filt, ext, zi=zi_coef * ext[:, :1], lengths=ext_lengths)

    # x[L-7 .. L-1] and the forward output at x[L-1], per row, in float64
    ends = lengths.device[:, None]
    xs = torch.gather(x, 1, ends - 7 + torch.arange(7, device=x.device)).to(torch.float64)
    y_last = torch.gather(y_fwd, 1, ends + (padlen - 1))[:, 0].to(torch.float64)
    # forward DF2T state at L-1 recovered from the output: z = b1*x - a1*y,
    # then the forward steps over the tail extension 2*x[L-1] - x[L-2 .. L-7]
    state = b1 * xs[:, 6] - a1 * y_last
    y_ext = []
    for k in range(padlen):
        sample = 2.0 * xs[:, 6] - xs[:, 5 - k]
        yk = b0 * sample + state
        state = b1 * sample - a1 * yk
        y_ext.append(yk)
    # the backward pass over the extension, from scipy's zi * y[-1]
    state = zi_coef * y_ext[-1]
    for k in range(padlen - 1, -1, -1):
        yb = b0 * y_ext[k] + state
        state = b1 * y_ext[k] - a1 * yb
    y = lfilter_first_order(filt, y_fwd, zi=state, reverse=True, lengths=ext_lengths)
    return y[:, padlen:]


def butter_lowpass(order: int, cutoff_hz: float, fs: float, x: torch.Tensor) -> torch.Tensor:
    """``scipy.signal.lfilter(*scipy.signal.butter(order, f, fs=fs), x)``
    with zero initial state, along the last axis — order 1 only in this
    port.  It is causal, so a zero-padded row needs no length."""
    if order != 1:
        raise NotImplementedError("Butterworth orders above 1 are not ported yet")
    return lfilter_first_order(butter1_coefficients(cutoff_hz, fs), x)
