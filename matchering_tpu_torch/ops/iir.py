"""IIR filtering of the limiter (PyTorch + kernels K2 and K3).

Counterpart of ``matchering_tpu.ops.iir`` (reference
``matchering/limiter/hyrax.py:48-75``).  A first-order filter runs through
``kernels.scan.first_order_filter`` (K2), each second-order section of a
higher order through ``kernels.sos.sos_filter`` (K3): the kernel on a CUDA
tensor, its plain float64 twin on a CPU tensor.  Filter coefficients are host floats,
designed on the host with scipy where the order is above 1.

Semantics kept exactly:

* ``lfilter_first_order`` — ``scipy.signal.lfilter(b, a, x, zi=[zi])`` for a
  (b0, b1) / (1, a1) section, DF2T state;
* ``filtfilt_first_order`` — ``scipy.signal.filtfilt(b, a, x)`` with its
  default odd extension of padlen = 6 samples and ``lfilter_zi`` scaling,
  along the last axis of (n,) or (B, n); with ``lengths``,
  ``filtfilt(b, a, x[r, :L_r])`` for every row r of a zero-padded batch
  (the counterpart of ``filtfilt_first_order_truncated``);
* ``butter1_coefficients`` — ``scipy.signal.butter(1, wn, fs=fs)``;
* ``butter_lowpass`` — ``lfilter(*butter(order, wn, fs=fs), x)`` at any
  order, run as ``sosfilt(butter(..., output="sos"), x)`` above order 1:
  scipy's sections in scipy's order, each on K3;
* ``lfilter`` — ``scipy.signal.lfilter(b, a, x)`` with zero state at any
  order: K2 for order 1, K3 for order 2, above that ``tf2sos``'s cascade;
* the JAX package's public scans on K2: ``scan_first_order`` (one launch),
  ``block_scan_summary``, ``filtfilt_first_order_truncated`` (two) and
  ``scan_first_order_ds`` with ``ds_pole_powers``, whose double-single
  arithmetic becomes float64 (see there).

The JAX package runs each section (and ``lfilter`` above order 1) as a
2x2 (or n x n) affine ``associative_scan`` (``iir.py:970-1049``).  At the
release cutoff that scan is off by 1.43e-4 in float64 and gives NaN in
float32 at order 2; the port follows scipy instead, within 1e-9 in
float64 (``tests/test_torch_configs.py``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .. import trace
from ..kernels import scan, sos
from ..utils import RowInts, resolve_device, stage_host_arrays, torch_dtype


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


@stage_host_arrays
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


def _host_pole(pole) -> float:
    """The pole as a host float: K2 takes its pole, and the pole's powers,
    from the host.  A 0-d tensor is read back once (a host sync)."""
    return float(pole.item()) if isinstance(pole, torch.Tensor) else float(pole)


@stage_host_arrays
def scan_first_order(drive: torch.Tensor, pole) -> torch.Tensor:
    """Solve ``y[i] = drive[i] + pole * y[i-1]`` from zero state along the
    last axis of a (n,) or (rows, n) drive: ``lfilter([1, 0], [1, -pole],
    drive)``, one K2 launch (its plain twin on a CPU tensor).

    ``pole``: a host float, or a 0-d tensor, which is read back to the host
    once.  That read, and the length of :func:`filtfilt_first_order_truncated`
    given as a 0-d tensor, are the only host syncs of these scans: they
    stand where the JAX package falls back to an ``associative_scan`` for a
    traced pole, since K2 takes the pole's powers from the host."""
    return scan.first_order_filter(drive.contiguous(), 1.0, 0.0, -_host_pole(pole))


@stage_host_arrays
def block_scan_summary(drive: torch.Tensor, pole) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The zero-state scan of a block and the block's affine carry map:
    ``(local, (pole**n, local[..., -1]))``.  The block's true output is
    ``local + pole**(i+1) * carry_in`` and it composes into a chain as
    ``carry_out = pole**n * carry_in + local[..., -1]``.  One K2 launch."""
    pole = _host_pole(pole)
    local = scan_first_order(drive, pole)
    a_total = torch.full((), pole ** drive.shape[-1], dtype=drive.dtype, device=drive.device)
    return local, (a_total, local[..., -1])


def _split(y: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float64 tensor as the (hi, lo) pair of ``dtype`` whose sum it is
    to about twice that dtype's precision."""
    hi = y.to(dtype)
    return hi, (y - hi.to(torch.float64)).to(dtype)


@stage_host_arrays
def scan_first_order_ds(drive_hi: torch.Tensor, drive_lo: torch.Tensor, pole) -> Tuple[torch.Tensor, torch.Tensor]:
    """The solve of :func:`scan_first_order` for a drive carried as a
    float32 (hi, lo) pair, returned as one: ``y_hi + y_lo`` holds about
    double precision.

    The JAX package carries the scan itself in double-single arithmetic,
    since its TPU has no float64.  The H100 runs float64 natively, so this
    computes the same function directly: ``hi + lo`` summed in float64, one
    K2 launch at float64, and the result split back into a pair of the
    drive's dtype."""
    drive = drive_hi.to(torch.float64) + drive_lo.to(torch.float64)
    return _split(scan_first_order(drive, pole), drive_hi.dtype)


def ds_pole_powers(pole: float, n: int, dtype, *, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pole**(1..n)`` as a (hi, lo) pair of ``dtype`` on ``device``
    (``cuda`` unless named).  Each power is one float64 ``pow`` on the
    device, split like :func:`scan_first_order_ds`'s result; the JAX
    package builds the pair as double-single products of host factors,
    for want of float64 on its TPU."""
    exponents = torch.arange(1, n + 1, dtype=torch.float64, device=resolve_device(device))
    return _split(torch.pow(float(pole), exponents), torch_dtype(dtype))


_PADLEN = 6  # scipy.signal.filtfilt's default odd extension for a first-order filter


@stage_host_arrays
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
    every L >= 7 (checked by the caller on the host).  The tail extension
    is the span ``length_tail``, timed on the device."""
    padlen = _PADLEN
    b0, b1, a1 = filt
    zi_coef = filt.zi()
    ext = torch.cat([head, x], dim=-1)
    ext_lengths = lengths.plus(padlen)
    y_fwd = lfilter_first_order(filt, ext, zi=zi_coef * ext[:, :1], lengths=ext_lengths)

    with trace.span("length_tail", device=x.device):
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


@stage_host_arrays
def filtfilt_first_order_truncated(filt: FirstOrderFilter, x: torch.Tensor, length) -> torch.Tensor:
    """``scipy.signal.filtfilt(b, a, x[:length])`` of a (n,) zero-padded
    track, 0 at and past ``length``: the one-row form of
    :func:`filtfilt_first_order` with ``lengths``, two K2 launches.

    ``length``: an int, a numpy int, a one-row ``RowInts``, or a 0-d
    array or tensor, read back to the host once (``RowInts.per_row``: K2
    checks its lengths on the host); at least 7 (scipy's odd extension
    reads ``x[length-7 .. length-1]``)."""
    length = RowInts.per_row(length, x.device)
    if not _PADLEN + 1 <= length.host[0] <= x.shape[-1]:
        raise ValueError(f"length {length.host[0]} is outside [7, {x.shape[-1]}]")
    return filtfilt_first_order(filt, x.reshape(1, -1).contiguous(), length)[0]


class SecondOrderSection(NamedTuple):
    """One row of scipy's ``sos``, normalised by a0: b = (b0, b1, b2),
    a = (1, a1, a2), all host floats."""

    b0: float
    b1: float
    b2: float
    a1: float
    a2: float

    @classmethod
    def of(cls, row: Sequence[float]) -> "SecondOrderSection":
        """From a (b0, b1, b2, a0, a1, a2) row, divided through by a0."""
        b0, b1, b2, a0, a1, a2 = (float(v) for v in row)
        return cls(b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def butter_coefficients(order: int, cutoff_hz: float, fs: float):
    """Digital Butterworth low-pass design, identical to
    ``scipy.signal.butter(order, cutoff_hz, fs=fs)``: (b, a) as tuples of
    host floats (order 1 in closed form)."""
    if order == 1:
        f = butter1_coefficients(cutoff_hz, fs)
        return (f.b0, f.b1), (1.0, f.a1)
    from scipy import signal

    b, a = signal.butter(order, cutoff_hz, fs=fs)
    return tuple(float(v) for v in b), tuple(float(v) for v in a)


@functools.lru_cache(maxsize=64)
def butter_sos(order: int, cutoff_hz: float, fs: float) -> Tuple[SecondOrderSection, ...]:
    """``scipy.signal.butter(order, cutoff_hz, fs=fs, output="sos")`` as
    sections in scipy's order, designed on the host."""
    from scipy import signal

    return tuple(
        SecondOrderSection.of(row) for row in signal.butter(order, cutoff_hz, fs=fs, output="sos")
    )


def sos_cascade(sections: Sequence[SecondOrderSection], x: torch.Tensor) -> torch.Tensor:
    """``scipy.signal.sosfilt(sections, x)`` with zero state along the last
    axis: one K3 launch per section."""
    for section in sections:
        x = sos.sos_filter(x, *section)
    return x


@stage_host_arrays
def butter_lowpass(order: int, cutoff_hz: float, fs: float, x: torch.Tensor) -> torch.Tensor:
    """``scipy.signal.lfilter(*scipy.signal.butter(order, f, fs=fs), x)``
    with zero initial state, along the last axis: order 1 in closed form
    on K2, higher orders as scipy's section cascade (:func:`sos_cascade`).
    It is causal, so a zero-padded row needs no length."""
    if order == 1:
        return lfilter_first_order(butter1_coefficients(cutoff_hz, fs), x)
    return sos_cascade(butter_sos(order, float(cutoff_hz), float(fs)), x)


@stage_host_arrays
def lfilter(b: Sequence[float], a: Sequence[float], x: torch.Tensor) -> torch.Tensor:
    """``scipy.signal.lfilter(b, a, x)`` with zero initial state, any order,
    along the last axis (host coefficients, normalised by a[0]): order 1
    on K2, order 2 on K3, and higher orders as the cascade of
    ``scipy.signal.tf2sos(b, a)``.  The JAX package's (n, n) companion
    scan is not carried over: sections stay accurate where it does not."""
    b = [float(v) for v in b]
    a = [float(v) for v in a]
    order = max(len(a), len(b)) - 1
    if order == 0:
        return x * (b[0] / a[0])
    if order > 2:
        from scipy import signal

        return sos_cascade([SecondOrderSection.of(row) for row in signal.tf2sos(b, a)], x)
    b = b + [0.0] * (3 - len(b))
    a = a + [0.0] * (3 - len(a))
    section = SecondOrderSection.of((*b, *a))
    if order == 1:
        return lfilter_first_order(FirstOrderFilter(section.b0, section.b1, section.a1), x)
    return sos_cascade([section], x)
