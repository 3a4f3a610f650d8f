"""Matching-curve smoothing: lin->log resample, LOWESS, log->lin resample.

Counterpart of ``matchering_tpu.ops.smoothing`` (reference
``matchering/stage_helpers/match_frequencies.py:45-75``).  Both cubic-spline
resamplings interpolate between static frequency grids, so each is a dense
linear operator built once on the host in float64 (scipy's ``interp1d``
applied to the identity).  The ``it=0`` LOWESS smoother with ``delta > 0``
is linear too (``lowess.linear_operator``), and is folded in on the host:
``to_log' = F @ to_log`` and ``to_lin' = to_lin @ W``.  The device then
smooths a curve with two matmuls.  Any other LOWESS (``lowess_it > 0``,
``lowess_exact``, ``lowess_delta = 0``) runs between the two plain
operators as ``lowess.smooth`` on the device.  Whether the smoother is
folded is an explicit field of the operator state, ``Smoothing.lowess``;
only a bare (to_log, to_lin) pair, the JAX package's form, is read by its
shape, as there.

Boundary semantics kept: the smoothed curve's DC bin is zeroed and bin 1
keeps its unsmoothed value (``match_frequencies.py:73-74``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import resolve_device, stage_host_arrays, torch_dtype
from . import lowess


@functools.lru_cache(maxsize=8)
def _grids(sample_rate: int, fft_size: int, oversampling: int) -> Tuple[np.ndarray, np.ndarray]:
    nyquist = sample_rate * 0.5
    grid_linear = nyquist * np.linspace(0, 1, fft_size // 2 + 1)
    grid_logarithmic = nyquist * np.logspace(
        np.log10(4 / fft_size), 0, (fft_size // 2) * oversampling + 1
    )
    return grid_linear, grid_logarithmic


@functools.lru_cache(maxsize=8)
def interpolation_operators(
    sample_rate: int, fft_size: int, oversampling: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(lin->log, log->lin) dense cubic-interpolation matrices (float64),
    scipy's ``interp1d(kind="cubic")`` evaluated on the identity."""
    from scipy import interpolate

    grid_linear, grid_logarithmic = _grids(sample_rate, fft_size, oversampling)
    nl = grid_linear.shape[0]
    ng = grid_logarithmic.shape[0]

    to_log = interpolate.interp1d(grid_linear, np.eye(nl), "cubic", axis=0)(
        grid_logarithmic
    )  # (ng, nl)
    to_lin = interpolate.interp1d(
        grid_logarithmic, np.eye(ng), "cubic", axis=0, fill_value="extrapolate"
    )(grid_linear)  # (nl, ng)
    return np.ascontiguousarray(to_log), np.ascontiguousarray(to_lin)


@functools.lru_cache(maxsize=8)
def folded_operators(
    sample_rate: int, fft_size: int, oversampling: int, frac: float, delta: float
) -> Tuple[np.ndarray, np.ndarray]:
    """The interpolation operators with the ``it=0`` LOWESS folded in
    (float64 numpy): ``(F @ to_log, to_lin @ W)``."""
    to_log, to_lin = interpolation_operators(sample_rate, fft_size, oversampling)
    W, F = lowess.linear_operator(to_log.shape[0], float(frac), float(delta))
    return F @ to_log, to_lin @ W


class Smoothing(NamedTuple):
    """The smoothing state of a ``Config`` on a device: the (to_log,
    to_lin) operators in the working dtype and, where the LOWESS is not
    folded into them, its staged plan (None: folded)."""

    to_log: torch.Tensor
    to_lin: torch.Tensor
    lowess: Optional[lowess.StagedPlan] = None


def folds(lowess_params: Tuple[float, int, float]) -> bool:
    """True where a LOWESS of (frac, it, delta) is a fixed linear map with
    an anchor subset, folded into the operators on the host
    (``matchering_tpu/ops/smoothing.py:88-93``)."""
    _, it, delta = lowess_params
    return it == 0 and delta > 0


def lowess_folds(config) -> bool:
    """:func:`folds` for the LOWESS of a ``Config``."""
    return folds(lowess_parameters(config))


def lowess_parameters(config) -> Tuple[float, int, float]:
    """(frac, it, delta) of the configured LOWESS; ``lowess_exact`` means
    delta = 0 (``matchering_tpu/stages.py:174``)."""
    delta = 0.0 if config.lowess_exact else config.lowess_delta
    return float(config.lowess_frac), int(config.lowess_it), float(delta)


def grid_rates(config) -> Tuple[int, int, int]:
    """(sample_rate, fft_size, oversampling): what the grids depend on."""
    return config.internal_sample_rate, config.fft_size, config.lin_log_oversampling


def host_operators(
    sample_rate: int, fft_size: int, oversampling: int, lowess_params=None
) -> Tuple[np.ndarray, np.ndarray]:
    """The (to_log, to_lin) float64 numpy operators: with the LOWESS of
    ``lowess_params = (frac, it, delta)`` folded in where it :func:`folds`,
    else the plain interpolation operators."""
    if lowess_params is not None and folds(lowess_params):
        frac, _, delta = lowess_params
        return folded_operators(sample_rate, fft_size, oversampling, frac, delta)
    return interpolation_operators(sample_rate, fft_size, oversampling)


def host_operators_for_config(config) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`host_operators` of a ``Config``, equal to the JAX package's
    ``operator_arrays_for_config``."""
    return host_operators(*grid_rates(config), lowess_parameters(config))


def interpolation_operator_arrays(
    sample_rate: int, fft_size: int, oversampling: int, dtype, lowess_params=None, *, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (to_log, to_lin) operators of :func:`host_operators` as tensors
    of ``dtype`` (a torch dtype or its name) on ``device`` (``cuda``
    unless named), staged once per (grids, LOWESS, dtype, device) in the
    cache of ``state.operators_for_config``.  Where ``lowess_params`` does
    not fold, the pair is the plain interpolation and the LOWESS plan is
    staged beside it there."""
    from ..state import staged_operators

    if lowess_params is not None:
        frac, it, delta = lowess_params
        lowess_params = (float(frac), int(it), float(delta))
    staged = staged_operators(
        (sample_rate, fft_size, oversampling), lowess_params, torch_dtype(dtype), resolve_device(device)
    )
    return staged.to_log, staged.to_lin


def operator_arrays_for_config(config, *, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (to_log, to_lin) pair of ``state.operators_for_config(config,
    device)``: the operators ``stages.master_graph`` runs with, the it=0
    LOWESS folded in where it folds."""
    from ..state import operators_for_config

    staged = operators_for_config(config, resolve_device(device))
    return staged.to_log, staged.to_lin


def as_smoothing(operators, grid_points: int, lowess_params, dtype: torch.dtype, device) -> Smoothing:
    """The smoothing state that ``operators`` stand for, on ``device`` in
    ``dtype``: a :class:`Smoothing` is itself; a (to_log, to_lin) pair (the
    JAX package's form, e.g. :func:`operator_arrays_for_config`) is put
    there (no copy where it already is), with the LOWESS of
    ``lowess_params = (frac, it, delta)`` staged beside it unless the pair
    has it folded in.  As in the JAX package, a bare pair tells that by
    its inner dimension: the folded one has fewer anchors than the
    ``grid_points`` of the log grid."""
    if isinstance(operators, Smoothing):
        return operators
    to_log, to_lin = (
        torch.as_tensor(op if isinstance(op, torch.Tensor) else np.asarray(op), dtype=dtype, device=device)
        for op in operators
    )
    plan = None
    if to_log.shape[0] == grid_points:
        frac, it, delta = lowess_params
        plan = lowess.stage_plan(grid_points, float(frac), int(it), float(delta), to_log.device)
    return Smoothing(to_log, to_lin, plan)


@stage_host_arrays
def smooth_exponentially(
    matching_fft: torch.Tensor,
    sample_rate: int,
    fft_size: int,
    oversampling: int,
    lowess_frac: float,
    lowess_it: int,
    lowess_delta: float,
    operators=None,
) -> torch.Tensor:
    """Smooth matching spectra (..., fft_size//2 + 1) on the log grid on
    their device: ``to_log``, the LOWESS where it is not folded
    (``lowess.smooth``, in float64), then ``to_lin``; both products
    contract the last axis, so a batch of curves is one product.

    ``operators``: a :class:`Smoothing` (``state.operators_for_config``),
    a (to_log, to_lin) pair (:func:`as_smoothing`), or None for the plain
    interpolation operators of the grids, staged once per (grids, dtype,
    device), with the LOWESS run between them, as the JAX package does
    with none.

    The caller keeps float32 matmuls at full precision
    (``torch.backends.cuda.matmul.allow_tf32 = False``, set by
    ``state.staged_operators``): TF32 keeps about three decimal digits."""
    if operators is None:
        from ..state import staged_operators

        operators = staged_operators(
            (sample_rate, fft_size, oversampling), None, matching_fft.dtype, matching_fft.device
        )[:2]
    operators = as_smoothing(
        operators,
        (fft_size // 2) * oversampling + 1,
        (lowess_frac, lowess_it, lowess_delta),
        matching_fft.dtype,
        matching_fft.device,
    )
    on_log_grid = matching_fft @ operators.to_log.mT
    if operators.lowess is not None:
        on_log_grid = lowess.smooth(on_log_grid, plan=operators.lowess)
    filtered = on_log_grid @ operators.to_lin.mT
    filtered[..., 0] = 0.0
    filtered[..., 1] = matching_fft[..., 1]
    return filtered
