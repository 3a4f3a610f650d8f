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
folded is an explicit field of the operator state, ``Smoothing.lowess``,
and of the port's own (to_log, to_lin) pairs, ``OperatorPair.folded``.  A
bare pair, the JAX package's form, is read by its shape where the shape
settles it, and by its values where it does not (:func:`as_smoothing`):
the JAX package reads it by the shape alone, and where its LOWESS keeps
every grid point as an anchor it takes its own folded pair for the plain
one and smooths twice.

Boundary semantics kept: the smoothed curve's DC bin is zeroed and bin 1
keeps its unsmoothed value (``match_frequencies.py:73-74``).
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import utils
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


class OperatorPair(tuple):
    """A (to_log, to_lin) pair of the port's own: it unpacks as the JAX
    package's pair, and ``folded`` says whether the it=0 LOWESS is folded
    into it, so :func:`as_smoothing` need not guess."""

    def __new__(cls, to_log, to_lin, folded: bool):
        pair = super().__new__(cls, (to_log, to_lin))
        pair.folded = bool(folded)
        return pair

    def __getnewargs__(self):
        return (*self, self.folded)


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
) -> OperatorPair:
    """The (to_log, to_lin) float64 numpy operators, an
    :class:`OperatorPair`: with the LOWESS of ``lowess_params = (frac, it,
    delta)`` folded in where it :func:`folds`, else the plain
    interpolation operators."""
    if lowess_params is not None and folds(lowess_params):
        frac, _, delta = lowess_params
        return OperatorPair(*folded_operators(sample_rate, fft_size, oversampling, frac, delta), True)
    return OperatorPair(*interpolation_operators(sample_rate, fft_size, oversampling), False)


def host_operators_for_config(config) -> OperatorPair:
    """:func:`host_operators` of a ``Config``, equal to the JAX package's
    ``operator_arrays_for_config``."""
    return host_operators(*grid_rates(config), lowess_parameters(config))


def interpolation_operator_arrays(
    sample_rate: int, fft_size: int, oversampling: int, dtype, lowess_params=None, *, device=None
) -> OperatorPair:
    """The (to_log, to_lin) operators of :func:`host_operators` as tensors
    of ``dtype`` (a torch dtype or its name) on ``device`` (``cuda``
    unless named), staged once per (grids, LOWESS, dtype, device) in the
    cache of ``state.operators_for_config``, as an :class:`OperatorPair`.
    Where ``lowess_params`` does not fold, the pair is the plain
    interpolation and the LOWESS plan is staged beside it there."""
    from ..state import staged_operators

    if lowess_params is not None:
        frac, it, delta = lowess_params
        lowess_params = (float(frac), int(it), float(delta))
    staged = staged_operators(
        (sample_rate, fft_size, oversampling), lowess_params, torch_dtype(dtype), resolve_device(device)
    )
    return OperatorPair(staged.to_log, staged.to_lin, lowess_params is not None and folds(lowess_params))


def operator_arrays_for_config(config, *, device=None) -> OperatorPair:
    """The (to_log, to_lin) :class:`OperatorPair` of
    ``state.operators_for_config(config, device)``: the operators
    ``stages.master_graph`` runs with, the it=0 LOWESS folded in where it
    folds."""
    from ..state import operators_for_config

    staged = operators_for_config(config, resolve_device(device))
    return OperatorPair(staged.to_log, staged.to_lin, lowess_folds(config))


# a pair's folded-or-plain image of the quadratic probe may differ from
# the other by this much (absolute; the probe's image is at most 1 on the
# log grid): float32 rounding gives ~5e-8, a LOWESS of 513-8193 anchors
# moves it by 5e-3 to 1e-2
_PROBE_TOL = 1e-5
# decisions by value, newest last: (id(to_log), id(to_lin), rates, lowess)
# -> (weak references to the two operators, folded); numpy, JAX and torch
# arrays all take weak references
_DECIDED: dict = {}
_DECIDED_MAX = 8


def _probe(op, vector: np.ndarray) -> np.ndarray:
    """``op @ vector`` in float64 on the host; a tensor computes it on its
    device and is read back once (``utils.read_back``)."""
    if not isinstance(op, torch.Tensor):
        return np.asarray(op, dtype=np.float64) @ vector
    product = op.to(torch.float64) @ torch.as_tensor(vector, device=op.device)
    return utils.read_back(product).cpu().numpy()


def _folded_by_value(to_log, rates, lowess_params) -> bool:
    """Whether ``to_log``, of as many rows as the log grid, is the plain
    interpolation or has the it=0 LOWESS of ``lowess_params`` folded in,
    where that LOWESS keeps every grid point as an anchor (so its
    anchor->grid map is the identity and the folded ``to_lin`` is the
    plain one).  Both are told apart by their image of a quadratic on the
    linear grid: the not-a-knot cubic spline reproduces it on the log
    grid exactly, the local-linear LOWESS does not."""
    sample_rate, fft_size, oversampling = rates
    grid_linear, grid_logarithmic = _grids(sample_rate, fft_size, oversampling)
    nyquist = sample_rate * 0.5
    plain = (grid_logarithmic / nyquist) ** 2
    frac, _, delta = lowess_params
    plan = lowess.plan_lowess(grid_logarithmic.shape[0], float(frac), float(delta))
    windows = plan.window_starts[:, None] + np.arange(plan.k)[None, :]
    folded = np.einsum("ak,ak->a", plan.fit_rows, plain[windows])
    image = _probe(to_log, (grid_linear / nyquist) ** 2)
    off_plain = float(np.max(np.abs(image - plain)))
    off_folded = float(np.max(np.abs(image - folded)))
    if off_plain <= _PROBE_TOL and off_plain <= off_folded:
        return False
    if off_folded <= _PROBE_TOL:
        return True
    raise ValueError(
        "a (to_log, to_lin) pair whose to_log is neither the plain interpolation of the grid "
        f"(off by {off_plain:.3g}) nor it with the LOWESS folded in (off by {off_folded:.3g}): "
        "pass a Smoothing (state.operators_for_config) or operator_arrays_for_config's pair"
    )


def _pair_is_folded(operators, grid_points: int, lowess_params, rates) -> bool:
    """Whether a bare (to_log, to_lin) pair has the it=0 LOWESS folded in.
    Its inner dimension settles it where it differs from the log grid's
    ``grid_points`` (the folded pair's is the anchor count), where the
    LOWESS does not fold, or where it would fold to fewer anchors than
    grid points.  Else (every grid point an anchor) its values decide,
    once per pair (:func:`_folded_by_value`, with the grids of ``rates =
    (sample_rate, fft_size, oversampling)``)."""
    to_log, to_lin = operators
    if to_log.shape[0] != grid_points:
        return True
    if not folds(lowess_params):
        return False
    frac, _, delta = lowess_params
    if lowess.plan_lowess(grid_points, float(frac), float(delta)).anchors.shape[0] < grid_points:
        return False
    if rates is None:
        raise ValueError(
            "a bare (to_log, to_lin) pair whose LOWESS keeps every grid point as an anchor does "
            "not say by its shape whether the LOWESS is folded in: pass a Smoothing "
            "(state.operators_for_config), operator_arrays_for_config's pair, or rates="
        )
    key = (id(to_log), id(to_lin), tuple(rates), tuple(lowess_params))
    seen = _DECIDED.get(key)
    if seen is not None and seen[0]() is to_log and seen[1]() is to_lin:
        return seen[2]
    folded = _folded_by_value(to_log, rates, lowess_params)
    if len(_DECIDED) >= _DECIDED_MAX:
        del _DECIDED[next(iter(_DECIDED))]  # the oldest
    _DECIDED[key] = (weakref.ref(to_log), weakref.ref(to_lin), folded)
    return folded


def as_smoothing(
    operators, grid_points: int, lowess_params, dtype: torch.dtype, device, *, rates=None
) -> Smoothing:
    """The smoothing state that ``operators`` stand for, on ``device`` in
    ``dtype``: a :class:`Smoothing` is itself; a (to_log, to_lin) pair is
    put there (no copy where it already is), with the LOWESS of
    ``lowess_params = (frac, it, delta)`` staged beside it unless the pair
    has it folded in, so that the LOWESS runs exactly once.  The port's
    :class:`OperatorPair` (:func:`operator_arrays_for_config`,
    :func:`interpolation_operator_arrays`) says which it is; a bare pair,
    as the JAX package gives it, is read by :func:`_pair_is_folded` on the
    log grid of ``grid_points`` and ``rates = (sample_rate, fft_size,
    oversampling)``."""
    if isinstance(operators, Smoothing):
        return operators
    if isinstance(operators, OperatorPair):
        folded = operators.folded
    else:
        folded = _pair_is_folded(operators, grid_points, lowess_params, rates)
    to_log, to_lin = (
        torch.as_tensor(op if isinstance(op, torch.Tensor) else np.asarray(op), dtype=dtype, device=device)
        for op in operators
    )
    plan = None
    if not folded:
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
    a (to_log, to_lin) pair (the port's :class:`OperatorPair` or the JAX
    package's, :func:`as_smoothing`), or None for the plain
    interpolation operators of the grids, staged once per (grids, dtype,
    device), with the LOWESS run between them, as the JAX package does
    with none.

    The caller keeps float32 matmuls at full precision
    (``torch.backends.cuda.matmul.allow_tf32 = False``, set by
    ``state.staged_operators``): TF32 keeps about three decimal digits."""
    rates = (sample_rate, fft_size, oversampling)
    if operators is None:
        from ..state import staged_operators

        plain = staged_operators(rates, None, matching_fft.dtype, matching_fft.device)
        operators = OperatorPair(plain.to_log, plain.to_lin, False)
    operators = as_smoothing(
        operators,
        (fft_size // 2) * oversampling + 1,
        (lowess_frac, lowess_it, lowess_delta),
        matching_fft.dtype,
        matching_fft.device,
        rates=rates,
    )
    on_log_grid = matching_fft @ operators.to_log.mT
    if operators.lowess is not None:
        on_log_grid = lowess.smooth(on_log_grid, plan=operators.lowess)
    filtered = on_log_grid @ operators.to_lin.mT
    filtered[..., 0] = 0.0
    filtered[..., 1] = matching_fft[..., 1]
    return filtered
