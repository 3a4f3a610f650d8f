"""LOWESS smoother on a fixed uniform grid, planned on the host (numpy).

Copy of ``matchering_tpu.ops.lowess`` (reference ``matchering/dsp.py:103-106``:
statsmodels' lowess on ``linspace(0, 1, n)`` with ``it=0`` and
``delta=0.001`` by default).  Everything data-independent is planned on the
host (:func:`plan_lowess`): the ``delta``-skipping anchors, each anchor's
k-nearest window and tricube weights, and the ``it=0`` regression rows.

* ``it=0`` with ``delta > 0`` is linear in the data: the whole smoother is
  a pair of dense float64 matrices (:func:`linear_operator`), which
  ``smoothing`` folds into its interpolation operators.
* Otherwise (``it > 0``, or the exact ``delta = 0`` form) :func:`smooth`
  runs on the device over a batch of curves: the windowed gather, the
  ``it=0`` fit, and per robustness iteration the bisquare weights from the
  median residual and a closed-form weighted regression per anchor
  (``matchering_tpu/ops/lowess.py:181-217``).  The plan's index and weight
  arrays are staged once per device (:func:`stage_plan`).  It runs in
  float64 whatever the working dtype: the JAX float32 robust smoother is
  3.6e-5 off its float64 on a curve of scale 1.79 (about 94 dB).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import stage_host_arrays


class LowessPlan(NamedTuple):
    """Static host-side plan (numpy arrays)."""

    n: int
    k: int
    anchors: np.ndarray  # (na,) int — grid indices fitted directly
    window_starts: np.ndarray  # (na,) int — left edge of each anchor's window
    tricube: np.ndarray  # (na, k) float64 — un-normalized tricube weights
    xw: np.ndarray  # (na, k) float64 — window abscissae
    xvals: np.ndarray  # (na,) float64 — anchor abscissae
    fit_rows: np.ndarray  # (na, k) float64 — it=0 regression row vectors
    interp_left: np.ndarray  # (n,) int — anchor index left of each point
    interp_weight: np.ndarray  # (n,) float64 — lerp weight toward right anchor


@functools.lru_cache(maxsize=32)
def plan_lowess(n: int, frac: float, delta: float) -> LowessPlan:
    x = np.linspace(0.0, 1.0, n)
    k = max(2, min(int(frac * n + 1e-10), n))

    # --- anchor selection (delta skipping, Cleveland's rule) ---
    anchors = [0]
    last = 0
    while last < n - 1:
        cut = x[last] + delta
        j = last + 1
        while j < n and x[j] <= cut:
            j += 1
        nxt = max(last + 1, j - 1)
        anchors.append(nxt)
        last = nxt
    anchors = np.asarray(anchors, dtype=np.int64)
    na = anchors.shape[0]

    # --- k-nearest windows per anchor (two-pointer, strict advance) ---
    starts = np.empty(na, dtype=np.int64)
    left = 0
    for idx, i in enumerate(anchors):
        right = left + k - 1
        # slide the window right while the next point is strictly closer
        while right < n - 1 and (x[right + 1] - x[i]) < (x[i] - x[left]):
            left += 1
            right += 1
        # window must contain the anchor
        while left > i:
            left -= 1
        while left + k - 1 < i:
            left += 1
        starts[idx] = left
    offsets = np.arange(k)
    win_idx = starts[:, None] + offsets[None, :]  # (na, k)
    xw = x[win_idx]
    xvals = x[anchors].astype(np.float64)

    # --- tricube weights ---
    dist = np.abs(xw - xvals[:, None])
    radius = np.maximum(dist[:, 0], dist[:, -1])
    radius = np.where(radius <= 0, 1.0, radius)
    d = np.clip(dist / radius[:, None], 0.0, 1.0)
    tricube = (1.0 - d**3) ** 3

    # --- it=0 regression rows: fitted = rows @ y_window ---
    fit_rows = _wls_rows(xw, xvals, tricube)

    # --- interpolation map from anchors back to the full grid ---
    interp_left = np.searchsorted(anchors, np.arange(n), side="right") - 1
    interp_left = np.clip(interp_left, 0, na - 2)
    x_left = x[anchors[interp_left]]
    x_right = x[anchors[interp_left + 1]]
    with np.errstate(invalid="ignore", divide="ignore"):
        w = (np.arange(n) * 0.0 + (x - x_left)) / (x_right - x_left)
    w = np.clip(np.nan_to_num(w), 0.0, 1.0)
    # anchor points must reproduce their own fit exactly
    w[anchors] = 0.0
    interp_left[anchors] = np.arange(na)
    interp_left = np.clip(interp_left, 0, na - 1)

    return LowessPlan(
        n=n,
        k=k,
        anchors=anchors,
        window_starts=starts,
        tricube=tricube,
        xw=xw,
        xvals=xvals,
        fit_rows=fit_rows,
        interp_left=interp_left,
        interp_weight=w,
    )


def _wls_rows(xw: np.ndarray, xvals: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Closed-form weighted linear regression prediction rows (numpy).

    For each anchor: fitted(xval) = sum_j row_j * y_j with
    row = w_norm * (1 + (xval - xbar) * (x - xbar) / var)  (WLS prediction),
    falling back to the weighted mean when the window has ~zero x variance.
    """
    wsum = weights.sum(axis=1, keepdims=True)
    wn = weights / np.maximum(wsum, 1e-300)
    xbar = (wn * xw).sum(axis=1, keepdims=True)
    dev = xw - xbar
    var = (wn * dev**2).sum(axis=1, keepdims=True)
    slope_term = np.where(
        var > 1e-12 * np.maximum(xbar**2, 1.0),
        dev * (xvals[:, None] - xbar) / np.maximum(var, 1e-300),
        0.0,
    )
    return wn * (1.0 + slope_term)


def linear_operator(n: int, frac: float, delta: float):
    """The ``it=0`` LOWESS smoother as a pair of dense float64 matrices:
    ``smooth(y, frac, 0, delta) == W @ (F @ y)`` exactly (both maps are
    linear in the data: F holds each anchor's WLS prediction row in its
    window columns, W the anchor->grid linear interpolation).

    The matrices fold into the lin<->log interpolation operators on the
    host (``smoothing``), so the device applies LOWESS inside two matmuls.
    Only for ``delta > 0`` (an anchor subset) and ``it == 0`` (robustness
    iterations are data-dependent)."""
    plan = plan_lowess(n, float(frac), float(delta))
    na = plan.anchors.shape[0]
    F = np.zeros((na, n))
    for i, s in enumerate(plan.window_starts):
        F[i, s : s + plan.k] = plan.fit_rows[i]
    W = np.zeros((n, na))
    idx = np.arange(n)
    left = plan.interp_left
    right = np.minimum(left + 1, na - 1)
    w = plan.interp_weight
    W[idx, left] += 1.0 - w
    W[idx, right] += w
    return W, F


class StagedPlan(NamedTuple):
    """A :class:`LowessPlan`'s arrays on a device, in float64, with the
    smoother's robustness iterations: what :func:`smooth` reads."""

    it: int
    win_idx: torch.Tensor  # (na * k,) int64 — flattened window indices
    fit_rows: torch.Tensor  # (na, k) — it=0 regression rows
    tricube: torch.Tensor  # (na, k)
    xw: torch.Tensor  # (na, k)
    xvals: torch.Tensor  # (na, 1)
    interp_left: torch.Tensor  # (n,) int64
    interp_right: torch.Tensor  # (n,) int64
    interp_weight: torch.Tensor  # (n,)


@functools.lru_cache(maxsize=8)
def stage_plan(n: int, frac: float, it: int, delta: float, device) -> StagedPlan:
    """The plan of ``(n, frac, delta)`` staged on ``device`` once (the
    exact plan's window indices are 20 MB at n = 8193), for ``it``
    robustness iterations."""
    plan = plan_lowess(n, float(frac), float(delta))
    device = torch.device(device)

    def on(array, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(array), dtype=dtype, device=device)

    win_idx = plan.window_starts[:, None] + np.arange(plan.k)[None, :]
    na = plan.anchors.shape[0]
    return StagedPlan(
        it=int(it),
        win_idx=on(win_idx.reshape(-1), torch.int64),
        fit_rows=on(plan.fit_rows),
        tricube=on(plan.tricube),
        xw=on(plan.xw),
        xvals=on(plan.xvals[:, None]),
        interp_left=on(plan.interp_left, torch.int64),
        interp_right=on(np.minimum(plan.interp_left + 1, na - 1), torch.int64),
        interp_weight=on(plan.interp_weight),
    )


def _interp_from_anchors(plan: StagedPlan, fitted: torch.Tensor) -> torch.Tensor:
    left = fitted.index_select(-1, plan.interp_left)
    right = fitted.index_select(-1, plan.interp_right)
    return (1.0 - plan.interp_weight) * left + plan.interp_weight * right


def _wls_fit(plan: StagedPlan, weights: torch.Tensor, yw: torch.Tensor) -> torch.Tensor:
    """Closed-form weighted regression at each anchor with the JAX
    package's device floors (``_wls_fit_jax``: 1e-30, and ``var > 1e-12``
    absolute), not the host rows' 1e-300 and relative test."""
    wsum = torch.clamp(weights.sum(-1, keepdim=True), min=1e-30)
    wn = weights / wsum
    xbar = (wn * plan.xw).sum(-1, keepdim=True)
    dev = plan.xw - xbar
    var = (wn * dev**2).sum(-1, keepdim=True)
    slope = torch.where(var > 1e-12, dev * (plan.xvals - xbar) / torch.clamp(var, min=1e-30), 0.0)
    return (wn * (1.0 + slope) * yw).sum(-1)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis from a device sort: the mean of the two
    middle values for an even length, as ``jnp.median`` (``torch.median``
    returns the lower one)."""
    n = x.shape[-1]
    ordered = torch.sort(x, dim=-1).values
    return 0.5 * (ordered[..., (n - 1) // 2] + ordered[..., n // 2])


@stage_host_arrays
def smooth(
    y: torch.Tensor,
    frac: Optional[float] = None,
    it: int = 0,
    delta: float = 0.001,
    plan: Optional[StagedPlan] = None,
) -> torch.Tensor:
    """LOWESS-smooth each row of ``y`` ((B, n) or (n,)) sampled on
    ``linspace(0, 1, n)``, ``statsmodels...lowess(y, x, frac, it,
    delta)[:, 1]``, the counterpart of ``matchering_tpu.ops.lowess.smooth``
    over a batch of curves.  ``plan``: the staged plan of the parameters
    (:func:`stage_plan`), in place of ``frac``, ``it`` and ``delta``.
    Runs in float64 on ``y``'s device with no host sync, and returns
    ``y``'s dtype."""
    if plan is None:
        plan = stage_plan(y.shape[-1], float(frac), int(it), float(delta), y.device)
    na, k = plan.fit_rows.shape
    values = y.to(torch.float64)

    def windows(v):
        return v.index_select(-1, plan.win_idx).reshape(*v.shape[:-1], na, k)

    yw = windows(values)
    out = _interp_from_anchors(plan, (plan.fit_rows * yw).sum(-1))
    for _ in range(plan.it):
        resid = (values - out).abs()
        scale = _median(resid)[..., None]
        rw = torch.clamp(resid / torch.clamp(6.0 * scale, min=1e-300), 0.0, 1.0)
        rw = (1.0 - rw**2) ** 2  # bisquare
        out = _interp_from_anchors(plan, _wls_fit(plan, plan.tricube * windows(rw), yw))
    return out.to(y.dtype)
