"""LOWESS smoother on a fixed uniform grid, planned on the host (numpy).

Copy of the host planners of ``matchering_tpu.ops.lowess`` (reference
``matchering/dsp.py:103-106``: statsmodels' lowess on ``linspace(0, 1, n)``
with ``it=0`` and ``delta=0.001`` by default).  Because the abscissae are a
static uniform grid and ``it=0`` makes the smoother linear in the data, the
whole smoother is a pair of dense float64 matrices
(:func:`linear_operator`), which ``smoothing`` folds into its interpolation
operators.  The robustness iterations (``it > 0``) and the exact
(``delta = 0``) form are not ported yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np


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
