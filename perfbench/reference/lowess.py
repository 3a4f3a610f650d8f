"""LOWESS on an ascending grid, in float64 NumPy: Cleveland's local linear
fit with tricube weights over the k nearest points and delta skipping, with
no robustness iterations (``it = 0``, the deployments' setting).

Fits run at anchor points: the first point, then from each anchor the last
point within ``delta`` of it (at least the next point), up to the last
point; the points between two anchors are interpolated linearly.
"""

from __future__ import annotations

import numpy as np


def lowess(y: np.ndarray, x: np.ndarray, frac: float, delta: float) -> np.ndarray:
    """The smoothed values of ``y`` over the ascending abscissae ``x``."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    k = max(2, min(int(frac * n + 1e-10), n))
    anchors = [0]
    while anchors[-1] < n - 1:
        last = anchors[-1]
        beyond = int(np.searchsorted(x, x[last] + delta, side="right"))
        anchors.append(max(last + 1, beyond - 1))

    fitted = np.empty(len(anchors))
    left = 0
    for a, i in enumerate(anchors):
        # slide the k-point window right while its right neighbour is
        # nearer to x[i] than its left end
        while left + k < n and x[i] - x[left] > x[left + k] - x[i]:
            left += 1
        xw = x[left : left + k]
        radius = max(x[i] - xw[0], xw[-1] - x[i])
        w = (1.0 - (np.abs(xw - x[i]) / radius) ** 3) ** 3
        w /= w.sum()
        centre = np.dot(w, xw)
        spread = np.dot(w, (xw - centre) ** 2)
        rows = w * (1.0 + (x[i] - centre) * (xw - centre) / spread)
        fitted[a] = np.dot(rows, y[left : left + k])
    return np.interp(x, x[anchors], fitted)
