"""Plain float64 previews: the loudest stretch of a master and the same
stretch of its target, in NumPy.

Independent of the program under test, as ``matchering.py`` is.  It
follows sergree/matchering 2.0 ``preview_creator.py:30-94``: the result's
energy (the sum of squares over both channels; the argmax of upstream's
RMS is the same window) in every ``preview_size`` window on the
``preview_analysis_step`` grid, the first loudest window taken; the
target's piece clipped to ``threshold``; both pieces faded in and out
linearly (``dsp.py:146-152``) over ``min(preview_fade_size, piece //
preview_fade_coefficient)`` samples, unless the piece is the whole track.
Sizes are given in seconds, as a configuration file gives them, and are
taken in samples as upstream's ``Config`` takes them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .matchering import DEFAULTS

PREVIEW_DEFAULTS = {
    "preview_size": 30.0,
    "preview_analysis_step": 5.0,
    "preview_fade_size": 1.0,
    "preview_fade_coefficient": 8.0,
}


def sizes(overrides: Dict) -> Tuple[int, int, int, float]:
    """(window, step, fade size) in samples and the fade coefficient of a
    configuration file's ``parameters``."""
    p = {**PREVIEW_DEFAULTS, **overrides}
    rate = overrides.get("internal_sample_rate", DEFAULTS["internal_sample_rate"])
    return (int(p["preview_size"] * rate), int(p["preview_analysis_step"] * rate),
            int(p["preview_fade_size"] * rate), p["preview_fade_coefficient"])


def window_energies(result: np.ndarray, window: int, step: int) -> np.ndarray:
    """The energy of each whole ``window`` on the ``step`` grid; none
    where the window is longer than the track."""
    energy = np.sum(np.square(np.asarray(result, dtype=np.float64)), axis=1)
    count = (energy.shape[0] - window) // step + 1 if window <= energy.shape[0] else 0
    return np.array([np.sum(energy[b * step : b * step + window]) for b in range(count)])


def loudest(result: np.ndarray, window: int, step: int) -> Tuple[int, Optional[float]]:
    """The index of the first loudest window (0 where there is at most
    one), and the gap between the best and the second-best window
    energies relative to the best (None where there is at most one)."""
    energies = window_energies(result, window, step)
    if energies.shape[0] < 2:
        return 0, None
    best, second = np.sort(energies)[-2:][::-1]
    return int(np.argmax(energies)), float((best - second) / best)


def fade(piece: np.ndarray, size: int) -> np.ndarray:
    """A copy of ``piece`` faded linearly in over its first ``size``
    samples and out over its last."""
    out = np.array(piece, dtype=np.float64)
    ramp = np.linspace(0.0, 1.0, size)[:, None]
    out[:size] *= ramp
    out[out.shape[0] - size :] *= ramp[::-1]
    return out


def preview(target: np.ndarray, result: np.ndarray, overrides: Dict):
    """(target piece, result piece, window index, top-two gap) of an
    (n, 2) target and its (n, 2) master, in float64."""
    window, step, fade_size, coefficient = sizes(overrides)
    threshold = overrides.get("threshold", DEFAULTS["threshold"])
    index, gap = loudest(result, window, step)
    n = result.shape[0]
    start, stop = (index * step, index * step + window) if window < n else (0, n)
    target_piece = np.clip(np.asarray(target[start:stop], dtype=np.float64), -threshold, threshold)
    result_piece = np.asarray(result[start:stop], dtype=np.float64)
    if stop - start != n:
        size = min(fade_size, int((stop - start) // coefficient))
        target_piece, result_piece = fade(target_piece, size), fade(result_piece, size)
    return target_piece, result_piece, index, gap
