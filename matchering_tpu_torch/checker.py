"""Input conditioning: bounds, channel layout, peak heuristics.

Counterpart of ``matchering_tpu.checker`` (reference
``matchering/checker.py:31-142``): tracks outside the configured length
window are rejected, mono becomes stereo, more than two channels is an
error, and the TARGET gets clipping/limiting advisories from a peak count
on the device.  Resampling is not ported yet: a track whose rate differs
from ``config.internal_sample_rate`` raises its role's loading error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .config import Config
from .log import Code, ModuleError, debug, info, warning
from .ops import basics
from .utils import resolve_device, time_str, to_device


@dataclass(frozen=True)
class _RolePolicy:
    """Event codes and behaviours attached to one input role."""

    name: str
    too_long: Code
    too_short: Code
    mono: Code
    too_many_channels: Code
    unsupported_rate: Code
    heuristics: bool  # clipping/limiter advisories run for the TARGET only


_POLICIES = {
    "TARGET": _RolePolicy(
        name="TARGET",
        too_long=Code.ERROR_TARGET_LENGTH_IS_EXCEEDED,
        too_short=Code.ERROR_TARGET_LENGTH_IS_TOO_SMALL,
        mono=Code.INFO_TARGET_IS_MONO,
        too_many_channels=Code.ERROR_TARGET_NUM_OF_CHANNELS_IS_EXCEEDED,
        unsupported_rate=Code.ERROR_TARGET_LOADING,
        heuristics=True,
    ),
    "REFERENCE": _RolePolicy(
        name="REFERENCE",
        too_long=Code.ERROR_REFERENCE_LENGTH_LENGTH_IS_EXCEEDED,
        too_short=Code.ERROR_REFERENCE_LENGTH_LENGTH_TOO_SMALL,
        mono=Code.INFO_REFERENCE_IS_MONO,
        too_many_channels=Code.ERROR_REFERENCE_NUM_OF_CHANNELS_IS_EXCEEDED,
        unsupported_rate=Code.ERROR_REFERENCE_LOADING,
        heuristics=False,
    ),
}


def _bound_length(
    array: np.ndarray, sample_rate: int, config: Config, policy: _RolePolicy
) -> None:
    samples = array.shape[0]
    debug(
        f"{policy.name} duration: {time_str(samples, sample_rate)} "
        f"({samples} samples at {sample_rate} Hz)"
    )
    if samples > config.max_length * sample_rate:
        raise ModuleError(policy.too_long)
    if samples < config.min_track_samples(sample_rate):
        raise ModuleError(policy.too_short)


def _to_stereo(array: np.ndarray, policy: _RolePolicy) -> np.ndarray:
    channels = array.shape[1]
    if channels == 2:
        return array
    if channels == 1:
        info(policy.mono)
        return np.repeat(array, repeats=2, axis=1)
    raise ModuleError(policy.too_many_channels)


def _require_internal_rate(sample_rate: int, config: Config, policy: _RolePolicy) -> None:
    if sample_rate != config.internal_sample_rate:
        debug(
            f"{policy.name} is at {sample_rate} Hz; resampling to "
            f"{config.internal_sample_rate} Hz is not ported yet"
        )
        raise ModuleError(policy.unsupported_rate)


def _int_to_float(array: np.ndarray) -> np.ndarray:
    if np.issubdtype(array.dtype, np.integer):
        return array.astype(np.float64) / basics.pcm_int_scale(array.dtype)
    return array


def _peak_heuristics(array: np.ndarray, config: Config, device) -> None:
    """Advisory-only analysis of the peak population: many samples pinned at
    one maximum suggest clipping (at full scale) or an upstream limiter."""
    peak, pinned = basics.count_max_peaks(to_device(array, device))
    peak, pinned = float(peak), int(pinned)
    if pinned <= config.clipping_samples_threshold:
        return
    at_full_scale = abs(peak - 1.0) <= 1e-8 + 1e-5  # np.isclose(peak, 1.0)
    if at_full_scale:
        warning(Code.WARNING_TARGET_IS_CLIPPING)
    elif pinned > config.limited_samples_threshold:
        warning(Code.WARNING_TARGET_LIMITER_IS_APPLIED)


def check(
    array: np.ndarray, sample_rate: int, config: Config, name: str, device=None
) -> Tuple[np.ndarray, int]:
    """Condition one input track for the mastering graph: bound its length,
    force stereo, require the internal rate, and (for the TARGET) emit
    peak-population advisories, counted on ``device`` (``cuda`` unless
    named)."""
    policy = _POLICIES[name.upper()]
    _bound_length(array, sample_rate, config, policy)
    array = _to_stereo(array, policy)
    _require_internal_rate(sample_rate, config, policy)
    if policy.heuristics:
        _peak_heuristics(array, config, resolve_device(device))
    return array, sample_rate


def check_equality(target: np.ndarray, reference: np.ndarray) -> None:
    """Matching a track against itself is meaningless; reject it
    (reference ``checker.py:140-142``).  Staged integer PCM compares in the
    float domain."""
    if target.shape == reference.shape and np.allclose(
        _int_to_float(target), _int_to_float(reference)
    ):
        raise ModuleError(Code.ERROR_TARGET_EQUALS_REFERENCE)
