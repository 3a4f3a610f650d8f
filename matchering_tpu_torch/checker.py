"""Input conditioning: bounds, channel layout, peak heuristics.

Counterpart of ``matchering_tpu.checker`` (reference
``matchering/checker.py:31-142``): tracks outside the configured length
window are rejected, mono becomes stereo, more than two channels is an
error, a track at another rate than ``config.internal_sample_rate`` is
resampled to it on the device (``ops.resample``; the reference delegates to
``resampy``, ``checker.py:42``), and the TARGET gets clipping/limiting
advisories from a peak count on the device.  Each track crosses to the
device once, as it was decoded (integer PCM as its raw codes, converted
where it is read), and comes back as a tensor there: the resampled track
as float64, any other in the dtype it was given.  The equality check runs
on those tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from . import trace
from .config import Config
from .log import Code, ModuleError, debug, info, warning
from .ops import basics, resample
from .utils import read_back, resolve_device, time_str, to_device


@dataclass(frozen=True)
class _RolePolicy:
    """Event codes and behaviours attached to one input role."""

    name: str
    too_long: Code
    too_short: Code
    mono: Code
    too_many_channels: Code
    resample_event: object  # zero-arg callable firing the role's resample code
    heuristics: bool  # clipping/limiter advisories run for the TARGET only


_POLICIES = {
    "TARGET": _RolePolicy(
        name="TARGET",
        too_long=Code.ERROR_TARGET_LENGTH_IS_EXCEEDED,
        too_short=Code.ERROR_TARGET_LENGTH_IS_TOO_SMALL,
        mono=Code.INFO_TARGET_IS_MONO,
        too_many_channels=Code.ERROR_TARGET_NUM_OF_CHANNELS_IS_EXCEEDED,
        resample_event=lambda: warning(Code.WARNING_TARGET_IS_RESAMPLED),
        heuristics=True,
    ),
    "REFERENCE": _RolePolicy(
        name="REFERENCE",
        too_long=Code.ERROR_REFERENCE_LENGTH_LENGTH_IS_EXCEEDED,
        too_short=Code.ERROR_REFERENCE_LENGTH_LENGTH_TOO_SMALL,
        mono=Code.INFO_REFERENCE_IS_MONO,
        too_many_channels=Code.ERROR_REFERENCE_NUM_OF_CHANNELS_IS_EXCEEDED,
        resample_event=lambda: info(Code.INFO_REFERENCE_IS_RESAMPLED),
        heuristics=False,
    ),
}


def _bound_length(
    array, sample_rate: int, config: Config, policy: _RolePolicy
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


def _to_stereo(array, policy: _RolePolicy, device) -> torch.Tensor:
    """Stage the track on ``device`` as stereo.  Mono crosses as one
    channel and is doubled there: half the bytes of doubling it first."""
    channels = array.shape[1]
    if channels not in (1, 2):
        raise ModuleError(policy.too_many_channels)
    staged = to_device(array, device)
    if channels == 1:
        info(policy.mono)
        return staged.repeat(1, 2)
    return staged


def _to_internal_rate(
    array: torch.Tensor, sample_rate: int, config: Config, policy: _RolePolicy
) -> Tuple[torch.Tensor, int]:
    """Resample the staged track to the internal rate on its device;
    integer PCM converts there."""
    internal = config.internal_sample_rate
    if sample_rate == internal:
        return array, sample_rate
    debug(f"Rate conversion for {policy.name}: {sample_rate} -> {internal} Hz")
    converted = resample.resample(array, sample_rate, internal)
    policy.resample_event()
    return converted, internal


def _as_float64(array, device) -> torch.Tensor:
    return basics.to_working_float(to_device(array, device), torch.float64)


def _peak_heuristics(array: torch.Tensor, config: Config) -> None:
    """Advisory-only analysis of the peak population: many samples pinned at
    one maximum suggest clipping (at full scale) or an upstream limiter."""
    peak, pinned = basics.count_max_peaks(array)
    peak, pinned = float(read_back(peak)), int(read_back(pinned))
    if pinned <= config.clipping_samples_threshold:
        return
    at_full_scale = abs(peak - 1.0) <= 1e-8 + 1e-5  # np.isclose(peak, 1.0)
    if at_full_scale:
        warning(Code.WARNING_TARGET_IS_CLIPPING)
    elif pinned > config.limited_samples_threshold:
        warning(Code.WARNING_TARGET_LIMITER_IS_APPLIED)


def check(
    array, sample_rate: int, config: Config, name: str, *, device=None
) -> Tuple[torch.Tensor, int]:
    """Condition one input track for the mastering graph: bound its length,
    stage it on ``device`` (``cuda`` unless named) as stereo, convert it to
    the internal rate there, and (for the TARGET) emit peak-population
    advisories from a count there.  Returns the staged tensor and its
    rate.  The span ``check``."""
    policy = _POLICIES[name.upper()]
    device = resolve_device(device)
    with trace.span("check"):
        _bound_length(array, sample_rate, config, policy)
        staged = _to_stereo(array, policy, device)
        staged, sample_rate = _to_internal_rate(staged, sample_rate, config, policy)
        if policy.heuristics:
            _peak_heuristics(staged, config)
    return staged, sample_rate


def check_equality(target, reference) -> None:
    """Matching a track against itself is meaningless; reject it
    (reference ``checker.py:140-142``).  The tracks compare in float64 with
    ``np.allclose``'s tolerances, staged integer PCM in the float domain, so
    the same track as PCM_16 WAV and as FLAC is still equal.  They compare
    on the target's device where it is a tensor, else on the reference's,
    else on the host, and the verdict is read back once.  The span
    ``equality``."""
    with trace.span("equality"):
        if tuple(target.shape) != tuple(reference.shape):
            return
        tensors = [a for a in (target, reference) if isinstance(a, torch.Tensor)]
        device = tensors[0].device if tensors else torch.device("cpu")
        close = torch.isclose(  # torch.allclose, its verdict counted as it is read
            _as_float64(target, device), _as_float64(reference, device), rtol=1e-5, atol=1e-8
        ).all()
        if bool(read_back(close)):
            raise ModuleError(Code.ERROR_TARGET_EQUALS_REFERENCE)
