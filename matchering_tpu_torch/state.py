"""The state carried between the JAX package and the port.

The system has no learned weights: its state is the ``Config`` and the
smoothing state built from it on the host (``ops.smoothing.Smoothing``: the
two operators and, where the LOWESS does not fold into them, its staged
plan).  These helpers let a caller feed both packages the same of each, and
stage the state on a device once per (smoothing parameters, dtype,
device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from .config import Config, LimiterConfig
from .ops import lowess, smoothing

# fields a Config takes in seconds and stores in samples
_SAMPLE_FIELDS = ("max_piece_size", "preview_size", "preview_analysis_step", "preview_fade_size")


def config_from_dict(fields: Mapping) -> Config:
    """The port's ``Config`` from the dataclass fields of a constructed
    ``Config`` (e.g. ``dataclasses.asdict(matchering_tpu.Config(...))``).
    Those hold the seconds-based fields already in samples; they are
    carried over exactly, not re-derived from seconds."""
    fields = dict(fields)
    limiter = fields.pop("limiter", {})
    if dataclasses.is_dataclass(limiter):
        limiter = dataclasses.asdict(limiter)
    limiter = LimiterConfig(**limiter)
    rate = fields.get("internal_sample_rate", 44100)
    samples = {name: fields[name] for name in _SAMPLE_FIELDS if name in fields}
    seconds = {name: value / rate for name, value in samples.items()}
    config = Config(**{**fields, **seconds}, limiter=limiter)
    for name, value in samples.items():
        object.__setattr__(config, name, int(value))
    return config


def _stage(to_log, to_lin, device, dtype: torch.dtype, lowess_params) -> smoothing.Smoothing:
    """The (to_log, to_lin) pair on ``device`` in ``dtype``, with the plan
    of ``lowess_params`` staged beside it where that LOWESS does not fold
    (None: no LOWESS)."""
    to_log, to_lin = np.asarray(to_log), np.asarray(to_lin)
    plan = None
    if lowess_params is not None and not smoothing.folds(lowess_params):
        frac, it, delta = lowess_params
        plan = lowess.stage_plan(to_log.shape[0], frac, it, delta, torch.device(device))
    return smoothing.Smoothing(
        torch.as_tensor(to_log, dtype=dtype, device=device),
        torch.as_tensor(to_lin, dtype=dtype, device=device),
        plan,
    )


# the staged smoothing states, oldest first
_STAGED: Dict[tuple, smoothing.Smoothing] = {}
_STAGED_MAX = 4


def staged_operators(rates, lowess_params, dtype: torch.dtype, device) -> smoothing.Smoothing:
    """The smoothing state of the grids ``rates = (sample_rate, fft_size,
    oversampling)`` and the LOWESS ``lowess_params = (frac, it, delta)``
    (None: none), built on the host and staged on ``device`` in ``dtype``
    (the LOWESS plan in float64), once per (rates, LOWESS, dtype, device):
    the plain operators of an unfolded LOWESS are 134 MB in float32 at the
    default ``fft_size``."""
    # the smoothing operators are float32 matmuls on the card: keep them
    # at full float32 precision (TF32 keeps about three decimal digits);
    # this is PyTorch's default, set here so the run does not depend on it
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # "cuda" and the tensors' "cuda:0" are one entry
        device = torch.device("cuda", torch.cuda.current_device())
    key = (*rates, lowess_params, dtype, device)
    if key not in _STAGED:
        if len(_STAGED) >= _STAGED_MAX:
            del _STAGED[next(iter(_STAGED))]  # the oldest
        to_log, to_lin = smoothing.host_operators(*rates, lowess_params)
        _STAGED[key] = _stage(to_log, to_lin, device, dtype, lowess_params)
    return _STAGED[key]


def operators_for_config(config: Config, device) -> smoothing.Smoothing:
    """The smoothing state of ``config`` on ``device`` in the working dtype
    (:func:`staged_operators`; (frac, it, delta) with delta = 0 for
    ``lowess_exact`` decide the smoother)."""
    return staged_operators(
        smoothing.grid_rates(config), smoothing.lowess_parameters(config), config.torch_dtype, device
    )
