"""The state carried between the JAX package and the port.

The system has no learned weights: its state is the ``Config`` and the two
smoothing operators built from it on the host.  These helpers let a caller
feed both packages the same of each, and stage the operators on a device
(once per device for a batch of pairs, ``parallel.batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from .config import Config, LimiterConfig
from .ops import smoothing

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


def operators_from_numpy(
    to_log: np.ndarray, to_lin: np.ndarray, device, dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (to_log, to_lin) smoothing operator pair as tensors for
    ``stages.master_graph``."""
    return (
        torch.as_tensor(np.asarray(to_log), dtype=dtype, device=device),
        torch.as_tensor(np.asarray(to_lin), dtype=dtype, device=device),
    )


def operators_for_config(config: Config, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded smoothing operators of ``config``, built on the host and
    staged on ``device`` in the working dtype."""
    # the smoothing operators are float32 matmuls on the card: keep them
    # at full float32 precision (TF32 keeps about three decimal digits);
    # this is PyTorch's default, set here so the run does not depend on it
    torch.backends.cuda.matmul.allow_tf32 = False
    to_log, to_lin = smoothing.host_operators_for_config(config)
    return operators_from_numpy(to_log, to_lin, device, config.torch_dtype)
