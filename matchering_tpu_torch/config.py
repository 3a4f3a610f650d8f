"""Configuration system (PyTorch port).

Same tunables, defaults, seconds->samples baking and validation rules as
``matchering_tpu.config`` (itself the reference's
``matchering/defaults.py:25-155``), kept as a copy so the port imports
nothing of the JAX package.  ``Config.torch_dtype`` maps the ``dtype`` field
to the torch working dtype.

Additions over the reference:

* ``dtype`` — device compute precision (default float32; float64 serves
  the CPU parity tests).
* ``lowess_exact`` — LOWESS at every grid point instead of the
  ``delta``-skipping approximation.
* ``length_bucketing`` — pad both tracks to a multiple of N samples and
  master them at their true lengths (``stages.main``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from .log import debug


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclass(frozen=True)
class LimiterConfig:
    """Hyrax limiter tunables (reference ``matchering/defaults.py:25-59``).

    Times are in milliseconds; filter coefficients parameterize the attack
    one-pole smoother and the hold/release Butterworth low-passes.
    """

    attack: float = 1.0
    hold: float = 1.0
    release: float = 3000.0
    attack_filter_coefficient: float = -2.0
    hold_filter_order: int = 1
    hold_filter_coefficient: float = 7.0
    release_filter_order: int = 1
    release_filter_coefficient: float = 800.0

    def __post_init__(self):
        _require(self.attack > 0, "limiter attack must be positive (ms)")
        _require(self.hold > 0, "limiter hold must be positive (ms)")
        _require(self.release > 0, "limiter release must be positive (ms)")
        _require(
            isinstance(self.hold_filter_order, int) and self.hold_filter_order > 0,
            "hold_filter_order must be a positive int",
        )
        _require(
            isinstance(self.release_filter_order, int)
            and self.release_filter_order > 0,
            "release_filter_order must be a positive int",
        )


@dataclass(frozen=True)
class Config:
    """Pipeline tunables (reference ``matchering/defaults.py:61-155``).

    Attribute units match the reference after construction:
    ``max_piece_size``, ``preview_size``, ``preview_analysis_step`` and
    ``preview_fade_size`` are given in seconds but *stored in samples* at
    ``internal_sample_rate``.
    """

    internal_sample_rate: int = 44100
    max_length: float = 15 * 60
    max_piece_size: float = 15  # seconds in; samples after __post_init__
    threshold: float = (2**15 - 61) / 2**15
    min_value: float = 1e-6
    fft_size: int = 4096
    lin_log_oversampling: int = 4
    rms_correction_steps: int = 4
    clipping_samples_threshold: int = 8
    limited_samples_threshold: int = 128
    allow_equality: bool = False
    lowess_frac: float = 0.0375
    lowess_it: int = 0
    lowess_delta: float = 0.001
    preview_size: float = 30  # seconds in; samples after __post_init__
    preview_analysis_step: float = 5  # seconds in; samples after __post_init__
    preview_fade_size: float = 1  # seconds in; samples after __post_init__
    preview_fade_coefficient: float = 8
    temp_folder: Optional[str] = None
    limiter: LimiterConfig = field(default_factory=LimiterConfig)

    # --- additions over the reference ---
    dtype: str = "float32"
    lowess_exact: bool = False
    length_bucketing: Optional[int] = None

    def __post_init__(self):
        _require(
            isinstance(self.internal_sample_rate, int)
            and self.internal_sample_rate > 0,
            "internal_sample_rate must be a positive int",
        )
        if self.internal_sample_rate != 44100:
            debug(
                "Using an internal sample rate other than 44100 has not been "
                "tested properly! Use it at your own risk!"
            )

        _require(self.fft_size > 1, "fft_size must be > 1")
        _require(
            math.log2(self.fft_size).is_integer(), "fft_size must be a power of two"
        )

        _require(self.max_length > 0, "max_length must be positive")
        _require(
            self.max_length > self.fft_size / self.internal_sample_rate,
            "max_length must exceed one FFT frame",
        )

        _require(self.min_value > 0, "min_value must be positive")
        _require(self.min_value < 0.1, "min_value must be < 0.1")
        _require(self.threshold > self.min_value, "threshold must exceed min_value")
        _require(self.threshold < 1, "threshold must be < 1")

        _require(self.max_piece_size > 0, "max_piece_size must be positive")
        _require(
            self.max_piece_size > self.fft_size / self.internal_sample_rate,
            "max_piece_size must exceed one FFT frame",
        )
        _require(self.max_piece_size < self.max_length, "max_piece_size < max_length")
        object.__setattr__(
            self, "max_piece_size", int(self.max_piece_size * self.internal_sample_rate)
        )

        _require(
            isinstance(self.lin_log_oversampling, int) and self.lin_log_oversampling > 0,
            "lin_log_oversampling must be a positive int",
        )
        _require(
            isinstance(self.rms_correction_steps, int)
            and self.rms_correction_steps >= 0,
            "rms_correction_steps must be a non-negative int",
        )

        _require(
            isinstance(self.clipping_samples_threshold, int)
            and self.clipping_samples_threshold >= 0,
            "clipping_samples_threshold must be a non-negative int",
        )
        _require(
            isinstance(self.limited_samples_threshold, int)
            and self.limited_samples_threshold > self.clipping_samples_threshold,
            "limited_samples_threshold must exceed clipping_samples_threshold",
        )

        _require(isinstance(self.allow_equality, bool), "allow_equality must be bool")

        _require(self.lowess_frac > 0, "lowess_frac must be positive")
        _require(
            isinstance(self.lowess_it, int) and self.lowess_it >= 0,
            "lowess_it must be a non-negative int",
        )
        _require(self.lowess_delta >= 0, "lowess_delta must be non-negative")

        _require(self.preview_size > 5, "preview_size must be > 5 seconds")
        _require(self.preview_analysis_step > 1, "preview_analysis_step > 1 second")
        _require(self.preview_fade_size > 0, "preview_fade_size must be positive")
        _require(
            self.preview_fade_coefficient >= 2, "preview_fade_coefficient must be >= 2"
        )
        object.__setattr__(
            self, "preview_size", int(self.preview_size * self.internal_sample_rate)
        )
        object.__setattr__(
            self,
            "preview_analysis_step",
            int(self.preview_analysis_step * self.internal_sample_rate),
        )
        object.__setattr__(
            self,
            "preview_fade_size",
            int(self.preview_fade_size * self.internal_sample_rate),
        )

        _require(
            self.temp_folder is None or isinstance(self.temp_folder, str),
            "temp_folder must be a string path or None",
        )
        _require(isinstance(self.limiter, LimiterConfig), "limiter: LimiterConfig")
        _require(
            self.dtype in ("float32", "float64"),
            "dtype: float32|float64 (bfloat16 is not offered: an 8-bit "
            "mantissa is far below audio quality)",
        )
        _require(
            self.length_bucketing is None
            or (
                isinstance(self.length_bucketing, int)
                and self.length_bucketing >= self.fft_size
            ),
            "length_bucketing must be None or an int >= fft_size",
        )

    # Derived quantities -------------------------------------------------

    @property
    def torch_dtype(self):
        """The torch working dtype named by ``dtype``."""
        import torch

        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]

    @property
    def spectrum_bins(self) -> int:
        """Number of rFFT bins of one analysis frame."""
        return self.fft_size // 2 + 1

    @property
    def log_grid_size(self) -> int:
        """Size of the oversampled logarithmic frequency grid."""
        return (self.fft_size // 2) * self.lin_log_oversampling + 1

    def min_track_samples(self, sample_rate: int) -> int:
        """Minimum valid track length at ``sample_rate`` (reference
        ``matchering/checker.py:99``)."""
        return self.fft_size * sample_rate // self.internal_sample_rate
