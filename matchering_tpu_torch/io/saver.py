"""Audio export (reference ``matchering/saver.py:27-33``), WAV only."""

from __future__ import annotations

import os

import numpy as np

from ..log import debug
from . import wav


def save(
    file: str,
    result: np.ndarray,
    sample_rate: int,
    subtype: str,
    name: str = "result",
) -> None:
    ext = os.path.splitext(file)[1][1:].upper()
    if ext != "WAV":
        raise RuntimeError(f"unsupported output format: {ext} (the port writes WAV only)")
    name = name.upper()
    debug(f"Saving the {name} {sample_rate} Hz Stereo {subtype} to: '{file}'...")
    wav.write(file, np.asarray(result), sample_rate, subtype)
    debug(f"'{file}' is saved")
