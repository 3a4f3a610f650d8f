"""Audio export (reference ``matchering/saver.py:27-33``) through
``codecs.write``, the container chosen by the file's extension."""

from __future__ import annotations

import numpy as np

from ..log import debug
from . import codecs


def save(
    file: str,
    result: np.ndarray,
    sample_rate: int,
    subtype: str,
    name: str = "result",
) -> None:
    name = name.upper()
    debug(f"Saving the {name} {sample_rate} Hz Stereo {subtype} to: '{file}'...")
    codecs.write(file, np.asarray(result), sample_rate, subtype)
    debug(f"'{file}' is saved")
