"""Audio export (reference ``matchering/saver.py:27-33``) through
``codecs.write``, the container chosen by the file's extension.  The
samples are float32 or float64: every writer widens float32 to float64
where it quantises, so a float32 result writes the bytes of the same
result widened to float64."""

from __future__ import annotations

import numpy as np

from .. import trace
from ..log import debug
from . import codecs


def save(
    file: str,
    result: np.ndarray,
    sample_rate: int,
    subtype: str,
    name: str = "result",
) -> None:
    """Write ``result`` to ``file``: the span ``encode``."""
    name = name.upper()
    debug(f"Saving the {name} {sample_rate} Hz Stereo {subtype} to: '{file}'...")
    with trace.span("encode"):
        codecs.write(file, np.asarray(result), sample_rate, subtype)
    debug(f"'{file}' is saved")
