"""Audio ingestion (reference ``matchering/loader.py:30-74``).

The numpy codecs (``codecs.read``: WAV/RF64, AIFF, W64, CAF) decode the
file; anything they cannot parse raises the role's coded ``ModuleError``.
The ffmpeg fallback of ``matchering_tpu.io.loader`` and its lossy-source
advisories are not ported.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from ..log import Code, ModuleError, debug
from . import codecs

_LOAD_ERRORS = {"TARGET": Code.ERROR_TARGET_LOADING, "REFERENCE": Code.ERROR_REFERENCE_LOADING}


def load(
    file: str, file_type: str, temp_folder: str = None, raw_int: bool = False
) -> Tuple[np.ndarray, int]:
    """Decode ``file`` into a float64 (n, ch) array + sample rate.

    ``file_type`` names the track's role ("target"/"reference") and selects
    the coded error raised on failure.  ``temp_folder`` is where a
    transcoding fallback would stage its files; the port has none, so it is
    accepted for the JAX package's signature and unused.  ``raw_int=True``
    keeps integer-PCM WAV payloads as unscaled int16/int32 codes:
    ``process()`` stages those to the device as they are and converts there
    (``ops.basics.to_working_float``).
    """
    role = file_type.upper()
    debug(f"Decoding the {role} track from '{file}'")
    try:
        audio, rate = codecs.read(file, raw_int=raw_int)
    except (RuntimeError, OSError, ValueError, struct.error) as error:
        debug(error)
        raise ModuleError(_LOAD_ERRORS[role]) from error
    debug(f"{role} decoded: {audio.shape[0]} samples at {rate} Hz")
    return audio, rate
