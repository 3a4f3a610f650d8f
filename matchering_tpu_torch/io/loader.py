"""Audio ingestion (reference ``matchering/loader.py:30-74``), WAV only.

The numpy RIFF/WAVE (and RF64/BW64) codec decodes the file; anything it
cannot parse raises the role's coded ``ModuleError`` — the other
containers and the ffmpeg fallback of ``matchering_tpu.io.loader`` are not
ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..log import Code, ModuleError, debug
from . import wav

_LOAD_ERRORS = {"TARGET": Code.ERROR_TARGET_LOADING, "REFERENCE": Code.ERROR_REFERENCE_LOADING}


def load(file: str, file_type: str, raw_int: bool = False) -> Tuple[np.ndarray, int]:
    """Decode a WAV ``file`` into a float64 (n, ch) array + sample rate.

    ``file_type`` names the track's role ("target"/"reference") and selects
    the coded error raised on failure.  ``raw_int=True`` keeps integer-PCM
    payloads as unscaled int16/int32 codes: ``process()`` stages those to
    the device as they are and converts there (``ops.basics.to_working_float``).
    """
    role = file_type.upper()
    debug(f"Decoding the {role} track from '{file}'")
    try:
        audio, rate = wav.read(file, raw_int=raw_int)
    except (RuntimeError, OSError, ValueError) as error:
        debug(error)
        raise ModuleError(_LOAD_ERRORS[role]) from error
    debug(f"{role} decoded: {audio.shape[0]} samples at {rate} Hz")
    return audio, rate
