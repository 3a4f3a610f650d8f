"""Codec registry — format capabilities and dispatch.

Counterpart of ``matchering_tpu.io.codecs``, limited to the pure-numpy
containers: WAV/RF64, AIFF/AIFC, Wave64 and CAF.  Reads dispatch on the
file's magic bytes, writes on its extension.  FLAC, the lossy codecs and
the ffmpeg fallback are not ported: reading such a file raises the
"unknown format" error, and ``check_format`` refuses them for writing.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from . import aiff, caf, w64, wav

_WRITE_FORMATS = {
    "WAV": ("PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE", "ALAW", "ULAW"),
    "AIFF": ("PCM_16", "PCM_24", "PCM_32", "FLOAT"),
    "AIF": ("PCM_16", "PCM_24", "PCM_32", "FLOAT"),
    "W64": ("PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE", "ALAW", "ULAW"),
    "CAF": ("PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE", "ALAW", "ULAW"),
}


def check_format(fmt: str, subtype: Optional[str] = None) -> bool:
    """True if ``fmt`` (and optionally ``subtype``) can be written."""
    subtypes = _WRITE_FORMATS.get(fmt.upper())
    if subtypes is None:
        return False
    return subtype is None or subtype.upper() in subtypes


def read(path: str, raw_int: bool = False) -> Tuple[np.ndarray, int]:
    """Read an audio file -> (float64 (n, ch) array, sample rate).

    ``raw_int=True`` asks integer-PCM WAV sources for their unscaled
    integer codes (see ``wav.read``) so callers can stage raw PCM to the
    device; every other container returns float64 regardless.  Raises
    RuntimeError with an "unknown format" message for any other container.
    """
    with open(path, "rb") as f:
        magic = f.read(16)  # 16 bytes: Wave64's riff GUID is the longest sniff
    if len(magic) >= 12 and magic[:4] in (b"RIFF", b"RF64", b"BW64") and magic[8:12] == b"WAVE":
        return wav.read(path, raw_int=raw_int)
    if len(magic) >= 12 and magic[:4] == b"FORM" and magic[8:12] in (b"AIFF", b"AIFC"):
        return aiff.read(path)
    if len(magic) >= 4 and magic[:4] == b"caff":
        return caf.read(path)
    if w64.is_w64(magic):
        return w64.read(path)
    raise RuntimeError(f"unknown format: '{os.path.basename(path)}'")


def write(path: str, array: np.ndarray, sample_rate: int, subtype: str) -> None:
    ext = os.path.splitext(path)[1][1:].upper()
    if ext == "WAV":
        wav.write(path, array, sample_rate, subtype)
    elif ext in ("AIFF", "AIF"):
        aiff.write(path, array, sample_rate, subtype)
    elif ext == "W64":
        w64.write(path, array, sample_rate, subtype)
    elif ext == "CAF":
        caf.write(path, array, sample_rate, subtype)
    else:
        raise RuntimeError(f"unsupported output format: {ext}")
