"""Output descriptors (reference ``matchering/results.py:25-46``).

A :class:`Result` names an output file, its PCM subtype and which processing
variant feeds it (limited / no-limiter / no-limiter-normalized).  The
formats and subtypes accepted are those ``io.codecs.check_format`` accepts
on this host: WAV, AIFF, W64 and CAF always, FLAC with the native codec
built, OGG, MP3 and OPUS through the system libraries or ffmpeg.
"""

from __future__ import annotations

import os

from .io.codecs import check_format


class Result:
    def __init__(
        self,
        file: str,
        subtype: str,
        use_limiter: bool = True,
        normalize: bool = True,
    ):
        _, file_ext = os.path.splitext(file)
        file_ext = file_ext[1:].upper()
        if not check_format(file_ext):
            raise TypeError(f"{file_ext} format is not supported")
        if not check_format(file_ext, subtype):
            raise TypeError(f"{file_ext} format does not have {subtype} subtype")
        self.file = file
        self.subtype = subtype
        self.use_limiter = use_limiter
        self.normalize = normalize

    def __repr__(self) -> str:
        return (
            f"Result(file={self.file!r}, subtype={self.subtype!r}, "
            f"use_limiter={self.use_limiter}, normalize={self.normalize})"
        )


def pcm16(file: str) -> Result:
    return Result(file, "PCM_16")


def pcm24(file: str) -> Result:
    return Result(file, "PCM_24")


def pcm32f(file: str) -> Result:
    """Float32 WAV output (not in the reference API)."""
    return Result(file, "FLOAT")
