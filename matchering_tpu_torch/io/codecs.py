"""Codec registry — format capabilities and dispatch.

Counterpart of ``matchering_tpu.io.codecs``, with the same chain: it plays
the role ``soundfile``'s format table plays for the reference
(``matchering/results.py:29-34`` uses ``sf.check_format``), maps
containers to the subtypes they take and dispatches reads (on the file's
magic bytes) and writes (on its extension) to the first backend that can:

1. the native C++ codec (``io/native``: WAV and FLAC), when it is built;
2. the numpy WAV/RF64/W64/AIFF/CAF codecs of this package;
3. the system libraries through ctypes: libvorbis for OGG/Vorbis, libmpg123
   and LAME for MP3, libopus for Ogg Opus, each read and write;
4. an ``ffmpeg`` subprocess for the lossy formats those libraries cannot
   write (the reference's fallback, ``matchering/loader.py:50-74``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from . import aiff, caf, w64, wav
from .native import binding as native
from .native import mp3, opus, vorbis

_WRITE_FORMATS = {
    "WAV": ("PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE", "ALAW", "ULAW"),
    "AIFF": ("PCM_16", "PCM_24", "PCM_32", "FLOAT"),
    "AIF": ("PCM_16", "PCM_24", "PCM_32", "FLOAT"),
    # FLAC via the native C++ codec (io/native/flac.cpp)
    "FLAC": ("PCM_16", "PCM_24"),
    # pure numpy containers (io/w64.py, io/caf.py)
    "W64": ("PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE", "ALAW", "ULAW"),
    "CAF": ("PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE", "ALAW", "ULAW"),
}

# Formats written by transcoding a staging WAV through ffmpeg (the write-side
# counterpart of the loader's read fallback; the reference reached these via
# libsndfile, ``matchering/saver.py:32``).  Subtype -> encoder arguments.
_FFMPEG_WRITE_FORMATS = {
    "OGG": {"VORBIS": ["-c:a", "libvorbis", "-qscale:a", "8"]},
    "MP3": {"MPEG_LAYER_III": ["-c:a", "libmp3lame", "-b:a", "320k"]},
    "OPUS": {"OPUS": ["-c:a", "libopus", "-b:a", "256k"]},
}


def ffmpeg_available() -> bool:
    import shutil

    return shutil.which("ffmpeg") is not None


def check_format(fmt: str, subtype: Optional[str] = None) -> bool:
    """True if ``fmt`` (and optionally ``subtype``) can be written."""
    fmt = fmt.upper()
    if fmt in _WRITE_FORMATS:
        if fmt == "FLAC" and not native.available():
            return False
        return subtype is None or subtype.upper() in _WRITE_FORMATS[fmt]
    if fmt == "OGG" and vorbis.available():
        return subtype is None or subtype.upper() == "VORBIS"
    if fmt == "MP3" and mp3.write_available():
        return subtype is None or subtype.upper() == "MPEG_LAYER_III"
    if fmt == "OPUS" and opus.write_available():
        return subtype is None or subtype.upper() == "OPUS"
    if fmt in _FFMPEG_WRITE_FORMATS and ffmpeg_available():
        return subtype is None or subtype.upper() in _FFMPEG_WRITE_FORMATS[fmt]
    return False


def is_lossy_container(path: str) -> bool:
    """True for containers whose audio is lossy-compressed (OGG, Opus, MP3)
    — drives the loader's lossy-source advisory even when the file decodes
    natively (the reference only warns on its ffmpeg path, but the source
    is just as lossy when libsndfile decodes it directly).  ``is_ogg``
    matches both Vorbis and Opus streams (shared OggS framing)."""
    return vorbis.is_ogg(path) or mp3.is_mp3(path)


def read(path: str, raw_int: bool = False) -> Tuple[np.ndarray, int]:
    """Read an audio file -> (float64 (n, ch) array, sample rate).

    ``raw_int=True`` asks integer-PCM WAV sources for their unscaled
    integer codes (see ``wav.read``) so callers can stage raw PCM to the
    device; every other container returns float64 regardless.

    Raises RuntimeError with an "unknown format" message for containers no
    built-in codec handles, so callers can trigger the ffmpeg fallback —
    the same contract the reference relies on (``matchering/loader.py:39-41``).
    """
    with open(path, "rb") as f:
        magic = f.read(16)  # 16 bytes: Wave64's riff GUID is the longest sniff
    if len(magic) >= 12 and magic[:4] == b"RIFF" and magic[8:12] == b"WAVE":
        if raw_int:
            # the numpy codec is a complete WAV reader: integer PCM comes
            # back as unscaled codes, everything else as float64
            return wav.read(path, raw_int=True)
        if native.available():
            try:
                return native.read_wav(path)
            except (RuntimeError, OSError):
                # encodings only the numpy codec knows (G.711 A-law/µ-law)
                return wav.read(path)
        return wav.read(path)
    if len(magic) >= 12 and magic[:4] in (b"RF64", b"BW64") and magic[8:12] == b"WAVE":
        return wav.read(path, raw_int=raw_int)
    if len(magic) >= 12 and magic[:4] == b"FORM" and magic[8:12] in (b"AIFF", b"AIFC"):
        return aiff.read(path)
    if len(magic) >= 4 and magic[:4] == b"fLaC" and native.available():
        return native.read_flac(path)
    if len(magic) >= 4 and magic[:4] == b"caff":
        return caf.read(path)
    if w64.is_w64(magic):
        return w64.read(path)
    if len(magic) >= 4 and magic[:4] == b"OggS":
        # OggS frames both Vorbis and Opus — sniff the first packet
        if opus.is_opus(path):
            if opus.available():
                return opus.read_opus(path)
        elif vorbis.available():
            return vorbis.read_ogg(path)
    # MP3 last: its frame-sync sniff is heuristic, every real magic above
    # has already been ruled out by this point
    if mp3.available() and mp3.is_mp3(path):
        return mp3.read_mp3(path)
    raise RuntimeError(f"unknown format: '{os.path.basename(path)}'")


def write(path: str, array: np.ndarray, sample_rate: int, subtype: str) -> None:
    """Write float32 or float64 (n, ch) samples; each backend widens
    float32 to float64 where it quantises (exact), so both write the same
    bytes."""
    ext = os.path.splitext(path)[1][1:].upper()
    if ext == "WAV":
        if native.available() and subtype in ("PCM_16", "PCM_24", "PCM_32", "FLOAT"):
            native.write_wav(path, array, sample_rate, subtype)
            return
        # DOUBLE/ALAW/ULAW subtypes go through the numpy codec
        wav.write(path, array, sample_rate, subtype)
    elif ext in ("AIFF", "AIF"):
        aiff.write(path, array, sample_rate, subtype)
    elif ext == "FLAC":
        if not native.available():
            raise RuntimeError("FLAC output needs the native codec (io/native)")
        native.write_flac(path, array, sample_rate, subtype)
    elif ext == "W64":
        w64.write(path, array, sample_rate, subtype)
    elif ext == "CAF":
        caf.write(path, array, sample_rate, subtype)
    elif ext == "OGG" and vorbis.available() and subtype.upper() == "VORBIS":
        vorbis.write_ogg(path, array, sample_rate)
    elif ext == "MP3" and mp3.write_available() and subtype.upper() == "MPEG_LAYER_III":
        mp3.write_mp3(path, array, sample_rate)
    elif ext == "OPUS" and opus.write_available() and subtype.upper() == "OPUS":
        opus.write_opus(path, array, sample_rate)
    elif ext in _FFMPEG_WRITE_FORMATS:
        _write_via_ffmpeg(path, array, sample_rate, ext, subtype)
    else:
        raise RuntimeError(f"unsupported output format: {ext}")


def _write_via_ffmpeg(
    path: str, array: np.ndarray, sample_rate: int, ext: str, subtype: str
) -> None:
    """Encode by staging a lossless WAV and transcoding it with ffmpeg —
    the write-side counterpart of the loader's read fallback."""
    import subprocess
    import tempfile

    encoder_args = _FFMPEG_WRITE_FORMATS[ext].get(subtype.upper())
    if encoder_args is None:
        raise RuntimeError(f"unsupported subtype for {ext}: {subtype}")
    if not ffmpeg_available():
        raise RuntimeError(f"{ext} output needs ffmpeg on PATH")
    fd, staging = tempfile.mkstemp(suffix=".wav")
    os.close(fd)
    try:
        wav.write(staging, array, sample_rate, "DOUBLE")
        subprocess.check_call(
            ["ffmpeg", "-y", "-i", staging, *encoder_args, path],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
    except subprocess.CalledProcessError as error:
        raise RuntimeError(f"ffmpeg could not encode '{path}'") from error
    finally:
        if os.path.exists(staging):
            os.remove(staging)
