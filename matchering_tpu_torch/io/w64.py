"""Sony Wave64 (.w64) container codec (pure numpy host path).

The reference reads and writes W64 natively through libsndfile
(``matchering/loader.py:35``, ``matchering/saver.py:32``); this gives the
same capability without an ffmpeg binary.  W64 is RIFF/WAVE with 16-byte
GUID chunk ids, 64-bit little-endian chunk sizes that INCLUDE the 24-byte
chunk header, and 8-byte chunk alignment — the ``fmt `` body is the ordinary
WAVEFORMAT(EXTENSIBLE) struct, so sample decoding is shared with ``wav``.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from . import pcm, wav

# GUIDs from the Sony Wave64 specification.  The first four bytes are the
# RIFF fourcc; 'riff' has its own suffix while the in-file chunks share one.
GUID_RIFF = b"riff\x2e\x91\xcf\x11\xa5\xd6\x28\xdb\x04\xc1\x00\x00"
_SUFFIX = b"\xf3\xac\xd3\x11\x8c\xd1\x00\xc0\x4f\x8e\xdb\x8a"
GUID_WAVE = b"wave" + _SUFFIX
GUID_FMT = b"fmt " + _SUFFIX
GUID_DATA = b"data" + _SUFFIX


def is_w64(magic: bytes) -> bool:
    return magic[:16] == GUID_RIFF


def _iter_chunks(buf: bytes, start: int, end: int):
    """Yield (guid, body offset, body size); sizes include the 24-byte
    header and chunks are aligned to 8-byte boundaries."""
    pos = start
    while pos + 24 <= end:
        guid = buf[pos : pos + 16]
        (size,) = struct.unpack_from("<q", buf, pos + 16)
        if size < 24:
            break
        yield guid, pos + 24, size - 24
        pos += (size + 7) & ~7


def read(path: str) -> Tuple[np.ndarray, int]:
    """Read a Wave64 file -> (float64 (n, channels) array, sample rate)."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 40 or not is_w64(buf) or buf[24:40] != GUID_WAVE:
        raise wav.WavFormatError("unknown format: not a Wave64 stream")

    fmt = None
    data = None
    for guid, body, size in _iter_chunks(buf, 40, len(buf)):
        if guid == GUID_FMT:
            fmt = struct.unpack_from("<HHIIHH", buf, body)
            if fmt[0] == wav.WAVE_FORMAT_EXTENSIBLE and size >= 40:
                (sub_tag,) = struct.unpack_from("<H", buf, body + 24)
                fmt = (sub_tag,) + fmt[1:]
        elif guid == GUID_DATA:
            data = buf[body : body + size]
    if fmt is None or data is None:
        raise wav.WavFormatError("unknown format: missing Wave64 fmt/data chunk")

    tag, channels, sample_rate, _brate, _balign, bits = fmt
    if channels < 1:
        raise wav.WavFormatError("invalid channel count")
    decoder = wav.decoder_for(tag, bits)
    if decoder is None:
        raise wav.WavFormatError(f"unsupported Wave64 encoding: tag={tag} bits={bits}")

    frame_bytes = channels * (bits // 8)
    usable = (len(data) // frame_bytes) * frame_bytes
    return decoder(data[:usable]).reshape(-1, channels), sample_rate


def _chunk(guid: bytes, body: bytes) -> bytes:
    size = 24 + len(body)
    pad = (-size) % 8
    return guid + struct.pack("<q", size) + body + b"\x00" * pad


def write(path: str, array: np.ndarray, sample_rate: int, subtype: str = "PCM_16") -> None:
    """Write a float array of shape (n, channels) as a Wave64 file."""
    array = np.asarray(array)
    if array.ndim == 1:
        array = array[:, None]
    if subtype not in pcm.ENCODERS:
        raise wav.WavFormatError(f"unsupported Wave64 subtype: {subtype}")

    channels = array.shape[1]
    bits = pcm.SUBTYPES[subtype] * 8
    tag = {
        "FLOAT": wav.WAVE_FORMAT_IEEE_FLOAT,
        "DOUBLE": wav.WAVE_FORMAT_IEEE_FLOAT,
        "ALAW": wav.WAVE_FORMAT_ALAW,
        "ULAW": wav.WAVE_FORMAT_MULAW,
    }.get(subtype, wav.WAVE_FORMAT_PCM)
    payload = pcm.ENCODERS[subtype](array.reshape(-1))

    block_align = channels * (bits // 8)
    fmt_body = struct.pack(
        "<HHIIHH", tag, channels, sample_rate, sample_rate * block_align, block_align, bits
    )
    body = GUID_WAVE + _chunk(GUID_FMT, fmt_body) + _chunk(GUID_DATA, payload)
    with open(path, "wb") as f:
        # the riff chunk size spans the whole file, header included
        f.write(GUID_RIFF + struct.pack("<q", 24 + len(body)) + body)
