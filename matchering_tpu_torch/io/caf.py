"""Apple Core Audio Format (.caf) codec (pure numpy host path).

The reference reads and writes CAF natively through libsndfile
(``matchering/loader.py:35``, ``matchering/saver.py:32``); this gives the
same capability without an ffmpeg binary.  CAF is a big-endian chunked
container: an 8-byte ``caff`` header, then (fourcc, int64 size) chunks —
``desc`` fixes the sample encoding, ``data`` carries a 4-byte edit count
followed by the audio (its size may be -1, meaning "to end of file").
Linear PCM may be big- or little-endian, integer or float, per the
``desc`` format flags; ``alaw``/``ulaw`` ride the shared G.711 tables.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from . import pcm

_FLAG_IS_FLOAT = 1 << 0
_FLAG_IS_LITTLE_ENDIAN = 1 << 1


class CafFormatError(RuntimeError):
    pass


def is_caf(magic: bytes) -> bool:
    return magic[:4] == b"caff"


def _decoder_for(format_id: bytes, flags: int, bits: int):
    big_endian = not (flags & _FLAG_IS_LITTLE_ENDIAN)
    if format_id == b"lpcm":
        if flags & _FLAG_IS_FLOAT:
            table = {32: pcm.decode_float, 64: pcm.decode_double}
        else:
            table = {16: pcm.decode_pcm16, 24: pcm.decode_pcm24, 32: pcm.decode_pcm32}
        decoder = table.get(bits)
    elif format_id == b"alaw" and bits == 8:
        decoder, big_endian = pcm.decode_alaw, False
    elif format_id == b"ulaw" and bits == 8:
        decoder, big_endian = pcm.decode_ulaw, False
    else:
        decoder = None
    if decoder is None:
        return None
    return lambda raw: decoder(raw, big_endian=big_endian)


def read(path: str) -> Tuple[np.ndarray, int]:
    """Read a CAF file -> (float64 (n, channels) array, sample rate)."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8 or not is_caf(buf):
        raise CafFormatError("unknown format: not a CAF stream")

    desc = None
    data = None
    pos = 8
    while pos + 12 <= len(buf):
        ctype = buf[pos : pos + 4]
        (size,) = struct.unpack_from(">q", buf, pos + 12 - 8)
        body = pos + 12
        if size < 0:  # unknown length: data runs to end of file
            size = len(buf) - body
        if ctype == b"desc":
            desc = struct.unpack_from(">d4sIIIII", buf, body)
        elif ctype == b"data":
            data = buf[body + 4 : body + size]  # skip the u32 edit count
        pos = body + size

    if desc is None or data is None:
        raise CafFormatError("unknown format: missing CAF desc/data chunk")

    sample_rate, format_id, flags, _bpp, _fpp, channels, bits = desc
    if channels < 1:
        raise CafFormatError("invalid channel count")
    decoder = _decoder_for(format_id, flags, bits)
    if decoder is None:
        raise CafFormatError(
            f"unsupported CAF encoding: {format_id!r} flags={flags} bits={bits}"
        )

    frame_bytes = channels * (bits // 8)
    usable = (len(data) // frame_bytes) * frame_bytes
    return decoder(data[:usable]).reshape(-1, channels), int(round(sample_rate))


def write(path: str, array: np.ndarray, sample_rate: int, subtype: str = "PCM_16") -> None:
    """Write a float array of shape (n, channels) as a big-endian CAF file."""
    array = np.asarray(array)
    if array.ndim == 1:
        array = array[:, None]
    encoder = pcm.ENCODERS.get(subtype)
    if encoder is None:
        raise CafFormatError(f"unsupported CAF subtype: {subtype}")

    channels = array.shape[1]
    bits = pcm.SUBTYPES[subtype] * 8
    if subtype in ("ALAW", "ULAW"):
        format_id, flags = subtype.lower().encode(), 0
        payload = encoder(array.reshape(-1))
    else:
        format_id = b"lpcm"
        flags = _FLAG_IS_FLOAT if subtype in ("FLOAT", "DOUBLE") else 0
        payload = encoder(array.reshape(-1), big_endian=True)

    frame_bytes = channels * (bits // 8)
    desc = struct.pack(
        ">d4sIIIII", float(sample_rate), format_id, flags, frame_bytes, 1, channels, bits
    )
    with open(path, "wb") as f:
        f.write(b"caff" + struct.pack(">HH", 1, 0))
        f.write(b"desc" + struct.pack(">q", len(desc)) + desc)
        f.write(b"data" + struct.pack(">qI", 4 + len(payload), 0) + payload)
