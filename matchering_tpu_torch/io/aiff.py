"""AIFF / AIFC container codec (pure numpy host path).

Covers the lossless AIFF path the reference gets from libsndfile
(``matchering/loader.py:35``): big-endian PCM 16/24/32 read and write plus
AIFC float32 ('fl32' — the reference's ``advanced_results.py`` uses the
FLOAT subtype for no-limiter output that may exceed 0 dB), including the
80-bit extended-precision sample-rate field of the COMM chunk.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from . import pcm


class AiffFormatError(RuntimeError):
    pass


def _decode_extended(raw: bytes) -> int:
    """Decode an IEEE 754 80-bit extended float (AIFF sample rate)."""
    exponent, hi, lo = struct.unpack(">HII", raw)
    sign = -1 if exponent & 0x8000 else 1
    exponent &= 0x7FFF
    mantissa = (hi << 32) | lo
    if exponent == 0 and mantissa == 0:
        return 0
    value = sign * mantissa * 2.0 ** (exponent - 16383 - 63)
    return int(round(value))


def _encode_extended(value: float) -> bytes:
    if value == 0:
        return b"\x00" * 10
    sign = 0
    if value < 0:
        sign = 0x8000
        value = -value
    exponent = 16383 + 63
    mantissa = int(value)
    # normalize so the top mantissa bit is set
    while mantissa < (1 << 63):
        mantissa <<= 1
        exponent -= 1
    while mantissa >= (1 << 64):
        mantissa >>= 1
        exponent += 1
    return struct.pack(">HII", sign | exponent, (mantissa >> 32) & 0xFFFFFFFF, mantissa & 0xFFFFFFFF)


def read(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 12 or buf[:4] != b"FORM" or buf[8:12] not in (b"AIFF", b"AIFC"):
        raise AiffFormatError("unknown format: not an AIFF stream")

    comm = None
    ssnd = None
    pos = 12
    while pos + 8 <= len(buf):
        cid, size = struct.unpack_from(">4sI", buf, pos)
        body = pos + 8
        if cid == b"COMM":
            channels, nframes, bits = struct.unpack_from(">HIH", buf, body)
            rate = _decode_extended(buf[body + 8 : body + 18])
            compression = buf[body + 18 : body + 22] if size >= 22 else b"NONE"
            comm = (channels, nframes, bits, rate, compression)
        elif cid == b"SSND":
            offset, _block = struct.unpack_from(">II", buf, body)
            ssnd = buf[body + 8 + offset : body + size]
        pos = body + size + (size & 1)
    if comm is None or ssnd is None:
        raise AiffFormatError("unknown format: missing COMM/SSND chunk")

    channels, nframes, bits, rate, compression = comm
    if compression in (b"fl32", b"FL32"):
        frame_bytes = channels * 4
        usable = min(len(ssnd) // frame_bytes, nframes) * frame_bytes
        samples = (
            np.frombuffer(ssnd[:usable], dtype=">f4").astype(np.float64)
        )
    elif compression in (b"fl64", b"FL64"):
        frame_bytes = channels * 8
        usable = min(len(ssnd) // frame_bytes, nframes) * frame_bytes
        samples = np.frombuffer(ssnd[:usable], dtype=">f8").astype(np.float64)
    elif compression in (b"NONE", b"sowt"):
        decoder = {
            16: pcm.decode_pcm16,
            24: pcm.decode_pcm24,
            32: pcm.decode_pcm32,
        }.get(bits)
        if decoder is None:
            raise AiffFormatError(f"unsupported AIFF bit depth: {bits}")
        frame_bytes = channels * (bits // 8)
        usable = min(len(ssnd) // frame_bytes, nframes) * frame_bytes
        # 'sowt' is AIFC's little-endian PCM variant
        samples = decoder(ssnd[:usable], big_endian=compression != b"sowt")
    else:
        raise AiffFormatError(f"unsupported AIFC compression: {compression!r}")
    return samples.reshape(-1, channels), rate


def write(path: str, array: np.ndarray, sample_rate: int, subtype: str = "PCM_16") -> None:
    array = np.asarray(array)
    if array.ndim == 1:
        array = array[:, None]
    channels = array.shape[1]
    if subtype == "FLOAT":
        bits = 32
        payload = array.reshape(-1).astype(">f4").tobytes()
        # AIFC with fl32 compression (what libsndfile writes for FLOAT)
        comm = (
            struct.pack(">HIH", channels, array.shape[0], bits)
            + _encode_extended(sample_rate)
            + b"fl32"
            + b"\x00\x00"  # empty pstring compression name (padded)
        )
        form_type = b"AIFC"
        fver = struct.pack(">4sII", b"FVER", 4, 0xA2805140)
    else:
        encoder = {
            "PCM_16": pcm.encode_pcm16,
            "PCM_24": pcm.encode_pcm24,
            "PCM_32": pcm.encode_pcm32,
        }.get(subtype)
        if encoder is None:
            raise AiffFormatError(f"unsupported AIFF subtype: {subtype}")
        bits = pcm.SUBTYPES[subtype] * 8
        payload = encoder(array.reshape(-1), big_endian=True)
        comm = struct.pack(">HIH", channels, array.shape[0], bits) + _encode_extended(
            sample_rate
        )
        form_type = b"AIFF"
        fver = b""

    ssnd_body = struct.pack(">II", 0, 0) + payload
    chunks = (
        fver
        + struct.pack(">4sI", b"COMM", len(comm))
        + comm
        + struct.pack(">4sI", b"SSND", len(ssnd_body))
        + ssnd_body
    )
    if len(ssnd_body) & 1:
        chunks += b"\x00"
    with open(path, "wb") as f:
        f.write(struct.pack(">4sI4s", b"FORM", 4 + len(chunks), form_type))
        f.write(chunks)
