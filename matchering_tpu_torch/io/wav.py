"""RIFF/WAVE container codec (pure numpy host path).

Replaces the ``soundfile.read``/``soundfile.write`` calls of the reference
(``matchering/loader.py:35``, ``matchering/saver.py:32``) for the WAV format:
reads PCM 16/24/32, IEEE float/double, G.711 A-law/µ-law (including
WAVE_FORMAT_EXTENSIBLE) and RF64/BW64 64-bit containers; writes
PCM_16/PCM_24/PCM_32/FLOAT/DOUBLE/ALAW/ULAW.  Arrays are float64 frames with
shape ``(n, channels)`` (``always_2d`` semantics).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from . import pcm

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavFormatError(RuntimeError):
    pass


def raw_decoder_for(tag: int, bits: int):
    """Unscaled integer decoder for a WAVEFORMAT tag/bit-depth pair, or
    None when the encoding has no raw-integer form (floats, G.711)."""
    if tag == WAVE_FORMAT_PCM:
        return {
            16: pcm.decode_pcm16_raw,
            24: pcm.decode_pcm24_raw,
            32: pcm.decode_pcm32_raw,
        }.get(bits)
    return None


def decoder_for(tag: int, bits: int):
    """PCM decoder for a WAVEFORMAT tag/bit-depth pair, or None.  Shared by
    the RIFF/WAVE and Sony Wave64 containers (same fmt chunk layout)."""
    if tag == WAVE_FORMAT_PCM:
        return {16: pcm.decode_pcm16, 24: pcm.decode_pcm24, 32: pcm.decode_pcm32}.get(bits)
    if tag == WAVE_FORMAT_IEEE_FLOAT:
        return {32: pcm.decode_float, 64: pcm.decode_double}.get(bits)
    if tag == WAVE_FORMAT_ALAW:
        return pcm.decode_alaw if bits == 8 else None
    if tag == WAVE_FORMAT_MULAW:
        return pcm.decode_ulaw if bits == 8 else None
    return None


def _iter_chunks(buf: bytes, start: int, end: int):
    """Yield (chunk id, body offset, raw declared size) — the declared size
    is NOT clamped to the buffer (RF64 stores 0xFFFFFFFF as a sentinel);
    slicing at the use sites clamps naturally."""
    pos = start
    while pos + 8 <= end:
        cid, size = struct.unpack_from("<4sI", buf, pos)
        body = pos + 8
        yield cid, body, size
        pos = body + size + (size & 1)  # chunks are word-aligned


def read(path: str, raw_int: bool = False) -> Tuple[np.ndarray, int]:
    """Read a WAV (or RF64/BW64) file -> (float64 (n, channels) array, rate).

    With ``raw_int=True``, integer-PCM encodings return their UNSCALED
    integer codes instead (int16 for 16-bit; int32 for 24/32-bit, 24-bit
    widened into the top bytes): the mastering graph accepts them and
    converts on device (``stages.py`` ``master_graph``), so raw PCM rides
    the slow host->device link at container size instead of float size.
    Non-integer encodings ignore the flag and return float64 as usual.
    """
    with open(path, "rb") as f:
        buf = f.read()
    is_rf64 = len(buf) >= 12 and buf[:4] in (b"RF64", b"BW64") and buf[8:12] == b"WAVE"
    if not is_rf64 and (len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE"):
        raise WavFormatError("unknown format: not a RIFF/WAVE stream")

    # RF64 (EBU Tech 3306): the 32-bit riff/data sizes are 0xFFFFFFFF and the
    # true 64-bit sizes live in a 'ds64' chunk that precedes 'fmt '
    ds64_data_size = None
    fmt = None
    data = None
    for cid, body, size in _iter_chunks(buf, 12, len(buf)):
        if cid == b"ds64" and size >= 16:
            _riff_size, ds64_data_size = struct.unpack_from("<qq", buf, body)
        elif cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", buf, body)
            if fmt[0] == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                # SubFormat GUID's first two bytes carry the actual format tag
                (sub_tag,) = struct.unpack_from("<H", buf, body + 24)
                fmt = (sub_tag,) + fmt[1:]
        elif cid == b"data":
            if size == 0xFFFFFFFF and ds64_data_size is not None:
                size = ds64_data_size
            data = buf[body : body + size]
    if fmt is None or data is None:
        raise WavFormatError("unknown format: missing fmt/data chunk")

    tag, channels, sample_rate, _brate, _balign, bits = fmt
    if channels < 1:
        raise WavFormatError("invalid channel count")

    decoder = (raw_int and raw_decoder_for(tag, bits)) or decoder_for(tag, bits)
    if decoder is None:
        raise WavFormatError(f"unsupported WAV encoding: tag={tag} bits={bits}")

    frame_bytes = channels * (bits // 8)
    usable = (len(data) // frame_bytes) * frame_bytes
    samples = decoder(data[:usable])
    return samples.reshape(-1, channels), sample_rate


def write(path: str, array: np.ndarray, sample_rate: int, subtype: str = "PCM_16") -> None:
    """Write a float array of shape (n, channels) as a WAV file."""
    array = np.asarray(array)
    if array.ndim == 1:
        array = array[:, None]
    if subtype not in pcm.ENCODERS:
        raise WavFormatError(f"unsupported WAV subtype: {subtype}")

    channels = array.shape[1]
    bits = pcm.SUBTYPES[subtype] * 8
    tag = {
        "FLOAT": WAVE_FORMAT_IEEE_FLOAT,
        "DOUBLE": WAVE_FORMAT_IEEE_FLOAT,
        "ALAW": WAVE_FORMAT_ALAW,
        "ULAW": WAVE_FORMAT_MULAW,
    }.get(subtype, WAVE_FORMAT_PCM)
    payload = pcm.ENCODERS[subtype](array.reshape(-1))

    block_align = channels * (bits // 8)
    byte_rate = sample_rate * block_align
    fmt_body = struct.pack("<HHIIHH", tag, channels, sample_rate, byte_rate, block_align, bits)
    # non-PCM WAVs (float, G.711) conventionally carry a fact chunk with the
    # frame count
    fact = (
        struct.pack("<4sII", b"fact", 4, array.shape[0])
        if tag != WAVE_FORMAT_PCM
        else b""
    )
    chunks = (
        struct.pack("<4sI", b"fmt ", len(fmt_body))
        + fmt_body
        + fact
        + struct.pack("<4sI", b"data", len(payload))
        + payload
    )
    if len(payload) & 1:
        chunks += b"\x00"
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 4 + len(chunks), b"WAVE"))
        f.write(chunks)
