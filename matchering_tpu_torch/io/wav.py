"""RIFF/WAVE container codec (pure numpy host path).

Replaces the ``soundfile.read``/``soundfile.write`` calls of the reference
(``matchering/loader.py:35``, ``matchering/saver.py:32``) for the WAV format:
reads PCM 16/24/32, IEEE float/double, G.711 A-law/µ-law (including
WAVE_FORMAT_EXTENSIBLE) and RF64/BW64 64-bit containers; writes
PCM_16/PCM_24/PCM_32/FLOAT/DOUBLE/ALAW/ULAW.  Arrays are float64 frames with
shape ``(n, channels)`` (``always_2d`` semantics).
"""

from __future__ import annotations

import os
import struct
import sys
from typing import NamedTuple, Optional, Tuple

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


def _read_at(f, offset: int, size: int) -> bytes:
    f.seek(offset)
    return f.read(size)


def _chunks(f):
    """The ``fmt `` fields and the payload's (offset, length) of the open
    WAV, RF64 or BW64 file ``f``, found with small reads and seeks.  The
    last ``fmt `` and ``data`` chunks count; chunks are word-aligned; the
    declared data size is clamped to the bytes present."""
    end = os.fstat(f.fileno()).st_size
    head = _read_at(f, 0, 12)
    if len(head) < 12 or head[:4] not in (b"RIFF", b"RF64", b"BW64") or head[8:12] != b"WAVE":
        raise WavFormatError("unknown format: not a RIFF/WAVE stream")

    # RF64 (EBU Tech 3306): the 32-bit riff/data sizes are 0xFFFFFFFF and the
    # true 64-bit sizes live in a 'ds64' chunk that precedes 'fmt '
    ds64_data_size = None
    fmt = None
    data = None
    pos = 12
    while pos + 8 <= end:
        cid, size = struct.unpack("<4sI", _read_at(f, pos, 8))
        body = pos + 8
        if cid == b"ds64" and size >= 16:
            _riff_size, ds64_data_size = struct.unpack("<qq", _read_at(f, body, 16))
        elif cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", _read_at(f, body, 16))
            if fmt[0] == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                # SubFormat GUID's first two bytes carry the actual format tag
                fmt = struct.unpack("<H", _read_at(f, body + 24, 2)) + fmt[1:]
        elif cid == b"data":
            declared = ds64_data_size if size == 0xFFFFFFFF and ds64_data_size is not None else size
            first, last, _ = slice(body, body + declared).indices(end)  # the bytes a slice of the file holds
            data = (first, max(0, last - first))
        pos = body + size + (size & 1)  # the declared size, as stored
    if fmt is None or data is None:
        raise WavFormatError("unknown format: missing fmt/data chunk")
    return fmt, data


def read(path: str, raw_int: bool = False) -> Tuple[np.ndarray, int]:
    """Read a WAV (or RF64/BW64) file -> (float64 (n, channels) array, rate).

    With ``raw_int=True``, integer-PCM encodings return their UNSCALED
    integer codes instead (int16 for 16-bit; int32 for 24/32-bit, 24-bit
    widened into the top bytes): the mastering graph accepts them and
    converts on device (``stages.py`` ``master_graph``), so raw PCM rides
    the slow host->device link at container size instead of float size.
    Non-integer encodings ignore the flag and return float64 as usual.
    ``pcm_layout`` and ``read_pcm_into`` read the same codes of a 16- or
    32-bit file straight into a caller's buffer.
    """
    with open(path, "rb") as f:
        fmt, (offset, length) = _chunks(f)
        tag, channels, sample_rate, _brate, _balign, bits = fmt
        if channels < 1:
            raise WavFormatError("invalid channel count")

        decoder = (raw_int and raw_decoder_for(tag, bits)) or decoder_for(tag, bits)
        if decoder is None:
            raise WavFormatError(f"unsupported WAV encoding: tag={tag} bits={bits}")

        frame_bytes = channels * (bits // 8)
        data = _read_at(f, offset, (length // frame_bytes) * frame_bytes)
    samples = decoder(data)
    return samples.reshape(-1, channels), sample_rate


class PcmLayout(NamedTuple):
    """Where a WAV's integer-PCM payload lies, for a payload whose bytes are
    already the codes ``read(path, raw_int=True)`` returns: little-endian
    PCM of 16 bits (int16) or 32 bits (int32)."""

    offset: int  # the payload's first byte in the file
    frames: int
    channels: int
    dtype: np.dtype
    sample_rate: int


_DIRECT_DTYPES = {16: np.dtype(np.int16), 32: np.dtype(np.int32)}


def pcm_layout(f) -> Optional[PcmLayout]:
    """The payload's layout in the open WAV, RF64 or BW64 file ``f``, found
    as ``read`` finds it (its frames: the whole frames present), or None
    where ``read(path, raw_int=True)`` would not return the payload's bytes
    as they stand: another encoding (PCM_24 is widened, the rest scaled),
    or a big-endian host.  Raises what ``read`` raises on a stream it
    refuses."""
    fmt, (offset, length) = _chunks(f)
    tag, channels, sample_rate, _brate, _balign, bits = fmt
    if sys.byteorder != "little" or tag != WAVE_FORMAT_PCM or bits not in _DIRECT_DTYPES or channels < 1:
        return None
    dtype = _DIRECT_DTYPES[bits]
    return PcmLayout(offset, length // (channels * dtype.itemsize), channels, dtype, sample_rate)


def read_pcm_into(f, layout: PcmLayout, out: np.ndarray) -> None:
    """Fill ``out``, a writable C-contiguous array of ``layout``'s frames
    times channels codes, with the payload of the open file ``f``: the
    codes ``read(path, raw_int=True)`` returns, read straight into it."""
    flat = out.reshape(-1).view(np.uint8)
    f.seek(layout.offset)
    filled = 0
    while filled < flat.size:
        n = f.readinto(flat[filled:])
        if not n:
            raise WavFormatError("the data chunk ended before its declared frames")
        filled += n


def header(subtype: str, frames: int, channels: int, sample_rate: int) -> bytes:
    """The bytes of a WAV file of ``frames`` x ``channels`` samples coded as
    ``subtype`` that precede its payload: the RIFF header (its size counts
    the pad byte after an odd payload), ``fmt `` of 16 bytes, a ``fact``
    chunk for every encoding but integer PCM, and the ``data`` chunk's
    header.  ``write`` and ``write_payload`` write it."""
    if subtype not in pcm.ENCODERS:
        raise WavFormatError(f"unsupported WAV subtype: {subtype}")
    width = pcm.SUBTYPES[subtype]
    tag = {
        "FLOAT": WAVE_FORMAT_IEEE_FLOAT,
        "DOUBLE": WAVE_FORMAT_IEEE_FLOAT,
        "ALAW": WAVE_FORMAT_ALAW,
        "ULAW": WAVE_FORMAT_MULAW,
    }.get(subtype, WAVE_FORMAT_PCM)
    payload_bytes = frames * channels * width
    block_align = channels * width
    fmt_body = struct.pack("<HHIIHH", tag, channels, sample_rate, sample_rate * block_align, block_align, 8 * width)
    # non-PCM WAVs (float, G.711) conventionally carry a fact chunk with the
    # frame count
    fact = struct.pack("<4sII", b"fact", 4, frames) if tag != WAVE_FORMAT_PCM else b""
    chunks = struct.pack("<4sI", b"fmt ", len(fmt_body)) + fmt_body + fact
    riff_size = 4 + len(chunks) + 8 + payload_bytes + (payload_bytes & 1)
    return struct.pack("<4sI4s", b"RIFF", riff_size, b"WAVE") + chunks + struct.pack("<4sI", b"data", payload_bytes)


def write_payload(path: str, payload, frames: int, channels: int, sample_rate: int, subtype: str) -> int:
    """Write a WAV file whose payload is ``payload``, any C-contiguous
    buffer that holds the little-endian codes of ``frames`` x ``channels``
    samples as ``subtype`` codes them: the header, the payload and the pad
    byte after an odd payload go out with one gathered write, the payload
    from the buffer itself.  Returns the payload's bytes."""
    data = memoryview(payload).cast("B")
    head = header(subtype, frames, channels, sample_rate)
    if len(data) != frames * channels * pcm.SUBTYPES[subtype]:
        raise WavFormatError(f"a payload of {len(data)} bytes for {frames} x {channels} {subtype} samples")
    parts = [part for part in (head, data, b"\x00"[: len(data) & 1]) if len(part)]
    with open(path, "wb", buffering=0) as f:
        while parts:
            wrote = os.writev(f.fileno(), parts)
            if not wrote:
                raise OSError(f"no byte of '{path}' could be written")
            while parts and wrote >= len(parts[0]):  # a write may stop short: go on from there
                wrote -= len(parts[0])
                parts.pop(0)
            if parts and wrote:
                parts[0] = memoryview(parts[0])[wrote:]
    return len(data)


def write(path: str, array: np.ndarray, sample_rate: int, subtype: str = "PCM_16") -> None:
    """Write a float array of shape (n, channels) as a WAV file."""
    array = np.asarray(array)
    if array.ndim == 1:
        array = array[:, None]
    if subtype not in pcm.ENCODERS:
        raise WavFormatError(f"unsupported WAV subtype: {subtype}")
    payload = pcm.ENCODERS[subtype](array.reshape(-1))
    write_payload(path, payload, array.shape[0], array.shape[1], sample_rate, subtype)
