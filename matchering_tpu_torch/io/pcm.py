"""PCM sample-format conversion (float <-> integer codes).

Replaces the float conversion conventions the reference inherits from
libsndfile via ``soundfile`` (reference ``matchering/loader.py:35``,
``matchering/saver.py:32``): integer PCM maps to float by dividing by
``2**(bits-1)``; float -> integer multiplies by ``2**(bits-1)`` and clips to
the representable range.  The integer and G.711 encoders widen float32
input to float64 first (exact), so it quantises as the same samples in
float64 do; FLOAT writes float32 as it is.
"""

from __future__ import annotations

import numpy as np

# subtype -> (bytes per sample, numpy dtype or None for packed 24-bit)
SUBTYPES = {
    "PCM_16": 2,
    "PCM_24": 3,
    "PCM_32": 4,
    "FLOAT": 4,
    "DOUBLE": 8,
    "ALAW": 1,
    "ULAW": 1,
}


def _g711_tables():
    """Canonical G.711 decode tables (ITU-T G.711 segment/mantissa layout)
    plus nearest-value encode boundaries.

    Decoding follows the standard expansion formulas into 16-bit linear
    range (the same mapping libsndfile uses for the reference's ALAW/ULAW
    subtypes); encoding quantizes to the *nearest* decoded level via
    ``searchsorted`` on the sorted level midpoints — spec-compliant and
    exactly self-inverse through the decode table.
    """
    codes = np.arange(256, dtype=np.int32)

    # µ-law: complement, then mag = ((mantissa<<3) + 0x84) << exponent, -0x84
    u = ~codes & 0xFF
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    mag = (((mantissa << 3) + 0x84) << exponent) - 0x84
    ulaw = np.where(u & 0x80, -mag, mag).astype(np.int16)

    # A-law: xor 0x55; segment 0 is linear, higher segments exponential;
    # sign bit SET means positive in the canonical table
    a = codes ^ 0x55
    seg = (a >> 4) & 0x07
    t = (a & 0x0F) << 4
    t = np.where(seg == 0, t + 8, (t + 0x108) << np.maximum(seg - 1, 0))
    alaw = np.where(a & 0x80, t, -t).astype(np.int16)

    def _encoder_plan(table):
        order = np.argsort(table.astype(np.int32), kind="stable")
        levels = table.astype(np.int32)[order]
        mids = (levels[:-1] + levels[1:]) / 2.0
        return order.astype(np.uint8), mids

    return (ulaw, _encoder_plan(ulaw)), (alaw, _encoder_plan(alaw))


(_ULAW_TABLE, (_ULAW_ORDER, _ULAW_MIDS)), (_ALAW_TABLE, (_ALAW_ORDER, _ALAW_MIDS)) = (
    _g711_tables()
)


def decode_pcm16_raw(raw: bytes, big_endian: bool = False) -> np.ndarray:
    """int16 codes, unscaled — for staging raw PCM to the accelerator
    (half the H2D bytes of float32; the device converts with the same
    ``/ 2**15`` convention, ``stages.py`` ``to_working_float``)."""
    dt = ">i2" if big_endian else "<i2"
    return np.frombuffer(raw, dtype=dt).astype(np.int16, copy=False)


def decode_pcm24_raw(raw: bytes, big_endian: bool = False) -> np.ndarray:
    """24-bit codes widened into the TOP bytes of int32 (``x << 8``), so the
    device-side ``/ 2**31`` reproduces ``/ 2**23`` exactly."""
    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
    if big_endian:
        b = b[:, ::-1]
    return (
        (b[:, 0].astype(np.uint32) << 8)
        | (b[:, 1].astype(np.uint32) << 16)
        | (b[:, 2].astype(np.uint32) << 24)
    ).astype(np.int32)


def decode_pcm32_raw(raw: bytes, big_endian: bool = False) -> np.ndarray:
    dt = ">i4" if big_endian else "<i4"
    return np.frombuffer(raw, dtype=dt).astype(np.int32, copy=False)


def decode_pcm16(raw: bytes, big_endian: bool = False) -> np.ndarray:
    dt = ">i2" if big_endian else "<i2"
    return np.frombuffer(raw, dtype=dt).astype(np.float64) / 32768.0


def decode_pcm24(raw: bytes, big_endian: bool = False) -> np.ndarray:
    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
    if big_endian:
        b = b[:, ::-1]
    val = (
        b[:, 0].astype(np.int32)
        | (b[:, 1].astype(np.int32) << 8)
        | (b[:, 2].astype(np.int32) << 16)
    )
    val = np.where(val >= 1 << 23, val - (1 << 24), val)
    return val.astype(np.float64) / float(1 << 23)


def decode_pcm32(raw: bytes, big_endian: bool = False) -> np.ndarray:
    dt = ">i4" if big_endian else "<i4"
    return np.frombuffer(raw, dtype=dt).astype(np.float64) / float(1 << 31)


def decode_float(raw: bytes, big_endian: bool = False) -> np.ndarray:
    dt = ">f4" if big_endian else "<f4"
    return np.frombuffer(raw, dtype=dt).astype(np.float64)


def decode_double(raw: bytes, big_endian: bool = False) -> np.ndarray:
    dt = ">f8" if big_endian else "<f8"
    return np.frombuffer(raw, dtype=dt).astype(np.float64)


def encode_pcm16(x: np.ndarray, big_endian: bool = False) -> bytes:
    x = np.asarray(x, dtype=np.float64)
    scaled = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int64)
    dt = ">i2" if big_endian else "<i2"
    return scaled.astype(dt).tobytes()


def encode_pcm24(x: np.ndarray, big_endian: bool = False) -> bytes:
    x = np.asarray(x, dtype=np.float64)
    scaled = np.clip(
        np.rint(x * float(1 << 23)), -(1 << 23), (1 << 23) - 1
    ).astype(np.int32)
    u = scaled.astype(np.uint32).reshape(-1)
    out = np.empty((u.size, 3), dtype=np.uint8)
    out[:, 0] = u & 0xFF
    out[:, 1] = (u >> 8) & 0xFF
    out[:, 2] = (u >> 16) & 0xFF
    if big_endian:
        out = out[:, ::-1]
    return out.tobytes()


def encode_pcm32(x: np.ndarray, big_endian: bool = False) -> bytes:
    x = np.asarray(x, dtype=np.float64)
    scaled = np.clip(
        np.rint(x * float(1 << 31)), -(1 << 31), (1 << 31) - 1
    ).astype(np.int64)
    dt = ">i4" if big_endian else "<i4"
    return scaled.astype(dt).tobytes()


def encode_float(x: np.ndarray, big_endian: bool = False) -> bytes:
    dt = ">f4" if big_endian else "<f4"
    return x.astype(dt).tobytes()


def encode_double(x: np.ndarray, big_endian: bool = False) -> bytes:
    dt = ">f8" if big_endian else "<f8"
    return x.astype(dt).tobytes()


def decode_ulaw(raw: bytes, big_endian: bool = False) -> np.ndarray:
    codes = np.frombuffer(raw, dtype=np.uint8)
    return _ULAW_TABLE[codes].astype(np.float64) / 32768.0


def decode_alaw(raw: bytes, big_endian: bool = False) -> np.ndarray:
    codes = np.frombuffer(raw, dtype=np.uint8)
    return _ALAW_TABLE[codes].astype(np.float64) / 32768.0


def encode_ulaw(x: np.ndarray, big_endian: bool = False) -> bytes:
    x = np.asarray(x, dtype=np.float64)
    scaled = np.clip(np.rint(x * 32768.0), -32768, 32767)
    return _ULAW_ORDER[np.searchsorted(_ULAW_MIDS, scaled)].tobytes()


def encode_alaw(x: np.ndarray, big_endian: bool = False) -> bytes:
    x = np.asarray(x, dtype=np.float64)
    scaled = np.clip(np.rint(x * 32768.0), -32768, 32767)
    return _ALAW_ORDER[np.searchsorted(_ALAW_MIDS, scaled)].tobytes()


DECODERS = {
    "PCM_16": decode_pcm16,
    "PCM_24": decode_pcm24,
    "PCM_32": decode_pcm32,
    "FLOAT": decode_float,
    "DOUBLE": decode_double,
    "ALAW": decode_alaw,
    "ULAW": decode_ulaw,
}

ENCODERS = {
    "PCM_16": encode_pcm16,
    "PCM_24": encode_pcm24,
    "PCM_32": encode_pcm32,
    "FLOAT": encode_float,
    "DOUBLE": encode_double,
    "ALAW": encode_alaw,
    "ULAW": encode_ulaw,
}
