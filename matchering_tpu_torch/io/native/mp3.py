"""MP3 decode via the system libmpg123 — no ffmpeg binary needed.

A copy of ``matchering_tpu/io/native/mp3.py`` (numpy and ctypes only).

Modern libsndfile (>= 1.1) reads MP3 natively, so the reference's loader
(``matchering/loader.py:35``) accepts MP3 uploads without ffmpeg; this
binding gives the same capability.  Gracefully unavailable on hosts without
``libmpg123.so.0`` (the loader then falls back to ffmpeg).

Write-side MP3 goes through LAME (``write_mp3``) when ``libmp3lame.so.0``
is present, mirroring libsndfile's lame-backed MP3 write.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_MPG123_ADD_FLAGS = 2
_MPG123_FORCE_FLOAT = 0x400
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_lame: Optional[ctypes.CDLL] = None
_lame_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL("libmpg123.so.0")
    except OSError:
        _lib_failed = True
        return None
    lib.mpg123_init.restype = ctypes.c_int
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_param.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_long,
        ctypes.c_double,
    ]
    lib.mpg123_param.restype = ctypes.c_int
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_open.restype = ctypes.c_int
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_getformat.restype = ctypes.c_int
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_read.restype = ctypes.c_int
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_init()
    _lib = lib
    return _lib


def _load_lame() -> Optional[ctypes.CDLL]:
    global _lame, _lame_failed
    if _lame is not None or _lame_failed:
        return _lame
    try:
        lib = ctypes.CDLL("libmp3lame.so.0")
    except OSError:
        _lame_failed = True
        return None
    lib.lame_init.restype = ctypes.c_void_p
    for name in (
        "lame_set_in_samplerate",
        "lame_set_num_channels",
        "lame_set_brate",
        "lame_set_quality",
    ):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.lame_init_params.argtypes = [ctypes.c_void_p]
    lib.lame_init_params.restype = ctypes.c_int
    lib.lame_encode_buffer_ieee_double.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.lame_encode_buffer_ieee_double.restype = ctypes.c_int
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.lame_encode_flush.restype = ctypes.c_int
    lib.lame_close.argtypes = [ctypes.c_void_p]
    _lame = lib
    return _lame


def available() -> bool:
    return _load() is not None


def write_available() -> bool:
    return _load_lame() is not None


def is_mp3(path: str) -> bool:
    """MP3 has no reliable magic: accept an ID3 tag or an MPEG audio frame
    sync (11 set bits), the same sniff libsndfile's mp3 detector uses."""
    try:
        with open(path, "rb") as f:
            head = f.read(3)
    except OSError:
        return False
    if head[:3] == b"ID3":
        return True
    return len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0


def read_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Decode an MP3 file -> (float64 (n, ch) array, sample rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libmpg123 is not available on this host")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (rc={err.value})")
    try:
        lib.mpg123_param(h, _MPG123_ADD_FLAGS, _MPG123_FORCE_FLOAT, 0.0)
        if lib.mpg123_open(h, path.encode()) != _MPG123_OK:
            raise RuntimeError(f"unknown format: '{os.path.basename(path)}'")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        if (
            lib.mpg123_getformat(
                h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)
            )
            != _MPG123_OK
        ):
            raise RuntimeError(f"unknown format: '{os.path.basename(path)}'")
        chunks = []
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(
                    np.frombuffer(buf.raw[: done.value], dtype=np.float32).copy()
                )
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                raise RuntimeError(f"mpg123 decode failed (rc={rc})")
        flat = (
            np.concatenate(chunks) if chunks else np.empty((0,), dtype=np.float32)
        )
        ch = max(channels.value, 1)
        out = flat[: len(flat) - len(flat) % ch].reshape(-1, ch).astype(np.float64)
        return out, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def write_mp3(
    path: str, array: np.ndarray, sample_rate: int, bitrate_kbps: int = 320
) -> None:
    """Encode float (n, ch<=2) audio as MP3 via LAME."""
    lame = _load_lame()
    if lame is None:
        raise RuntimeError("libmp3lame is not available on this host")
    array = np.ascontiguousarray(array, dtype=np.float64)
    if array.ndim == 1:
        array = array[:, None]
    n, channels = array.shape
    if channels > 2:
        raise RuntimeError("MP3 supports at most 2 channels")
    g = lame.lame_init()
    if not g:
        raise RuntimeError("lame_init failed")
    try:
        lame.lame_set_in_samplerate(g, sample_rate)
        lame.lame_set_num_channels(g, channels)
        lame.lame_set_brate(g, bitrate_kbps)
        lame.lame_set_quality(g, 2)
        if lame.lame_init_params(g) < 0:
            raise RuntimeError("lame rejected the stream parameters")
        left = np.ascontiguousarray(array[:, 0])
        right = np.ascontiguousarray(array[:, 1] if channels == 2 else array[:, 0])
        out = ctypes.create_string_buffer(int(1.25 * n) + 7200 + (1 << 14))
        dbl = ctypes.POINTER(ctypes.c_double)
        wrote = lame.lame_encode_buffer_ieee_double(
            g,
            left.ctypes.data_as(dbl),
            right.ctypes.data_as(dbl),
            n,
            out,
            len(out),
        )
        if wrote < 0:
            raise RuntimeError(f"lame encode failed (rc={wrote})")
        with open(path, "wb") as f:
            f.write(out.raw[:wrote])
            tail = lame.lame_encode_flush(g, out, len(out))
            if tail > 0:
                f.write(out.raw[:tail])
    finally:
        lame.lame_close(g)
