"""ctypes binding for the native C++ codec: FLAC.

Counterpart of ``matchering_tpu/io/native/binding.py``.  The native backend
(``flac.cpp``) converts PCM <-> float64 in bulk and reads and writes FLAC
files for the host shell; FLAC has no other codec.  The writer also takes
float32 samples (``mtpu_flac_write_f32``), which it widens to float64
before it quantises: the bytes are those of the float64 entry with the
same samples widened.  The port has one WAV codec, the numpy one
(``io/wav.py``) with ``save``'s codes path: ``read_wav`` and ``write_wav``
keep the JAX package's names and hand over to it.  The library is the
port's own, built with g++ from the source beside this file into
``matchering_tpu_torch/_build/`` (``build.py``) at first use.  Set
``MATCHERING_TPU_TORCH_NO_AUTOBUILD=1`` to forbid that build: without a
built library FLAC is refused (``codecs.check_format``).  A build that
fails is reported as a ``debug`` log line, with the compiler's message.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from typing import Optional, Tuple

import numpy as np

from ...log import debug
from .. import wav
from . import build as _build

NO_AUTOBUILD_ENV = "MATCHERING_TPU_TORCH_NO_AUTOBUILD"
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
build_seconds: Optional[float] = None  # wall time of this process's build, None if loaded


def _lib_path() -> str:
    return os.path.join(_build.BUILD_DIR, _build.library_name())


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted, build_seconds
    if _load_attempted:
        return _lib
    _load_attempted = True
    path = _lib_path()
    if not os.path.exists(path):
        if os.environ.get(NO_AUTOBUILD_ENV) == "1":
            debug(f"native codec not built and {NO_AUTOBUILD_ENV}=1: no FLAC")
            return None
        start = time.perf_counter()
        try:
            _build.build(verbose=False, build_dir=_build.BUILD_DIR)
            build_seconds = time.perf_counter() - start
        except (OSError, subprocess.CalledProcessError) as error:
            detail = getattr(error, "stderr", None) or error
            debug(f"native codec build failed, no FLAC: {detail}")
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as error:
        debug(f"native codec did not load: {error}")
        return None
    lib.mtpu_flac_probe.restype = ctypes.c_int
    lib.mtpu_flac_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),  # frames
        ctypes.POINTER(ctypes.c_int),  # channels
        ctypes.POINTER(ctypes.c_int),  # sample rate
        ctypes.POINTER(ctypes.c_int),  # bits per sample
    ]
    lib.mtpu_flac_read.restype = ctypes.c_longlong
    lib.mtpu_flac_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong,
    ]
    for entry, sample in (("mtpu_flac_write", ctypes.c_double), ("mtpu_flac_write_f32", ctypes.c_float)):
        getattr(lib, entry).restype = ctypes.c_int
        getattr(lib, entry).argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(sample),
            ctypes.c_longlong,  # frames
            ctypes.c_int,  # channels
            ctypes.c_int,  # sample rate
            ctypes.c_int,  # bits per sample
        ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _loaded() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native codec is not available (see the debug log)")
    return lib


def _writer(lib: ctypes.CDLL, entry: str, array):
    """A writer's entry for ``array``'s dtype (float32 samples go to the
    ``_f32`` entry as they are, anything else as float64), the (n, ch)
    C-contiguous samples, and their pointer."""
    array = np.asarray(array)
    f32 = array.dtype == np.float32
    array = np.ascontiguousarray(array, dtype=np.float32 if f32 else np.float64)
    if array.ndim == 1:
        array = array[:, None]
    sample = ctypes.c_float if f32 else ctypes.c_double
    fn = getattr(lib, entry + "_f32" if f32 else entry)
    return fn, array, array.ctypes.data_as(ctypes.POINTER(sample))


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file -> (float64 (n, ch), rate): ``wav.read``, the
    port's one WAV reader."""
    return wav.read(path)


def write_wav(path: str, array: np.ndarray, sample_rate: int, subtype: str) -> None:
    """Encode (n, ch) audio as WAV (PCM_16/24/32, FLOAT), float32 samples
    as they are and any other as float64: ``save``'s codes path
    (``saver.write_codes``), the port's one WAV writer."""
    from ..saver import write_codes  # saver imports this module through codecs

    array = np.asarray(array)
    write_codes(path, array if array.dtype == np.float32 else array.astype(np.float64), sample_rate, subtype)


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file via the native codec -> (float64 (n, ch), rate)."""
    lib = _loaded()
    frames = ctypes.c_longlong()
    channels = ctypes.c_int()
    rate = ctypes.c_int()
    bps = ctypes.c_int()
    rc = lib.mtpu_flac_probe(
        path.encode(),
        ctypes.byref(frames),
        ctypes.byref(channels),
        ctypes.byref(rate),
        ctypes.byref(bps),
    )
    if rc != 0:
        raise RuntimeError(f"unknown format: '{os.path.basename(path)}' (rc={rc})")

    def _decode(capacity: int) -> Tuple[np.ndarray, int]:
        buf = np.empty((capacity, channels.value), dtype=np.float64)
        n = lib.mtpu_flac_read(
            path.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            capacity,
        )
        if n < 0:
            raise RuntimeError(f"native FLAC decode failed (rc={n})")
        return buf, n

    # STREAMINFO total_samples is advisory (0 = unknown, RFC 9639) and
    # attacker-controlled: allocate from it only when the implied buffer is
    # plausible against the file size.  Legit FLAC decompresses to at most a
    # few times the file size (our f64 buffer is 8 bytes/sample vs >= 2 on
    # disk), so 64x file size is already generous; a crafted small file
    # claiming billions of samples now caps at megabytes instead of the old
    # 16 GiB absolute bound.  Pathological cases (all-digital-silence tracks
    # compress ~500x) fail the gate harmlessly: they decode via the growing
    # buffer below.
    claimed = frames.value
    file_bytes = os.path.getsize(path)
    plausible = 0 < claimed and claimed * channels.value * 8 <= max(
        1 << 26, file_bytes * 64
    )
    if plausible:
        out, n = _decode(claimed)
        return out[:n], rate.value
    capacity = max(file_bytes // max(channels.value, 1), 1 << 16)
    while True:
        out, n = _decode(capacity)
        if n < capacity:
            return out[:n].copy(), rate.value
        capacity *= 4


def write_flac(path: str, array: np.ndarray, sample_rate: int, subtype: str) -> None:
    """Encode float32 or float64 (n, ch) audio as FLAC (PCM_16 or PCM_24)."""
    bps = {"PCM_16": 16, "PCM_24": 24}[subtype]
    write, array, samples = _writer(_loaded(), "mtpu_flac_write", array)
    rc = write(
        path.encode(),
        samples,
        array.shape[0],
        array.shape[1],
        sample_rate,
        bps,
    )
    if rc != 0:
        raise RuntimeError(f"native FLAC write failed (rc={rc})")
