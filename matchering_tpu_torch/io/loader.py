"""Audio ingestion: native decoders first, transcoding as a safety net.

Counterpart of ``matchering_tpu.io.loader`` (reference
``matchering/loader.py:30-74``): any container the built-in codecs
understand decodes directly (``codecs.read``: the numpy containers,
the native FLAC codec, the system lossy libraries); anything else is
handed to an ``ffmpeg`` subprocess that rewrites it into a temporary WAV.
A lossy source fires the role's advisory (``WARNING_TARGET_IS_LOSSY``,
``INFO_REFERENCE_IS_LOSSY``), and a coded ``ModuleError`` fires only after
every strategy is exhausted.

Structure is a decode chain: each strategy either returns ``(audio, rate)``
or ``None`` to let the next one try.
"""

from __future__ import annotations

import os
import struct
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from .. import trace
from ..log import Code, ModuleError, debug, info, warning
from ..utils import random_file, staging_block
from . import codecs, wav

_LOAD_ERRORS = {"TARGET": Code.ERROR_TARGET_LOADING, "REFERENCE": Code.ERROR_REFERENCE_LOADING}
_LOSSY_EVENTS = {
    "TARGET": lambda: warning(Code.WARNING_TARGET_IS_LOSSY),
    "REFERENCE": lambda: info(Code.INFO_REFERENCE_IS_LOSSY),
}
# what a codec raises on a file it cannot parse (the numpy containers raise
# ValueError and struct.error on truncated headers)
_DECODE_ERRORS = (RuntimeError, OSError, ValueError, struct.error)


def _is_unknown_container(error: Exception) -> bool:
    """True when the codec layer rejected the *container*, i.e.
    transcoding could still succeed (as opposed to e.g. a truncated file)."""
    text = str(error)
    return "unknown format" in text or "Format not recognised" in text


def _decode_native(file: str, role: str, temp_folder: str, raw_int: bool):
    try:
        decoded = codecs.read(file, raw_int=raw_int)
    except _DECODE_ERRORS as error:
        debug(error)
        return None if _is_unknown_container(error) else _raise_load_error(role)
    if codecs.is_lossy_container(file):
        _LOSSY_EVENTS[role]()
    return decoded


def _decode_via_ffmpeg(file: str, role: str, temp_folder: str, raw_int: bool):
    """Transcode with ffmpeg into a temp WAV, decode that, clean up."""
    debug(f"Unknown container — transcoding '{file}' through ffmpeg")
    staging = os.path.join(temp_folder, random_file(prefix="temp"))
    try:
        subprocess.check_call(
            ["ffmpeg", "-i", file, staging],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
    except FileNotFoundError:
        debug("no ffmpeg binary on PATH — cannot transcode unknown containers")
        return None
    except subprocess.CalledProcessError:
        debug(f"ffmpeg could not produce a WAV from '{file}'")
        return None
    try:
        decoded = codecs.read(staging, raw_int=raw_int)
    except _DECODE_ERRORS as error:
        # a WAV flavour the codecs cannot parse: stay inside the chain's
        # contract (a coded ModuleError, not a raw exception)
        debug(error)
        return None
    finally:
        if os.path.exists(staging):
            os.remove(staging)
    _LOSSY_EVENTS[role]()
    return decoded


def _raise_load_error(role: str):
    raise ModuleError(_LOAD_ERRORS[role])


_DECODE_CHAIN = (_decode_native, _decode_via_ffmpeg)


def load(
    file: str, file_type: str, temp_folder: Optional[str] = None, raw_int: bool = False
) -> Tuple[np.ndarray, int]:
    """Decode ``file`` into a float64 (n, ch) array + sample rate.

    ``file_type`` names the track's role ("target"/"reference") and selects
    which coded events fire on failure or lossy input.  ``temp_folder``:
    where the ffmpeg fallback stages its WAV (the system's temporary folder
    if None).  ``raw_int=True`` keeps integer-PCM WAV payloads as unscaled
    int16/int32 codes: ``process()`` stages those to the device as they are
    and converts there (``ops.basics.to_working_float``).  The span
    ``load``.
    """
    return _load(file, file_type, temp_folder, raw_int, None)


def load_staged(file: str, file_type: str, temp_folder: Optional[str] = None, *, device):
    """``load(file, file_type, temp_folder, raw_int=True)`` for a track bound
    for ``device``.  A WAV whose payload is already the codes that cross
    (16- or 32-bit integer PCM, ``wav.pcm_layout``) is read with one
    ``readinto`` straight into ``utils.staging_block(..., device)``, the
    block ``to_device`` stages from, and its bytes count in
    ``direct_bytes`` (``trace``); every other file decodes as ``load``
    decodes it.  Returns the block (a page-locked tensor for a card, a
    numpy array for the CPU) or ``load``'s array, and the rate."""
    return _load(file, file_type, temp_folder, True, device)


def _read_direct(file: str, device):
    """(staging block, rate) of a file ``wav.pcm_layout`` places, else None
    (the decode chain then reads it, and raises what it raises)."""
    try:
        with open(file, "rb") as f:
            layout = wav.pcm_layout(f)
            if layout is None:
                return None
            block = staging_block((layout.frames, layout.channels), layout.dtype, device)
            wav.read_pcm_into(f, layout, np.asarray(block))
    except _DECODE_ERRORS:
        return None
    trace.count("direct_bytes", layout.frames * layout.channels * layout.dtype.itemsize)
    return block, layout.sample_rate


def _load(file, file_type, temp_folder, raw_int, device):
    role = file_type.upper()
    debug(f"Decoding the {role} track from '{file}'")
    folder = tempfile.gettempdir() if temp_folder is None else temp_folder
    decoded = None
    with trace.span("load"):
        if device is not None:
            decoded = _read_direct(file, device)
        if decoded is None:
            for strategy in _DECODE_CHAIN:
                decoded = strategy(file, role, folder, raw_int)
                if decoded is not None:
                    break
    if decoded is None:
        _raise_load_error(role)
    debug(f"{role} decoded: {decoded[0].shape[0]} samples at {decoded[1]} Hz")
    return decoded
