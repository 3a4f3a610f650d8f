"""Audio export (reference ``matchering/saver.py:27-33``).

Float32 or float64 samples bound for a WAV file of one of the subtypes in
``DIRECT_SUBTYPES`` are quantised in their own dtype (``codes``): a
tensor on its own device, its codes crossing to the host once, into
page-locked memory (``utils.host_copy``); a numpy array on the CPU, in
its own memory.  The file is written from the codes' block
(``wav.write_payload``).  Every other result goes through
``codecs.write``, the container chosen by the file's extension, a tensor
after one copy to the host at its dtype.  Either way the bytes are those
of the same samples widened to float64 and quantised by the numpy codec
(``io/pcm.py``): scaling by a power of two is exact in float32 and
float64, and ``torch.round`` rounds half to even, as ``np.rint`` does.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import trace
from ..log import debug
from ..utils import host_copy, to_host
from . import codecs, pcm, wav

DIRECT_SUBTYPES = ("PCM_16", "PCM_24", "PCM_32", "FLOAT")
_CODE_DTYPES = {"PCM_16": torch.int16, "PCM_24": torch.int32, "PCM_32": torch.int32}


def writes_codes(file: str, result, subtype: str) -> bool:
    """True where ``save`` quantises ``result`` (``write_codes``): float32
    or float64 samples, a tensor or a numpy array of one or two
    dimensions, bound for a ``.wav`` file of a subtype in
    ``DIRECT_SUBTYPES``, on a little-endian host."""
    floats = (torch.float32, torch.float64) if isinstance(result, torch.Tensor) else (np.float32, np.float64)
    return (
        isinstance(result, (torch.Tensor, np.ndarray))
        and result.dtype in floats
        and result.ndim in (1, 2)
        and subtype in DIRECT_SUBTYPES
        and os.path.splitext(file)[1].upper() == ".WAV"
        and sys.byteorder == "little"
    )


def codes(samples: torch.Tensor, subtype: str) -> torch.Tensor:
    """The WAV payload of float ``samples`` as ``subtype`` codes it,
    computed on their device in their dtype, C-contiguous: int16 for
    PCM_16, three little-endian bytes a sample (uint8) for PCM_24, int32
    for PCM_32, float32 for FLOAT.  An integer code is the sample times
    2^(bits - 1), rounded half to even and clipped to the code's range;
    the temporaries are one buffer of the samples' dtype besides the
    codes (PCM_32's is int64 once it is rounded)."""
    if subtype == "FLOAT":
        return samples.to(torch.float32).contiguous()
    full = 1 << (8 * pcm.SUBTYPES[subtype] - 1)
    scaled = (samples * full).round_()
    if subtype == "PCM_32":  # the float32 image of 2^31 - 1 is 2^31: clip as int64
        scaled = scaled.clamp_(-full, full).to(torch.int64)
    out = scaled.clamp_(-full, full - 1).to(_CODE_DTYPES[subtype])
    del scaled
    if subtype == "PCM_24":  # the low three of each code's four little-endian bytes
        out = out.reshape(-1, 1).view(torch.uint8)[:, :3]
    return out.contiguous()


def write_codes(file: str, result, sample_rate: int, subtype: str) -> None:
    """Write float32 or float64 ``result``, a tensor or a numpy array of
    (n, channels) or (n,) samples, as a WAV file of ``subtype``, one of
    ``DIRECT_SUBTYPES``, from its codes.  The span ``fetch`` holds the
    quantise, and for a tensor the codes' copy to the host and its wait;
    ``encode`` holds the file's one write, whose payload bytes count in
    ``direct_out_bytes`` (``trace``)."""
    frames, channels = result.shape[0], (result.shape[1] if result.ndim == 2 else 1)
    with trace.span("fetch"):
        if isinstance(result, torch.Tensor):
            block = host_copy(codes(result, subtype))
        else:  # on the CPU over the array's own memory: nothing is read back
            block = codes(torch.from_numpy(np.require(result, requirements="CW")), subtype).numpy()
    with trace.span("encode"):
        trace.count("direct_out_bytes", wav.write_payload(file, block, frames, channels, sample_rate, subtype))


def save(
    file: str,
    result,
    sample_rate: int,
    subtype: str,
    name: str = "result",
) -> None:
    """Write ``result``, (n, channels) or (n,) float32 or float64 samples
    as a numpy array or a tensor, to ``file``: from its codes
    (``write_codes``) where ``writes_codes`` holds.  Otherwise a tensor
    crosses at its dtype (``to_host``, the span ``fetch``), and
    ``encode`` holds ``codecs.write``."""
    name = name.upper()
    debug(f"Saving the {name} {sample_rate} Hz Stereo {subtype} to: '{file}'...")
    if writes_codes(file, result, subtype):
        write_codes(file, result, sample_rate, subtype)
    else:
        if isinstance(result, torch.Tensor):
            result = to_host(result)
        with trace.span("encode"):
            codecs.write(file, np.asarray(result), sample_rate, subtype)
    debug(f"'{file}' is saved")
