"""K1: the limiter front end — CUDA kernel wrapper and its plain twin.

Replaces the Pallas TPU kernel ``matchering_tpu/ops/pallas_envelope.py``
(``limiter_front_end``): stereo -> (hard-clip gain, attack-slided gain),
for one (n, 2) track or for each row of a (B, n, 2) batch, optionally with
each row's true length (``matchering_tpu/limiter.py:124-130`` and
``ops/sliding.py:73-95``, which the JAX package runs as XLA ops).  See
``csrc/envelope.cu`` for the design and its bound.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import trace
from ..ops import basics, sliding
from ..utils import RowInts, make_odd, stage_host_arrays
from . import build

LAST_GRID = 0  # blocks of the last launch, as the kernel's launcher reports them

# the kernel's tiling (csrc/envelope.cu: kRun, kTile, kMaxHalo)
RUN = 32  # outputs per thread
TILE = RUN * 256  # outputs per block of 256 threads
MAX_HALO = 2048  # window - 1 may not exceed this


def window_for(attack: int) -> int:
    """Centred attack window, ``2*make_odd(attack) - 1`` samples."""
    return 2 * make_odd(attack) - 1


def check_window(n: int, window: int) -> None:
    """Raise ValueError where the window does not fit the kernel's halo or
    the track is shorter than the window."""
    if window < 1 or window - 1 > MAX_HALO:
        raise ValueError(f"attack window {window} does not fit the kernel's halo of {MAX_HALO}")
    if n < window:
        raise ValueError(f"track of {n} samples is shorter than the attack window {window}")


def limiter_front_end_plain(
    array: torch.Tensor, threshold: float, attack: int, lengths: Optional[RowInts] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused composition the kernel fuses: ``flip(1/rectify(x))``
    then ``sliding_max_attack``.  With ``lengths`` (a (B, n, 2) batch) the
    rectified envelope is 1 at and past each row's length, so the gain is
    0 there, and the sliding max reflects at the length and is 0 past it."""
    rectified = basics.rectify(array, threshold)
    if lengths is None:
        gain = basics.flip(1.0 / rectified)
        return gain, sliding.sliding_max_attack(gain, attack)
    keep = lengths.mask(array.shape[-2])
    gain = basics.flip(1.0 / torch.where(keep, rectified, torch.ones_like(rectified)))
    return gain, sliding.sliding_max_attack_truncated(gain, attack, lengths)


@stage_host_arrays
def limiter_front_end(
    array: torch.Tensor, threshold: float, attack: int, lengths: Optional[RowInts] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, 2) or (B, n, 2) stereo -> (hard-clip gain, attack-slided gain),
    each (n,) or (B, n).  ``lengths`` (``RowInts``, for a batch): each
    row's true length, in [attack window, n], else ValueError, on every
    device; both outputs are 0 at and past it.  A CPU tensor runs the
    plain twin; a CUDA tensor launches K1."""
    if array.ndim not in (2, 3) or array.shape[-1] != 2:
        raise ValueError(f"expected an (n, 2) or (B, n, 2) stereo tensor, got {tuple(array.shape)}")
    if lengths is not None:
        if array.ndim != 3:
            raise ValueError("lengths need a (B, n, 2) batch")
        build.check_lengths(lengths, array.shape[0], array.shape[1], window_for(attack))
    if array.device.type == "cpu":
        return limiter_front_end_plain(array, threshold, attack, lengths)
    if array.device.type != "cuda":
        raise ValueError(f"unsupported device {array.device}")
    if array.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64, got {array.dtype}")
    if not array.is_contiguous():
        raise ValueError("the stereo tensor must be contiguous")
    n = array.shape[-2]
    rows = 1 if array.ndim == 2 else array.shape[0]
    window = window_for(attack)
    check_window(n, window)
    lengths_ptr = build.lengths_pointer(lengths, rows, n, window, array.device)
    lib = build.library()

    global LAST_GRID
    gain = torch.empty(array.shape[:-1], dtype=array.dtype, device=array.device)
    slided = torch.empty_like(gain)
    launched = (ctypes.c_longlong * 1)()
    fn = lib.mtpu_envelope_f32 if array.dtype == torch.float32 else lib.mtpu_envelope_f64
    with torch.cuda.device(array.device):
        stream = torch.cuda.current_stream(array.device).cuda_stream
        status = fn(
            array.data_ptr(), gain.data_ptr(), slided.data_ptr(), lengths_ptr, rows, n,
            float(threshold), window, launched, stream,
        )
    build.check(status, "envelope kernel")
    trace.count("launch.k1")
    LAST_GRID = launched[0]
    return gain, slided
