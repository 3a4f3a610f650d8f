"""K1: the limiter front end — CUDA kernel wrapper and its plain twin.

Replaces the Pallas TPU kernel ``matchering_tpu/ops/pallas_envelope.py``
(``limiter_front_end``): (n, 2) stereo -> (hard-clip gain, attack-slided
gain), each (n,).  See ``csrc/envelope.cu`` for the design and its bound.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import basics, sliding
from ..utils import make_odd
from . import build

LAUNCHES = 0  # calls that launched the CUDA kernel

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
    array: torch.Tensor, threshold: float, attack: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused composition the kernel fuses:
    ``flip(1/rectify(x))`` then ``sliding_max_attack``."""
    gain = basics.flip(1.0 / basics.rectify(array, threshold))
    return gain, sliding.sliding_max_attack(gain, attack)


def limiter_front_end(
    array: torch.Tensor, threshold: float, attack: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, 2) stereo -> (hard-clip gain, attack-slided gain).  A CPU tensor
    runs the plain twin; a CUDA tensor launches K1."""
    if array.ndim != 2 or array.shape[1] != 2:
        raise ValueError(f"expected an (n, 2) stereo tensor, got {tuple(array.shape)}")
    if array.device.type == "cpu":
        return limiter_front_end_plain(array, threshold, attack)
    if array.device.type != "cuda":
        raise ValueError(f"unsupported device {array.device}")
    if array.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64, got {array.dtype}")
    if not array.is_contiguous():
        raise ValueError("the stereo tensor must be contiguous")
    n = array.shape[0]
    window = window_for(attack)
    check_window(n, window)
    lib = build.library()

    global LAUNCHES
    gain = torch.empty(n, dtype=array.dtype, device=array.device)
    slided = torch.empty_like(gain)
    fn = lib.mtpu_envelope_f32 if array.dtype == torch.float32 else lib.mtpu_envelope_f64
    with torch.cuda.device(array.device):
        stream = torch.cuda.current_stream(array.device).cuda_stream
        status = fn(
            array.data_ptr(), gain.data_ptr(), slided.data_ptr(), n,
            float(threshold), window, stream,
        )
    build.check(status, "envelope kernel")
    LAUNCHES += 1
    return gain, slided
