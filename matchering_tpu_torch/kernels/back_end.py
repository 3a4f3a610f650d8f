"""K4: the limiter back end — CUDA kernel wrapper and its plain twin.

Mixes the limiter's four gain envelopes, masks each row past its true
length, and scales the stereo track, optionally by one factor a row:
``limiter.limit``'s last step, and with the graph's final amplitude
coefficient ``stages.master_graph``'s.  Replaces no Pallas kernel: the JAX
package writes this chain as XLA ops (``matchering_tpu/limiter.py:138``).
See ``csrc/back_end.cu`` for the design and its bound.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import trace
from ..ops import basics
from ..utils import RowInts, stage_host_arrays
from . import build

LAST_GRID = 0  # blocks of the last launch, as the kernel's launcher reports them


def limiter_back_end_plain(
    array: torch.Tensor,
    hard_clip: torch.Tensor,
    attack: torch.Tensor,
    hold: torch.Tensor,
    release: torch.Tensor,
    not_needed: torch.Tensor,
    lengths: Optional[RowInts] = None,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The unfused composition the kernel fuses: the gain
    ``1 - max(hard_clip, attack, max(hold, release))``, times 0 at and past
    each row's length, applied to both channels of the rows that are not
    ``not_needed`` (those pass as they are), then each row times its
    ``scale``."""
    gain = basics.flip(basics.max_mix(hard_clip, attack, torch.maximum(hold, release)))
    if lengths is not None:
        gain = gain * lengths.mask(array.shape[-2], gain.dtype)
    limited = torch.where(not_needed[..., None, None], array, array * gain[..., None])
    if scale is not None:
        limited = limited * basics.per_row(scale, limited)
    return limited


@stage_host_arrays
def limiter_back_end(
    array: torch.Tensor,
    hard_clip: torch.Tensor,
    attack: torch.Tensor,
    hold: torch.Tensor,
    release: torch.Tensor,
    not_needed: torch.Tensor,
    lengths: Optional[RowInts] = None,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(n, 2) or (B, n, 2) stereo and four (n,) or (B, n) gains -> the
    limited stereo, a new tensor.  ``not_needed``: one bool a row (0-d for
    an (n, 2) track), true where the row passes unlimited.  ``lengths``
    (``RowInts``, for a batch): each row's true length, in [0, n], else
    ValueError; the gain is 0 at and past it.  ``scale``: None, or one
    factor a row, in the array's dtype on a card.  A CPU tensor runs the
    plain twin; a CUDA tensor launches K4: the stereo must be contiguous,
    and a gain whose samples are is read where it lies, whatever its row
    stride (the scans hand over such views), any other copied first."""
    if array.ndim not in (2, 3) or array.shape[-1] != 2:
        raise ValueError(f"expected an (n, 2) or (B, n, 2) stereo tensor, got {tuple(array.shape)}")
    gains = (hard_clip, attack, hold, release)
    for gain in gains:
        if tuple(gain.shape) != tuple(array.shape[:-1]):
            raise ValueError(f"a gain of shape {tuple(gain.shape)} for stereo {tuple(array.shape)}")
    rows = 1 if array.ndim == 2 else array.shape[0]
    n = array.shape[-2]
    if lengths is not None:
        if array.ndim != 3:
            raise ValueError("lengths need a (B, n, 2) batch")
        build.check_lengths(lengths, rows, n, 0)
    if array.device.type == "cpu":
        return limiter_back_end_plain(array, hard_clip, attack, hold, release, not_needed, lengths, scale)
    if array.device.type != "cuda":
        raise ValueError(f"unsupported device {array.device}")
    if array.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64, got {array.dtype}")
    if not array.is_contiguous():
        raise ValueError("the stereo tensor must be contiguous")
    if any(gain.dtype != array.dtype or gain.device != array.device for gain in gains):
        raise TypeError("the gains must have the stereo tensor's dtype and device")
    # the kernel reads each gain's rows where they lie, one row stride each
    gains = tuple(gain if gain.stride(-1) == 1 else gain.contiguous() for gain in gains)
    strides = tuple(gain.stride(0) if gain.ndim == 2 else n for gain in gains)
    if (not_needed.dtype, not_needed.numel(), not_needed.device) != (torch.bool, rows, array.device):
        raise ValueError(f"not_needed must hold one bool a row ({rows}) on {array.device}")
    not_needed = not_needed.reshape(rows).contiguous()
    scale_ptr = None
    if scale is not None:
        if (scale.dtype, scale.numel(), scale.device) != (array.dtype, rows, array.device):
            raise ValueError(f"scale must hold one {array.dtype} a row ({rows}) on {array.device}")
        scale = scale.reshape(rows).contiguous()
        scale_ptr = scale.data_ptr()
    lengths_ptr = build.lengths_pointer(lengths, rows, n, 0, array.device)
    lib = build.library()

    global LAST_GRID
    out = torch.empty_like(array)
    launched = (ctypes.c_longlong * 1)()
    fn = lib.mtpu_back_end_f32 if array.dtype == torch.float32 else lib.mtpu_back_end_f64
    with torch.cuda.device(array.device):
        stream = torch.cuda.current_stream(array.device).cuda_stream
        status = fn(
            array.data_ptr(), *(gain.data_ptr() for gain in gains), *strides,
            not_needed.data_ptr(), lengths_ptr, scale_ptr, out.data_ptr(), rows, n, launched, stream,
        )
    build.check(status, "back-end kernel")
    trace.count("launch.k4")
    LAST_GRID = launched[0]
    return out
