"""K2: the first-order IIR scan — CUDA kernel wrapper and its plain twin.

``first_order_filter(x, b0, b1, a1, zi, reverse, lengths)`` computes
``scipy.signal.lfilter([b0, b1], [1, a1], x, zi=[zi])`` along the last axis
of a (rows, n) or (n,) tensor, from the end of each row when ``reverse``,
and with ``lengths`` over each row's first L samples only (0 past them).
It replaces the XLA scans of ``matchering_tpu/ops/iir.py`` (lines 105-822);
see ``csrc/scan.cu`` for the kernel's design and its bound.  The state, the
pole and the coefficients are float64 on both paths, whatever the I/O type.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import trace
from ..utils import RowInts
from . import build

LAST_GRID = 0  # blocks of the last launch, as the kernel's launcher reports them

# the kernel's tiling (csrc/scan.cu: kRun, kTileLog, kTile, kPowers)
RUN = 16  # consecutive scan positions per thread
TILE_LOG = 8  # 2**TILE_LOG threads per block
TILE = RUN << TILE_LOG  # scan positions per block
# pole**(RUN * 2**k) for k < POWERS: the thread shuffles (k < 5), the warps
# (5 <= k < TILE_LOG), the tiles of look-back (TILE_LOG <= k < TILE_LOG + 5)
# and a look-back step of 32 tiles (the last)
POWERS = TILE_LOG + 6

_PLAIN_BLOCK = 256


def scratch_words(rows: int, n: int) -> int:
    """8-byte words of zeroed scratch a call over (rows, n) needs: an
    aggregate and an inclusive prefix per (row, tile of TILE samples), and
    a tile counter."""
    return 2 * rows * -(-n // TILE) + 1


@functools.lru_cache(maxsize=64)
def pole_powers(pole: float) -> Tuple[float, ...]:
    """``pole**(RUN * 2**k)`` for k < POWERS, in float64, each one ``pow``
    (repeated squaring would compound its rounding 2**k times)."""
    return tuple(pole ** (RUN << k) for k in range(POWERS))


@functools.lru_cache(maxsize=64)
def _powers_array(pole: float):
    """``pole_powers(pole)`` as the C array the kernel's entry point copies
    from (read on the host before the launch returns, so one can be shared)."""
    return (ctypes.c_double * POWERS)(*pole_powers(pole))


def _blocked_scan(drive: torch.Tensor, pole: float) -> torch.Tensor:
    """Inclusive ``y[i] = drive[i] + pole * y[i-1]`` (zero entry state)
    along the last axis of a float64 (rows, n) tensor.  Python loops run
    over the block length only: each block is scanned from zero, the block
    end states are scanned the same way one level up with pole
    ``pole**block``, and each block adds ``pole**(k+1)`` times its carry."""
    rows, n = drive.shape
    block = _PLAIN_BLOCK
    if n <= block:
        out = torch.empty_like(drive)
        state = torch.zeros(rows, dtype=drive.dtype, device=drive.device)
        for k in range(n):
            state = drive[:, k] + pole * state
            out[:, k] = state
        return out
    nb = -(-n // block)
    blocks = torch.nn.functional.pad(drive, (0, nb * block - n)).reshape(rows, nb, block)
    local = torch.empty_like(blocks)
    state = torch.zeros(rows, nb, dtype=drive.dtype, device=drive.device)
    for k in range(block):
        state = blocks[:, :, k] + pole * state
        local[:, :, k] = state
    ends = _blocked_scan(local[:, :, -1], pole**block)  # state at each block end
    carry = torch.nn.functional.pad(ends[:, :-1], (1, 0))  # entry state per block
    powers = pole ** torch.arange(1, block + 1, dtype=drive.dtype, device=drive.device)
    out = local + carry[:, :, None] * powers
    return out.reshape(rows, nb * block)[:, :n]


def first_order_filter_plain(
    x: torch.Tensor,
    b0: float,
    b1: float,
    a1: float,
    zi=None,
    reverse: bool = False,
    lengths: Optional[RowInts] = None,
) -> torch.Tensor:
    """The twin of K2 in torch ops: the DF2T drive and a blocked scan, in
    float64, cast back to the input dtype.  With ``lengths`` the samples
    at and past each row's length are zeroed first, and in reverse each
    row's state enters at its last sample, so the scan over the zeros
    beyond carries nothing into the row."""
    rows_x = x.reshape(-1, x.shape[-1]).to(torch.float64)
    keep = None if lengths is None else lengths.mask(rows_x.shape[1])
    if keep is not None:
        rows_x = rows_x * keep
    if reverse:
        rows_x = torch.flip(rows_x, (1,))
    drive = b0 * rows_x
    drive[:, 1:] += b1 * rows_x[:, :-1]
    if zi is not None:
        states = torch.as_tensor(zi, dtype=torch.float64, device=x.device).reshape(-1)
        if reverse and lengths is not None:
            # the first scanned sample is the row's last, at n - L once flipped
            n = drive.shape[1]
            first = torch.arange(n, device=x.device) == (n - lengths.device)[:, None]
            drive = drive + torch.where(first, states[:, None], 0.0)
        else:
            drive[:, 0] += states
    y = _blocked_scan(drive, -a1)
    if reverse:
        y = torch.flip(y, (1,))
    if keep is not None:
        y = y * keep
    return y.to(x.dtype).reshape(x.shape)


def first_order_filter(
    x: torch.Tensor,
    b0: float,
    b1: float,
    a1: float,
    zi=None,
    reverse: bool = False,
    lengths: Optional[RowInts] = None,
) -> torch.Tensor:
    """``lfilter([b0, b1], [1, a1], x, zi=[zi])`` along the last axis.

    ``zi``: None, or a tensor with one initial state per row (any float
    dtype; the kernel reads it as float64).  ``lengths``: None, or each
    row's length L (1 <= L <= n): the row is filtered over [0, L) only,
    ``reverse`` starts at L - 1, ``zi`` enters at the first scanned sample,
    and the output is 0 at and past L.  A CPU tensor runs the plain twin;
    a CUDA tensor launches K2."""
    if x.ndim not in (1, 2):
        raise ValueError(f"expected a (n,) or (rows, n) tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return first_order_filter_plain(x, b0, b1, a1, zi, reverse, lengths)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the input must be contiguous")
    n = x.shape[-1]
    rows = 1 if x.ndim == 1 else x.shape[0]
    lengths_ptr = build.lengths_pointer(lengths, rows, n, 1, x.device)
    zi_ptr = None
    if zi is not None:
        zi = torch.as_tensor(zi, device=x.device).to(torch.float64).reshape(-1).contiguous()
        if zi.shape[0] != rows:
            raise ValueError(f"zi holds {zi.shape[0]} states for {rows} rows")
        zi_ptr = zi.data_ptr()

    global LAST_GRID
    lib = build.library()
    y = torch.empty_like(x)
    scratch = torch.zeros(scratch_words(rows, n), dtype=torch.int64, device=x.device)
    powers = _powers_array(-float(a1))
    launched = (ctypes.c_longlong * 1)()
    fn = lib.mtpu_scan_f32 if x.dtype == torch.float32 else lib.mtpu_scan_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(
            x.data_ptr(), y.data_ptr(), zi_ptr, lengths_ptr, rows, n, float(b0), float(b1),
            float(a1), int(reverse), ctypes.addressof(powers), scratch.data_ptr(), launched, stream,
        )
    build.check(status, "scan kernel")
    trace.count("launch.k2")
    LAST_GRID = launched[0]
    return y
