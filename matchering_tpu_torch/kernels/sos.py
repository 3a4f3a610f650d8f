"""K3: the second-order-section scan — CUDA kernel wrapper and its plain twin.

``sos_filter(x, b0, b1, b2, a1, a2)`` computes
``scipy.signal.sosfilt([[b0, b1, b2, 1, a1, a2]], x)`` with zero initial
state along the last axis of a (rows, n) or (n,) tensor.  It replaces the
2x2 ``associative_scan`` of ``matchering_tpu/ops/iir.py`` (``lfilter``,
lines 992-1049) that ``butter_lowpass`` runs for orders above 1; see
``csrc/sos_scan.cu`` for the kernel's design and its bound.  In DF2T form
the state s = (z1, z2) obeys ``s[i] = A s[i-1] + B x[i]`` with
``A = [[-a1, 1], [-a2, 0]]`` and ``B = (b1 - a1*b0, b2 - a2*b0)``, and
``y[i] = b0*x[i] + z1[i-1]``.  The state, the coefficients and every power
of A are float64 on both paths, whatever the I/O type.

Why the spans are combined with compensated products: at the release
cutoff the poles are a complex pair about 2.7e-5 inside the unit circle,
at an angle of about 2.7e-5.  Then A^L has entries up to ~1/angle (~4e4)
that cancel when applied to a state (z1 ~ -z2), and an error put into the
state grows by up to as much again before it decays.  A product ``A^L s``
rounded term by term carries an error of eps * |A^L| * |s| into the state,
which that growth then amplifies: a blocked scan combined that way is
~1.6e-8 off at 200,000 samples, where ``sosfilt``'s sequential steps are
6.5e-10 off (both against a long-double run).  So each combine
``add + A^L s`` keeps the products' and sums' rounding errors (Dekker's and
Knuth's exact transformations) and rounds once, and each A^L comes from the
host as a float64 pair hi + lo, squared out at 50 decimal digits.
"""

from __future__ import annotations

import ctypes
import decimal
import functools
from typing import Tuple

import numpy as np
import torch

from .. import trace
from . import build

LAST_GRID = 0  # blocks of the last launch, the grid passed to its launcher

# the kernel's geometry (csrc/sos_scan.cu: kRun, kThreads, kTile, kLaneStates,
# kChunk, kDepth, kWindow, kStages, kTableDoubles, kRingOffset)
RUN = 32  # consecutive samples per thread
THREADS = 128
TILE = RUN * THREADS  # samples per tile
LANE_STATES = THREADS // 32  # threads' end states per lane of warp 0
CHUNK = RUN * LANE_STATES  # samples per lane of warp 0
WARPS = THREADS // 32
DEPTH = 5  # tiles a thread reads in a look-back step
WINDOW = DEPTH * THREADS  # tiles a look-back step covers
STAGES = 2  # tile buffers in a block's ring
# powers A**e in the kernel's table, in its order: the thread spans, the
# lanes' chunks, the look-back distances (0 to THREADS - 1 tiles), a hop of
# THREADS tiles and a look-back step of WINDOW tiles
TABLE_EXPONENTS = (
    tuple(RUN * k for k in range(1, LANE_STATES))
    + tuple(CHUNK * (lane + 1) for lane in range(32))
    + tuple(TILE * d for d in range(THREADS))
    + (THREADS * TILE, WINDOW * TILE)
)
TABLE_DOUBLES = 8 * len(TABLE_EXPONENTS)
# shared memory before the ring: the tables, four states per thread and a
# state and a stop per warp, rounded up to 128 bytes
SHARED_HEAD = -(-(8 * TABLE_DOUBLES + 4 * 16 * THREADS + 20 * WARPS) // 128) * 128

_PLAIN_BLOCK = 256
_DIGITS = 50  # decimal digits of the host's matrix powers
_SPLIT = 134217729.0  # 2**27 + 1: Dekker's split of a float64 into two halves

Matrix = Tuple[Tuple[decimal.Decimal, decimal.Decimal], Tuple[decimal.Decimal, decimal.Decimal]]


def tiles_per_row(n: int, itemsize: int) -> int:
    """Tiles of a row of n samples: a row whose start is off a 16-byte
    boundary (n not a multiple of the samples in 16 bytes) is scanned from
    the boundary before it, so it may reach into one more tile."""
    per_vector = 16 // itemsize
    return -(-(n + (per_vector - 1 if n % per_vector else 0)) // TILE)


def tile_span(row: int, tile: int, n: int, itemsize: int) -> Tuple[int, int, int]:
    """Tile ``tile`` of row ``row`` as the kernel cuts it: the element
    offset of its first position (a multiple of the samples in 16 bytes,
    before the row start by the row's misalignment in its first tile) and
    its samples of the row, [first, end) counted from there."""
    origin = tile * TILE - (row * n) % (16 // itemsize)
    return row * n + origin, max(0, -origin), min(TILE, n - origin)


def scratch_words(rows: int, n: int, itemsize: int) -> int:
    """8-byte words of zeroed scratch a call over (rows, n) needs: an
    aggregate pair and an inclusive-prefix pair per (row, tile)."""
    return 4 * rows * tiles_per_row(n, itemsize)


def grid_size(rows: int, n: int, itemsize: int, resident_blocks: int, sms: int) -> int:
    """Blocks of a launch: as many as are resident at once on the card
    (``resident_blocks`` per SM, from the occupancy query; the launch is
    cooperative and needs them all resident), and no more than there are
    tiles."""
    if resident_blocks < 1:
        raise RuntimeError("the sos scan kernel cannot be resident on this card")
    return min(resident_blocks * sms, rows * tiles_per_row(n, itemsize))


def _mul(a: Matrix, b: Matrix) -> Matrix:
    return (
        (a[0][0] * b[0][0] + a[0][1] * b[1][0], a[0][0] * b[0][1] + a[0][1] * b[1][1]),
        (a[1][0] * b[0][0] + a[1][1] * b[1][0], a[1][0] * b[0][1] + a[1][1] * b[1][1]),
    )


def _power(a1: float, a2: float, exponent: int) -> Matrix:
    """A**exponent by repeated squaring in the current decimal context
    (float64 coefficients convert exactly)."""
    one, zero = decimal.Decimal(1), decimal.Decimal(0)
    base = ((-decimal.Decimal(a1), one), (-decimal.Decimal(a2), zero))
    result = ((one, zero), (zero, one))
    while exponent:
        if exponent & 1:
            result = _mul(result, base)
        base = _mul(base, base)
        exponent >>= 1
    return result


def _context() -> decimal.Context:
    """50 digits; an unstable filter's far powers become infinite instead
    of raising (a stable one's underflow to 0)."""
    context = decimal.Context(prec=_DIGITS)
    context.traps[decimal.Overflow] = False
    return context


def _hi_lo(m: Matrix) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """A matrix as two row-major float64 4-tuples, hi the rounding of m and
    lo the rounding of the rest (hi + lo is m to ~32 digits)."""
    hi = tuple(float(v) for row in m for v in row)
    lo = tuple(
        float(v - decimal.Decimal(h)) if abs(h) != float("inf") else 0.0
        for v, h in zip((v for row in m for v in row), hi)
    )
    return hi, lo


@functools.lru_cache(maxsize=64)
def section_tables(a1: float, a2: float) -> Tuple[float, ...]:
    """The kernel's table (csrc/sos_scan.cu, ``Tables``): for each
    exponent e of TABLE_EXPONENTS, A**e as its four row-major entries
    rounded to float64 (hi) and the four roundings of what hi leaves (lo),
    each power at 50 digits."""
    out = []
    with decimal.localcontext(_context()):
        for exponent in TABLE_EXPONENTS:
            hi, lo = _hi_lo(_power(a1, a2, exponent))
            out.extend(hi + lo)
    return tuple(out)


@functools.lru_cache(maxsize=64)
def device_tables(a1: float, a2: float, device: torch.device) -> torch.Tensor:
    """``section_tables`` on ``device``, staged once per section and device
    through pinned memory without a host sync."""
    host = torch.tensor(section_tables(a1, a2), dtype=torch.float64)
    return host.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=16)
def resident_blocks(device: torch.device, dtype: torch.dtype) -> int:
    """Blocks of the kernel resident per SM on ``device`` (the occupancy
    query of ``mtpu_sos_info``)."""
    out = (ctypes.c_longlong * 6)()
    with torch.cuda.device(device):
        build.check(build.library().mtpu_sos_info(int(dtype == torch.float64), out), "sos scan info")
    return int(out[3])


@functools.lru_cache(maxsize=64)
def power_table(a1: float, a2: float, step: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
    """``A**(step * (k + 1))`` for k < count as two (count, 2, 2) float64
    arrays hi and lo, multiplied out at 50 digits."""
    hi = np.empty((count, 2, 2))
    lo = np.empty((count, 2, 2))
    with decimal.localcontext(_context()):
        m = _power(a1, a2, step)
        p = m
        for k in range(count):
            h, low = _hi_lo(p)
            hi[k] = np.reshape(h, (2, 2))
            lo[k] = np.reshape(low, (2, 2))
            p = _mul(p, m)
    return hi, lo


def _split(a):
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    """p, e with p + e = a * b exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a, b):
    """s, e with s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def affine(m_hi: torch.Tensor, m_lo: torch.Tensor, v: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """``add + M v`` over the last axis of float64 (..., 2) states, with
    M = m_hi + m_lo given as broadcastable (..., 2, 2) pairs: the products
    and the sums keep their rounding errors, and each entry is rounded
    once, so the result is off by about one rounding of itself, not of
    |M| |v|.  The kernel computes the same with fma in place of Dekker's
    split."""
    out = []
    for i in range(2):
        p0, e0 = _two_prod(m_hi[..., i, 0], v[..., 0])
        p1, e1 = _two_prod(m_hi[..., i, 1], v[..., 1])
        s, e2 = _two_sum(p0, p1)
        u, e3 = _two_sum(s, add[..., i])
        rest = m_lo[..., i, 0] * v[..., 0] + m_lo[..., i, 1] * v[..., 1]
        out.append(u + (((e0 + e1) + (e2 + e3)) + rest))
    return torch.stack(out, dim=-1)


def _table(a1: float, a2: float, step: int, count: int, device):
    hi, lo = power_table(a1, a2, step, count)
    return torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device)


def _blocked_scan(drive: torch.Tensor, a1: float, a2: float, step: int = 1) -> torch.Tensor:
    """Inclusive ``s[i] = M s[i-1] + drive[i]`` (zero entry state) along
    axis 1 of a float64 (rows, n, 2) tensor, with ``M = A**step``.  Python
    loops run over the block length only: each block of 256 is scanned from
    zero, vectorised over rows x blocks; the block-end states are scanned
    the same way one level up with ``A**(256 step)``; and each block adds
    ``A**(step (k+1)) carry`` from a host table.  The steps with A itself
    are plain float64 updates, as in ``sosfilt``; every step with a power
    of A and every carry goes through :func:`affine`."""
    rows, n, _ = drive.shape
    block = _PLAIN_BLOCK
    m_hi, m_lo = _table(a1, a2, step, 1, drive.device)

    def advance(state, add):
        if step == 1:
            return torch.stack([state[..., 1] - a1 * state[..., 0], -a2 * state[..., 0]], -1) + add
        return affine(m_hi[0], m_lo[0], state, add)

    if n <= block:
        out = torch.empty_like(drive)
        state = torch.zeros((rows, 2), dtype=drive.dtype, device=drive.device)
        for k in range(n):
            state = advance(state, drive[:, k])
            out[:, k] = state
        return out
    nb = -(-n // block)
    blocks = torch.nn.functional.pad(drive, (0, 0, 0, nb * block - n)).reshape(rows, nb, block, 2)
    local = torch.empty_like(blocks)
    state = torch.zeros((rows, nb, 2), dtype=drive.dtype, device=drive.device)
    for k in range(block):
        state = advance(state, blocks[:, :, k])
        local[:, :, k] = state
    ends = _blocked_scan(local[:, :, -1], a1, a2, step * block)  # state at each block end
    carry = torch.nn.functional.pad(ends[:, :-1], (0, 0, 1, 0))  # entry state per block
    t_hi, t_lo = _table(a1, a2, step, block, drive.device)
    out = affine(t_hi, t_lo, carry[:, :, None, :], local)
    return out.reshape(rows, nb * block, 2)[:, :n]


def sos_filter_plain(
    x: torch.Tensor, b0: float, b1: float, b2: float, a1: float, a2: float
) -> torch.Tensor:
    """The twin of K3 in torch ops: the drive ``B x``, a blocked 2-state
    scan and ``y = b0 x + z1[i-1]``, in float64, cast back to the input
    dtype."""
    rows_x = x.reshape(-1, x.shape[-1]).to(torch.float64)
    drive = torch.stack([(b1 - a1 * b0) * rows_x, (b2 - a2 * b0) * rows_x], dim=-1)
    z1 = _blocked_scan(drive, a1, a2)[:, :, 0]
    y = b0 * rows_x
    y[:, 1:] += z1[:, :-1]
    return y.to(x.dtype).reshape(x.shape)


def sos_filter(
    x: torch.Tensor, b0: float, b1: float, b2: float, a1: float, a2: float
) -> torch.Tensor:
    """``sosfilt([[b0, b1, b2, 1, a1, a2]], x)`` with zero initial state
    along the last axis of a (rows, n) or (n,) tensor.  A CPU tensor runs
    the plain twin; a CUDA tensor launches K3."""
    if x.ndim not in (1, 2):
        raise ValueError(f"expected a (n,) or (rows, n) tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return sos_filter_plain(x, b0, b1, b2, a1, a2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the input must be contiguous")
    n = x.shape[-1]
    rows = 1 if x.ndim == 1 else x.shape[0]

    global LAST_GRID
    lib = build.library()
    if x.data_ptr() % 16:  # the kernel reads and writes from 16-byte boundaries
        x = x.clone()
    y = torch.empty_like(x)
    itemsize = x.element_size()
    scratch = torch.zeros(scratch_words(rows, n, itemsize), dtype=torch.int64, device=x.device)
    tables = device_tables(float(a1), float(a2), x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = grid_size(rows, n, itemsize, resident_blocks(x.device, x.dtype), sms)
    fn = lib.mtpu_sos_f32 if x.dtype == torch.float32 else lib.mtpu_sos_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(
            x.data_ptr(), y.data_ptr(), rows, n, float(b0), float(b1), float(b2), float(a1),
            float(a2), tables.data_ptr(), grid, scratch.data_ptr(), stream,
        )
    build.check(status, "sos scan kernel")
    trace.count("launch.k3")
    LAST_GRID = grid
    return y
