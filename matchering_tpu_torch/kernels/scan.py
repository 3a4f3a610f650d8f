"""K2: the first-order IIR scan — CUDA kernel wrapper and its plain twin.

``first_order_filter(x, b0, b1, a1, zi, reverse)`` computes
``scipy.signal.lfilter([b0, b1], [1, a1], x, zi=[zi])`` along the last axis
of a (rows, n) or (n,) tensor, from the end of each row when ``reverse``.
It replaces the XLA scans of ``matchering_tpu/ops/iir.py`` (lines 105-822);
see ``csrc/scan.cu`` for the kernel's design and its bound.  The state, the
pole and the coefficients are float64 on both paths, whatever the I/O type.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = 0  # calls that launched the CUDA kernel

_PLAIN_BLOCK = 256


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
    x: torch.Tensor, b0: float, b1: float, a1: float, zi=None, reverse: bool = False
) -> torch.Tensor:
    """The twin of K2 in torch ops: the DF2T drive and a blocked scan, in
    float64, cast back to the input dtype."""
    rows_x = x.reshape(-1, x.shape[-1]).to(torch.float64)
    if reverse:
        rows_x = torch.flip(rows_x, (1,))
    drive = b0 * rows_x
    drive[:, 1:] += b1 * rows_x[:, :-1]
    if zi is not None:
        drive[:, 0] += torch.as_tensor(zi, dtype=torch.float64, device=x.device).reshape(-1)
    y = _blocked_scan(drive, -a1)
    if reverse:
        y = torch.flip(y, (1,))
    return y.to(x.dtype).reshape(x.shape)


def first_order_filter(
    x: torch.Tensor, b0: float, b1: float, a1: float, zi=None, reverse: bool = False
) -> torch.Tensor:
    """``lfilter([b0, b1], [1, a1], x, zi=[zi])`` along the last axis.

    ``zi``: None, or a tensor with one initial state per row (any float
    dtype; the kernel reads it as float64).  A CPU tensor runs the plain
    twin; a CUDA tensor launches K2."""
    if x.ndim not in (1, 2):
        raise ValueError(f"expected a (n,) or (rows, n) tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return first_order_filter_plain(x, b0, b1, a1, zi, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the input must be contiguous")
    n = x.shape[-1]
    rows = 1 if x.ndim == 1 else x.shape[0]
    zi_ptr = None
    if zi is not None:
        zi = torch.as_tensor(zi, device=x.device).to(torch.float64).reshape(-1).contiguous()
        if zi.shape[0] != rows:
            raise ValueError(f"zi holds {zi.shape[0]} states for {rows} rows")
        zi_ptr = zi.data_ptr()

    global LAUNCHES
    lib = build.library()
    y = torch.empty_like(x)
    scratch = torch.empty(
        max(lib.mtpu_scan_scratch(rows, n), 1), dtype=torch.float64, device=x.device
    )
    fn = lib.mtpu_scan_f32 if x.dtype == torch.float32 else lib.mtpu_scan_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(
            x.data_ptr(), y.data_ptr(), zi_ptr, rows, n,
            float(b0), float(b1), float(a1), int(reverse), scratch.data_ptr(), stream,
        )
    build.check(status, "scan kernel")
    LAUNCHES += 1
    return y
