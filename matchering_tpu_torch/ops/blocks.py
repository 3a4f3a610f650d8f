"""Overlapping windows of a signal (PyTorch).

Counterpart of ``matchering_tpu.ops.blocks`` (reference ``as_strided``
windows, ``matchering/dsp.py:128-139``).  The JAX package assembles the
windows from shifted reshapes because its TPU compiler is slow on gathers;
here they are a strided view, ``Tensor.unfold``.
"""

from __future__ import annotations

import torch

from ..utils import stage_host_arrays


@stage_host_arrays
def overlapping_blocks(x: torch.Tensor, nblocks: int, hop: int, width: int) -> torch.Tensor:
    """(n,) or (n, c) -> (nblocks, width[, c]) with
    ``W[b] = x[b*hop : b*hop + width]``, a view of ``x``.

    ``x`` must hold at least ``(nblocks - 1 + ceil(width / hop)) * hop``
    samples, as in the JAX package: callers pad."""
    need = (nblocks - 1 + -(-width // hop)) * hop
    if x.shape[0] < need:
        raise ValueError(
            f"overlapping_blocks needs {need} samples, got {x.shape[0]} "
            f"(nblocks={nblocks}, hop={hop}, width={width})"
        )
    windows = x.unfold(0, width, hop)[:nblocks]  # (nblocks[, c], width)
    return windows if x.ndim == 1 else windows.movedim(-1, 1)
