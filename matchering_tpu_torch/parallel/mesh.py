"""Device meshes for the mastering farm (PyTorch).

Counterpart of ``matchering_tpu/parallel/mesh.py``.  A mesh is a grid of
torch devices with named axes, ``(pairs, time)`` as a rule:

* ``pairs`` — independent (target, reference) pairs, no traffic between
  them;
* ``time``  — the time blocks of one track (``parallel.timeshard``): halo
  copies between neighbours and a few small reductions.

Unlike a JAX mesh, a device may appear more than once: ``["cuda:0"] * 2``
puts two time shards on one card, and ``["cpu"] * 8`` runs eight shards in
one process on the CPU.  Without ``devices`` a mesh takes every visible
CUDA device, and never the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import resolve_device


class Mesh:
    """A grid of torch devices with named axes, as far as callers use
    ``jax.sharding.Mesh``: ``devices`` (a numpy object array of
    ``torch.device``), ``axis_names`` and ``shape`` (axis name -> size)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        for index, device in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[index] = resolve_device(device)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs {grid.ndim} axis names")
        self.devices = grid
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def along(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at the first position of every other
        axis (a JAX mesh replicates over those)."""
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has no '{axis}' axis: {self.axis_names}")
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    def rows(self, outer: str, inner: str) -> List[List[torch.device]]:
        """The devices as ``shape[outer]`` rows of ``shape[inner]``: row i
        holds the devices at position i of ``outer``, in ``inner``'s order
        (axes the mesh lacks count as size 1; any other axis must be 1)."""
        grid, names = self.devices, list(self.axis_names)
        for name in (outer, inner):
            if name not in names:
                grid, names = grid[..., None], names + [name]
        grid = np.moveaxis(grid, [names.index(outer), names.index(inner)], [-2, -1])
        if grid.size != grid.shape[-2] * grid.shape[-1]:
            raise ValueError(f"mesh axes {self.axis_names} hold more than {outer} and {inner}")
        grid = grid.reshape(grid.shape[-2], grid.shape[-1])
        return [list(row) for row in grid]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    """The named devices, or every visible CUDA device (raising without a
    card: no CPU fallback)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def make_mesh(pairs: int = 1, time: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ``(pairs, time)`` mesh of the first ``pairs * time`` of
    ``devices`` (default: every visible CUDA device), in order, so that
    the ``time`` axis runs over neighbouring devices."""
    devices = _devices(devices)
    needed = pairs * time
    if len(devices) < needed:
        raise ValueError(
            f"mesh ({pairs} pairs x {time} time) needs {needed} devices, have {len(devices)}"
        )
    grid = np.empty(needed, dtype=object)
    grid[:] = devices[:needed]
    return Mesh(grid.reshape(pairs, time), axis_names=("pairs", "time"))


def single_axis_mesh(axis: str, size: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh named ``axis`` over ``devices`` (default: every visible
    CUDA device), or over the first ``size`` of them."""
    devices = _devices(devices)
    if size is not None:
        devices = devices[:size]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid, axis_names=(axis,))


def require_pairs_axis(mesh: Mesh) -> None:
    """Raise ValueError for a mesh with no ``pairs`` axis (the batch is
    sharded over it; ``matchering_tpu/farm.py:74-79``)."""
    if "pairs" not in mesh.shape:
        raise ValueError(
            "process_batch shards jobs over a 'pairs' mesh axis, but the "
            f"provided mesh has axes {tuple(mesh.axis_names)} — build it "
            "with parallel.make_mesh (pairs[, time])"
        )
