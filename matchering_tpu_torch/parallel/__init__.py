"""Several pairs, and one track, over several devices (PyTorch).

Counterpart of ``matchering_tpu.parallel``:

* ``mesh``      — device meshes: a ``(pairs, time)`` grid of torch devices,
                  a device allowed more than once (``make_mesh``);
* ``batch``     — pairs zero-padded to shared buckets (``bucket_pad``),
                  one batch-first graph over them (``master_batch``, its
                  rows over a mesh's ``pairs`` axis) or one graph per pair
                  (``master_pairs``);
* ``timeshard`` — one track's time axis cut over a list of devices
                  (``master_sharded``; ``master_farm`` over a ``(pairs,
                  time)`` mesh), driven from one process.

Multi-host runs (the JAX package's ``launch``) are not ported yet
(``ROADMAP.md``).
"""

from . import batch, mesh, timeshard
from .batch import bucket_pad, master_batch, master_pairs
from .mesh import make_mesh
from .timeshard import master_sharded

__all__ = [
    "batch",
    "bucket_pad",
    "make_mesh",
    "master_batch",
    "master_pairs",
    "master_sharded",
    "mesh",
    "timeshard",
]
