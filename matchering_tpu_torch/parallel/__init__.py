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
                  time)`` mesh), driven from one process;
* ``launch``    — several processes or hosts on ``torch.distributed``:
                  each masters the pairs it owns (``global_mesh``,
                  ``master_batch_distributed``, ``master_farm_distributed``).
"""

from . import batch, launch, mesh, timeshard
from .batch import bucket_pad, master_batch, master_pairs
from .launch import global_mesh, initialize, master_batch_distributed
from .mesh import make_mesh
from .timeshard import master_sharded

__all__ = [
    "batch",
    "bucket_pad",
    "global_mesh",
    "initialize",
    "launch",
    "make_mesh",
    "master_batch",
    "master_batch_distributed",
    "master_pairs",
    "master_sharded",
    "mesh",
    "timeshard",
]
