"""Batches of (target, reference) pairs (PyTorch).

Counterpart of ``matchering_tpu.parallel``'s pair batching: ``batch`` holds
``bucket_pad``, ``master_batch`` (one batch-first graph over B rows) and
``master_pairs`` (one graph per pair).  Device meshes and time sharding
(``mesh``, ``timeshard``, ``launch``) are not ported yet (``ROADMAP.md``
queue 3).
"""

from . import batch
from .batch import bucket_pad, master_batch, master_pairs

__all__ = ["batch", "bucket_pad", "master_batch", "master_pairs"]
