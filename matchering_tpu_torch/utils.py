"""Host-side scalar helpers (reference ``matchering/utils.py:28-59``) and the
port's device rules."""

from __future__ import annotations

import functools
import math
import os
import random
import string
from datetime import timedelta
from typing import NamedTuple, Tuple

import numpy as np

from . import trace


def get_temp_folder(results: list) -> str:
    """Folder of the first result file, used for codec temp conversions."""
    return os.path.dirname(os.path.abspath(results[0].file))


def random_str(size: int = 16) -> str:
    alphabet = string.ascii_lowercase + string.digits
    return "".join(random.choices(alphabet, k=size))


def random_file(prefix: str = "", extension: str = "wav") -> str:
    head = f"{prefix}-" if prefix else ""
    return f"{head}{random_str()}.{extension}"


def to_db(value: float) -> str:
    return f"{20 * math.log10(value):.4f} dB"


def ms_to_samples(value: float, sample_rate: int) -> int:
    return int(sample_rate * value * 1e-3)


def make_odd(value: int) -> int:
    return value if value & 1 else value + 1


def time_str(length: int, sample_rate: int) -> str:
    return str(timedelta(seconds=length // sample_rate))


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Never falls back to the CPU: without a card the default
    raises."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def stage_host_arrays(fn):
    """Decorate a public function whose JAX twin computes on the device:
    a host (numpy) array passed as an argument is staged where the call
    runs, as JAX puts it on its default device, and never runs silently
    on the CPU.  The call runs on the device of its tensor arguments, or,
    with none, on ``resolve_device(device)`` (the card unless a ``device``
    keyword names another; without a card that raises).  A 0-d host array
    is a host scalar, as a numpy scalar is."""

    @functools.wraps(fn)
    def staged(*args, **kwargs):
        values = args + tuple(kwargs.values())
        if not any(isinstance(v, np.ndarray) for v in values):
            return fn(*args, **kwargs)
        import torch

        tensors = [v for v in values if isinstance(v, torch.Tensor)]
        device = tensors[0].device if tensors else resolve_device(kwargs.get("device"))

        def stage(v):
            if not isinstance(v, np.ndarray):
                return v
            return v.item() if v.ndim == 0 else to_device(v, device)

        return fn(*map(stage, args), **{k: stage(v) for k, v in kwargs.items()})

    return staged


def torch_dtype(dtype):
    """A torch dtype from a torch dtype or a numpy dtype or its name
    ("float32", ``np.float64``)."""
    import torch

    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def read_back(tensor):
    """``tensor``, counted as one read of its values into host values (on
    a card, one host sync): ``host_reads`` and its bytes in ``d2h_bytes``
    (``trace``), on every device."""
    trace.count("host_reads")
    trace.count("d2h_bytes", tensor.numel() * tensor.element_size())
    return tensor


def host_int(value) -> int:
    """One per-track length or piece geometry value, in any of the JAX
    package's forms (a Python or numpy int, a 0-d array or tensor), as a
    host int.  A tensor is read back (on a card, one host sync; counted
    by ``read_back``): the kernels check lengths and size launches on the
    host."""
    import torch

    if isinstance(value, torch.Tensor):
        return int(read_back(value))
    return int(value)


class RowInts(NamedTuple):
    """One int per row of a batch, carried both ways: ``host`` as Python
    ints, for the kernels' launch checks and host geometry such as strided
    views, and ``device``, the same values as a (B,) int64 tensor for the
    graph.  Nothing reads the tensor back.  The rows' true lengths in a
    zero-padded batch travel as one."""

    host: Tuple[int, ...]
    device: "torch.Tensor"

    @classmethod
    def of(cls, values, device) -> "RowInts":
        """Stage host ints on ``device`` (one host-to-device copy)."""
        import torch

        host = tuple(int(v) for v in values)
        return cls(host, torch.tensor(host, dtype=torch.int64, device=device))

    @classmethod
    def per_row(cls, value, device) -> "RowInts":
        """The port's form of the JAX package's per-track lengths and piece
        geometry: ``RowInts`` as they are; a scalar (a Python or numpy int,
        a 0-d array or tensor) as one row, for an unbatched input that runs
        as a batch of one; a sequence or 1-d tensor as one value per row.
        A tensor's values are read back to the host once (from a card, one
        host sync; counted by ``read_back``), and the tensor itself is the
        device side where it is on ``device`` already."""
        import torch

        if isinstance(value, RowInts):
            return value
        if isinstance(value, torch.Tensor):
            rows = value.reshape(-1)
            host = tuple(int(v) for v in read_back(rows).tolist())
            return cls(host, rows.to(device=device, dtype=torch.int64))
        if np.ndim(value) == 0:
            return cls.of([int(value)], device)
        return cls.of(value, device)

    def plus(self, offset: int) -> "RowInts":
        """Every value moved by ``offset``, on both sides."""
        return RowInts(tuple(v + offset for v in self.host), self.device + offset)

    def mask(self, n: int, dtype=None):
        """(B, n) 0/1 mask of the samples below each row's length, as
        ``dtype`` (bool if None)."""
        import torch

        keep = torch.arange(n, device=self.device.device) < self.device[:, None]
        return keep if dtype is None else keep.to(dtype)


def staging_block(shape, dtype, device):
    """A writable host block of ``shape`` and numpy ``dtype`` for data bound
    for ``device``, which ``to_device`` stages without a refill: for a
    card, a page-locked tensor from the caching host allocator (its blocks
    are reused from call to call, and a block goes back out only once the
    copies that read it have run); for the CPU, a numpy array, which
    ``to_device`` wraps as it is."""
    import torch

    if torch.device(device).type == "cpu":
        return np.empty(shape, dtype)
    return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype, pin_memory=True)


def to_device(array, device):
    """Host array or tensor -> tensor on ``device``.  Integer PCM keeps its
    integer dtype, so raw int16 crosses to the card at half the bytes of
    float32.  A host array bound for a card is copied once into
    page-locked memory (the caching host allocator's, reused from call to
    call) and crosses from there without blocking the host: a copy from
    pageable memory runs at a fraction of the link's rate.  One bound for
    the CPU is wrapped, after a copy only where its buffer is read-only (a
    decoded file), since a tensor may not share read-only memory.  A host
    tensor bound for a card crosses as it is, without blocking the host
    where it is page-locked (``staging_block``).  The staging of a host
    array, on every device, and of a host tensor bound for a card, is the
    span ``stage``, and its bytes count in ``h2d_bytes`` (``trace``)."""
    import torch

    device = torch.device(device)
    if isinstance(array, torch.Tensor):
        if array.device.type != "cpu" or device.type == "cpu":
            return array.to(device)
        with trace.span("stage"):
            trace.count("h2d_bytes", array.numel() * array.element_size())
            return array.to(device, non_blocking=array.is_pinned())
    with trace.span("stage"):
        trace.count("h2d_bytes", array.nbytes)
        if device.type == "cpu":
            return torch.from_numpy(np.require(array, requirements=["C", "W"]))
        staged = staging_block(array.shape, array.dtype, device)
        staged.numpy()[...] = array
        return staged.to(device, non_blocking=True)


def to_host(tensor):
    """A tensor's values as a host numpy array, at its dtype
    (``host_copy``).  The span ``fetch``."""
    with trace.span("fetch"):
        return host_copy(tensor)


def host_copy(tensor):
    """A tensor's values as a C-contiguous host numpy array, at its dtype.
    From a card they are copied once, into page-locked memory (the caching
    host allocator's, reused from call to call): a copy into fresh
    pageable memory runs at a fraction of the link's rate.  A CPU tensor's
    own memory where it is C-contiguous.  One ``read_back``."""
    import torch

    read_back(tensor)
    if tensor.device.type == "cpu":
        return tensor.contiguous().numpy()
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    return host.numpy()
