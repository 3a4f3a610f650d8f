"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``matchering_tpu_torch/csrc`` is compiled by
``nvcc`` for ``sm_90a`` (one process per source, all started together),
linked into one shared library with a plain C interface, and loaded with
``ctypes``.  The build runs at the first launch, into
``matchering_tpu_torch/_build/``, keyed by a hash of the sources and the
shared ``*.cuh`` headers, so a changed source rebuilds and an unchanged one
loads the existing library.  On loading, the kernels' tiling constants are
checked once against the wrappers' Python copies.  Importing this module
needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(_PACKAGE, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_D = ctypes.c_double
_I = ctypes.c_int

# C signatures: name -> (restype, argtypes)
_SIGNATURES = {
    "mtpu_envelope_max_halo": (_I, []),
    "mtpu_envelope_tile": (_I, []),
    "mtpu_envelope_f32": (_I, [_P, _P, _P, _P, _LL, _LL, _D, _I, _P, _P]),
    "mtpu_envelope_f64": (_I, [_P, _P, _P, _P, _LL, _LL, _D, _I, _P, _P]),
    "mtpu_scan_run": (_I, []),
    "mtpu_scan_tile": (_I, []),
    "mtpu_scan_powers": (_I, []),
    "mtpu_scan_f32": (_I, [_P, _P, _P, _P, _LL, _LL, _D, _D, _D, _I, _P, _P, _P, _P]),
    "mtpu_scan_f64": (_I, [_P, _P, _P, _P, _LL, _LL, _D, _D, _D, _I, _P, _P, _P, _P]),
    "mtpu_sos_run": (_I, []),
    "mtpu_sos_tile": (_I, []),
    "mtpu_sos_stages": (_I, []),
    "mtpu_sos_table_doubles": (_I, []),
    "mtpu_sos_shared_head": (_I, []),
    "mtpu_sos_f32": (_I, [_P, _P, _LL, _LL, _D, _D, _D, _D, _D, _P, _LL, _P, _P]),
    "mtpu_sos_f64": (_I, [_P, _P, _LL, _LL, _D, _D, _D, _D, _D, _P, _LL, _P, _P]),
    "mtpu_back_end_f32": (_I, [_P] * 5 + [_LL] * 4 + [_P] * 4 + [_LL, _LL, _P, _P]),
    "mtpu_back_end_f64": (_I, [_P] * 5 + [_LL] * 4 + [_P] * 4 + [_LL, _LL, _P, _P]),
    # each kernel's launch: registers, shared memory, resident blocks (csrc/info.cuh)
    "mtpu_envelope_info": (_I, [_I, _I, _P]),
    "mtpu_scan_info": (_I, [_I, _P]),
    "mtpu_sos_info": (_I, [_I, _P]),
    "mtpu_back_end_info": (_I, [_I, _P]),
}

# C constants the Python wrappers mirror: C function -> (module, attribute)
_CONSTANTS = {
    "mtpu_envelope_max_halo": ("envelope", "MAX_HALO"),
    "mtpu_envelope_tile": ("envelope", "TILE"),
    "mtpu_scan_run": ("scan", "RUN"),
    "mtpu_scan_tile": ("scan", "TILE"),
    "mtpu_scan_powers": ("scan", "POWERS"),
    "mtpu_sos_run": ("sos", "RUN"),
    "mtpu_sos_tile": ("sos", "TILE"),
    "mtpu_sos_stages": ("sos", "STAGES"),
    "mtpu_sos_table_doubles": ("sos", "TABLE_DOUBLES"),
    "mtpu_sos_shared_head": ("sos", "SHARED_HEAD"),
}

_library = None  # the loaded ctypes.CDLL, once built
build_seconds = None  # wall time of this process's build, None if loaded


def sources(suffixes=(".cu",)):
    return sorted(
        os.path.join(CSRC, name) for name in os.listdir(CSRC) if name.endswith(suffixes)
    )


def _nvcc() -> str:
    candidates = [
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash(paths) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return digest.hexdigest()[:16]


def _run(procs) -> None:
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err.decode(errors='replace')}"
            )


def _compile(paths, target: str) -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = []
        procs = []
        for path in paths:
            obj = os.path.join(tmp, os.path.basename(path) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", path, "-o", obj]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
            objects.append(obj)
        _run(procs)
        staged = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", *objects, "-o", staged]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE))])
        os.replace(staged, target)  # atomic: a concurrent build loses nothing


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _library, build_seconds
    if _library is not None:
        return _library
    digest = _source_hash(sources((".cu", ".cuh")))
    target = os.path.join(BUILD_DIR, f"libmtpu_kernels_{digest}.so")
    if not os.path.exists(target):
        start = time.perf_counter()
        _compile(sources(), target)
        build_seconds = time.perf_counter() - start
    lib = ctypes.CDLL(target)
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    for name, (module, attribute) in _CONSTANTS.items():
        want = getattr(importlib.import_module(f"{__package__}.{module}"), attribute)
        got = getattr(lib, name)()
        if got != want:
            raise RuntimeError(f"{name}() is {got}, but {module}.{attribute} is {want}")
    _library = lib
    return lib


def check_lengths(lengths, rows: int, n: int, minimum: int) -> None:
    """Raise ValueError unless ``lengths`` (``RowInts``) hold one host int
    per row, each in [minimum, n]."""
    if len(lengths.host) != rows:
        raise ValueError(f"{len(lengths.host)} lengths for {rows} rows")
    for length in lengths.host:
        if not minimum <= length <= n:
            raise ValueError(f"length {length} is outside [{minimum}, {n}]")


def lengths_pointer(lengths, rows: int, n: int, minimum: int, device) -> int:
    """The device address of a kernel's per-row lengths (None without
    them), after checking their host copy: one per row, each in
    [minimum, n], and the tensor int64, contiguous and on ``device``.
    Nothing is read back from the card."""
    if lengths is None:
        return None
    check_lengths(lengths, rows, n, minimum)
    tensor = lengths.device
    if tensor.dtype != torch.int64 or tensor.device != device or not tensor.is_contiguous():
        raise ValueError("lengths must be a contiguous int64 tensor on the input's device")
    if tuple(tensor.shape) != (rows,):
        raise ValueError(f"lengths tensor of shape {tuple(tensor.shape)} for {rows} rows")
    return tensor.data_ptr()


def check(status: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {status}")
