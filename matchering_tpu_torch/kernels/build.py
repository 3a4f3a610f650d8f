"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``matchering_tpu_torch/csrc`` is compiled by
``nvcc`` for ``sm_90a`` (one process per source, all started together),
linked into one shared library with a plain C interface, and loaded with
``ctypes``.  The build runs at the first launch, into
``matchering_tpu_torch/_build/``, keyed by a hash of the sources, so a
changed source rebuilds and an unchanged one loads the existing library.
Importing this module needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

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
    "mtpu_envelope_f32": (_I, [_P, _P, _P, _LL, _D, _I, _P]),
    "mtpu_envelope_f64": (_I, [_P, _P, _P, _LL, _D, _I, _P]),
    "mtpu_scan_scratch": (_LL, [_LL, _LL]),
    "mtpu_scan_f32": (_I, [_P, _P, _P, _LL, _LL, _D, _D, _D, _I, _P, _P]),
    "mtpu_scan_f64": (_I, [_P, _P, _P, _LL, _LL, _D, _D, _D, _I, _P, _P]),
}

_library = None  # the loaded ctypes.CDLL, once built
build_seconds = None  # wall time of this process's build, None if loaded


def sources():
    return sorted(
        os.path.join(CSRC, name) for name in os.listdir(CSRC) if name.endswith(".cu")
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
    paths = sources()
    target = os.path.join(BUILD_DIR, f"libmtpu_kernels_{_source_hash(paths)}.so")
    if not os.path.exists(target):
        start = time.perf_counter()
        _compile(paths, target)
        build_seconds = time.perf_counter() - start
    lib = ctypes.CDLL(target)
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _library = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {status}")
