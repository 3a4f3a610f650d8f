"""Build the native codec shared library with g++.

Usage: ``python -m matchering_tpu_torch.io.native.build``

Counterpart of ``matchering_tpu/io/native/build.py``, with the same
compiler flags.  The library goes to ``matchering_tpu_torch/_build/``,
never into the source tree, named by a hash of the sources and flags, so a
changed source builds anew, and by the host's CPU model, since
``-march=native`` builds for that CPU alone.  It is published atomically:
parallel builds (test workers) race safely.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(HERE, "flac.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(HERE)), "_build")
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def _host_cpu() -> bytes:
    """The first CPU's model and feature flags (what ``-march=native``
    reads), or the machine's architecture where there is no cpuinfo."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            head = f.read().split(b"\n\n")[0]
    except OSError:
        return platform.machine().encode()
    return b"\n".join(line for line in head.splitlines() if line.startswith((b"model name", b"flags")))


def library_name() -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode() + b"\0" + _host_cpu())
    for path in SOURCES:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return f"libmtpu_codec_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = True, build_dir: str = BUILD_DIR) -> str:
    """Compile the codec into ``build_dir`` and return the library's path."""
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, library_name())
    fd, staging = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = ["g++", *FLAGS, *SOURCES, "-o", staging]
    if verbose:
        print(" ".join(cmd).replace(staging, out))
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose, text=True)
        os.replace(staging, out)
    finally:
        if os.path.exists(staging):
            os.remove(staging)
    return out


if __name__ == "__main__":
    print(f"built {build()}")
    sys.exit(0)
