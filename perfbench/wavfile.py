"""The harness's own PCM_16 WAV files: it writes the inputs it makes and
reads back the codes of the program's results, with no code of the
program in between."""

from __future__ import annotations

import struct

import numpy as np


def write(path: str, codes: np.ndarray, rate: int) -> None:
    """Write (n, channels) int16 codes as a canonical 44-byte-header WAV."""
    codes = np.ascontiguousarray(codes, dtype="<i2")
    channels = codes.shape[1]
    data = codes.nbytes
    header = b"RIFF" + struct.pack("<I", 36 + data) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, rate, rate * 2 * channels, 2 * channels, 16)
    header += b"data" + struct.pack("<I", data)
    with open(path, "wb") as f:
        f.write(header)
        codes.tofile(f)


def read(path: str):
    """(int16 (n, channels) codes, rate) of a PCM_16 WAV file; chunks
    other than ``fmt `` and ``data`` are skipped."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a WAV file")
    pos, fmt = 12, None
    while pos + 8 <= len(buf):
        tag, size = buf[pos : pos + 4], struct.unpack("<I", buf[pos + 4 : pos + 8])[0]
        body = pos + 8
        if tag == b"fmt ":
            fmt = struct.unpack("<HHIIHH", buf[body : body + 16])
        elif tag == b"data":
            tag_format, channels, rate, _, _, bits = fmt
            if tag_format != 1 or bits != 16:
                raise ValueError(f"{path}: not PCM_16")
            codes = np.frombuffer(buf, "<i2", count=size // 2, offset=body)
            return codes.reshape(-1, channels), rate
        pos = body + size + (size & 1)
    raise ValueError(f"{path}: no data chunk")
