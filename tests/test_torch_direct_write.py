"""The host shell's direct WAV write, on the CPU.

``io.saver.save`` quantises float32 or float64 samples bound for a WAV
file of a subtype in ``saver.DIRECT_SUBTYPES``, a tensor on its device and
a numpy array on the CPU, and writes the file from the codes' host block
(``saver.codes``, ``utils.host_copy``, ``wav.write_payload``).  Each file
must be, to the byte, the file the numpy codec (``wav.write``) writes for
the same samples widened to float64: header, payload and pad byte.  Every
other input keeps ``codecs.write`` and counts no ``direct_out_bytes``.
"""

import numpy as np
import pytest
import torch

from matchering_tpu_torch import trace
from matchering_tpu_torch.io import codecs, pcm, saver, wav

SR = 44100
FRAMES = 1001  # odd, so a PCM_24 mono payload needs its pad byte


def _samples(subtype: str, dtype, channels: int) -> np.ndarray:
    """(FRAMES, channels) samples: full scale, just past it, the code's
    half steps k + 0.5 for even and odd k, both zeros, and a seeded block
    beyond the code's range at both ends."""
    step = 2.0 ** (1 - 8 * (2 if subtype == "FLOAT" else pcm.SUBTYPES[subtype]))  # one code
    ulp = float(np.finfo(dtype).eps)
    edges = [1.0, -1.0, 1.0 + ulp, -1.0 - ulp, 1.0 - ulp / 2, -1.0 + ulp / 2, 0.0, -0.0]
    halves = [sign * (k + 0.5) * step for k in (0, 1, 2, 3, 100, 101, 2**14 - 1) for sign in (1, -1)]
    fixed = np.array(edges + halves, dtype=dtype)
    rng = np.random.default_rng(2100 + channels)
    flat = np.concatenate([fixed, rng.uniform(-1.25, 1.25, FRAMES * channels - fixed.size).astype(dtype)])
    return flat.reshape(FRAMES, channels)


CASES = [
    (s, d, c, f) for f in ("tensor", "numpy") for s in saver.DIRECT_SUBTYPES for d in ("float32", "float64")
    for c in (1, 2)
]


@pytest.mark.parametrize(
    "subtype,dtype,channels,form", CASES,
    ids=[f"{s}-{d}-{c}ch" + ("" if f == "tensor" else "-numpy") for s, d, c, f in CASES],
)
def test_a_tensor_writes_the_bytes_of_a_float64_export(tmp_path, subtype, dtype, channels, form):
    """The file of a tensor or of a numpy array is ``wav.write``'s for the
    samples widened to float64, and every payload byte counts in
    ``direct_out_bytes``."""
    samples = _samples(subtype, np.dtype(dtype), channels)
    got, want = tmp_path / "got.wav", tmp_path / "want.wav"
    result = torch.from_numpy(samples) if form == "tensor" else samples
    assert saver.writes_codes(str(got), result, subtype)
    before = trace.counts().get("direct_out_bytes", 0)
    saver.save(str(got), result, SR, subtype)
    written = trace.counts().get("direct_out_bytes", 0) - before
    wav.write(str(want), samples.astype(np.float64), SR, subtype)
    assert got.read_bytes() == want.read_bytes()
    assert written == samples.size * pcm.SUBTYPES[subtype]
    assert wav.read(str(got))[0].shape == (FRAMES, channels)


@pytest.mark.parametrize(
    "name,result,subtype",
    [
        ("numpy", np.zeros((FRAMES, 2), np.float16), "PCM_16"),
        ("aiff", torch.zeros(FRAMES, 2), "PCM_16"),
        ("double", torch.zeros(FRAMES, 2), "DOUBLE"),
        ("float16", torch.zeros(FRAMES, 2, dtype=torch.float16), "PCM_16"),
    ],
)
def test_every_other_input_keeps_the_codecs_writer(tmp_path, name, result, subtype):
    """Another container, another subtype, or another dtype in a numpy
    array or a tensor: the bytes of ``codecs.write`` and no
    ``direct_out_bytes``."""
    ext = "aiff" if name == "aiff" else "wav"
    got, want = tmp_path / f"got.{ext}", tmp_path / f"want.{ext}"
    assert not saver.writes_codes(str(got), result, subtype)
    before = trace.counts().get("direct_out_bytes", 0)
    saver.save(str(got), result, SR, subtype)
    assert trace.counts().get("direct_out_bytes", 0) == before
    codecs.write(str(want), np.asarray(result, dtype=np.float64), SR, subtype)
    assert got.read_bytes() == want.read_bytes()
