"""The host shell's direct read of integer-PCM WAV payloads, on the CPU.

``io.loader.load_staged`` reads a 16- or 32-bit integer-PCM WAV's payload
with one ``readinto`` straight into the block ``utils.to_device`` stages
from (``wav.pcm_layout``, ``wav.read_pcm_into``).  Each file here, written
by the port's own writers or packed by hand, must give the codes
``wav.read(path, raw_int=True)`` gives, to the bit, at the same shape and
dtype, and those of the JAX package's reader, whose chunk walk is its own;
every other encoding must take the decode chain (``load``'s result,
no ``direct_bytes``), and a file the chain refuses must be refused with
the same coded error.
"""

import struct

import numpy as np
import pytest

from matchering_tpu.io import wav as jwav

import matchering_tpu_torch as mt
from matchering_tpu_torch import trace
from matchering_tpu_torch.io import aiff, codecs, loader, wav

SR = 44100
FRAMES = 1001  # odd, so an odd-sized payload needs its pad byte


def _codes(bits: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dtype = np.int16 if bits == 16 else np.int32
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=(FRAMES, channels), endpoint=True, dtype=dtype)


def _fmt(bits: int, channels: int, tag: int = wav.WAVE_FORMAT_PCM) -> bytes:
    align = channels * bits // 8
    return struct.pack("<HHIIHH", tag, channels, SR, SR * align, align, bits)


def _extensible(bits: int, channels: int) -> bytes:
    guid_tail = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    return _fmt(bits, channels, wav.WAVE_FORMAT_EXTENSIBLE) + struct.pack(
        "<HHI", 22, bits, 3 if channels == 2 else 4
    ) + struct.pack("<H", wav.WAVE_FORMAT_PCM) + guid_tail


def _chunk(cid: bytes, payload: bytes, declared=None) -> bytes:
    size = len(payload) if declared is None else declared
    return struct.pack("<4sI", cid, size) + payload + (b"\x00" if len(payload) & 1 else b"")


def _container(chunks: bytes, magic: bytes = b"RIFF") -> bytes:
    size = 0xFFFFFFFF if magic != b"RIFF" else 4 + len(chunks)
    return struct.pack("<4sI4s", magic, size, b"WAVE") + chunks


def _ds64(payload: bytes, data_size=None) -> bytes:
    size = len(payload) if data_size is None else data_size
    return _chunk(b"ds64", struct.pack("<qqqI", 0, size, FRAMES, 0))


def _packed(name: str) -> bytes:
    """A hand-packed WAV of each layout ``wav.read`` takes."""
    stereo = _codes(16, 2, 1).tobytes()
    if name == "extensible_16":
        return _container(_chunk(b"fmt ", _extensible(16, 2)) + _chunk(b"data", stereo))
    if name == "extensible_32":
        return _container(_chunk(b"fmt ", _extensible(32, 1)) + _chunk(b"data", _codes(32, 1, 2).tobytes()))
    if name in ("rf64", "bw64"):
        body = _ds64(stereo) + _chunk(b"fmt ", _fmt(16, 2)) + _chunk(b"data", stereo, 0xFFFFFFFF)
        return _container(body, name.upper().encode())
    if name == "rf64_without_ds64":  # the sentinel size: the data runs to the end of the file
        return _container(_chunk(b"fmt ", _fmt(16, 2)) + _chunk(b"data", stereo, 0xFFFFFFFF), b"RF64")
    if name == "odd_chunk_before_data_list_after":
        mono = _codes(16, 1, 3).tobytes()  # 2002 bytes
        return _container(
            _chunk(b"fmt ", _fmt(16, 1)) + _chunk(b"junk", b"seven b") + _chunk(b"data", mono)
            + _chunk(b"LIST", b"INFOISFT\x05\x00\x00\x00test\x00")
        )
    if name == "odd_payload_padded":  # 3 bytes of mono int16 codes after 1001 frames of 32-bit stereo
        payload = _codes(32, 2, 4).tobytes() + b"\x01\x02\x03"
        return _container(_chunk(b"fmt ", _fmt(32, 2)) + _chunk(b"data", payload) + _chunk(b"LIST", b"abc"))
    if name == "data_longer_than_file":
        return _container(_chunk(b"fmt ", _fmt(16, 2)) + _chunk(b"data", stereo, len(stereo) + 4096))
    if name == "trailing_partial_frame":
        return _container(_chunk(b"fmt ", _fmt(16, 2)) + _chunk(b"data", stereo + b"\x07\x08\x09"))
    if name == "two_data_chunks":  # the last one is the payload, as in wav.read
        first = _codes(16, 2, 5)[:17].tobytes()
        return _container(_chunk(b"fmt ", _fmt(16, 2)) + _chunk(b"data", first) + _chunk(b"data", stereo))
    if name == "fmt_after_data":
        return _container(_chunk(b"data", stereo) + _chunk(b"fmt ", _fmt(16, 2)))
    raise KeyError(name)


WRITTEN = [(bits, channels) for bits in (16, 32) for channels in (1, 2)]
PACKED = [
    "extensible_16", "extensible_32", "rf64", "bw64", "rf64_without_ds64",
    "odd_chunk_before_data_list_after", "odd_payload_padded", "data_longer_than_file",
    "trailing_partial_frame", "two_data_chunks", "fmt_after_data",
]


def _path(tmp_path, case) -> str:
    path = tmp_path / "track.wav"
    if isinstance(case, tuple):
        bits, channels = case
        codes = _codes(bits, channels, 7)
        wav.write(str(path), codes / float(np.iinfo(codes.dtype).max + 1), SR, f"PCM_{bits}")
    else:
        path.write_bytes(_packed(case))
    return str(path)


def _direct(path):
    before = trace.counts().get("direct_bytes", 0)
    block, rate = loader.load_staged(path, "target", device="cpu")
    return block, rate, trace.counts().get("direct_bytes", 0) - before


@pytest.mark.parametrize("case", WRITTEN + PACKED, ids=lambda c: c if isinstance(c, str) else f"pcm{c[0]}_{c[1]}ch")
def test_the_direct_read_gives_read_raw_ints_codes(tmp_path, case):
    path = _path(tmp_path, case)
    want, want_rate = wav.read(path, raw_int=True)
    with open(path, "rb") as f:
        assert wav.pcm_layout(f) is not None
    got, rate, direct = _direct(path)
    assert isinstance(got, np.ndarray) and got.flags.writeable and got.flags.c_contiguous
    assert rate == want_rate and got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    jax_codes, jax_rate = jwav.read(path, raw_int=True)
    assert jax_rate == rate and jax_codes.dtype == got.dtype and jax_codes.shape == got.shape
    assert jax_codes.tobytes() == got.tobytes()
    assert want.shape[0] > 0 and direct == want.nbytes


def _write_other(path: str, kind: str) -> str:
    audio = np.sin(np.arange(FRAMES * 2).reshape(FRAMES, 2) * 0.01) * 0.5
    if kind == "aiff":
        aiff.write(path + ".aiff", audio, SR, "PCM_16")
        return path + ".aiff"
    if kind == "flac":
        codecs.write(path + ".flac", audio, SR, "PCM_16")
        return path + ".flac"
    wav.write(path + ".wav", audio, SR, kind)
    return path + ".wav"


@pytest.mark.parametrize("kind", ["PCM_24", "FLOAT", "ALAW", "aiff", "flac"])
def test_other_encodings_take_the_decode_chain(tmp_path, kind):
    if kind == "flac" and not codecs.check_format("FLAC", "PCM_16"):
        pytest.fail("the native codec did not build: FLAC cannot be written")
    path = _write_other(str(tmp_path / "track"), kind)
    with open(path, "rb") as f:
        if kind in ("aiff", "flac"):  # not a RIFF/WAVE stream: refused as wav.read refuses it
            with pytest.raises(wav.WavFormatError, match="unknown format"):
                wav.pcm_layout(f)
        else:
            assert wav.pcm_layout(f) is None
    want, want_rate = loader.load(path, "target", raw_int=True)
    got, rate, direct = _direct(path)
    assert direct == 0 and rate == want_rate
    assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("cut", [20, 30, 40])
def test_a_file_the_chain_refuses_is_refused_alike(tmp_path, cut):
    """A PCM_16 WAV cut inside its header: the direct read steps aside and
    the decode chain raises its coded error."""
    path = _path(tmp_path, (16, 2))
    with open(path, "rb") as f:
        head = f.read(cut)
    with open(path, "wb") as f:
        f.write(head)
    codes = []
    for read in (lambda: loader.load(path, "target", raw_int=True), lambda: _direct(path)):
        with pytest.raises(mt.ModuleError) as error:
            read()
        codes.append(error.value.code)
    assert codes[0] == codes[1] == mt.Code.ERROR_TARGET_LOADING
