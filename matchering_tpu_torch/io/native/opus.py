"""Ogg Opus decode AND encode via the system libopus — no ffmpeg needed.

A copy of ``matchering_tpu/io/native/opus.py`` (numpy and ctypes; the
write side resamples with the port's ``ops.resample`` on the host).  The
reference reads and writes .opus through libsndfile
(``matchering/loader.py:35``, ``saver.py:32``).  The usual native route, libopusfile/libopusenc, is absent on typical
minimal images — but the raw codec ``libopus`` is almost always present
(pulled in by every media stack).  So: handle the Ogg container in pure
Python (the framing layer is just lacing tables + a CRC — RFC 3533) and
hand packets to ``opus_decode_float`` / ``opus_encode_float`` over ctypes.

Implements RFC 7845 (Ogg encapsulation of Opus) both ways: OpusHead
parsing/synthesis (channel count, pre-skip, output gain, channel mapping
families 0/1 on read; family 0 on write), OpusTags, 48 kHz codec rate,
pre-skip and end-trim granule accounting.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

_MAX_FRAME = 5760  # 120 ms at 48 kHz — the largest Opus frame

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    name = ctypes.util.find_library("opus") or "libopus.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        _lib_failed = True
        return None
    c_int, c_int32, c_ubyte_p = ctypes.c_int, ctypes.c_int32, ctypes.POINTER(ctypes.c_ubyte)
    c_float_p = ctypes.POINTER(ctypes.c_float)
    lib.opus_decoder_create.restype = ctypes.c_void_p
    lib.opus_decoder_create.argtypes = [c_int32, c_int, ctypes.POINTER(c_int)]
    lib.opus_decode_float.restype = c_int
    lib.opus_decode_float.argtypes = [ctypes.c_void_p, c_ubyte_p, c_int32, c_float_p, c_int, c_int]
    lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_multistream_decoder_create.restype = ctypes.c_void_p
    lib.opus_multistream_decoder_create.argtypes = [
        c_int32, c_int, c_int, c_int, c_ubyte_p, ctypes.POINTER(c_int),
    ]
    lib.opus_multistream_decode_float.restype = c_int
    lib.opus_multistream_decode_float.argtypes = [
        ctypes.c_void_p, c_ubyte_p, c_int32, c_float_p, c_int, c_int,
    ]
    lib.opus_multistream_decoder_destroy.argtypes = [ctypes.c_void_p]
    # encoder entry points (present in every standard libopus build)
    try:
        lib.opus_encoder_create.restype = ctypes.c_void_p
        lib.opus_encoder_create.argtypes = [c_int32, c_int, c_int, ctypes.POINTER(c_int)]
        lib.opus_encode_float.restype = c_int32
        lib.opus_encode_float.argtypes = [
            ctypes.c_void_p, c_float_p, c_int, c_ubyte_p, c_int32,
        ]
        # variadic ctl: pin the fixed args (the encoder handle must travel
        # as a 64-bit pointer, not a truncated Python int) and let ctypes
        # pass the request's vararg through
        lib.opus_encoder_ctl.restype = c_int
        lib.opus_encoder_ctl.argtypes = [ctypes.c_void_p, c_int]
        lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
        lib._mtpu_has_encoder = True
    except AttributeError:
        lib._mtpu_has_encoder = False
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _first_packet(buf: bytes) -> bytes:
    """The first packet of the first Ogg page (enough for magic sniffing)."""
    if len(buf) < 28 or buf[:4] != b"OggS":
        return b""
    nsegs = buf[26]
    body = 27 + nsegs
    first_len = 0
    for lace in buf[27 : 27 + nsegs]:
        first_len += lace
        if lace < 255:
            break
    return buf[body : body + first_len]


def is_opus(path: str) -> bool:
    """True when the file is an Ogg stream whose first packet is OpusHead."""
    try:
        with open(path, "rb") as f:
            head = f.read(1024)
    except OSError:
        return False
    return _first_packet(head)[:8] == b"OpusHead"


def _demux_ogg(buf: bytes) -> Tuple[List[bytes], int]:
    """Assemble Ogg packets (RFC 3533 lacing) -> (packets, last granulepos)."""
    packets: List[bytes] = []
    partial = b""
    granule = 0
    pos = 0
    while pos + 27 <= len(buf):
        if buf[pos : pos + 4] != b"OggS":
            break
        header_type = buf[pos + 5]
        (page_granule,) = struct.unpack_from("<q", buf, pos + 6)
        nsegs = buf[pos + 26]
        lacing = buf[pos + 27 : pos + 27 + nsegs]
        body = pos + 27 + nsegs
        if not (header_type & 0x01):  # not a continuation: drop any orphan
            partial = b""
        seg_pos = body
        for lace in lacing:
            partial += buf[seg_pos : seg_pos + lace]
            seg_pos += lace
            if lace < 255:
                packets.append(partial)
                partial = b""
        if page_granule >= 0:
            granule = page_granule
        pos = seg_pos
    return packets, granule


class _OpusHead:
    def __init__(self, packet: bytes):
        if packet[:8] != b"OpusHead" or len(packet) < 19:
            raise RuntimeError("unknown format: malformed OpusHead")
        (self.version, self.channels, self.pre_skip, _input_rate, gain_q8,
         self.mapping_family) = struct.unpack_from("<BBHIhB", packet, 8)
        if self.channels < 1:
            raise RuntimeError("unknown format: invalid Opus channel count")
        self.gain = 10.0 ** (gain_q8 / (20.0 * 256.0))
        if self.mapping_family == 0:
            self.streams = 1
            self.coupled = 1 if self.channels == 2 else 0
            self.mapping = bytes(range(self.channels))
        else:
            if len(packet) < 21 + self.channels:
                raise RuntimeError("unknown format: malformed Opus channel mapping")
            self.streams, self.coupled = struct.unpack_from("<BB", packet, 19)
            self.mapping = packet[21 : 21 + self.channels]


def read_opus(path: str) -> Tuple[np.ndarray, int]:
    """Decode an Ogg Opus file -> (float64 (n, ch) array, 48000)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libopus is not available on this host")
    with open(path, "rb") as f:
        buf = f.read()
    packets, granule = _demux_ogg(buf)
    if not packets or packets[0][:8] != b"OpusHead":
        raise RuntimeError(f"unknown format: '{os.path.basename(path)}'")
    head = _OpusHead(packets[0])
    audio = packets[1:]
    if audio and audio[0][:8] == b"OpusTags":
        audio = audio[1:]

    err = ctypes.c_int(0)
    multistream = head.mapping_family != 0
    if multistream:
        mapping = (ctypes.c_ubyte * head.channels).from_buffer_copy(head.mapping)
        dec = lib.opus_multistream_decoder_create(
            48000, head.channels, head.streams, head.coupled, mapping, ctypes.byref(err)
        )
        decode, destroy = lib.opus_multistream_decode_float, lib.opus_multistream_decoder_destroy
    else:
        dec = lib.opus_decoder_create(48000, head.channels, ctypes.byref(err))
        decode, destroy = lib.opus_decode_float, lib.opus_decoder_destroy
    if not dec or err.value != 0:
        raise RuntimeError(f"opus decoder init failed (rc={err.value})")

    try:
        frame = np.empty(_MAX_FRAME * head.channels, dtype=np.float32)
        frame_p = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        chunks = []
        for pkt in audio:
            if not pkt:
                continue
            data = (ctypes.c_ubyte * len(pkt)).from_buffer_copy(pkt)
            n = decode(dec, data, len(pkt), frame_p, _MAX_FRAME, 0)
            if n < 0:
                raise RuntimeError(f"opus packet decode failed (rc={n})")
            chunks.append(frame[: n * head.channels].reshape(n, head.channels).copy())
    finally:
        destroy(dec)

    if not chunks:
        raise RuntimeError(f"unknown format: '{os.path.basename(path)}' (no audio)")
    pcm = np.concatenate(chunks, axis=0).astype(np.float64)
    # RFC 7845 §4: trim the encoder pre-skip, and end-trim to the final
    # granule position (granules count 48 kHz samples incl. pre-skip)
    end = granule if 0 < granule <= pcm.shape[0] else pcm.shape[0]
    pcm = pcm[min(head.pre_skip, end) : end]
    if head.gain != 1.0:
        pcm *= head.gain
    return pcm, 48000


# --------------------------------------------------------------------------
# Encode side: float PCM -> Ogg Opus (RFC 7845 encapsulation, RFC 3533
# framing), the write-half of the demux above.  The reference writes .opus
# through libsndfile (``matchering/saver.py:32``); here the Ogg layer is
# pure Python and the codec is the same system libopus the read side uses.

_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE = 4002
_OPUS_GET_LOOKAHEAD = 4027
_FRAME = 960  # 20 ms at 48 kHz
_OPUS_RATES = (8000, 12000, 16000, 24000, 48000)


def write_available() -> bool:
    lib = _load()
    return bool(lib is not None and getattr(lib, "_mtpu_has_encoder", False))


def _ogg_crc_table() -> np.ndarray:
    """Ogg's CRC-32: polynomial 0x04c11db7, MSB-first, init 0, no final
    xor (RFC 3533 §6) — NOT the zlib crc32."""
    poly = 0x04C11DB7
    table = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ poly) if (r & 0x80000000) else (r << 1)
            r &= 0xFFFFFFFF
        table[i] = r
    return table


_CRC_TABLE = _ogg_crc_table()


def _ogg_crc(data: bytes) -> int:
    crc = 0
    table = _CRC_TABLE
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(table[((crc >> 24) & 0xFF) ^ b])
    return crc


def _lacing(length: int) -> bytes:
    """RFC 3533 lacing values for one packet (255-terminated segments)."""
    full, last = divmod(length, 255)
    return bytes([255] * full + [last])


def _ogg_page(
    packets: List[bytes], granule: int, serial: int, seq: int, header_type: int
) -> bytes:
    lacing = b"".join(_lacing(len(p)) for p in packets)
    if len(lacing) > 255:
        raise ValueError("too many segments for one Ogg page")
    body = b"".join(packets)
    header = struct.pack(
        "<4sBBqIIIB",
        b"OggS", 0, header_type, granule, serial, seq, 0, len(lacing),
    ) + lacing
    crc = _ogg_crc(header + body)
    header = header[:22] + struct.pack("<I", crc) + header[26:]
    return header + body


def write_opus(
    path: str, array: np.ndarray, sample_rate: int, bitrate: int = 256000
) -> None:
    """Encode a float (n, ch) array as an Ogg Opus file.

    Opus only codes at 8/12/16/24/48 kHz; other input rates (including the
    pipeline's 44.1 kHz default) are polyphase-resampled to 48 kHz first —
    the same resampler the checker uses (``ops.resample``), so write-side
    rate conversion matches the framework's ingest conversion.  The
    original rate is recorded in OpusHead's informational input-rate field
    (RFC 7845 §5.1: decoders always run at 48 kHz).
    """
    lib = _load()
    if lib is None or not getattr(lib, "_mtpu_has_encoder", False):
        raise RuntimeError("libopus encoder is not available on this host")
    array = np.asarray(array, dtype=np.float32)
    if array.ndim == 1:
        array = array[:, None]
    channels = array.shape[1]
    if channels not in (1, 2):
        raise RuntimeError("opus encode supports 1 or 2 channels")

    input_rate = int(sample_rate)
    if input_rate not in _OPUS_RATES:
        from ...ops import resample as _resample

        array = (
            _resample.resample(array.astype(np.float64), input_rate, 48000)
            .numpy()
            .astype(np.float32)
        )
        rate = 48000
    else:
        rate = input_rate

    err = ctypes.c_int(0)
    enc = lib.opus_encoder_create(
        rate, channels, _OPUS_APPLICATION_AUDIO, ctypes.byref(err)
    )
    if not enc or err.value != 0:
        raise RuntimeError(f"opus encoder init failed (rc={err.value})")
    try:
        lib.opus_encoder_ctl(enc, _OPUS_SET_BITRATE, ctypes.c_int32(bitrate))
        lookahead = ctypes.c_int32(0)
        lib.opus_encoder_ctl(enc, _OPUS_GET_LOOKAHEAD, ctypes.byref(lookahead))
        # granules are always 48 kHz samples regardless of the coding rate
        granule_scale = 48000 // rate
        pre_skip_48k = lookahead.value * granule_scale

        n = array.shape[0]
        frame = _FRAME * rate // 48000  # 20 ms at the coding rate
        # enough trailing zeros that the decoder can reconstruct all n
        # samples after dropping the encoder lookahead
        nframes = -(-(n + lookahead.value) // frame)
        padded = np.zeros((nframes * frame, channels), dtype=np.float32)
        padded[:n] = array
        out_buf = (ctypes.c_ubyte * 4000)()

        packets: List[bytes] = []
        for i in range(nframes):
            chunk = np.ascontiguousarray(padded[i * frame : (i + 1) * frame])
            pcm_p = chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            nbytes = lib.opus_encode_float(enc, pcm_p, frame, out_buf, 4000)
            if nbytes < 0:
                raise RuntimeError(f"opus frame encode failed (rc={nbytes})")
            packets.append(bytes(out_buf[:nbytes]))
    finally:
        lib.opus_encoder_destroy(enc)

    head = struct.pack(
        "<8sBBHIhB",
        b"OpusHead", 1, channels, pre_skip_48k, input_rate, 0, 0,
    )
    vendor = b"matchering_tpu"
    tags = b"OpusTags" + struct.pack("<I", len(vendor)) + vendor + struct.pack("<I", 0)

    serial = 0x6D747075  # 'mtpu'
    pages = [
        _ogg_page([head], 0, serial, 0, 0x02),  # BOS
        _ogg_page([tags], 0, serial, 1, 0x00),
    ]
    end_granule = pre_skip_48k + n * granule_scale
    seq = 2
    granule = 0
    group: List[bytes] = []
    group_segments = 0
    for idx, pkt in enumerate(packets):
        segs = len(_lacing(len(pkt)))
        if group and group_segments + segs > 255:
            pages.append(_ogg_page(group, granule, serial, seq, 0x00))
            seq += 1
            group, group_segments = [], 0
        group.append(pkt)
        group_segments += segs
        granule += frame * granule_scale
    # final page: EOS, granule end-trimmed to the true sample count
    pages.append(_ogg_page(group, end_granule, serial, seq, 0x04))

    with open(path, "wb") as f:
        for page in pages:
            f.write(page)
