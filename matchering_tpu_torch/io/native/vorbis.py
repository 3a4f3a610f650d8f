"""OGG/Vorbis codec via the system libvorbis — no ffmpeg binary needed.

A copy of ``matchering_tpu/io/native/vorbis.py`` (numpy and ctypes only).
The reference reads OGG/Vorbis natively through libsndfile
(``matchering/loader.py:35``).  Here we
bind the host's ``libvorbisfile``/``libvorbisenc`` shared libraries directly
with ctypes — the common lossy-upload case now decodes (and encodes) with no
external process at all, and degrades gracefully to the ffmpeg fallback on
hosts without the libraries.

ABI notes: the bound structs (``vorbis_info``, ``ogg_packet``, ``ogg_page``)
have been frozen since libvorbis/libogg 1.0 (2002).  Structs the library
treats as caller-allocated opaque state (``OggVorbis_File``,
``vorbis_dsp_state``, ``vorbis_block``, ``ogg_stream_state``,
``vorbis_comment``) are allocated as oversized zeroed buffers — the library
only touches the true ``sizeof``, so extra space is harmless.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_c_long = ctypes.c_long
_c_int = ctypes.c_int
_c_int64 = ctypes.c_int64
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_float_pp = ctypes.POINTER(_c_float_p)

# generous upper bounds on the opaque caller-allocated structs (true x86-64
# sizes: OggVorbis_File 944, vorbis_dsp_state 256, vorbis_block 192,
# ogg_stream_state 408, vorbis_comment 32)
_OPAQUE_BYTES = 8192


class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", _c_int),
        ("channels", _c_int),
        ("rate", _c_long),
        ("bitrate_upper", _c_long),
        ("bitrate_nominal", _c_long),
        ("bitrate_lower", _c_long),
        ("bitrate_window", _c_long),
        ("codec_setup", ctypes.c_void_p),
    ]


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", _c_long),
        ("b_o_s", _c_long),
        ("e_o_s", _c_long),
        ("granulepos", _c_int64),
        ("packetno", _c_int64),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", _c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", _c_long),
    ]


def _opaque():
    return ctypes.create_string_buffer(_OPAQUE_BYTES)


_libs: Optional[Tuple] = None
_load_failed = False


def _load():
    """(vorbisfile, vorbis, vorbisenc, ogg) handles, or None if absent."""
    global _libs, _load_failed
    if _libs is not None or _load_failed:
        return _libs
    try:
        vf = ctypes.CDLL("libvorbisfile.so.3")
        vo = ctypes.CDLL("libvorbis.so.0")
        ve = ctypes.CDLL("libvorbisenc.so.2")
        og = ctypes.CDLL("libogg.so.0")
    except OSError:
        _load_failed = True
        return None

    vf.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    vf.ov_fopen.restype = _c_int
    vf.ov_info.argtypes = [ctypes.c_void_p, _c_int]
    vf.ov_info.restype = ctypes.POINTER(_VorbisInfo)
    vf.ov_pcm_total.argtypes = [ctypes.c_void_p, _c_int]
    vf.ov_pcm_total.restype = _c_int64
    vf.ov_read_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(_c_float_pp),
        _c_int,
        ctypes.POINTER(_c_int),
    ]
    vf.ov_read_float.restype = _c_long
    vf.ov_clear.argtypes = [ctypes.c_void_p]
    vf.ov_clear.restype = _c_int

    ve.vorbis_encode_init_vbr.argtypes = [
        ctypes.c_void_p,
        _c_long,
        _c_long,
        ctypes.c_float,
    ]
    ve.vorbis_encode_init_vbr.restype = _c_int

    vo.vorbis_info_init.argtypes = [ctypes.c_void_p]
    vo.vorbis_comment_init.argtypes = [ctypes.c_void_p]
    vo.vorbis_analysis_init.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    vo.vorbis_analysis_init.restype = _c_int
    vo.vorbis_block_init.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    vo.vorbis_block_init.restype = _c_int
    vo.vorbis_analysis_headerout.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.POINTER(_OggPacket)
    ] * 3
    vo.vorbis_analysis_headerout.restype = _c_int
    vo.vorbis_analysis_buffer.argtypes = [ctypes.c_void_p, _c_int]
    vo.vorbis_analysis_buffer.restype = _c_float_pp
    vo.vorbis_analysis_wrote.argtypes = [ctypes.c_void_p, _c_int]
    vo.vorbis_analysis_wrote.restype = _c_int
    vo.vorbis_analysis_blockout.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    vo.vorbis_analysis_blockout.restype = _c_int
    vo.vorbis_analysis.argtypes = [ctypes.c_void_p, ctypes.POINTER(_OggPacket)]
    vo.vorbis_analysis.restype = _c_int
    vo.vorbis_bitrate_addblock.argtypes = [ctypes.c_void_p]
    vo.vorbis_bitrate_addblock.restype = _c_int
    vo.vorbis_bitrate_flushpacket.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(_OggPacket),
    ]
    vo.vorbis_bitrate_flushpacket.restype = _c_int
    for name in (
        "vorbis_block_clear",
        "vorbis_dsp_clear",
        "vorbis_comment_clear",
        "vorbis_info_clear",
    ):
        fn = getattr(vo, name)
        fn.argtypes = [ctypes.c_void_p]

    og.ogg_stream_init.argtypes = [ctypes.c_void_p, _c_int]
    og.ogg_stream_init.restype = _c_int
    og.ogg_stream_packetin.argtypes = [ctypes.c_void_p, ctypes.POINTER(_OggPacket)]
    og.ogg_stream_packetin.restype = _c_int
    og.ogg_stream_flush.argtypes = [ctypes.c_void_p, ctypes.POINTER(_OggPage)]
    og.ogg_stream_flush.restype = _c_int
    og.ogg_stream_pageout.argtypes = [ctypes.c_void_p, ctypes.POINTER(_OggPage)]
    og.ogg_stream_pageout.restype = _c_int
    og.ogg_page_eos.argtypes = [ctypes.POINTER(_OggPage)]
    og.ogg_page_eos.restype = _c_int
    og.ogg_stream_clear.argtypes = [ctypes.c_void_p]

    _libs = (vf, vo, ve, og)
    return _libs


def available() -> bool:
    return _load() is not None


def is_ogg(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"OggS"
    except OSError:
        return False


def read_ogg(path: str) -> Tuple[np.ndarray, int]:
    """Decode an OGG/Vorbis file -> (float64 (n, ch) array, sample rate)."""
    libs = _load()
    if libs is None:
        raise RuntimeError("libvorbisfile is not available on this host")
    vf_lib, *_ = libs
    vf = _opaque()
    rc = vf_lib.ov_fopen(path.encode(), vf)
    if rc != 0:
        raise RuntimeError(
            f"unknown format: '{os.path.basename(path)}' (ov_fopen rc={rc})"
        )
    try:
        info = vf_lib.ov_info(vf, -1).contents
        channels, rate = info.channels, int(info.rate)
        total = int(vf_lib.ov_pcm_total(vf, -1))  # -1 on unseekable streams
        chunks = []
        pcm = _c_float_pp()
        bitstream = _c_int(0)
        while True:
            got = vf_lib.ov_read_float(vf, ctypes.byref(pcm), 4096, ctypes.byref(bitstream))
            if got == 0:
                break
            if got < 0:  # OV_HOLE etc. — corrupt page, skip like libsndfile
                continue
            frame = np.empty((got, channels), dtype=np.float64)
            for c in range(channels):
                frame[:, c] = np.ctypeslib.as_array(pcm[c], shape=(got,))
            chunks.append(frame)
        out = (
            np.concatenate(chunks)
            if chunks
            else np.empty((0, channels), dtype=np.float64)
        )
        if 0 < total < out.shape[0]:
            out = out[:total]
        return out, rate
    finally:
        vf_lib.ov_clear(vf)


def write_ogg(
    path: str, array: np.ndarray, sample_rate: int, quality: float = 0.8
) -> None:
    """Encode float (n, ch) audio as OGG/Vorbis (VBR ``quality`` in [-0.1, 1])."""
    libs = _load()
    if libs is None:
        raise RuntimeError("libvorbisenc is not available on this host")
    _, vo, ve, og = libs
    array = np.ascontiguousarray(array, dtype=np.float32)
    if array.ndim == 1:
        array = array[:, None]
    n, channels = array.shape

    vi, vc, vd, vb, os_ = (_opaque() for _ in range(5))
    vo.vorbis_info_init(vi)
    if ve.vorbis_encode_init_vbr(vi, channels, sample_rate, quality) != 0:
        vo.vorbis_info_clear(vi)
        raise RuntimeError("vorbis encoder rejected the stream parameters")
    vo.vorbis_comment_init(vc)
    vo.vorbis_analysis_init(vd, vi)
    vo.vorbis_block_init(vd, vb)
    og.ogg_stream_init(os_, 0x6D747075)  # 'mtpu'

    page = _OggPage()
    try:
        with open(path, "wb") as f:

            def drain(flush: bool) -> None:
                pump = og.ogg_stream_flush if flush else og.ogg_stream_pageout
                while pump(os_, ctypes.byref(page)) != 0:
                    f.write(ctypes.string_at(page.header, page.header_len))
                    f.write(ctypes.string_at(page.body, page.body_len))

            headers = (_OggPacket(), _OggPacket(), _OggPacket())
            vo.vorbis_analysis_headerout(vd, vc, *map(ctypes.byref, headers))
            for h in headers:
                og.ogg_stream_packetin(os_, ctypes.byref(h))
            drain(flush=True)  # audio data must start on a fresh page

            packet = _OggPacket()
            block_len = 4096

            def submit(chunk) -> None:
                if len(chunk):
                    buf = vo.vorbis_analysis_buffer(vd, len(chunk))
                    # bind each contiguous column before taking .ctypes.data:
                    # a temporary would be freed the moment the address is
                    # extracted, and memmove would read reused heap memory
                    cols = [np.ascontiguousarray(chunk[:, c]) for c in range(channels)]
                    for c in range(channels):
                        ctypes.memmove(buf[c], cols[c].ctypes.data, len(chunk) * 4)
                vo.vorbis_analysis_wrote(vd, len(chunk))  # 0 marks end-of-stream
                while vo.vorbis_analysis_blockout(vd, vb) == 1:
                    vo.vorbis_analysis(vb, None)
                    vo.vorbis_bitrate_addblock(vb)
                    while vo.vorbis_bitrate_flushpacket(vd, ctypes.byref(packet)) == 1:
                        og.ogg_stream_packetin(os_, ctypes.byref(packet))
                        drain(flush=False)

            for start in range(0, n, block_len):
                submit(array[start : start + block_len])
            submit(array[:0])  # end-of-stream
            drain(flush=True)
    finally:
        og.ogg_stream_clear(os_)
        vo.vorbis_block_clear(vb)
        vo.vorbis_dsp_clear(vd)
        vo.vorbis_comment_clear(vc)
        vo.vorbis_info_clear(vi)
