"""The port's FLAC, lossy and ffmpeg codec chain (``matchering_tpu_torch.io``)
against the JAX package's, on the CPU.

Mirrors the FLAC, lossy and ffmpeg classes of tests/test_output_formats.py
on the port's own modules (its native library builds from the port's
sources into ``matchering_tpu_torch/_build/``; the auto-build tests build
into ``tmp_path``), plus parity with the JAX package: the port's FLAC and
native WAV files byte-identical to JAX's for the same array and subtype,
its decode of every format equal to JAX's decode of the same file, and the
native WAV writer held to the numpy one (tests/test_host_shell.py:34-44).
ffmpeg is absent here, so the transcode plumbing runs through a stub
binary that copies the staged WAV.
"""

import os
import stat
import sys

import numpy as np
import pytest

import matchering_tpu_torch as mt
from matchering_tpu.io import codecs as jcodecs
from matchering_tpu.io.native import binding as jnative
from matchering_tpu_torch.io import codecs, wav
from matchering_tpu_torch.io.native import binding as native
from matchering_tpu_torch.io.native import build as native_build
from matchering_tpu_torch.io.native import mp3 as mp3lib
from matchering_tpu_torch.io.native import opus as opuslib
from matchering_tpu_torch.io.native import vorbis as vorbislib
from matchering_tpu_torch.results import Result
from test_output_formats import _encode_oggopus


@pytest.fixture
def no_lossy_libs(monkeypatch):
    """Simulate a host without libvorbis/libmpg123/LAME (restored after)."""
    monkeypatch.setattr(vorbislib, "_libs", None)
    monkeypatch.setattr(vorbislib, "_load_failed", True)
    monkeypatch.setattr(mp3lib, "_lib", None)
    monkeypatch.setattr(mp3lib, "_lib_failed", True)
    monkeypatch.setattr(mp3lib, "_lame", None)
    monkeypatch.setattr(mp3lib, "_lame_failed", True)


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    """A stand-in ffmpeg that copies the staged WAV to the output path."""
    script = tmp_path / "ffmpeg"
    script.write_text(
        "#!%s\nimport shutil, sys\n"
        "args = sys.argv[1:]\n"
        "src = args[args.index('-i') + 1]\n"
        "shutil.copy(src, args[-1])\n" % sys.executable
    )
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    return script


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The port's binding with nothing loaded and its build directory in
    ``tmp_path`` (restored after)."""
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    yield tmp_path / "build"
    native._lib = None
    native._load_attempted = False


def _sine_pair(n=44100, rate=44100):
    t = np.arange(n) / rate
    return np.stack([0.5 * np.sin(2 * np.pi * 440 * t), 0.5 * np.sin(2 * np.pi * 660 * t)], 1)


def _noise(seed, n=30000):
    return np.clip(0.4 * np.random.RandomState(seed).randn(n, 2), -0.9, 0.9)


class TestFfmpegWriteFallback:
    def test_format_table_requires_ffmpeg(self, monkeypatch, tmp_path, no_lossy_libs):
        monkeypatch.setenv("PATH", str(tmp_path))  # nothing on PATH
        assert not codecs.check_format("OGG", "VORBIS")
        assert not codecs.check_format("MP3", "MPEG_LAYER_III")
        with pytest.raises(TypeError):
            Result("out.ogg", "VORBIS")

    def test_ogg_write_falls_back_to_ffmpeg(self, fake_ffmpeg, tmp_path, no_lossy_libs):
        assert codecs.check_format("OGG", "VORBIS")
        result = Result(str(tmp_path / "out.ogg"), "VORBIS")
        audio = _noise(1, 44100)
        codecs.write(result.file, audio, 44100, result.subtype)
        decoded, sr = codecs.read(result.file)
        assert sr == 44100
        np.testing.assert_allclose(decoded, audio, atol=1e-12)

    @pytest.mark.parametrize("name, subtype", [("x.mp3", "MPEG_LAYER_III"), ("x.caf", "PCM_24")])
    def test_other_ffmpeg_formats_accepted(self, fake_ffmpeg, tmp_path, name, subtype, no_lossy_libs):
        result = Result(str(tmp_path / name), subtype)
        codecs.write(result.file, np.zeros((1000, 2)), 44100, result.subtype)
        assert os.path.getsize(result.file) > 0

    def test_bad_subtype_rejected(self, fake_ffmpeg):
        with pytest.raises(TypeError):
            Result("out.ogg", "PCM_16")  # OGG carries VORBIS only

    def test_loader_transcodes_unknown_container(self, fake_ffmpeg, tmp_path):
        """An unknown container goes through ffmpeg into a staging WAV in
        the temp folder, fires the lossy advisory and leaves no file."""
        src = str(tmp_path / "in.wav")
        wav.write(src, _noise(2, 5000), 44100, "PCM_16")
        odd = str(tmp_path / "in.xyz")
        with open(odd, "wb") as f:  # junk before the WAV: no magic matches
            f.write(b"JUNK" + open(src, "rb").read())
        fake_ffmpeg.write_text(  # a "transcoder" that drops the junk
            "#!%s\nimport sys\nargs = sys.argv[1:]\n"
            "data = open(args[args.index('-i') + 1], 'rb').read()[4:]\n"
            "open(args[-1], 'wb').write(data)\n" % sys.executable
        )
        staging = tmp_path / "staging"
        staging.mkdir()
        seen = []
        mt.log(warning_handler=seen.append, show_codes=True)
        try:
            audio, rate = mt.load(odd, "target", str(staging))
        finally:
            mt.log()
        want, _ = wav.read(src)
        assert rate == 44100
        np.testing.assert_array_equal(audio, want)
        assert any(str(int(mt.Code.WARNING_TARGET_IS_LOSSY)) in str(m) for m in seen), seen
        assert not list(staging.iterdir())


class TestNativeLossyCodecs:
    """OGG/Vorbis and MP3 read and write with no ffmpeg binary, through the
    system libraries; the lossy-source advisories still fire."""

    @staticmethod
    def _aligned_snr(want, got):
        best, delay = np.inf, 0
        probe = want[2000:10000]
        for lag in range(0, 5000):
            seg = got[lag + 2000 : lag + 10000]
            if len(seg) < len(probe):
                break
            e = float(np.sum((seg - probe) ** 2))
            if e < best:
                best, delay = e, lag
        m = min(len(got) - delay, len(want))
        err = got[delay : delay + m] - want[:m]
        return 10 * np.log10(np.sum(want[:m] ** 2) / np.sum(err**2))

    def test_ogg_roundtrip_without_ffmpeg(self, tmp_path, monkeypatch):
        if not vorbislib.available():
            pytest.skip("libvorbis not on this host")
        monkeypatch.setenv("PATH", str(tmp_path))
        audio = _sine_pair()
        path = str(tmp_path / "rt.ogg")
        codecs.write(path, audio, 44100, "VORBIS")
        decoded, sr = codecs.read(path)
        assert sr == 44100 and decoded.shape[1] == 2
        assert self._aligned_snr(audio, decoded) > 15.0

    def test_mp3_roundtrip_without_ffmpeg(self, tmp_path, monkeypatch):
        if not (mp3lib.available() and mp3lib.write_available()):
            pytest.skip("libmpg123/libmp3lame not on this host")
        monkeypatch.setenv("PATH", str(tmp_path))
        audio = _sine_pair()
        path = str(tmp_path / "rt.mp3")
        codecs.write(path, audio, 44100, "MPEG_LAYER_III")
        decoded, sr = codecs.read(path)
        assert sr == 44100 and decoded.shape[1] == 2
        assert self._aligned_snr(audio, decoded) > 40.0

    @pytest.mark.parametrize(
        "role, expect_code",
        [("target", "WARNING_TARGET_IS_LOSSY"), ("reference", "INFO_REFERENCE_IS_LOSSY")],
    )
    @pytest.mark.parametrize("ext, subtype", [("ogg", "VORBIS"), ("mp3", "MPEG_LAYER_III")])
    def test_loader_advisory_fires_for_native_lossy(
        self, tmp_path, monkeypatch, role, expect_code, ext, subtype
    ):
        if not codecs.check_format(ext, subtype):
            pytest.skip(f"no {ext} encoder on this host")
        monkeypatch.setenv("PATH", str(tmp_path))  # no ffmpeg anywhere
        path = str(tmp_path / f"in.{ext}")
        codecs.write(path, _sine_pair(), 44100, subtype)
        seen = []
        mt.log(
            warning_handler=lambda m: seen.append(("w", m)),
            info_handler=lambda m: seen.append(("i", m)),
            show_codes=True,
        )
        try:
            decoded, sr = mt.load(path, role, str(tmp_path))
        finally:
            mt.log()
        assert sr == 44100 and decoded.shape[0] > 0
        code = getattr(mt.Code, expect_code)
        assert any(str(int(code)) in str(m) for _, m in seen), seen

    def test_lossless_source_fires_no_advisory(self, tmp_path):
        path = str(tmp_path / "in.flac")
        codecs.write(path, _noise(3), 44100, "PCM_16")
        seen = []
        mt.log(warning_handler=seen.append, info_handler=seen.append, show_codes=True)
        try:
            mt.load(path, "target", str(tmp_path))
        finally:
            mt.log()
        assert not seen

    def test_unavailable_libs_degrade_to_unknown_format(self, tmp_path, no_lossy_libs):
        path = str(tmp_path / "x.ogg")
        with open(path, "wb") as f:
            f.write(b"OggS" + b"\x00" * 64)
        with pytest.raises(RuntimeError, match="unknown format"):
            codecs.read(path)


class TestFlacStreaminfoEdges:
    """STREAMINFO's total_samples is advisory: 0 (unknown length) decodes
    through the growing buffer, and an absurd claim allocates no more."""

    @staticmethod
    def _patched_flac(tmp_path, total_samples_bytes):
        audio = _noise(4)
        path = str(tmp_path / "edge.flac")
        native.write_flac(path, np.ascontiguousarray(audio), 44100, "PCM_16")
        blob = bytearray(open(path, "rb").read())
        blob[21] = (blob[21] & 0xF0) | total_samples_bytes[0]
        blob[22:26] = bytes(total_samples_bytes[1:])
        open(path, "wb").write(bytes(blob))
        return path, audio

    def test_unknown_length_decodes(self, tmp_path):
        path, audio = self._patched_flac(tmp_path, [0, 0, 0, 0, 0])
        decoded, sr = native.read_flac(path)
        assert sr == 44100 and decoded.shape == audio.shape
        np.testing.assert_allclose(decoded, audio, atol=2.0 / (1 << 15))

    def test_absurd_claimed_length_bounded(self, tmp_path):
        path, audio = self._patched_flac(tmp_path, [0x0F, 0xFF, 0xFF, 0xFF, 0xFF])
        decoded, sr = native.read_flac(path)
        assert sr == 44100 and decoded.shape == audio.shape
        np.testing.assert_allclose(decoded, audio, atol=2.0 / (1 << 15))


class TestNativeAutoBuild:
    def test_flac_codec_builds_on_first_use(self, fresh_native, tmp_path):
        assert native.available()  # runs g++ into the fresh build folder
        assert os.path.dirname(native._lib_path()) == str(fresh_native)
        assert os.path.exists(native._lib_path())
        assert [p.name for p in fresh_native.iterdir()] == [native_build.library_name()]
        out = str(tmp_path / "x.flac")
        audio = _noise(5, 5000)
        native.write_flac(out, np.ascontiguousarray(audio), 44100, "PCM_16")
        decoded, sr = codecs.read(out)
        assert sr == 44100 and decoded.shape == audio.shape

    def test_autobuild_opt_out(self, fresh_native, monkeypatch, tmp_path):
        monkeypatch.setenv(native.NO_AUTOBUILD_ENV, "1")
        assert not native.available()
        assert not os.path.exists(fresh_native)
        assert not codecs.check_format("FLAC", "PCM_16")
        # WAV still writes, through numpy
        path = str(tmp_path / "n.wav")
        codecs.write(path, _noise(6, 1000), 44100, "PCM_16")
        assert codecs.read(path)[0].shape == (1000, 2)

    def test_failed_build_is_reported(self, fresh_native, monkeypatch, tmp_path):
        """No compiler: the build fails, a debug line says so, and FLAC is
        refused."""
        monkeypatch.setenv("PATH", str(tmp_path))  # no g++
        lines = []
        mt.log(debug_handler=lambda *parts: lines.append(" ".join(map(str, parts))))
        try:
            assert not native.available()
        finally:
            mt.log()
        assert any("native codec build failed" in line for line in lines), lines
        with pytest.raises(TypeError):
            Result("x.flac", "PCM_16")

    def test_library_is_the_ports_own(self):
        assert native.available()
        path = native._lib_path()
        assert os.path.dirname(path) == native_build.BUILD_DIR
        assert os.path.dirname(path) != os.path.dirname(jnative._lib_path())


class TestJaxParity:
    @pytest.fixture(autouse=True)
    def _both_codecs(self):
        assert native.available(), "the port's native codec must build here (g++)"
        if not jnative.available():
            pytest.skip("the JAX package's native codec is not built")

    @pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24"])
    def test_flac_bytes_match_jax(self, tmp_path, subtype):
        x = np.random.RandomState(len(subtype)).uniform(-1.1, 1.1, (12345, 2))
        jcodecs.write(str(tmp_path / "j.flac"), x, 48000, subtype)
        codecs.write(str(tmp_path / "p.flac"), x, 48000, subtype)
        assert (tmp_path / "p.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()

    @pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "PCM_32", "FLOAT"])
    def test_native_wav_bytes_match_jax(self, tmp_path, subtype):
        x = np.random.RandomState(7).uniform(-1.1, 1.1, (4321, 2))
        jcodecs.write(str(tmp_path / "j.wav"), x, 44100, subtype)
        codecs.write(str(tmp_path / "p.wav"), x, 44100, subtype)
        assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()

    @pytest.mark.parametrize(
        "ext, subtype",
        [("wav", "PCM_16"), ("wav", "PCM_24"), ("flac", "PCM_16"), ("flac", "PCM_24"),
         ("ogg", "VORBIS"), ("mp3", "MPEG_LAYER_III"), ("opus", "OPUS")],
    )
    def test_decode_matches_jax(self, tmp_path, ext, subtype):
        if not jcodecs.check_format(ext, subtype):
            pytest.skip(f"no {ext} encoder on this host")
        path = str(tmp_path / f"j.{ext}")
        jcodecs.write(path, _sine_pair(20000, 48000), 48000, subtype)
        want, want_rate = jcodecs.read(path)
        got, got_rate = codecs.read(path)
        assert got_rate == want_rate
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    def test_opus_bytes_match_jax_at_48k(self, tmp_path):
        if not opuslib.write_available():
            pytest.skip("libopus encoder not present on this host")
        x = _sine_pair(24000, 48000)
        jcodecs.write(str(tmp_path / "j.opus"), x, 48000, "OPUS")
        codecs.write(str(tmp_path / "p.opus"), x, 48000, "OPUS")
        assert (tmp_path / "p.opus").read_bytes() == (tmp_path / "j.opus").read_bytes()

    def test_native_wav_matches_numpy(self, tmp_path):
        """The native reader equals the numpy reader on native-written
        files, and the native writer's codes equal the numpy writer's
        (tests/test_host_shell.py:34-44 holds the JAX pair to the first)."""
        x = np.clip(np.random.RandomState(8).randn(777, 2) * 0.5, -1, 1)
        for subtype in ("PCM_16", "PCM_24", "PCM_32", "FLOAT"):
            path, plain = str(tmp_path / "n.wav"), str(tmp_path / "p.wav")
            native.write_wav(path, np.ascontiguousarray(x), 44100, subtype)
            wav.write(plain, x, 44100, subtype)
            y_native, sr1 = native.read_wav(path)
            y_numpy, sr2 = wav.read(path)
            assert sr1 == sr2 == 44100
            np.testing.assert_array_equal(y_native, y_numpy)
            codes, _ = wav.read(path, raw_int=True)
            plain_codes, _ = wav.read(plain, raw_int=True)
            assert np.max(np.abs(codes.astype(np.float64) - plain_codes)) <= 1


class TestOpusRead:
    @pytest.fixture(autouse=True)
    def _need_libopus(self):
        if not opuslib.available():
            pytest.skip("libopus not present on this host")

    def test_decode_sine(self, tmp_path):
        x = _sine_pair(48000 * 2, 48000)
        path = str(tmp_path / "tone.opus")
        _encode_oggopus(path, x)
        assert opuslib.is_opus(path)
        y, sr = codecs.read(path)  # dispatch must pick opus, not vorbis
        assert sr == 48000 and y.shape == x.shape
        for c in range(2):
            a, b = x[:, c], y[:, c]
            corr = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
            assert corr > 0.97, f"channel {c} correlation {corr}"

    def test_lossy_advisory_and_loader(self, tmp_path):
        t = np.arange(24000) / 48000.0
        x = np.stack([0.3 * np.sin(2 * np.pi * 220 * t)] * 2, axis=1)
        path = str(tmp_path / "up.opus")
        _encode_oggopus(path, x)
        assert codecs.is_lossy_container(path)
        y, sr = mt.load(path, "target", str(tmp_path))
        assert sr == 48000 and y.shape[0] == x.shape[0]

    def test_mono(self, tmp_path):
        t = np.arange(9600) / 48000.0
        x = (0.4 * np.sin(2 * np.pi * 330 * t))[:, None]
        path = str(tmp_path / "mono.opus")
        _encode_oggopus(path, x)
        y, sr = opuslib.read_opus(path)
        assert y.shape == x.shape and sr == 48000


class TestOpusWrite:
    @pytest.fixture(autouse=True)
    def _need_encoder(self):
        if not opuslib.write_available():
            pytest.skip("libopus encoder not present on this host")

    def test_roundtrip_48k(self, tmp_path):
        x = _sine_pair(2 * 48000, 48000)
        path = str(tmp_path / "rt.opus")
        opuslib.write_opus(path, x, 48000)
        y, rate = opuslib.read_opus(path)
        assert rate == 48000 and y.shape == x.shape
        snr = 10 * np.log10(np.sum(x**2) / np.sum((x - y) ** 2))
        assert snr > 25.0, snr

    def test_44k_input_resamples_to_48k(self, tmp_path):
        """Write-side resampling runs the port's resampler (on the host)."""
        sr = 44100
        x = np.stack([0.4 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)] * 2, 1)
        path = str(tmp_path / "rt44.opus")
        opuslib.write_opus(path, x, sr)
        y, rate = opuslib.read_opus(path)
        assert rate == 48000 and y.shape[0] == sr * 48000 // 44100

    def test_ogg_crc_matches_libogg(self, tmp_path):
        import struct

        if not vorbislib.available():
            pytest.skip("libvorbis/libogg not present")
        sr = 44100
        x = np.stack([0.3 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)] * 2, 1)
        path = str(tmp_path / "crc.ogg")
        vorbislib.write_ogg(path, x, sr)
        buf = open(path, "rb").read()
        pos, checked = 0, 0
        while pos + 27 <= len(buf) and buf[pos : pos + 4] == b"OggS":
            nsegs = buf[pos + 26]
            body_len = sum(buf[pos + 27 : pos + 27 + nsegs])
            page = bytearray(buf[pos : pos + 27 + nsegs + body_len])
            stored = struct.unpack_from("<I", page, 22)[0]
            struct.pack_into("<I", page, 22, 0)
            assert opuslib._ogg_crc(bytes(page)) == stored
            assert _ogg_crc_bytewise(bytes(page)) == stored
            checked += 1
            pos += 27 + nsegs + body_len
        assert checked >= 3

    def test_codecs_dispatch_and_result_spec(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PATH", str(tmp_path))
        assert codecs.check_format("OPUS", "OPUS")
        r = Result(str(tmp_path / "master.opus"), "OPUS")
        x = np.zeros((48000, 2))
        x[:, 0] = 0.1 * np.sin(2 * np.pi * 330 * np.arange(48000) / 48000)
        codecs.write(r.file, x, 48000, r.subtype)
        y, sr = codecs.read(r.file)
        assert sr == 48000 and y.shape == x.shape


    def test_failing_encoder_ctl_raises(self, tmp_path, monkeypatch):
        """A nonzero return of ``opus_encoder_ctl`` (here the lookahead
        query, which would leave pre_skip 0 and shift the audio by the
        encoder's delay) raises instead of writing a file."""
        lib = opuslib._load()
        real = lib.opus_encoder_ctl

        def ctl(enc, request, argument):
            return -1 if request == opuslib._OPUS_GET_LOOKAHEAD else real(enc, request, argument)

        monkeypatch.setattr(lib, "opus_encoder_ctl", ctl)
        path = tmp_path / "bad.opus"
        with pytest.raises(RuntimeError, match="OPUS_GET_LOOKAHEAD"):
            opuslib.write_opus(str(path), _sine_pair(4800, 48000), 48000)
        assert not path.exists()


def _ogg_crc_bytewise(data: bytes) -> int:
    """Ogg's CRC-32 a byte at a time (RFC 3533 §6: polynomial 0x04c11db7,
    MSB first, init 0, no final xor): the twin of ``opus._ogg_crc``."""
    table = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7) if (r & 0x80000000) else (r << 1)
            r &= 0xFFFFFFFF
        table.append(r)
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ table[((crc >> 24) & 0xFF) ^ b]
    return crc


@pytest.mark.parametrize("size", [0, 1, 2, 3, 27, 255, 4097, 100_001])
def test_ogg_crc_matches_its_bytewise_twin(size):
    data = np.random.RandomState(size).randint(0, 256, size).astype(np.uint8).tobytes()
    assert opuslib._ogg_crc(data) == _ogg_crc_bytewise(data)


def test_ogg_crc_of_a_three_minute_opus_stream_is_fast():
    """5.76 MB, a 180 s stereo Opus at 256 kbps: under 50 ms (the
    byte-at-a-time loop took 1.33 s)."""
    import time

    data = np.random.RandomState(1).randint(0, 256, 5_760_000).astype(np.uint8).tobytes()
    opuslib._ogg_crc(data)
    best = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        opuslib._ogg_crc(data)
        best = min(best, time.perf_counter() - start)
    assert best < 0.050, best


class TestOggMuxEdges:
    def test_lacing_255_boundary_roundtrips(self):
        for length in (0, 1, 254, 255, 256, 510, 1000):
            pkt = (bytes(range(256)) * 4)[:length]
            page = opuslib._ogg_page([pkt], 7, 42, 0, 0x02)
            packets, granule = opuslib._demux_ogg(page)
            assert packets == [pkt], length
            assert granule == 7

    def test_multi_packet_page_roundtrip(self):
        pkts = [b"a" * 10, b"b" * 255, b"c" * 300, b""]
        page = opuslib._ogg_page(pkts, 99, 1, 3, 0x00)
        got, granule = opuslib._demux_ogg(page)
        assert got == pkts and granule == 99


def test_process_writes_flac_within_one_step_of_wav(tmp_path):
    """``process()`` with a FLAC target and a FLAC PCM_24 result: the same
    PCM_24 codes as the run from WAV, within one step."""
    sr = 44100
    target = _noise(9, 5 * sr) * 0.5
    reference = np.clip(_noise(10, 6 * sr) * 2.0, -0.98, 0.98)
    for ext in ("wav", "flac"):
        codecs.write(str(tmp_path / f"t.{ext}"), target, sr, "PCM_24")
    codecs.write(str(tmp_path / "r.wav"), reference, sr, "PCM_24")
    config = mt.Config(dtype="float64", fft_size=1024)  # small operators: the codecs are the point
    mt.process(str(tmp_path / "t.wav"), str(tmp_path / "r.wav"),
               [mt.pcm24(str(tmp_path / "o.wav"))], config, device="cpu")
    mt.process(str(tmp_path / "t.flac"), str(tmp_path / "r.wav"),
               [mt.pcm24(str(tmp_path / "o.flac"))], config, device="cpu")
    from_wav, _ = codecs.read(str(tmp_path / "o.wav"))
    from_flac, rate = codecs.read(str(tmp_path / "o.flac"))
    assert rate == sr and from_flac.shape == from_wav.shape == (5 * sr, 2)
    assert np.max(np.abs(from_flac - from_wav)) * 2**23 <= 1.0
