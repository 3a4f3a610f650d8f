"""The port's kernels K1 (limiter front end), K2 (first-order IIR scan) and
K4 (limiter back end) through their plain twins on the CPU, and the
wrappers of all four (K3, the second-order-section scan, is held to scipy
and modelled in ``test_torch_configs.py``).

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` holds
each against its twin there.  Here the twins are held against the JAX
package (K1's Pallas kernel in interpret mode) and scipy at float64, K4's
twin against the limiter's former unfused back end bit for bit, the
wrappers' host arithmetic (scratch, pole powers, window checks) against
numpy, and
numpy models of the kernels' decompositions against the twins; the wrappers
are checked to import without ``nvcc`` and to raise, never fall back to the
twin, when asked to launch without a kernel library.
"""

import re
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

import matchering_tpu.ops.pallas_envelope as pe
from matchering_tpu.ops import iir as jiir
from matchering_tpu_torch import Config, stages
from matchering_tpu_torch.kernels import back_end, build, envelope, scan, sos
from matchering_tpu_torch.ops import basics, iir
from matchering_tpu_torch.utils import RowInts

THRESHOLD = 0.998138427734375  # Config().threshold
FS = 44100

# the limiter's three default poles (Config().limiter, hyrax.py:48-75)
FILTERS = {
    "attack": (iir.one_pole_filter(-2.0, 44), jiir.one_pole_filter(-2.0, 44)),
    "hold": (iir.butter1_coefficients(7.0, FS), jiir.butter1_coefficients(7.0, FS)),
    "release": (
        iir.butter1_coefficients(800.0 / 3000.0, FS),
        jiir.butter1_coefficients(800.0 / 3000.0, FS),
    ),
}


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def interpreted():
    """Run pallas_call in interpreter mode (the pattern of test_pallas.py)."""
    orig = pe.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    with mock.patch.object(pe.pl, "pallas_call", interp):
        yield


class TestEnvelopeTwin:
    @pytest.mark.parametrize("n", [33000, 70001])
    def test_matches_pallas_kernel(self, interpreted, rng, n):
        x = rng.randn(n, 2) * 0.6
        gain, slided = envelope.limiter_front_end(t(x), THRESHOLD, 44)
        jgain, jslided = pe.limiter_front_end(jnp.asarray(x), THRESHOLD, 44)
        np.testing.assert_allclose(gain.numpy(), np.asarray(jgain), rtol=0, atol=1e-12)
        np.testing.assert_allclose(slided.numpy(), np.asarray(jslided), rtol=0, atol=1e-12)

    def test_quiet_signal_zero_gain(self, rng):
        gain, slided = envelope.limiter_front_end(t(rng.randn(5000, 2) * 0.1), THRESHOLD, 44)
        assert float(gain.abs().max()) == 0.0 and float(slided.abs().max()) == 0.0


class TestScanTwin:
    @pytest.mark.parametrize("pole", sorted(FILTERS))
    def test_lfilter_matches_jax_and_scipy(self, rng, pole):
        filt, jfilt = FILTERS[pole]
        x = rng.rand(20_000)
        got = iir.lfilter_first_order(filt, t(x), zi=t(np.array([0.3]))).numpy()
        want = np.asarray(jiir.lfilter_first_order(jfilt, jnp.asarray(x), zi=0.3))
        ref, _ = signal.lfilter([filt.b0, filt.b1], [1.0, filt.a1], x, zi=[0.3])
        np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)

    @pytest.mark.parametrize("pole", sorted(FILTERS))
    def test_filtfilt_matches_jax_and_scipy(self, rng, pole):
        filt, jfilt = FILTERS[pole]
        x = rng.rand(20_001)
        got = iir.filtfilt_first_order(filt, t(x)).numpy()
        want = np.asarray(jiir.filtfilt_first_order(jfilt, jnp.asarray(x)))
        ref = signal.filtfilt([filt.b0, filt.b1], [1.0, filt.a1], x)
        np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)

    @pytest.mark.parametrize("n", [1, 200, 256, 257, 70_001])
    def test_rows_and_reverse(self, rng, n):
        filt = FILTERS["release"][0]
        b, a = [filt.b0, filt.b1], [1.0, filt.a1]
        x = rng.rand(3, n)
        zi = rng.rand(3)
        forward = scan.first_order_filter(t(x), *filt, zi=t(zi)).numpy()
        backward = scan.first_order_filter(t(x), *filt, zi=t(zi), reverse=True).numpy()
        for r in range(3):
            ref, _ = signal.lfilter(b, a, x[r], zi=[zi[r]])
            np.testing.assert_allclose(forward[r], ref, rtol=1e-11, atol=1e-12)
            ref, _ = signal.lfilter(b, a, x[r, ::-1], zi=[zi[r]])
            np.testing.assert_allclose(backward[r], ref[::-1], rtol=1e-11, atol=1e-12)

    def test_float32_io_keeps_float64_state(self, rng):
        filt = FILTERS["release"][0]
        x = rng.rand(50_000)
        got = scan.first_order_filter(t(x.astype(np.float32)), *filt)
        assert got.dtype == torch.float32
        ref, _ = signal.lfilter(
            [filt.b0, filt.b1], [1.0, filt.a1], x.astype(np.float32).astype(np.float64),
            zi=[0.0],
        )
        # only the final rounding to float32 separates the two
        np.testing.assert_allclose(got.numpy(), ref, rtol=2**-23, atol=0)


class TestKernelWrappers:
    def test_modules_import_without_nvcc(self, monkeypatch, tmp_path):
        import importlib

        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        for module in (build, envelope, scan, sos, back_end):
            importlib.reload(module)
        with pytest.raises(RuntimeError, match="nvcc"):
            build._nvcc()

    @pytest.mark.parametrize("kernel", ["envelope", "scan", "sos", "back_end"])
    def test_cuda_tensor_raises_instead_of_running_the_twin(
        self, monkeypatch, tmp_path, kernel
    ):
        """A CUDA tensor goes to the kernel: without a kernel library the
        wrapper raises, and the twin is never called."""

        def no_nvcc():
            raise RuntimeError("nvcc not found")

        monkeypatch.setattr(build, "_library", None)
        monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(build, "_nvcc", no_nvcc)
        fake = mock.MagicMock(spec=torch.Tensor)
        fake.device = torch.device("cuda", 0)
        fake.dtype = torch.float32
        fake.ndim = 2
        fake.shape = (4096, 2)
        fake.is_contiguous.return_value = True
        twin = mock.MagicMock()
        if kernel == "envelope":
            monkeypatch.setattr(envelope, "limiter_front_end_plain", twin)
            call = lambda: envelope.limiter_front_end(fake, THRESHOLD, 44)  # noqa: E731
        elif kernel == "scan":
            monkeypatch.setattr(scan, "first_order_filter_plain", twin)
            call = lambda: scan.first_order_filter(fake, 0.5, 0.0, -0.5)  # noqa: E731
        elif kernel == "sos":
            monkeypatch.setattr(sos, "sos_filter_plain", twin)
            call = lambda: sos.sos_filter(fake, 0.25, 0.5, 0.25, -0.5, 0.1)  # noqa: E731
        else:
            monkeypatch.setattr(back_end, "limiter_back_end_plain", twin)
            gain = mock.MagicMock(spec=torch.Tensor)
            gain.device, gain.dtype, gain.shape = fake.device, fake.dtype, (4096,)
            gain.contiguous.return_value = gain
            flag = mock.MagicMock(spec=torch.Tensor)
            flag.device, flag.dtype = fake.device, torch.bool
            flag.numel.return_value = 1
            flag.reshape.return_value = flag
            flag.contiguous.return_value = flag
            call = lambda: back_end.limiter_back_end(fake, gain, gain, gain, gain, flag)  # noqa: E731
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
        twin.assert_not_called()

    def test_library_checks_the_mirrored_constants(self, monkeypatch, tmp_path):
        """The kernels' tiling constants are compared with the wrappers'
        Python copies once, when the library loads."""
        monkeypatch.setattr(build, "_library", None)
        monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
        digest = build._source_hash(build.sources((".cu", ".cuh")))
        (tmp_path / f"libmtpu_kernels_{digest}.so").touch()
        lib = mock.MagicMock()
        modules = {"envelope": envelope, "scan": scan, "sos": sos}
        for name, (module, attribute) in build._CONSTANTS.items():
            getattr(lib, name).return_value = getattr(modules[module], attribute)
        monkeypatch.setattr(build.ctypes, "CDLL", mock.MagicMock(return_value=lib))
        assert build.library() is lib
        monkeypatch.setattr(build, "_library", None)
        lib.mtpu_scan_tile.return_value = 2 * scan.TILE
        with pytest.raises(RuntimeError, match="scan.TILE"):
            build.library()

    def test_c_entry_points_match_the_signatures(self):
        """Every C entry point the wrappers bind takes the parameters, in
        number and kind, that ``build._SIGNATURES`` declares for ctypes."""
        text = "".join(open(path).read() for path in build.sources((".cu", ".cuh")))
        kinds = {"int": build._I, "long long": build._LL, "double": build._D}
        for name, (restype, argtypes) in build._SIGNATURES.items():
            found = re.findall(rf"\bint {name}\(([^)]*)\)", text)
            assert len(found) == 1, name
            params = [p.split() for p in found[0].split(",") if p.strip()]
            declared = [
                build._P if "*" in "".join(words) else kinds[" ".join(words[:-1])] for words in params
            ]
            assert (restype, declared) == (build._I, argtypes), name

    def test_every_c_entry_point_is_bound(self):
        """Every ``extern "C"`` entry point of the kernels' ``.cu`` sources
        has its ctypes signature in ``build._SIGNATURES`` (K4's among them;
        ``trace.cuh``'s entry exists only in the tracing tool's builds)."""
        text = "".join(open(path).read() for path in build.sources())
        defined = set(re.findall(r"\bint (mtpu_\w+)\(", text))
        assert {"mtpu_back_end_f32", "mtpu_back_end_f64", "mtpu_back_end_info"} <= defined
        assert defined == set(build._SIGNATURES)


class TestKernelTiling:
    """The host arithmetic the kernel wrappers hand to the kernels."""

    @pytest.mark.parametrize("n", [1, 63, 4096, 4097, 7_938_000])
    def test_scan_geometry(self, n):
        """One status pair per tile of TILE = RUN threads x 2**TILE_LOG
        samples, and the tile counter."""
        assert (scan.RUN, scan.TILE) == (16, 16 << scan.TILE_LOG) == (16, 4096)
        tiles = int(np.ceil(n / np.float64(scan.TILE)))
        assert (tiles - 1) * scan.TILE < n <= tiles * scan.TILE
        assert scan.scratch_words(1, n) == 2 * tiles + 1

    @pytest.mark.parametrize("rows", [1, 3])
    def test_scan_scratch_words(self, rows):
        for n, tiles in [(1, 1), (4096, 1), (4097, 2), (7_938_000, 1938)]:
            assert scan.scratch_words(rows, n) == 2 * rows * tiles + 1

    @pytest.mark.parametrize("pole", sorted(FILTERS))
    def test_pole_powers(self, pole):
        p = FILTERS[pole][0].pole
        powers = np.array(scan.pole_powers(p))
        exponents = scan.RUN * 2 ** np.arange(scan.POWERS)
        # against extended precision, rounded once to float64
        want = np.power(np.longdouble(p), exponents.astype(np.longdouble)).astype(np.float64)
        np.testing.assert_allclose(powers, want, rtol=1e-15, atol=0)
        assert powers[scan.TILE_LOG] == np.float64(np.longdouble(p) ** scan.TILE)  # p^TILE

    @pytest.mark.parametrize(
        "window, fits", [(1, True), (89, True), (2049, True), (0, False), (2051, False), (4097, False)]
    )
    def test_envelope_window_check(self, window, fits):
        if not fits:
            with pytest.raises(ValueError, match="halo"):
                envelope.check_window(10_000, window)
            return
        assert window - 1 <= envelope.MAX_HALO == 2048
        envelope.check_window(window, window)
        envelope.check_window(10_000, window)
        with pytest.raises(ValueError, match="shorter"):
            envelope.check_window(window - 1, window)

    def test_envelope_window_must_fit_the_halo(self, monkeypatch):
        """A CUDA tensor's window is checked before the kernel is built."""
        monkeypatch.setattr(build, "library", mock.MagicMock(side_effect=AssertionError))
        fake = mock.MagicMock(spec=torch.Tensor)
        fake.device = torch.device("cuda", 0)
        fake.dtype = torch.float32
        fake.ndim = 2
        fake.is_contiguous.return_value = True
        fake.shape = (10_000, 2)
        assert envelope.window_for(1100) - 1 > envelope.MAX_HALO
        with pytest.raises(ValueError, match="halo"):
            envelope.limiter_front_end(fake, THRESHOLD, 1100)
        fake.shape = (88, 2)
        with pytest.raises(ValueError, match="shorter"):
            envelope.limiter_front_end(fake, THRESHOLD, 44)
        build.library.assert_not_called()


def _scan_model(x, b0, b1, pole, zi, powers):
    """csrc/scan.cu's arithmetic for one row, tile by tile in numpy float64:
    runs scanned from zero, the warp-shuffle and warp scans with
    powers[:TILE_LOG], look-back over every earlier tile's aggregate (the
    longest walk, 32 tiles a step: lane l takes tiles l, l + 32, ... back,
    weighted by powers[TILE_LOG:]), then each run rescanned from its
    carried-in state."""
    run, tile = scan.RUN, scan.TILE
    threads = tile // run
    lanes = np.arange(32)

    def power(first, bits, e):
        return np.prod([np.where((e >> k) & 1, powers[first + k], 1.0) for k in range(bits)], axis=0)

    n = len(x)
    drive = b0 * x
    drive[1:] += b1 * x[:-1]
    drive[0] += zi
    y = np.empty(n)
    aggregates = []
    for b in range(-(-n // tile)):
        part = drive[b * tile : (b + 1) * tile]
        runs = np.zeros(tile)
        runs[: len(part)] = part
        runs = runs.reshape(threads, run)
        s = np.zeros(threads)
        for r in range(run):
            s = runs[:, r] + pole * s
        inclusive = s.reshape(-1, 32)
        for k in range(5):
            d = 1 << k
            other = np.zeros_like(inclusive)
            other[:, d:] = inclusive[:, :-d]
            inclusive = inclusive + np.where(lanes >= d, powers[k] * other, 0.0)
        exclusive = np.zeros_like(inclusive)
        exclusive[:, 1:] = inclusive[:, :-1]
        w = inclusive[:, 31].copy()
        warps = np.arange(len(w))
        for k in range(scan.TILE_LOG - 5):
            d = 1 << k
            other = np.zeros_like(w)
            other[d:] = w[:-d]
            w = w + np.where(warps >= d, powers[5 + k] * other, 0.0)
        carry = 0.0
        if b > 0:  # tile 0's prefix is its aggregate: the term at d = b - 1
            d = np.arange(b)
            weight = power(scan.TILE_LOG, 5, d % 32) * powers[scan.TILE_LOG + 5] ** (d // 32)
            carry = np.sum(weight * np.array(aggregates[::-1]))
        aggregates.append(w[-1])
        before = np.concatenate([[0.0], w[:-1]])
        entry = exclusive + power(0, 5, lanes) * (before + power(5, scan.TILE_LOG - 5, warps) * carry)[:, None]
        out = np.empty_like(runs)
        state = entry.reshape(-1)
        for r in range(run):
            state = runs[:, r] + pole * state
            out[:, r] = state
        y[b * tile : (b + 1) * tile] = out.reshape(-1)[: len(part)]
    return y


def _window_max_model(g, window):
    """csrc/envelope.cu's window maxima over one block's span of gains:
    per run of RUN outputs the shared middle, the left suffix maxima and
    the right prefix maxima (the plain loop below RUN)."""
    run = envelope.RUN
    out = np.empty(len(g) - window + 1)
    for base in range(0, len(out), run):
        k = np.arange(min(run, len(out) - base))
        if window >= run:
            middle = g[base + run - 1 : base + window].max()
            left = np.maximum.accumulate(g[base : base + run - 1][::-1])[::-1]
            right = np.maximum.accumulate(g[base + window : base + window + run - 1])
            left = np.append(left, middle)
            right = np.insert(right, 0, middle)
            out[base + k] = np.maximum(np.maximum(left[k], middle), right[k])
        else:
            out[base + k] = [g[base + i : base + i + window].max() for i in k]
    return out


class TestKernelModels:
    """numpy models of the kernels' decompositions against the twins: the
    arithmetic that only the card runs, checked where a test can reach it."""

    @pytest.mark.parametrize("pole", sorted(FILTERS))
    @pytest.mark.parametrize("n", [1, 4095, 3 * 4096 + 5, 300 * 4096 + 7])
    def test_scan_decomposition(self, rng, pole, n):
        filt = FILTERS[pole][0]
        x = rng.rand(n)
        got = _scan_model(x, filt.b0, filt.b1, filt.pole, 0.3, scan.pole_powers(filt.pole))
        ref, _ = signal.lfilter([filt.b0, filt.b1], [1.0, filt.a1], x, zi=[0.3])
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)

    @pytest.mark.parametrize("attack", [44, 3, 1])
    @pytest.mark.parametrize("n", [89, 8193, 3 * 8192 + 7])
    def test_window_max_decomposition(self, rng, attack, n):
        """The model's spans, edges and maxima equal the twin exactly."""
        x = rng.randn(n, 2) * 0.8
        window = envelope.window_for(attack)
        half = window // 2
        gain, slided = envelope.limiter_front_end_plain(t(x), THRESHOLD, attack)
        gain = gain.numpy()
        out = np.empty(n)
        for start in range(0, n, envelope.TILE):
            j = np.arange(start - half, start + envelope.TILE + window - 1 - half)
            inside = j < n + half
            mirrored = np.where(j < 0, -j - 1, np.where(j >= n, 2 * n - j - 1, j))
            g = np.where(inside, gain[np.clip(mirrored, 0, n - 1)], 0.0)
            out[start : start + envelope.TILE] = _window_max_model(g, window)[: n - start]
        np.testing.assert_array_equal(out, slided.numpy())


# --- K4, the limiter back end -------------------------------------------------

BACK_END_ROWS = 3
BACK_END_PASSES = torch.tensor([False, True, False])  # row 1 passes unlimited


def _back_end_inputs(dtype, n=1001, nan=False):
    """A batch of three rows, its four gains (quantised to eighths in half
    of each row, so the maxima tie and meet 0), and with ``nan`` a NaN in
    a gain of every row: row 0 inside its length, row 2 past it."""
    r = np.random.RandomState(7)
    x = r.randn(BACK_END_ROWS, n, 2) * 0.7
    gains = []
    for _ in range(4):
        g = r.rand(BACK_END_ROWS, n)
        g[:, : n // 2] = np.floor(g[:, : n // 2] * 8) / 8
        gains.append(g)
    if nan:
        gains[2][0, 10] = np.nan  # hold
        gains[1][1, 3] = np.nan  # attack, on the row that passes
        gains[3][2, n - 1] = np.nan  # release, past row 2's length
    return t(x).to(dtype), [t(g).to(dtype) for g in gains]


def _back_end_lengths(n):
    """Row 0 full, row 1 at the limiter's shortest length, row 2 odd."""
    return RowInts.of([n, stages.minimum_length(Config()), n // 2 - 1], "cpu")


def _former_back_end(x, hard_clip, attack, hold, release, passes, lengths, scale):
    """The limiter's back end before K4 (``limiter.limit`` and
    ``stages.master_graph``), composed as they composed it."""
    gain_release = torch.maximum(hold, release)
    gain = basics.flip(basics.max_mix(hard_clip, attack, gain_release))
    if lengths is not None:
        gain = gain * lengths.mask(x.shape[-2], gain.dtype)
    limited = torch.where(passes[..., None, None], x, x * gain[..., None])
    if scale is not None:
        limited = limited * scale[:, None, None]
    return limited


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    assert torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def _back_end_model(x, gains, passes, lengths, scale):
    """csrc/back_end.cu's arithmetic in numpy, one flat index a thread: the
    row from a float64 product by 1/n corrected one step, each gain read
    at row * its row stride + i from its storage."""
    x = x.numpy()
    rows, n = x.shape[:2]
    j = np.arange(rows * n, dtype=np.int64)
    r = _model_row(j, n)
    i = j - r * n
    a, b, c, d = (
        torch.as_strided(g, (g.untyped_storage().nbytes() // g.element_size(),), (1,), 0).numpy()[
            g.storage_offset() + r * g.stride(0) + i
        ]
        for g in gains
    )
    one, zero = x.dtype.type(1), x.dtype.type(0)
    g = one - np.maximum(np.maximum(a, b), np.maximum(c, d))
    if lengths is not None:
        g = g * np.where(i < np.asarray(lengths.host)[r], one, zero)
    flat_x = x.reshape(-1, 2)
    y = np.where(passes.numpy()[r][:, None], flat_x, flat_x * g[:, None])
    if scale is not None:
        y = y * scale.numpy()[r][:, None]
    return torch.from_numpy(y.reshape(x.shape))


def _model_row(flat, n):
    row = (flat.astype(np.float64) * (1.0 / np.float64(n))).astype(np.int64)
    return np.where(row * n > flat, row - 1, np.where((row + 1) * n <= flat, row + 1, row))


class TestBackEndTwin:
    @pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
    @pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
    @pytest.mark.parametrize("with_lengths", [False, True], ids=["static", "lengths"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
    def test_twin_equals_the_former_back_end(self, dtype, with_lengths, scaled, nan):
        """Bit for bit, with a row that passes unlimited; a NaN gain gives
        NaN on both channels as ``torch.maximum`` propagates it, past a
        row's length too (the mask is a product), and nothing on the row
        that passes."""
        n = 1001
        x, gains = _back_end_inputs(dtype, n, nan)
        lengths = _back_end_lengths(n) if with_lengths else None
        scale = torch.tensor([0.5, 1.25, 3.0], dtype=dtype) if scaled else None
        got = back_end.limiter_back_end(x, *gains, BACK_END_PASSES, lengths, scale)
        _same_bits(got, _former_back_end(x, *gains, BACK_END_PASSES, lengths, scale))
        assert got.data_ptr() != x.data_ptr()
        factor = scale if scaled else torch.ones(BACK_END_ROWS, dtype=dtype)
        _same_bits(got[1], x[1] * factor[1] if scaled else x[1])
        assert torch.isnan(got[0, 10]).all() == nan and torch.isnan(got[2, n - 1]).all() == nan
        if with_lengths and not nan:
            assert not got[2, lengths.host[2]:].any() and not got[0].isnan().any()

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
    def test_one_track_runs_as_one_row(self, dtype):
        """An (n, 2) track with (n,) gains and a 0-d flag."""
        x, gains = _back_end_inputs(dtype)
        for row in (0, 1):
            got = back_end.limiter_back_end(x[row], *(g[row] for g in gains), BACK_END_PASSES[row])
            _same_bits(got, _former_back_end(x[row:row + 1], *(g[row:row + 1] for g in gains),
                                             BACK_END_PASSES[row:row + 1], None, None)[0])

    def test_checks_its_shapes_and_lengths(self):
        x, gains = _back_end_inputs(torch.float64)
        with pytest.raises(ValueError, match="gain of shape"):
            back_end.limiter_back_end(x, gains[0][:, 1:], *gains[1:], BACK_END_PASSES)
        with pytest.raises(ValueError, match="outside"):
            back_end.limiter_back_end(x, *gains, BACK_END_PASSES, RowInts.of([1001, 1002, 5], "cpu"))
        with pytest.raises(ValueError, match="need a"):
            back_end.limiter_back_end(x[0], *(g[0] for g in gains), BACK_END_PASSES[0],
                                      RowInts.of([5], "cpu"))


class TestBackEndModel:
    """csrc/back_end.cu's flat indexing against the twin: the arithmetic
    that only the card runs, checked where a test can reach it."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
    @pytest.mark.parametrize("n", [1, 3, 5, 1001])
    def test_flat_index_equals_the_twin(self, dtype, n):
        """With the attack gain a view into rows n + 6 wide, 6 samples in,
        as the length-aware filtfilt hands it over."""
        x, gains = _back_end_inputs(dtype, n)
        wide = torch.zeros(BACK_END_ROWS, n + 6, dtype=dtype)
        wide[:, 6:] = gains[1]
        gains[1] = wide[:, 6:]
        lengths = RowInts.of([n, n // 2, max(n - 1, 0)], "cpu")
        scale = torch.tensor([0.5, 1.25, 3.0], dtype=dtype)
        for args in ((None, None), (lengths, scale)):
            want = back_end.limiter_back_end(x, *gains, BACK_END_PASSES, *args)
            _same_bits(_back_end_model(x, gains, BACK_END_PASSES, *args), want)

    @pytest.mark.parametrize(
        "rows, n", [(1, 345_600_000), (16, 18_350_080), (16, 18_350_081), (3, 1001), (7, 3)]
    )
    def test_row_of_a_flat_index(self, rows, n):
        """The float64 product by 1/n, corrected one step, is the row of a
        flat index at the long form's and the farm's sizes, on both sides
        of every row's start."""
        starts = np.arange(rows + 1, dtype=np.int64) * n
        flat = (starts[:, None] + np.arange(-8, 9)).reshape(-1)
        flat = np.unique(np.clip(flat, 0, rows * n - 1))
        np.testing.assert_array_equal(_model_row(flat, n), flat // n)
