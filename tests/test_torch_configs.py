"""Every ``Config`` the JAX package honours, through the port, on the CPU.

The non-default configurations: Butterworth hold/release filters of order
above 1 (scipy's second-order sections on kernel K3's plain twin),
``iir.lfilter`` at any order, and the LOWESS
smoother with robustness iterations (``lowess_it > 0``) or at every grid
point (``lowess_exact``, ``lowess_delta = 0``).

References and tolerances:

* the filters against ``scipy.signal.sosfilt`` run in long double (the
  reference semantics, ~2000x finer than float64), to 1e-9 absolute for
  inputs in [0, 1).  ``sosfilt`` in float64 is itself up to ~1e-9 off at
  the release cutoff (6.5e-10 at 200,000 samples, 9.7e-10 at 7,938,000),
  the port's twin ~4e-12;
* the JAX package's order > 1 ``butter_lowpass`` (a 2x2 ``associative_scan``
  per section, ``matchering_tpu/ops/iir.py:970-1049``) is 1.43e-4 off
  ``sosfilt`` at the release cutoff (order 2, float64, 200,000 samples of
  ``rand``; 2.79e-5 at order 3): the port follows scipy, and a test shows
  the divergence;
* LOWESS against the JAX ``lowess.smooth`` at float64 to 1e-12 (the whole
  chain under these configs: ``test_torch_configs_chain.py``);
* a numpy-free model of K3's decomposition (runs, warp shuffles, look-back,
  compensated combines) against the twin to 1e-10 relative, the tolerance
  ``chip_smoke.py`` holds the kernel to on the card.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

import matchering_tpu as mj
import matchering_tpu_torch as mt
from matchering_tpu.ops import iir as jiir
from matchering_tpu.ops import lowess as jlowess
from matchering_tpu.ops import smoothing as jsm
from matchering_tpu_torch import state
from matchering_tpu_torch.kernels import sos
from matchering_tpu_torch.ops import iir, lowess, smoothing

FS = 44100
CUTOFFS = {"hold": 7.0, "release": 800.0 / 3000.0}  # LimiterConfig() defaults
FILTER_TOL = 1e-9
LOWESS_TOL = 1e-12
ORDERS_2_2 = dict(hold_filter_order=2, release_filter_order=2)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def sosfilt_ld(sections, x):
    """``scipy.signal.sosfilt`` in long double, rounded to float64."""
    sections = np.asarray(sections, dtype=np.longdouble)
    return signal.sosfilt(sections, np.asarray(x, np.longdouble), axis=-1).astype(np.float64)


def rows_of(sections):
    return [[s.b0, s.b1, s.b2, 1.0, s.a1, s.a2] for s in sections]


# --- K3: the second-order-section scan ---------------------------------------


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 3 * 256 + 5, 200_000])
@pytest.mark.parametrize("cutoff", sorted(CUTOFFS))
def test_sos_twin_matches_sosfilt(rng, cutoff, n, rows):
    (section,) = iir.butter_sos(2, CUTOFFS[cutoff], FS)
    x = rng.rand(rows, n) if rows > 1 else rng.rand(n)
    got = sos.sos_filter(t(x), *section)
    assert got.shape == x.shape and got.dtype == torch.float64
    err = np.max(np.abs(got.numpy() - sosfilt_ld(rows_of([section]), x)))
    assert err <= FILTER_TOL, err


@pytest.mark.parametrize("cutoff", sorted(CUTOFFS))
def test_sos_twin_float32_io_keeps_float64_state(rng, cutoff):
    (section,) = iir.butter_sos(2, CUTOFFS[cutoff], FS)
    x = rng.rand(70_000).astype(np.float32)
    got = sos.sos_filter(t(x), *section)
    assert got.dtype == torch.float32
    want = sosfilt_ld(rows_of([section]), x.astype(np.float64))
    # only the final rounding to float32 separates the two
    assert np.all(np.abs(got.numpy() - want) <= 2.0**-24 * np.abs(want) + 1e-11)


@pytest.mark.parametrize("cutoff", sorted(CUTOFFS))
def test_section_powers_are_exact_to_32_digits(cutoff):
    """Each power in the kernel's table (thread spans, lane chunks,
    look-back distances, hop and step) is hi + lo: hi the float64 rounding
    of the exact power, lo the rounding of what hi leaves."""
    import decimal

    (section,) = iir.butter_sos(2, CUTOFFS[cutoff], FS)
    table = np.array(sos.section_tables(section.a1, section.a2))
    assert table.shape == (sos.TABLE_DOUBLES,)
    count = len(sos.TABLE_EXPONENTS)
    assert count == sos.LANE_STATES - 1 + 32 + sos.THREADS + 2
    powers = table.reshape(count, 8)
    checked = 0
    with decimal.localcontext() as context:
        context.prec = 100
        for exponent, entry in zip(sos.TABLE_EXPONENTS, powers):
            exact = sos._power(section.a1, section.a2, exponent)
            flat = [v for row in exact for v in row]
            np.testing.assert_array_equal(entry[:4], [float(v) for v in flat])
            scale = max(abs(v) for v in flat)
            if scale < decimal.Decimal("1e-300"):  # decayed below float64's range
                continue
            for v, hi, lo in zip(flat, entry[:4], entry[4:]):
                assert abs(v - decimal.Decimal(hi) - decimal.Decimal(lo)) <= scale * decimal.Decimal("1e-30")
            checked += 1
    assert checked >= 40
    assert sos.TABLE_EXPONENTS[: sos.LANE_STATES - 1] == (32, 64, 96)
    assert sos.TABLE_EXPONENTS[-2:] == (sos.THREADS * sos.TILE, sos.WINDOW * sos.TILE)


@pytest.mark.parametrize("rows", [1, 3])
def test_sos_scratch_words(rows):
    """An aggregate pair and a prefix pair per (row, tile); a row off a
    16-byte boundary may reach into one more tile."""
    for n, itemsize, tiles in [(1, 4, 1), (4096, 4, 1), (4096, 8, 1), (4097, 4, 2), (4093, 4, 1),
                               (4094, 4, 2), (4095, 8, 1), (4097, 8, 2), (7_938_000, 4, 1938), (31 << 18, 4, 1984)]:
        assert sos.tiles_per_row(n, itemsize) == tiles
        assert sos.scratch_words(rows, n, itemsize) == 4 * rows * tiles
    assert (sos.RUN, sos.THREADS, sos.TILE, sos.CHUNK) == (32, 128, 4096, 128)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [1, 5, 4093, 4097, 3 * 4096 + 5, 7_938_001])
def test_sos_tiles_cover_each_row_from_aligned_starts(n, itemsize):
    """Every tile starts on a 16-byte boundary (a row off one begins its
    first tile before the row), and the tiles of each row cover it once,
    in order, with whole 16-byte chunks in between."""
    per_vector = 16 // itemsize
    tiles = sos.tiles_per_row(n, itemsize)
    for row in range(5):
        covered = 0
        for b in range(tiles):
            start, first, end = sos.tile_span(row, b, n, itemsize)
            assert start % per_vector == 0
            assert start + first == row * n + covered or first >= end
            if b == 0:
                assert first == (row * n) % per_vector
            else:
                assert first == 0
            covered += max(0, end - first)
        assert covered == n
        # the last tile holds a sample, or is the one a shifted row does not reach
        start, first, end = sos.tile_span(row, tiles - 1, n, itemsize)
        assert end > first or (n % per_vector and (row * n) % per_vector == 0)


def test_sos_ring_and_grid(monkeypatch):
    """A block's ring of STAGES tiles and its head fit an SM four times in
    float32 and twice in float64, the look-back's window reaches past the
    grid's blocks, and the grid is the resident blocks, no more than the
    tiles (the occupancy query stubbed)."""
    assert sos.STAGES == 2
    assert sos.SHARED_HEAD % 128 == 0 and sos.SHARED_HEAD >= 8 * sos.TABLE_DOUBLES
    assert sos.WINDOW >= 4 * 132  # an H100's resident float32 blocks: one look-back step
    for itemsize, blocks in ((4, 4), (8, 2)):
        dynamic = sos.SHARED_HEAD + sos.STAGES * sos.TILE * itemsize  # csrc/sos_scan.cu: shared_bytes
        assert dynamic <= 227 * 1024
        assert 228 * 1024 // (dynamic + 1024) == blocks  # an H100 SM, 1 KB reserved per block
    assert sos.grid_size(1, 7_938_000, 4, 3, 132) == 396
    assert sos.grid_size(8, 31 << 18, 4, 3, 132) == 396
    assert sos.grid_size(1, 5000, 4, 3, 132) == 2
    assert sos.grid_size(3, 1, 8, 2, 132) == 3
    with pytest.raises(RuntimeError, match="resident"):
        sos.grid_size(1, 5000, 4, 0, 132)

    class Library:
        def mtpu_sos_info(self, f64, out):
            out[3] = 2 if f64 else 3
            return 0

    monkeypatch.setattr(sos.build, "library", lambda: Library())
    monkeypatch.setattr(sos.torch.cuda, "device", lambda device: contextlib.nullcontext())
    sos.resident_blocks.cache_clear()
    try:
        assert sos.resident_blocks("cuda:0", torch.float32) == 3
        assert sos.resident_blocks("cuda:0", torch.float64) == 2
    finally:
        sos.resident_blocks.cache_clear()


def _sos_model(x, section, shift=0):
    """csrc/sos_scan.cu's arithmetic for one row that starts ``shift``
    samples past a 16-byte boundary, tile by tile, in float64 torch ops on
    the CPU: the runs scanned from zero, warp 0's chains, lane scan, lane
    ends and thread entries through ``sos.affine`` with the kernel's table,
    look-back over every earlier tile's aggregate (the longest walk: steps
    of WINDOW tiles, thread t's DEPTH tiles combined Horner-wise with
    A^(THREADS TILE), then A^(TILE t), each step then A^(WINDOW TILE) once
    per step), and each run rescanned from the state entering it."""
    b0, b1, b2, a1, a2 = section
    run, tile, states = sos.RUN, sos.TILE, sos.LANE_STATES
    threads = tile // run
    count = len(sos.TABLE_EXPONENTS)
    table = torch.tensor(sos.section_tables(a1, a2), dtype=torch.float64).reshape(count, 2, 4)
    hi, lo = table[:, 0].reshape(-1, 2, 2), table[:, 1].reshape(-1, 2, 2)
    lane_at, distance_at = states - 1, states - 1 + 32
    hop_at, step_at = distance_at + threads, distance_at + threads + 1
    c1, c2 = b1 - a1 * b0, b2 - a2 * b0
    zero = torch.zeros(2, dtype=torch.float64)

    def combine(i, v, add):
        return sos.affine(hi[i], lo[i], v, add)

    def shift_lanes(v, d):
        out = torch.zeros_like(v)
        out[d:] = v[:-d]
        return out

    x = torch.cat([torch.zeros(shift, dtype=torch.float64), torch.as_tensor(x, dtype=torch.float64)])
    n = x.shape[0]
    y = torch.empty(n, dtype=torch.float64)
    lanes = torch.arange(32)
    aggregates = []
    for b in range(-(-n // tile)):
        part = x[b * tile : (b + 1) * tile]
        runs = torch.zeros(tile, dtype=torch.float64)
        runs[: len(part)] = part
        runs = runs.reshape(threads, run)
        def scan(s, out=None):
            for r in range(run):
                xi = runs[:, r]
                if out is not None:
                    out[:, r] = b0 * xi + s[:, 0]
                s = torch.stack([(c1 * xi + s[:, 1]) - a1 * s[:, 0], c2 * xi - a2 * s[:, 0]], -1)
            return s

        s = scan(torch.zeros(threads, 2, dtype=torch.float64))
        ends = s.reshape(32, states, 2)
        chain = [ends[:, 0]]
        for k in range(1, states):
            chain.append(combine(0, chain[-1], ends[:, k]))
        g = chain[-1]
        for k in range(5):
            d = 1 << k
            g = torch.where((lanes >= d)[:, None], combine(lane_at + d - 1, shift_lanes(g, d), g), g)
        carry = zero
        if b > 0:
            for m, last in enumerate(range(b - 1, -1, -sos.WINDOW)):
                # thread t: tiles last - t - THREADS k, the farthest first
                window = aggregates[max(0, last - sos.WINDOW + 1) : last + 1][::-1]
                window = window + [zero] * (sos.WINDOW - len(window))
                values = torch.stack(window).reshape(sos.DEPTH, threads, 2)
                acc = values[-1]
                for k in range(sos.DEPTH - 2, -1, -1):
                    acc = combine(hop_at, acc, values[k])
                term = combine(slice(distance_at, distance_at + threads), acc, torch.zeros_like(acc)).sum(0)
                for _ in range(m):
                    term = combine(step_at, term, zero)
                carry = carry + term
        aggregates.append(g[31])
        f = g if b == 0 else combine(slice(lane_at, lane_at + 32), carry.expand(32, 2), g)
        enter = shift_lanes(f, 1)
        enter[0] = carry
        entry = [enter] + [combine(k - 1, enter, chain[k - 1]) for k in range(1, states)]
        out = torch.empty(threads, run, dtype=torch.float64)
        scan(torch.stack(entry, 1).reshape(threads, 2), out)
        y[b * tile : (b + 1) * tile] = out.reshape(-1)[: len(part)]
    return y[shift:].numpy()


@pytest.mark.parametrize(
    "n, shift",
    [(1, 0), (1, 3), (4095, 0), (4095, 3), (3 * 4096 + 5, 0), (3 * 4096 + 5, 3), (660 * 4096 + 7, 3)],
)
@pytest.mark.parametrize("cutoff", sorted(CUTOFFS))
def test_sos_kernel_decomposition(rng, cutoff, n, shift):
    (section,) = iir.butter_sos(2, CUTOFFS[cutoff], FS)
    x = rng.rand(n)
    got = _sos_model(x, section, shift)
    twin = sos.sos_filter(t(x), *section).numpy()
    assert np.max(np.abs(got - sosfilt_ld(rows_of([section]), x))) <= FILTER_TOL
    rel = np.abs(got - twin) / np.maximum(np.abs(twin), 1e-300)
    assert np.max(rel) <= 1e-10, np.max(rel)


# --- ops.iir: Butterworth cascades and lfilter -------------------------------


@pytest.mark.parametrize("order", [2, 3, 4, 8])
@pytest.mark.parametrize("cutoff", sorted(CUTOFFS))
def test_butter_lowpass_matches_sosfilt(rng, cutoff, order):
    x = rng.rand(2, 50_000)
    got = iir.butter_lowpass(order, CUTOFFS[cutoff], FS, t(x)).numpy()
    want = sosfilt_ld(signal.butter(order, CUTOFFS[cutoff], fs=FS, output="sos"), x)
    assert np.max(np.abs(got - want)) <= FILTER_TOL
    b, a = iir.butter_coefficients(order, CUTOFFS[cutoff], FS)
    jb, ja = jiir.butter_coefficients(order, CUTOFFS[cutoff], FS)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(a, ja)


def test_butter_sections_run_on_k3(monkeypatch):
    """scipy's sections in scipy's order, one K3 launch each.  Butterworth's
    odd orders pair their real pole with a second-order numerator, so no
    section of an order above 1 is first-order."""
    for order in range(2, 9):
        sections = iir.butter_sos(order, CUTOFFS["release"], FS)
        want = signal.butter(order, CUTOFFS["release"], fs=FS, output="sos")
        np.testing.assert_array_equal(rows_of(sections), want)
        assert len(sections) == -(-order // 2)
        assert not any(s.b2 == s.a2 == 0.0 for s in sections)
    assert iir.SecondOrderSection.of([0.5, 0.5, 0.0, 2.0, -1.0, 0.0]) == (0.25, 0.25, 0.0, -0.5, 0.0)
    launched = []
    monkeypatch.setattr(sos, "sos_filter", lambda x, *section: launched.append(section) or x)
    iir.butter_lowpass(3, CUTOFFS["release"], FS, torch.zeros(8, dtype=torch.float64))
    assert launched == list(iir.butter_sos(3, CUTOFFS["release"], FS))


@pytest.fixture(scope="module")
def jitted_lfilter():
    @functools.lru_cache(maxsize=None)
    def compiled(b, a):
        return jax.jit(functools.partial(jiir.lfilter, b, a))

    return compiled


@pytest.mark.parametrize(
    "b, a",
    [
        ((0.2, 0.3), (1.0, -0.6)),
        ((0.3, -0.1, 0.2), (2.0, -1.0, 0.4)),
        ((0.1, 0.2, 0.1, 0.05), (1.0, -0.9, 0.5, -0.1)),
    ],
    ids=["order1", "order2", "order3"],
)
def test_lfilter_matches_scipy_and_jax(rng, jitted_lfilter, b, a):
    x = rng.rand(3, 20_000)
    got = iir.lfilter(b, a, t(x)).numpy()
    np.testing.assert_allclose(got, signal.lfilter(b, a, x, axis=-1), rtol=0, atol=1e-10)
    want = np.stack([np.asarray(jitted_lfilter(b, a)(jnp.asarray(row))) for row in x])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_jax_butter_lowpass_diverges_from_scipy_at_the_release_cutoff():
    """The fault of the reference (ROADMAP queue 3): at the release cutoff
    (800/3000 Hz at 44.1 kHz, poles ~2.7e-5 inside the unit circle) the JAX
    order-2 ``butter_lowpass`` (a 2x2 ``associative_scan``,
    ``matchering_tpu/ops/iir.py:970-1049``) is 1.43e-4 off ``sosfilt`` in
    float64 on 200,000 samples of ``rand`` (2.79e-5 at order 3; NaN in
    float32), where float64 ``sosfilt`` is 6.5e-10 off long double and the
    port's cascade ~4e-12.  The port follows scipy."""
    x = np.random.RandomState(0).rand(200_000)
    cutoff = CUTOFFS["release"]
    sections = signal.butter(2, cutoff, fs=FS, output="sos")
    reference = signal.sosfilt(sections, x)
    jax_filter = jax.jit(functools.partial(jiir.butter_lowpass, 2, cutoff, FS))
    jax_out = np.asarray(jax_filter(jnp.asarray(x)))
    port_out = iir.butter_lowpass(2, cutoff, FS, t(x)).numpy()
    assert np.max(np.abs(jax_out - reference)) > 1e-5
    assert np.max(np.abs(port_out - reference)) < 1e-9
    assert np.max(np.abs(port_out - sosfilt_ld(sections, x))) < 1e-11
    assert np.isnan(np.asarray(jax_filter(jnp.asarray(x, jnp.float32)))).any()
    port32 = iir.butter_lowpass(2, cutoff, FS, t(x.astype(np.float32))).numpy()
    assert np.max(np.abs(port32 - reference)) < 2.0**-23


# --- ops.lowess: the device smoother -----------------------------------------


@pytest.fixture(scope="module")
def curves():
    """Three log-grid-like curves of 2049 points (fft_size 1024, 4x)."""
    r = np.random.RandomState(7)
    grid = np.linspace(0, 1, 2049)
    base = 1.0 + 0.5 * np.sin(9 * grid)[None] + 0.3 * np.cos(31 * grid)[None] * r.rand(3, 1)
    return base + 0.05 * r.randn(3, 2049) + (r.rand(3, 2049) < 0.01) * 2.0  # with outliers


@pytest.mark.parametrize("batched", [False, True], ids=["one-curve", "batch-of-3"])
@pytest.mark.parametrize("it, delta", [(1, 0.001), (2, 0.001), (0, 0.0), (1, 0.0)])
def test_lowess_smooth_matches_jax(curves, it, delta, batched):
    y = curves if batched else curves[0]
    got = lowess.smooth(t(y), 0.0375, it, delta).numpy()
    want = np.stack([np.asarray(jlowess.smooth(jnp.asarray(row), 0.0375, it, delta))
                     for row in np.atleast_2d(y)])
    assert got.shape == y.shape
    np.testing.assert_allclose(np.atleast_2d(got), want, rtol=0, atol=LOWESS_TOL)


def test_lowess_smooth_runs_in_float64_and_casts_back(curves):
    got = lowess.smooth(t(curves.astype(np.float32)), 0.0375, 1, 0.001)
    assert got.dtype == torch.float32
    want = lowess.smooth(t(curves.astype(np.float32).astype(np.float64)), 0.0375, 1, 0.001)
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.float32))


def test_median_averages_the_middle_pair():
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [5.0, 5.0, 1.0, 9.0]], dtype=torch.float64)
    np.testing.assert_array_equal(lowess._median(x).numpy(), np.median(x.numpy(), axis=-1))
    np.testing.assert_array_equal(lowess._median(x[:, :3]).numpy(), [3.0, 5.0])


# --- ops.smoothing and state: the unfolded smoothers -------------------------

LOWESS_CONFIGS = [{"lowess_it": 1}, {"lowess_exact": True}]
SMALL_FFT = 1024  # a 2049-point log grid: the operators build in a fraction of a second


@pytest.mark.parametrize("kwargs", LOWESS_CONFIGS + [{"lowess_delta": 0.0}, {}])
def test_smoothing_state_names_its_lowess(kwargs):
    """The operator state says whether the LOWESS is folded by a field, and
    holds the JAX package's operators for every config."""
    config = mt.Config(dtype="float64", fft_size=SMALL_FFT, **kwargs)
    ops = state.operators_for_config(config, "cpu")
    # staged once per (smoothing parameters, dtype, device)
    other_limiter = mt.Config(dtype="float64", fft_size=SMALL_FFT, limiter=mt.LimiterConfig(hold_filter_order=2),
                              **kwargs)
    assert state.operators_for_config(other_limiter, torch.device("cpu")) is ops
    assert state.operators_for_config(mt.Config(fft_size=SMALL_FFT, **kwargs), "cpu").to_log.dtype == torch.float32
    folded = not kwargs
    assert smoothing.lowess_folds(config) is folded
    assert (ops.lowess is None) is folded
    want = jsm.operator_arrays_for_config(mj.Config(dtype="float64", fft_size=SMALL_FFT, **kwargs))
    for got, w in zip(ops[:2], want):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    if not folded:
        assert ops.lowess.it == config.lowess_it
        anchors = ops.lowess.fit_rows.shape[0]
        exact = config.lowess_exact or config.lowess_delta == 0
        assert (anchors == config.log_grid_size) is exact


@pytest.mark.parametrize("operators", ["none", "jax-pair"])
@pytest.mark.parametrize("kwargs", [{}, {"lowess_it": 1}], ids=["folded", "lowess_it=1"])
def test_smooth_exponentially_takes_the_jax_call_form(rng, kwargs, operators):
    """``smooth_exponentially(matching_fft, sample_rate, fft_size,
    oversampling, lowess_frac, lowess_it, lowess_delta, operators=None)``
    on one curve, with no operators (the plain ones, the LOWESS between
    them, as JAX does) or the JAX package's pair (folded or plain, told
    apart by its shape): JAX's output within 1e-12 relative."""
    jconfig = mj.Config(dtype="float64", fft_size=SMALL_FFT, **kwargs)
    curve = np.abs(rng.randn(SMALL_FFT // 2 + 1)) + 0.2
    args = (jconfig.internal_sample_rate, jconfig.fft_size, jconfig.lin_log_oversampling,
            jconfig.lowess_frac, jconfig.lowess_it, jconfig.lowess_delta)
    jops = None if operators == "none" else jsm.operator_arrays_for_config(jconfig)
    want = np.asarray(jsm.smooth_exponentially(jnp.asarray(curve), *args, operators=jops))
    ops = None if jops is None else tuple(np.asarray(op) for op in jops)
    got = smoothing.smooth_exponentially(t(curve), *args, operators=ops).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


@pytest.mark.parametrize("kwargs", LOWESS_CONFIGS)
def test_smooth_exponentially_matches_jax(rng, kwargs):
    jconfig = mj.Config(dtype="float64", fft_size=SMALL_FFT, **kwargs)
    config = state.config_from_dict(dataclasses.asdict(jconfig))
    curves = np.abs(rng.randn(2, config.fft_size // 2 + 1)) + 0.2
    ops64 = jsm.operator_arrays_for_config(jconfig)
    ops = smoothing.as_smoothing(ops64, config.log_grid_size, smoothing.lowess_parameters(config),
                                 torch.float64, "cpu")
    assert ops.lowess is not None
    got = smoothing.smooth_exponentially(
        t(curves), config.internal_sample_rate, config.fft_size, config.lin_log_oversampling,
        *smoothing.lowess_parameters(config), operators=ops,
    ).numpy()
    for row, curve in zip(got, curves):
        want = jsm.smooth_exponentially(
            jnp.asarray(curve), jconfig.internal_sample_rate, jconfig.fft_size,
            jconfig.lin_log_oversampling, jconfig.lowess_frac, jconfig.lowess_it,
            0.0 if jconfig.lowess_exact else jconfig.lowess_delta, operators=ops64,
        )
        scale = np.max(np.abs(np.asarray(want)))
        np.testing.assert_allclose(row, np.asarray(want), rtol=0, atol=1e-10 * scale)
