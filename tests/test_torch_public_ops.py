"""The port's public op library against the JAX package's, function by function.

Each function the port adds under the JAX package's name gets the same
float64 inputs, made with numpy from a seed, on the CPU (K2 runs its plain
twin there), beside its JAX twin.  Tolerances: 1e-12 relative to the
reference's largest magnitude for the elementwise, reduction and FFT ops
and the scans; ``scan_first_order_ds`` is held to ``scipy.signal.lfilter``
by the JAX package's own gate (more than 180 dB, ``tests/test_ops_kernels.py``),
and the JAX result on the same input too; the sharded ops run over eight
shards against the JAX package's on the 8-device virtual CPU mesh
(``tests/test_torch_timeshard.py``'s helpers); ``render_variants`` is
held to at least 200 dB per variant.  Signals stay at most 65,536 samples
and the operators at ``fft_size=1024``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from scipy import signal

import matchering_tpu as mj
from matchering_tpu import core as jcore
from matchering_tpu import stages as jstages
from matchering_tpu.ops import basics as jb
from matchering_tpu.ops import blocks as jblocks
from matchering_tpu.ops import convolve as jconv
from matchering_tpu.ops import fftpack as jfft
from matchering_tpu.ops import iir as jiir
from matchering_tpu.ops import smoothing as jsm
from matchering_tpu.ops import spectrum as jsp
from matchering_tpu.parallel import timeshard as jts
from matchering_tpu_torch import core, stages, state
from matchering_tpu_torch.kernels import scan
from matchering_tpu_torch.ops import basics, blocks, convolve, fftpack, iir, smoothing, spectrum
from matchering_tpu_torch.parallel import timeshard
from matchering_tpu_torch.utils import RowInts
from test_torch_pipeline import make_pair
from test_torch_timeshard import GRID, SHARDS, jax_mesh, jax_sharded, shards, whole  # noqa: F401

RTOL = 1e-12
DS_SNR_DB = 180.0  # the JAX package's gate for its compensated scan
RELEASE = jiir.butter1_coefficients(800.0 / 3000.0, 44100).pole
SMALL_FFT = 1024


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_close(port, reference, rtol=RTOL):
    port = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port, np.float64)
    reference = np.asarray(reference, np.float64)
    assert port.shape == reference.shape, (port.shape, reference.shape)
    scale = max(np.max(np.abs(reference)), 1e-300)
    err = np.max(np.abs(port - reference)) / scale
    assert err <= rtol, err


def snr_db(reference, test):
    reference, test = np.asarray(reference, np.float64), np.asarray(test, np.float64)
    err = np.sum((reference - test) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(reference**2) / err)


# ---------------------------------------------------------------------------
# ops.basics, ops.spectrum, ops.convolve, ops.fftpack, ops.blocks


@pytest.mark.parametrize("name", ["mono_to_stereo", "amplify", "unfold", "batch_rms"])
def test_basics(rng, name):
    x = rng.randn(4321)
    if name == "mono_to_stereo":
        mono = rng.randn(300, 1)
        assert_close(basics.mono_to_stereo(t(mono)), jb.mono_to_stereo(jnp.asarray(mono)))
    elif name == "amplify":
        assert_close(basics.amplify(t(x), 0.37), jb.amplify(jnp.asarray(x), 0.37))
    elif name == "unfold":
        assert_close(basics.unfold(t(x), 700, 6), jb.unfold(jnp.asarray(x), 700, 6))
    else:
        pieces = rng.randn(6, 700)
        assert_close(basics.batch_rms(t(pieces)), jb.batch_rms(jnp.asarray(pieces)))


FFT = 128
MASK = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])


@pytest.mark.parametrize(
    "name", ["framed_magnitude_mean", "masked_average_spectrum", "masked_average_spectrum_flat"]
)
def test_spectrum_static(rng, name):
    piece, divisions = 1000, 6
    x = rng.randn(piece * divisions + 77)
    pieces = x[: piece * divisions].reshape(divisions, piece)
    if name == "framed_magnitude_mean":
        got = spectrum.framed_magnitude_mean(t(pieces), FFT)
        want = jsp.framed_magnitude_mean(jnp.asarray(pieces), FFT)
    elif name == "masked_average_spectrum":
        got = spectrum.masked_average_spectrum(t(pieces), t(MASK), FFT)
        want = jsp.masked_average_spectrum(jnp.asarray(pieces), jnp.asarray(MASK), FFT)
    else:
        got = spectrum.masked_average_spectrum_flat(t(x), t(MASK), piece, divisions, FFT)
        want = jsp.masked_average_spectrum_flat(jnp.asarray(x), jnp.asarray(MASK), piece, divisions, FFT)
    assert_close(got, want)


@pytest.mark.parametrize("piece", [1000, 100])  # 7 full frames a piece; none
def test_masked_average_spectrum_dynamic(rng, piece):
    """Piece geometry as a 0-d tensor, over a zero-padded signal; the
    pieces past the true division count are masked out."""
    div_max, fpp_max = 6, 9
    x = np.concatenate([rng.randn(4 * piece), np.zeros(2 * piece + 500)])
    mask = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 0.0])
    got = spectrum.masked_average_spectrum_dynamic(
        t(x), t(mask), torch.tensor(piece), div_max, FFT, fpp_max
    )
    want = jsp.masked_average_spectrum_dynamic(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(piece), div_max, FFT, fpp_max
    )
    assert_close(got, want)


@pytest.mark.parametrize("n,taps,block", [(5000, 257, 1 << 14), (60000, 257, 1 << 12), (30000, 9000, 1 << 12)])
def test_fft_convolve_same(rng, n, taps, block):
    """Both branches (one FFT, overlap-save), and a FIR longer than
    ``block_fft // 2``, which raises the block size."""
    x, h = rng.randn(n), rng.randn(taps)
    got = convolve.fft_convolve_same(t(x), t(h), block_fft=block)
    assert_close(got, jconv.fft_convolve_same(jnp.asarray(x), jnp.asarray(h), block_fft=block))
    assert_close(got, signal.fftconvolve(x, h, "same"), rtol=1e-11)


@pytest.mark.parametrize("name", ["irfft", "four_step_fft", "four_step_fft_inverse"])
def test_fftpack(rng, name):
    if name == "irfft":
        spec = rng.randn(3, 129) + 1j * rng.randn(3, 129)
        assert_close(fftpack.irfft(t(spec), 256), jfft.irfft(jnp.asarray(spec), 256))
        assert_close(
            fftpack.irfft(t(spec.T), 256, axis=0), jfft.irfft(jnp.asarray(spec.T), 256, axis=0)
        )
        return
    inverse = name.endswith("inverse")
    re, im = rng.randn(2, 4096), rng.randn(2, 4096)
    got = fftpack.four_step_fft(t(re), t(im), inverse=inverse)
    want = jfft.four_step_fft(jnp.asarray(re), jnp.asarray(im), inverse=inverse)
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("shape", [(1200,), (1200, 2)])
def test_overlapping_blocks(rng, shape):
    x = rng.randn(*shape)
    got = blocks.overlapping_blocks(t(x), 7, 128, 300)
    assert_close(got, jblocks.overlapping_blocks(jnp.asarray(x), 7, 128, 300))
    with pytest.raises(ValueError, match="needs"):
        blocks.overlapping_blocks(t(x), 9, 128, 300)


# ---------------------------------------------------------------------------
# ops.iir: the public scans on K2's plain twin


def test_scan_first_order(rng):
    drive = rng.randn(20000)
    jscan = jax.jit(lambda d: jiir.scan_first_order(d, RELEASE))
    want = jscan(jnp.asarray(drive))
    assert_close(iir.scan_first_order(t(drive), RELEASE), want)
    # a 0-d tensor pole, and rows
    assert_close(iir.scan_first_order(t(drive), torch.tensor(RELEASE, dtype=torch.float64)), want)
    rows = iir.scan_first_order(t(np.stack([drive, -drive])), RELEASE)
    assert_close(rows[1], -np.asarray(want))


def test_block_scan_summary(rng):
    drive = rng.randn(5000)
    local, (a, u) = iir.block_scan_summary(t(drive), 0.93)
    jlocal, (ja, ju) = jiir.block_scan_summary(jnp.asarray(drive), jnp.asarray(0.93))
    assert_close(local, jlocal)
    assert_close(a, ja)
    assert_close(u, ju)


@pytest.mark.parametrize("length", [4000, 7])
def test_filtfilt_first_order_truncated(rng, length):
    filt = iir.butter1_coefficients(7.0, 44100)
    x = np.concatenate([rng.rand(4000), np.zeros(1500)])
    want = jax.jit(lambda v, n: jiir.filtfilt_first_order_truncated(jiir.FirstOrderFilter(*filt), v, n))(
        jnp.asarray(x), jnp.asarray(length)
    )
    assert_close(iir.filtfilt_first_order_truncated(filt, t(x), length), want)
    assert_close(iir.filtfilt_first_order_truncated(filt, t(x), torch.tensor(length)), want)
    assert_close(iir.filtfilt_first_order_truncated(filt, t(x), RowInts.of([length], "cpu")), want)
    with pytest.raises(ValueError, match="outside"):
        iir.filtfilt_first_order_truncated(filt, t(x), 6)


def test_scan_first_order_ds(rng):
    """The port's hi + lo and the JAX package's, each to scipy's lfilter."""
    n = 20000
    d = rng.randn(n).astype(np.float32)
    lo = (rng.randn(n) * 1e-9).astype(np.float32)
    exact = signal.lfilter([1.0], [1.0, -RELEASE], d.astype(np.float64) + lo.astype(np.float64))
    hi_p, lo_p = iir.scan_first_order_ds(t(d), t(lo), RELEASE)
    assert hi_p.dtype == lo_p.dtype == torch.float32
    port = hi_p.double().numpy() + lo_p.double().numpy()
    jh, jl = jax.jit(lambda a, b: jiir.scan_first_order_ds(a, b, RELEASE))(jnp.asarray(d), jnp.asarray(lo))
    jax_sum = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    assert snr_db(exact, port) > DS_SNR_DB
    assert snr_db(exact, jax_sum) > DS_SNR_DB


def test_ds_pole_powers():
    pole, n = 0.9999623444444, 40000
    hi, lo = iir.ds_pole_powers(pole, n, np.float32, device="cpu")
    assert hi.dtype == lo.dtype == torch.float32
    jh, jl = jiir.ds_pole_powers(pole, n, jnp.float32)
    want = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    assert_close(hi.double() + lo.double(), want)
    assert_close(hi.double() + lo.double(), np.float64(pole) ** np.arange(1, n + 1))


def test_public_scans_run_the_twin_only_on_the_cpu():
    """Off the CPU the scans launch K2 or raise, never the twin; an entry
    point that makes its tensors defaults to the card."""
    with pytest.raises(ValueError, match="unsupported device"):
        iir.scan_first_order(torch.zeros(8, device="meta"), 0.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            iir.ds_pole_powers(0.5, 4, torch.float32)


# ---------------------------------------------------------------------------
# ops.smoothing, stages, core


@pytest.mark.parametrize("lowess", [None, (0.0375, 0, 0.001), (0.0375, 1, 0.001)])
def test_interpolation_operator_arrays(lowess):
    got = smoothing.interpolation_operator_arrays(44100, SMALL_FFT, 4, "float64", lowess, device="cpu")
    again = smoothing.interpolation_operator_arrays(44100, SMALL_FFT, 4, torch.float64, lowess, device="cpu")
    want = jsm.interpolation_operator_arrays(44100, SMALL_FFT, 4, jnp.float64, lowess_params=lowess)
    for g, a, w in zip(got, again, want):
        assert g is a  # one staged copy, in the smoothing state's cache
        assert_close(g, w)


def test_operator_arrays_for_config():
    jconfig = mj.Config(dtype="float64", fft_size=SMALL_FFT)
    config = state.config_from_dict(dataclasses.asdict(jconfig))
    got = smoothing.operator_arrays_for_config(config, device="cpu")
    assert got[0] is state.operators_for_config(config, "cpu").to_log
    for g, w in zip(got, jsm.operator_arrays_for_config(jconfig)):
        assert_close(g, w)


@pytest.mark.parametrize("n,max_piece", [(661500, 661500), (1323001, 80000), (5, 7)])
def test_piece_division(n, max_piece):
    assert stages.piece_division(n, max_piece) == jstages.piece_division(n, max_piece)


def test_render_variants():
    target, reference = make_pair(4, 31)
    jconfig = mj.Config(dtype="float64", fft_size=SMALL_FFT, max_piece_size=2)
    config = state.config_from_dict(dataclasses.asdict(jconfig))
    keys = {"limited", "normalized"}
    want = jcore.render_variants(target, reference, jconfig, keys)
    got = core.render_variants(target, reference, config, keys, device="cpu")
    assert set(got) == set(want) == keys
    for key in keys:
        assert snr_db(np.asarray(want[key]), got[key].numpy()) >= 200.0, key


# ---------------------------------------------------------------------------
# parallel.timeshard, over eight shards


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("init", [None, (0.5, 0.75)])
def test_carried_scan(rng, jax_mesh, reverse, init):
    drive = rng.randn(SHARDS * 2000)
    pole = 0.995
    j_init = None if init is None else tuple(jnp.asarray(v) for v in init)
    want = jax_sharded(jax_mesh, lambda d: jts.carried_scan(d, pole, "time", init=j_init, reverse=reverse), drive)
    got = whole(timeshard.carried_scan(shards(drive), pole, GRID, init=init, reverse=reverse), drive.size)
    assert_close(got, want)
    if init is None and not reverse:
        assert_close(got, iir.scan_first_order(t(drive), pole))


def test_sliding_max_attack_sharded(rng, jax_mesh):
    x = np.abs(rng.randn(SHARDS * 1000))
    want = jax_sharded(jax_mesh, lambda v: jts.sliding_max_attack_sharded(v, 44, "time"), x)
    got = whole(timeshard.sliding_max_attack_sharded(shards(x), 44, GRID), x.size)
    assert_close(got, want)


def _geometry(length, max_piece):
    divisions = length // max_piece + 1
    return length // divisions, divisions


def test_piece_rms_sharded_dynamic(rng, jax_mesh):
    n, length, div_max = SHARDS * 3000, SHARDS * 3000 - 4321, 9
    x = np.concatenate([rng.randn(length), np.zeros(n - length)])
    piece, divisions = _geometry(length, 2900)

    def local(v):
        rmses, valid = jts.piece_rms_sharded_dynamic(v, jnp.asarray(piece), jnp.asarray(divisions), div_max, "time")
        return jnp.stack([rmses, valid])

    want = jax_sharded(jax_mesh, local, x, out=P())
    rmses, valid = timeshard.piece_rms_sharded_dynamic(
        shards(x), torch.tensor(piece), torch.tensor(divisions), div_max, GRID
    )
    assert_close(rmses[0], want[0])
    assert_close(valid[0], want[1])


@pytest.mark.parametrize("piece_size", [None, 100])  # the track's pieces; pieces without a frame
def test_masked_average_spectrum_sharded_dynamic(rng, jax_mesh, piece_size):
    n, length, div_max, fft_size = SHARDS * 3000, SHARDS * 3000 - 4321, 9, 512
    x = np.concatenate([rng.randn(length), np.zeros(n - length)])
    piece, divisions = _geometry(length, 2900)
    piece = piece_size or piece
    mask = (np.arange(div_max) < divisions) * (rng.rand(div_max) > 0.3).astype(np.float64)

    def local(v):
        return jts.masked_average_spectrum_sharded_dynamic(
            v, jnp.asarray(mask), jnp.asarray(piece), jnp.asarray(divisions), div_max, fft_size, "time"
        )

    want = jax_sharded(jax_mesh, local, x, out=P())
    got = timeshard.masked_average_spectrum_sharded_dynamic(
        shards(x), t(mask), torch.tensor(piece), torch.tensor(divisions), div_max, fft_size, GRID
    )
    for spectrum_on_device in got:
        assert_close(spectrum_on_device, want)


def test_sharded_filters_launch_through_the_carry(monkeypatch, rng):
    """``carried_scan`` and the sharded filters share one carry: two K2
    calls per device for a scan, four for a filtfilt."""
    calls = []
    real = scan.first_order_filter_plain
    monkeypatch.setattr(scan, "first_order_filter_plain", lambda *a, **k: calls.append(1) or real(*a, **k))
    parts = shards(rng.rand(SHARDS * 1000))
    timeshard.carried_scan(parts, 0.9, GRID)
    assert len(calls) == 2 * len(GRID.devices)
    calls.clear()
    timeshard.filtfilt_first_order_sharded(iir.one_pole_filter(-2.0, 44.0), parts, GRID)
    assert len(calls) == 4 * len(GRID.devices)
