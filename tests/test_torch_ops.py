"""Parity of the PyTorch port's DSP ops with their JAX twins.

Both packages get the same float64 inputs, made with numpy from a seed, on
the CPU.  Tolerance: 1e-10 relative to the reference's largest magnitude
(float64 rounding, with room for a different summation or FFT order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matchering_tpu as mj
from matchering_tpu.ops import basics as jb
from matchering_tpu.ops import convolve as jc
from matchering_tpu.ops import fir as jf
from matchering_tpu.ops import sliding as js
from matchering_tpu.ops import smoothing as jsm
from matchering_tpu.ops import spectrum as jsp
from matchering_tpu_torch import state
from matchering_tpu_torch.ops import basics, convolve, fir, sliding, smoothing, spectrum

RTOL = 1e-10


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_close(port, reference, rtol=RTOL):
    port = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port, np.float64)
    reference = np.asarray(reference, np.float64)
    assert port.shape == reference.shape
    scale = max(np.max(np.abs(reference)), 1e-300)
    err = np.max(np.abs(port - reference)) / scale
    assert err <= rtol, err


@pytest.fixture
def stereo(rng):
    return rng.randn(5000, 2) * 0.5


class TestBasics:
    def test_mid_side(self, stereo):
        mid, side = basics.lr_to_ms(t(stereo))
        jmid, jside = jb.lr_to_ms(jnp.asarray(stereo))
        assert_close(mid, jmid)
        assert_close(side, jside)
        assert_close(basics.ms_to_lr(mid, side), jb.ms_to_lr(jmid, jside))

    @pytest.mark.parametrize("to", [1.0, 0.37])
    def test_clip(self, stereo, to):
        assert_close(basics.clip(t(stereo), to), jb.clip(jnp.asarray(stereo), to))
        limit = torch.tensor(to, dtype=torch.float64)
        assert_close(basics.clip(t(stereo), limit), jb.clip(jnp.asarray(stereo), to))

    def test_rectify_flip_max_mix(self, stereo):
        thr = 0.998138427734375
        r = basics.rectify(t(stereo), thr)
        jr = jb.rectify(jnp.asarray(stereo), thr)
        assert_close(r, jr)
        assert_close(basics.flip(r), jb.flip(jr))
        assert_close(basics.max_mix(r, 2 * r - 1.5), jb.max_mix(jr, 2 * jr - 1.5))

    @pytest.mark.parametrize("normalize_clipped", [False, True])
    @pytest.mark.parametrize("scale", [0.3, 1.5])
    def test_normalize(self, stereo, normalize_clipped, scale):
        x = stereo * scale
        out, c = basics.normalize(t(x), 0.9981, 1e-6, normalize_clipped)
        jout, jc_ = jb.normalize(jnp.asarray(x), 0.9981, 1e-6, normalize_clipped)
        assert_close(out, jout)
        assert_close(c, jc_)

    @pytest.mark.parametrize("divisions,piece_size", [(3, 1500), (7, 701)])
    def test_piece_rms_and_loudest_pieces(self, rng, divisions, piece_size):
        x = rng.randn(5003) * np.repeat(rng.rand(8), 626)[:5003]
        rmses = basics.piece_rms_flat(t(x), piece_size, divisions)
        jrmses = jb.piece_rms_flat(jnp.asarray(x), piece_size, divisions)
        assert_close(rmses, jrmses)
        mask, match = basics.loudest_piece_stats(rmses)
        jmask, jmatch = jb.loudest_piece_stats(jrmses)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert_close(match, jmatch)
        assert_close(basics.rms(t(x)), jb.rms(jnp.asarray(x)))
        assert_close(basics.masked_rms(rmses, mask), jb.masked_rms(jrmses, jmask))

    @pytest.mark.parametrize("dtype", [np.int16, np.int32])
    def test_int_pcm_to_float_and_peaks(self, rng, dtype):
        full = np.iinfo(dtype).max
        codes = (rng.randn(4000, 2) * full / 4).clip(-full, full).astype(dtype)
        codes[:20, 0] = full  # a pinned peak
        assert_close(
            basics.to_working_float(t(codes), torch.float64),
            jb.to_working_float(jnp.asarray(codes), jnp.float64),
        )
        peak, count = basics.count_max_peaks(t(codes))
        jpeak, jcount = jb.count_max_peaks(jnp.asarray(codes))
        assert_close(peak, jpeak)
        assert int(count) == int(jcount)


class TestSpectrum:
    @pytest.mark.parametrize("divisions,piece_size", [(3, 9000), (5, 4100)])
    def test_masked_average_spectrum_pair(self, rng, divisions, piece_size):
        fft_size = 1024
        a = rng.randn(divisions * piece_size + 77)
        b = rng.randn(divisions * piece_size + 77) * 0.3
        mask = (rng.rand(divisions) > 0.4).astype(np.float64)
        mask[0] = 1.0
        got = spectrum.masked_average_spectrum_flat_pair(
            t(a), t(b), t(mask), piece_size, divisions, fft_size
        )
        want = jsp.masked_average_spectrum_flat_pair(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), piece_size, divisions, fft_size
        )
        assert_close(got[0], want[0])
        assert_close(got[1], want[1])


class TestFir:
    @pytest.mark.parametrize("fft_size", [512, 4096])
    def test_fir_from_magnitude(self, rng, fft_size):
        curve = np.abs(rng.randn(fft_size // 2 + 1)) + 0.1
        assert_close(
            fir.fir_from_magnitude(t(curve), fft_size),
            jf.fir_from_magnitude(jnp.asarray(curve), fft_size),
        )

    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    def test_hann_symmetric_takes_the_jax_call_form(self, monkeypatch, dtype):
        """``hann_symmetric(n, dtype)`` as the JAX package calls it: a
        numpy dtype name, and the device keyword-only; with none it runs
        on the card, never on the CPU, and raises without one."""
        got = fir.hann_symmetric(4096, dtype, device="cpu")
        assert got.dtype == getattr(torch, dtype)
        assert_close(got, jf.hann_symmetric(4096, jnp.dtype(dtype)), rtol=1e-12 if dtype == "float64" else 1e-6)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            fir.hann_symmetric(4096, np.float64)


class TestSmoothing:
    def test_host_operators_equal_jax_operators(self):
        config = mj.Config(dtype="float64")
        want = [np.asarray(m) for m in jsm.operator_arrays_for_config(config)]
        got = smoothing.host_operators_for_config(
            state.config_from_dict(dataclasses.asdict(config))
        )
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)

    def test_smooth_exponentially(self, rng):
        config = mj.Config(dtype="float64")
        curve = np.abs(rng.randn(config.fft_size // 2 + 1)) + 0.2
        ops64 = jsm.operator_arrays_for_config(config)
        want = jsm.smooth_exponentially(
            jnp.asarray(curve), config.internal_sample_rate, config.fft_size,
            config.lin_log_oversampling, config.lowess_frac, config.lowess_it,
            config.lowess_delta, operators=ops64,
        )
        port_config = state.config_from_dict(dataclasses.asdict(config))
        ops = smoothing.as_smoothing(ops64, port_config.log_grid_size,
                                     smoothing.lowess_parameters(port_config), torch.float64, "cpu")
        assert ops.lowess is None
        got = smoothing.smooth_exponentially(
            t(curve), port_config.internal_sample_rate, port_config.fft_size,
            port_config.lin_log_oversampling, port_config.lowess_frac, port_config.lowess_it,
            port_config.lowess_delta, operators=ops,
        )
        assert_close(got, want)

    @pytest.mark.parametrize("kwargs", [{"lowess_it": 1}, {"lowess_exact": True}])
    def test_unfolded_smoothers_keep_the_plain_operators(self, kwargs):
        """``lowess_it > 0`` and ``lowess_exact`` do not fold: the host
        operators are the plain interpolation, as the JAX package's."""
        config = mj.Config(dtype="float64", **kwargs)
        port_config = state.config_from_dict(dataclasses.asdict(config))
        assert not smoothing.lowess_folds(port_config)
        want = [np.asarray(m) for m in jsm.operator_arrays_for_config(config)]
        got = smoothing.host_operators_for_config(port_config)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


class TestConvolve:
    @pytest.mark.parametrize(
        "n,taps",
        [(3000, 257), (3001, 4096), (200_000, 4096), (150_001, 1023)],
        ids=["single-odd-taps", "single-long-fir", "blocked", "blocked-odd"],
    )
    def test_batch_matches_jax(self, rng, n, taps):
        signals = rng.randn(2, n)
        firs = rng.randn(2, taps) * np.hanning(taps)
        assert_close(
            convolve.fft_convolve_same_batch(t(signals), t(firs)),
            jc.fft_convolve_same_batch(jnp.asarray(signals), jnp.asarray(firs)),
        )

    @pytest.mark.parametrize("n,taps", [(3000, 257), (200_000, 4096)], ids=["single", "blocked"])
    def test_block_fft_none_picks_the_block(self, rng, n, taps):
        """``block_fft=None``, JAX's default, picks the port's block."""
        signals = rng.randn(2, n)
        firs = rng.randn(2, taps) * np.hanning(taps)
        got = convolve.fft_convolve_same_batch(t(signals), t(firs), block_fft=None)
        assert_close(got, jc.fft_convolve_same_batch(jnp.asarray(signals), jnp.asarray(firs), block_fft=None),
                     rtol=1e-12)
        assert torch.equal(got, convolve.fft_convolve_same_batch(t(signals), t(firs), 1 << 16))

    def test_blocked_branch_of_one_channel(self, rng):
        x = rng.randn(40_000)
        taps = rng.randn(301)
        got = convolve.fft_convolve_same_batch(t(x[None]), t(taps[None]), block_fft=4096)[0]
        assert_close(got, jc.fft_convolve_same(jnp.asarray(x), jnp.asarray(taps), 4096))
        assert_close(got, np.convolve(x, taps, mode="same"))


class TestSliding:
    @pytest.mark.parametrize("size", [1, 2, 7, 8, 89])
    def test_max_filter1d(self, rng, size):
        x = rng.rand(3001)
        assert_close(sliding.max_filter1d(t(x), size), js.max_filter1d(jnp.asarray(x), size))

    @pytest.mark.parametrize("window", [44, 45, 3])
    def test_attack_and_hold(self, rng, window):
        x = rng.rand(5000)
        assert_close(
            sliding.sliding_max_attack(t(x), window),
            js.sliding_max_attack(jnp.asarray(x), window),
        )
        assert_close(
            sliding.sliding_max_hold(t(x), window),
            js.sliding_max_hold(jnp.asarray(x), window),
        )
