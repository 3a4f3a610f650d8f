"""The plain reference: its blocked steps equal SciPy's whole-array calls,
and its master equals the port's CPU path in float64 on a few-second
pair (so what the benchmark holds the card to is the algorithm)."""

import numpy as np
import pytest
import torch
from scipy import ndimage, signal

from perfbench import signals
from perfbench.reference import matchering as reference
from perfbench.tests.test_perfbench_signals import LOUD, TARGET


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(reference, "BLOCK", 1000)


def test_blocked_sliding_maxima_equal_scipy(small_blocks):
    x = np.random.default_rng(0).random(10_007)
    for hold in (44, 45, 96):
        half = (hold - 1) // 2
        direct = ndimage.maximum_filter1d(np.pad(x, (half, 0)), size=hold)[:-half]
        assert np.array_equal(reference._windowed_max(x, hold, hold - 1, pad_zeros=True), direct)
    for size in (89, 193):
        direct = ndimage.maximum_filter1d(x, size=size)
        assert np.array_equal(reference._windowed_max(x, size, size // 2, pad_zeros=False), direct)


@pytest.mark.parametrize("taps", [4096, 33])
def test_blocked_convolution_equals_fftconvolve_same(small_blocks, taps):
    rng = np.random.default_rng(1)
    x, f = rng.standard_normal(10_007), rng.standard_normal(taps)
    direct = signal.fftconvolve(1.5 * x, f, "same")
    np.testing.assert_allclose(reference.convolve_same(x, f, 1.5), direct, rtol=0, atol=1e-11)


def test_blocked_limiter_equals_the_whole_array_form(small_blocks):
    p = reference.parameters({})
    track = np.random.default_rng(2).standard_normal((20_000, 2)) * 0.6
    # the Hyrax limiter written out whole (limiter/hyrax.py)
    threshold, sr = p["threshold"], p["internal_sample_rate"]
    rect = np.maximum(np.abs(track).max(1), threshold) / threshold
    clip_gain = 1 - 1 / rect
    attack = int(sr * 1e-3)
    slided = ndimage.maximum_filter1d(clip_gain, size=2 * (attack + 1 - attack % 2) - 1)
    c = np.exp(-2.0 / attack)
    attack_gain = signal.filtfilt([1 - c], [1, -c], slided)
    half = (attack - 1) // 2
    held = ndimage.maximum_filter1d(np.pad(slided, (half, 0)), size=attack)[:-half]
    hold_out = signal.lfilter(*signal.butter(1, 7.0, fs=sr), held)
    release_out = signal.lfilter(*signal.butter(1, 800.0 / 3000.0, fs=sr), np.maximum(held, hold_out))
    gain = 1 - np.maximum(np.maximum(clip_gain, attack_gain), np.maximum(hold_out, release_out))
    np.testing.assert_allclose(reference.limit(track, p), track * gain[:, None], rtol=0, atol=1e-15)
    quiet = track * 0.1
    assert reference.limit(quiet, p) is quiet


def test_pcm16_codes():
    x = np.array([[0.5 / 32768, 1.5 / 32768], [1.0, -1.5], [-2.5 / 32768, 0.999]])
    assert reference.pcm16_codes(x).tolist() == [[0, 2], [32767, -32768], [-2, 32735]]


@pytest.fixture(scope="module")
def pair():
    gen = signals.generator(2**31 + 99, "cpu")
    target = signals.pcm16(signals.track(44100 * 6, 44100, TARGET, gen, "cpu"))
    ref = signals.pcm16(signals.track(44100 * 5, 44100, LOUD, gen, "cpu"))
    return target, ref


def test_the_reference_is_the_ports_algorithm_in_float64(pair):
    import matchering_tpu_torch as mt

    target, ref = pair
    expected = reference.master(target.numpy() / 32768.0, ref.numpy() / 32768.0, {})
    port = mt.master(target, ref, mt.Config(dtype="float64"), device="cpu").result.numpy()
    rel = np.sqrt(np.sum((port - expected) ** 2) / np.sum(expected**2))
    assert rel < 1e-10
    assert np.array_equal(reference.pcm16_codes(port), reference.pcm16_codes(expected))


def test_the_reference_follows_a_96k_configuration(pair):
    import matchering_tpu_torch as mt

    target, ref = pair  # read as 96 kHz tracks: the grids and the limiter follow the rate
    config = mt.Config(dtype="float64", internal_sample_rate=96000, max_length=7200)
    expected = reference.master(target.numpy() / 32768.0, ref.numpy() / 32768.0,
                                {"internal_sample_rate": 96000})
    port = mt.master(target, ref, config, device="cpu").result.numpy()
    assert np.sqrt(np.sum((port - expected) ** 2) / np.sum(expected**2)) < 1e-10


def test_float32_on_the_cpu_sits_inside_the_limits(pair):
    import matchering_tpu_torch as mt
    from perfbench import harness

    target, ref = pair
    expected = reference.master(target.numpy() / 32768.0, ref.numpy() / 32768.0, {})
    port = mt.master(target, ref, mt.Config(), device="cpu").result.numpy().astype(np.float64)
    limits = harness.Cell.load("longform96k.master").limits
    assert np.sqrt(np.sum((port - expected) ** 2) / np.sum(expected**2)) < limits["rel_rms_error"]
    assert np.abs(port - expected).max() < limits["max_abs_error"]
    torch.testing.assert_close(torch.tensor(port), torch.tensor(expected), rtol=0, atol=1e-5)
