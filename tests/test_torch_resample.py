"""The port's resampler and input conditioning against the JAX package.

``matchering_tpu_torch.ops.resample.resample`` runs the JAX package's
polyphase plan as one float64 product (or, for rate pairs whose plan is too
large, the same host windowed evaluation), so on the CPU at float64 it must
match ``matchering_tpu.ops.resample.resample`` to 1e-12 with the same
output length.  ``check()`` must then give the same track, rate and coded
events as the JAX ``check`` for off-rate inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matchering_tpu as mj
import matchering_tpu_torch as mt
from matchering_tpu.ops import resample as jresample
from matchering_tpu_torch.ops import resample as tresample

TOL = 1e-12
PLAN_PAIRS = [(48000, 44100), (96000, 44100), (88200, 44100), (32000, 44100),
              (22050, 44100), (44100, 48000)]
WINDOWED_PAIRS = [(44101, 44100)]


def _signal(seed, n, channels, integer):
    x = np.random.RandomState(seed).randn(n, channels) * 0.3
    x = x[:, 0] if channels == 1 else x
    if integer:
        return np.clip(x * 2**15, -(2**15), 2**15 - 1).astype(np.int16)
    return x


def _jax_resample(x, sr_in, sr_out):
    if np.issubdtype(x.dtype, np.integer):
        x = x.astype(np.float64) / 2**15
    return np.asarray(jresample.resample(jnp.asarray(x), sr_in, sr_out))


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int16"])
@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("sr_in,sr_out", PLAN_PAIRS + WINDOWED_PAIRS)
def test_resample_matches_jax(sr_in, sr_out, channels, integer):
    x = _signal(sr_in + channels, 2999, channels, integer)
    want = _jax_resample(x, sr_in, sr_out)
    got = tresample.resample(torch.from_numpy(x), sr_in, sr_out)
    assert got.dtype == torch.float64
    assert tuple(got.shape) == want.shape
    assert float(np.max(np.abs(got.numpy() - want))) <= TOL


def test_windowed_route_is_taken_for_a_large_plan():
    assert tresample._plan_bytes(44101, 44100) > tresample._PLAN_BYTES_CAP
    for sr_in, sr_out in PLAN_PAIRS:
        assert tresample._plan_bytes(sr_in, sr_out) <= tresample._PLAN_BYTES_CAP


def test_plan_is_the_jax_plan():
    got = tresample.plan_resample(48000, 44100)
    want = jresample.plan_resample(48000, 44100)
    assert got[:6] == want[:6]
    np.testing.assert_array_equal(got.weights, want.weights)


def test_chunked_product_matches_jax(monkeypatch):
    """The window-bytes cap splits the product over blocks; with a cap of a
    few blocks the result must not change."""
    x = _signal(7, 20_000, 2, False)
    width = tresample.plan_resample(48000, 44100).weights.shape[1]
    monkeypatch.setattr(tresample, "_WINDOW_BYTES_CAP", 3 * 2 * width * 8)
    got = tresample.resample(torch.from_numpy(x), 48000, 44100).numpy()
    want = _jax_resample(x, 48000, 44100)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= TOL


def test_same_rate_converts_only():
    x = _signal(3, 1000, 2, True)
    got = tresample.resample(torch.from_numpy(x), 44100, 44100)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), x / 2**15)


def _events(package):
    events = []
    package.log(
        info_handler=events.append, warning_handler=events.append,
        debug_handler=events.append, show_codes=True,
    )
    return events


def _check_both(array, rate, role, **config):
    try:
        jax_events = _events(mj)
        want, want_rate = mj.check(array, rate, mj.Config(**config), role)
        port_events = _events(mt)
        got, got_rate = mt.check(array, rate, mt.Config(**config), role, device="cpu")
    finally:
        mj.log()
        mt.log()
    return (np.asarray(want), want_rate, jax_events), (got, got_rate, port_events)


@pytest.mark.parametrize(
    "role,rate,channels,config",
    [
        ("target", 48000, 1, {}),
        ("reference", 48000, 2, {}),
        ("target", 44100, 2, {"internal_sample_rate": 48000}),
    ],
    ids=["target-48k-mono", "reference-48k-stereo", "target-44k-to-48k"],
)
def test_check_matches_jax(role, rate, channels, config):
    """Raw int16 PCM, as process() stages it: resampled on the device, the
    same samples, rate and event stream as the JAX package."""
    pcm = _signal(rate + channels, 3 * rate, channels, True)
    pcm = pcm[:, None] if channels == 1 else pcm
    (want, want_rate, want_events), (got, got_rate, got_events) = _check_both(
        pcm, rate, role, **config
    )
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert got_rate == want_rate
    assert tuple(got.shape) == want.shape
    assert float(np.max(np.abs(got.numpy() - want))) <= TOL
    assert got_events == want_events
    resampled = {"target": "3003:", "reference": "2202:"}[role]
    assert any(e.startswith(resampled) for e in got_events)


def test_check_equality_compares_tensors():
    x = torch.from_numpy(_signal(1, 5000, 2, False))
    with pytest.raises(mt.ModuleError) as error:
        mt.check_equality(x, x.clone())
    assert error.value.code == mt.Code.ERROR_TARGET_EQUALS_REFERENCE
    codes = (x.numpy() * 2**15).round().astype(np.int16)
    with pytest.raises(mt.ModuleError):
        mt.check_equality(codes, torch.from_numpy(codes / 2**15))
    mt.check_equality(x, x * 1.001)  # beyond np.allclose's tolerance
    mt.check_equality(x, x[:-1])
