"""The port's previews against the JAX package, on the CPU at float64.

``_loudest_window_index`` must choose the JAX package's window exactly,
including on a result whose two loudest windows differ by less than 1e-6
relative, and ``create_preview`` must write the same target and result
pieces to 1e-12, including previews as long as the track or longer.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matchering_tpu as mj
import matchering_tpu_torch as mt
from matchering_tpu import preview as jpreview
from matchering_tpu.io import wav as jwav
from matchering_tpu.ops import basics as jbasics
from matchering_tpu_torch import preview as tpreview
from matchering_tpu_torch import state
from matchering_tpu_torch.ops import basics as tbasics

TOL = 1e-12


def _noise(seed, n):
    return np.random.RandomState(seed).randn(n, 2) * 0.2


def _near_tie(step, window, steps, ratio):
    """Loud windows at the start and the end of the track, the later one
    ``ratio`` times louder in amplitude, quiet noise between them."""
    rng = np.random.RandomState(11)
    n = steps * step
    result = rng.randn(n, 2) * 0.01
    loud = rng.randn(window, 2) * 0.5
    result[:window] = loud
    result[n - window :] = loud * ratio
    return result


def _energies(result, window, step):
    count = (result.shape[0] - window) // step + 1
    energy = np.sum(result**2, axis=1)
    return np.array([energy[b * step : b * step + window].sum() for b in range(count)])


CASES = {
    "noise-k3": (_noise(1, 9_000), 600, 200),
    "noise-k3-r70": (_noise(2, 9_001), 670, 200),
    "noise-one-step-over": (_noise(3, 900), 700, 200),
    "near-tie": (_near_tie(200, 600, 40, 1 + 2e-7), 600, 200),
    "near-tie-r50": (_near_tie(200, 650, 41, 1 + 2e-7), 650, 200),
    "window-equals-track": (_noise(4, 600), 600, 200),
    "window-exceeds-track": (_noise(5, 500), 600, 200),
}


@pytest.mark.parametrize("case", CASES)
def test_loudest_window_index_matches_jax(case):
    result, window, step = CASES[case]
    want = int(jpreview._loudest_window_index(jnp.asarray(result), window, step))
    got = tpreview._loudest_window_index(torch.from_numpy(result), window, step)
    assert got == want
    # a float32 result is searched in float64 too
    got32 = tpreview._loudest_window_index(torch.from_numpy(result).float(), window, step)
    assert got32 == int(jpreview._loudest_window_index(
        jnp.asarray(result.astype(np.float32).astype(np.float64)), window, step
    ))


def test_near_tie_is_a_near_tie():
    result, window, step = CASES["near-tie"]
    top = np.sort(_energies(result, window, step))[-2:]
    assert 0 < (top[1] - top[0]) / top[1] < 1e-6


@pytest.mark.parametrize("shape,fade_size", [((300, 2), 1), ((300, 2), 37), ((300,), 5)])
def test_fade_matches_jax(shape, fade_size, rng):
    x = rng.randn(*shape)
    got = tbasics.fade(torch.from_numpy(x), fade_size).numpy()
    want = np.asarray(jbasics.fade(jnp.asarray(x), fade_size))
    assert float(np.max(np.abs(got - want))) <= TOL


# internal_sample_rate 8000 keeps the seconds-based preview sizes short
PREVIEW_CONFIG = dict(dtype="float64", internal_sample_rate=8000, preview_size=6,
                      preview_analysis_step=2, preview_fade_size=1)


@pytest.mark.parametrize("seconds", [17, 6, 5], ids=["cut", "piece-is-track", "track-shorter"])
@pytest.mark.parametrize("integer_target", [False, True], ids=["float", "int16"])
def test_create_preview_matches_jax(tmp_path, seconds, integer_target):
    jconfig = mj.Config(**PREVIEW_CONFIG)
    tconfig = state.config_from_dict(dataclasses.asdict(jconfig))
    rng = np.random.RandomState(seconds)
    n = seconds * 8000
    env = 0.2 + np.abs(np.sin(np.arange(n) / 8000 * 0.7))[:, None]
    result = rng.randn(n, 2) * 0.3 * env
    target = np.clip(rng.randn(n, 2) * 0.5, -1, 1)  # some samples over the threshold
    if integer_target:
        target = (target * 2**15).clip(-(2**15), 2**15 - 1).astype(np.int16)
    paths = {k: str(tmp_path / f"{k}.wav") for k in ("jt", "jr", "tt", "tr")}
    mj.create_preview(target, jnp.asarray(result), jconfig,
                      mj.Result(paths["jt"], "DOUBLE"), mj.Result(paths["jr"], "DOUBLE"))
    mt.create_preview(target, torch.from_numpy(result), tconfig,
                      mt.Result(paths["tt"], "DOUBLE"), mt.Result(paths["tr"], "DOUBLE"))
    for jax_key, port_key in (("jt", "tt"), ("jr", "tr")):
        want, want_rate = jwav.read(paths[jax_key])
        got, got_rate = jwav.read(paths[port_key])
        assert got_rate == want_rate == 8000
        assert got.shape == want.shape == (min(n, 6 * 8000), 2)
        assert float(np.max(np.abs(got - want))) <= TOL


def test_create_preview_writes_only_what_is_asked(tmp_path):
    config = mt.Config(dtype="float64", internal_sample_rate=8000, preview_size=6)
    result = torch.from_numpy(_noise(6, 7 * 8000))
    mt.create_preview(result.numpy(), result, config, None, mt.pcm16(str(tmp_path / "r.wav")))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["r.wav"]
