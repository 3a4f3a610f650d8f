"""The whole chain under every ``Config`` the JAX package honours, on the CPU.

The non-default configurations (Butterworth hold/release orders above 1,
``lowess_it > 0``, ``lowess_exact``, ``lowess_delta = 0``) through
``master``, ``limit``, ``process``, ``process_batch``, ``master_batch`` and
``stages.main``: ``master`` against ``matchering_tpu.master`` at >= 200 dB
(float64) and > 95 dB (the port's float32 against JAX float64); ``limit``
against a long-double ``sosfilt`` release stage (1e-9) and against the
JAX limiter at the SNR its order-2 fault allows; the farm's entry points
within one PCM_16 step of ``process()``.  The filters and the smoother
themselves are held to scipy and JAX in ``test_torch_configs.py``.

Every config here takes ``fft_size=1024`` (a 2049-point log grid): the
default 4096's smoothing operators take ~6 s to build on the host, and
tens of times that with the tier-1 run's six workers contending for
memory.  ``chip_smoke.py`` runs the default size on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

import matchering_tpu as mj
from matchering_tpu.ops import smoothing as jsm
import matchering_tpu_torch as mt
from matchering_tpu_torch import stages, state
from matchering_tpu_torch.io import wav
from matchering_tpu_torch.ops import iir
from matchering_tpu_torch.parallel import batch

FILTER_TOL = 1e-9
ORDERS_2_2 = dict(hold_filter_order=2, release_filter_order=2)
LOWESS_CONFIGS = [{"lowess_it": 1}, {"lowess_exact": True}]
SMALL = dict(fft_size=1024)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def sosfilt_ld(sections, x):
    """``scipy.signal.sosfilt`` in long double, rounded to float64."""
    sections = np.asarray(sections, dtype=np.longdouble)
    return signal.sosfilt(sections, np.asarray(x, np.longdouble), axis=-1).astype(np.float64)


SR = 44100
VARIANTS = ("result", "result_no_limiter", "result_no_limiter_normalized")
ALL = dict(need_default=True, need_no_limiter=True, need_no_limiter_normalized=True)


def make_pair(seconds, seed):
    r = np.random.RandomState(seed)
    n = int(seconds * SR)
    env = 0.5 + 0.5 * np.sin(np.arange(n) / SR * 1.3)[:, None]
    target = np.clip(0.3 * r.randn(n, 2) * env, -1, 1)
    reference = np.clip(0.9 * r.randn(n, 2) * env, -1, 1)
    return target, reference


@pytest.fixture(scope="module")
def pair():
    return make_pair(8, 5)


@pytest.fixture(scope="module", params=LOWESS_CONFIGS, ids=["lowess_it=1", "lowess_exact"])
def jax_master(request, pair):
    config = mj.Config(dtype="float64", max_piece_size=2, **SMALL, **request.param)
    out = mj.master(jnp.asarray(pair[0]), jnp.asarray(pair[1]), config, **ALL)
    return request.param, config, {k: np.asarray(getattr(out, k)) for k in VARIANTS}


def test_master_float64_matches_jax(pair, jax_master, snr):
    _, config, want = jax_master
    out = mt.master(pair[0], pair[1], state.config_from_dict(dataclasses.asdict(config)),
                    device="cpu", **ALL)
    for variant in VARIANTS:
        measured = snr(want[variant], getattr(out, variant).numpy())
        assert measured >= 200.0, (variant, measured)


def test_master_float32_above_jax_gate(pair, jax_master, snr):
    kwargs, _, want = jax_master
    out = mt.master(pair[0], pair[1], mt.Config(max_piece_size=2, **SMALL, **kwargs), device="cpu", **ALL)
    for variant in VARIANTS:
        assert getattr(out, variant).dtype == torch.float32
        measured = snr(want[variant], getattr(out, variant).numpy())
        assert measured > 95.0, (variant, measured)


def test_master_graph_takes_the_jax_pair_of_an_unfolded_lowess(pair, jax_master, snr):
    """``master_graph(target, reference, config, need_default,
    need_no_limiter, need_no_limiter_normalized, interp_ops)`` with the
    JAX package's ``operator_arrays_for_config`` pair of a LOWESS that does
    not fold: the plain operators, the staged LOWESS plan of ``config``
    beside them; JAX's master >= 200 dB."""
    _, jconfig, want = jax_master
    interp_ops = tuple(np.asarray(op) for op in jsm.operator_arrays_for_config(jconfig))
    config = state.config_from_dict(dataclasses.asdict(jconfig))
    out = stages.master_graph(t(pair[0]), t(pair[1]), config, True, True, True, interp_ops)
    for variant in VARIANTS:
        measured = snr(want[variant], getattr(out, variant).numpy())
        assert measured >= 200.0, (variant, measured)


@pytest.fixture(scope="module")
def loud():
    return np.random.RandomState(3).randn(100_000, 2) * 0.8  # many samples over the threshold


def test_limit_orders_2_2_against_jax(loud, snr):
    """The JAX package's order-2 release filter is off scipy (above), and
    its error grows with the track: on this loud 100,000-sample track the
    two limiters agree to 89.36 dB (160.1 dB on 30,000 samples), held here
    at 85 dB.  The JAX suite holds this config at 70 dB against the
    reference (tests/test_pipeline_parity.py)."""
    config = mj.Config(dtype="float64", limiter=mj.LimiterConfig(**ORDERS_2_2))
    want = np.asarray(jax.jit(lambda x: mj.limit(x, config))(jnp.asarray(loud)))
    got = mt.limit(t(loud), state.config_from_dict(dataclasses.asdict(config))).numpy()
    assert snr(want, got) >= 85.0


def _scipy_butter_lowpass(order, cutoff_hz, fs, x):
    sections = signal.butter(order, cutoff_hz, fs=fs, output="sos")
    return torch.from_numpy(sosfilt_ld(sections, x.numpy()))


ORDER_PAIRS = [(2, 2)] + [(h, 9 - h) for h in range(1, 9)]


@pytest.mark.parametrize("hold, release", ORDER_PAIRS, ids=[f"{h}-{r}" for h, r in ORDER_PAIRS])
def test_limit_matches_a_sosfilt_release_stage(loud, monkeypatch, hold, release):
    """``limit()`` at hold/release orders (h, r) within 1e-9 of the same
    limiter whose Butterworth low-passes are ``sosfilt`` in long double."""
    config = mt.Config(
        dtype="float64", limiter=mt.LimiterConfig(hold_filter_order=hold, release_filter_order=release)
    )
    x = t(loud[:30_000])
    got = mt.limit(x, config).numpy()
    monkeypatch.setattr(iir, "butter_lowpass", _scipy_butter_lowpass)
    want = mt.limit(x, config).numpy()
    assert np.max(np.abs(got - want)) <= FILTER_TOL


CONFIGS_2_2 = dict(lowess_it=1, limiter=mt.LimiterConfig(**ORDERS_2_2), **SMALL)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    folder = tmp_path_factory.mktemp("configs")
    paths = []
    for i, (t_sec, r_sec) in enumerate([(3.0, 4.0), (4.5, 3.5)]):
        target, _ = make_pair(t_sec, 40 + i)
        _, reference = make_pair(r_sec, 50 + i)
        pair_paths = (str(folder / f"t{i}.wav"), str(folder / f"r{i}.wav"))
        wav.write(pair_paths[0], target, SR, "PCM_16")
        wav.write(pair_paths[1], reference, SR, "PCM_16")
        paths.append(pair_paths)
    return folder, paths


def _read(path):
    audio, rate = wav.read(str(path), raw_int=True)
    assert rate == SR and audio.dtype == np.int16
    return audio


def _within_one_lsb(a, b):
    assert a.shape == b.shape
    assert np.max(np.abs(a.astype(np.int32) - b)) <= 1


def test_process_batch_and_master_batch_match_process(jobs):
    """Orders 2/2 and ``lowess_it=1``: ``process_batch`` (vmapped) and
    ``master_batch`` against ``process()`` per job, one PCM_16 step."""
    folder, paths = jobs
    config = mt.Config(dtype="float64", **CONFIGS_2_2)
    mt.process_batch(
        [mt.PairJob(tp, rp, [mt.pcm16(str(folder / f"b{i}.wav"))]) for i, (tp, rp) in enumerate(paths)],
        config, dispatch="vmapped", device="cpu",
    )
    tracks = [(wav.read(tp)[0], wav.read(rp)[0]) for tp, rp in paths]
    t_batch, t_lens = batch.bucket_pad([a for a, _ in tracks], 1 << 17, device="cpu")
    r_batch, r_lens = batch.bucket_pad([b for _, b in tracks], 1 << 17, device="cpu")
    out = batch.master_batch(t_batch, r_batch, config, target_lengths=t_lens,
                             reference_lengths=r_lens, device="cpu").result
    for i, (tp, rp) in enumerate(paths):
        mt.process(tp, rp, [mt.pcm16(str(folder / f"s{i}.wav"))], config, device="cpu")
        single = _read(folder / f"s{i}.wav")
        _within_one_lsb(_read(folder / f"b{i}.wav"), single)
        codes = np.clip(np.rint(out[i, : t_lens[i]].numpy() * 32768.0), -32768, 32767)
        _within_one_lsb(codes.astype(np.int16), single)


def test_stages_main_bucketed_matches_unbucketed(snr):
    """``stages.main`` with ``length_bucketing`` (the dynamic graph) and the
    non-default smoother and filters, against the static graph."""
    target, reference = make_pair(4.2, 61)[0], make_pair(3.7, 62)[1]
    config = dict(dtype="float64", **CONFIGS_2_2)
    got = stages.main(target, reference, mt.Config(length_bucketing=1 << 17, **config), device="cpu")
    want = stages.main(target, reference, mt.Config(**config), device="cpu")
    assert got[0].shape == want[0].shape
    assert snr(want[0].numpy(), got[0].numpy()) > 100.0


RUN_CONFIGS = {
    "lowess_it=2": dict(lowess_it=2),
    "lowess_exact": dict(lowess_exact=True),
    "lowess_delta=0": dict(lowess_delta=0.0),
    **{f"orders-{h}-{9 - h}": dict(limiter=mt.LimiterConfig(hold_filter_order=h, release_filter_order=9 - h))
       for h in range(1, 9)},
}


@pytest.fixture(scope="module")
def processed(jobs):
    """``process()`` on the CPU for every non-default config, and the
    default one (each at ``fft_size=1024``)."""
    folder, paths = jobs
    tp, rp = paths[0]
    out = {}
    for name, kwargs in {"default": {}, **RUN_CONFIGS}.items():
        path = folder / f"run_{name}.wav"
        mt.process(tp, rp, [mt.pcm16(str(path))], mt.Config(**SMALL, **kwargs), device="cpu")
        out[name] = _read(path)
    return out


@pytest.mark.parametrize("name", sorted(RUN_CONFIGS))
def test_process_runs_every_config(processed, name):
    audio = processed[name]
    assert audio.shape == processed["default"].shape
    peak = np.max(np.abs(audio.astype(np.int32)))
    assert 0 < peak <= 32767 * mt.Config().threshold + 1
    if name == "lowess_delta=0":  # the exact smoother, by its other name
        np.testing.assert_array_equal(audio, processed["lowess_exact"])
    else:
        assert np.any(audio != processed["default"])
