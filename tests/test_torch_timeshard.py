"""The port's time sharding against the JAX package's, on the CPU.

Eight shards in one process (``TimeGrid(["cpu"] * 8)``; K1 and K2 run
their plain twins) against the JAX package's sharded functions on the
8-device virtual CPU mesh of ``tests/conftest.py``, and against the port's
own single-device functions, at float64 on inputs made with numpy from a
seed.  Tolerances: the convolution 1e-8 (``rtol`` and ``atol``, as
``tests/test_timeshard.py``), every other op 1e-9; masters >= 200 dB SNR
(float64 rounding apart, the same chain), the float32 port > 95 dB against
the JAX float64 result (the JAX package's float32 gate).  Two large JAX
sharded graphs are compiled here, ``limit_sharded`` and ``master_sharded``
(the padded length; ``tests/test_torch_mesh.py`` compiles ``master_farm``);
the per-op references are small ones.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import matchering_tpu as mj
import matchering_tpu_torch as mt
from matchering_tpu.ops import iir as jiir
from matchering_tpu.parallel import mesh as jmesh
from matchering_tpu.parallel import timeshard as jts
from matchering_tpu_torch import state
from matchering_tpu_torch.kernels import envelope
from matchering_tpu_torch.ops import basics, convolve, iir, sliding, spectrum
from matchering_tpu_torch.parallel import mesh, timeshard
from matchering_tpu_torch.utils import RowInts
from test_torch_pipeline import make_pair

SHARDS = 8
VARIANTS = ("result", "result_no_limiter", "result_no_limiter_normalized")
ALL = dict(need_default=True, need_no_limiter=True, need_no_limiter_normalized=True)
THRESHOLD = mt.Config().threshold
ATTACK = 44  # Config().limiter.attack at 44.1 kHz, in samples
GRID = timeshard.TimeGrid(["cpu"] * SHARDS)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.single_axis_mesh("time")


def jax_sharded(jax_mesh, fn, *arrays, out=P("time")):
    """Apply a shard-local JAX function over arrays sharded on time."""
    specs = tuple(P("time", *([None] * (np.ndim(a) - 1))) for a in arrays)
    wrapped = shard_map(fn, mesh=jax_mesh, in_specs=specs, out_specs=out, check_vma=False)
    return np.asarray(jax.jit(wrapped)(*[jnp.asarray(a) for a in arrays]))


def shards(x):
    return GRID.split(torch.from_numpy(np.ascontiguousarray(x)), x.shape[0] // SHARDS)


def whole(parts, n):
    return GRID.join(parts, n, "cpu").numpy()


def gains(stereo):
    """The hard-clip gain the attack max reads: ``flip(1/rectify(x))``."""
    return 1.0 - 1.0 / np.maximum(np.abs(stereo).max(1), THRESHOLD) * THRESHOLD


def _ops(rng):
    """Each sharded op: (port sharded, port single-device, JAX sharded),
    every one a function of nothing, returning numpy."""
    attack = iir.one_pole_filter(-2.0, 44.0)
    j_attack = jiir.one_pole_filter(-2.0, 44.0)
    hold = iir.butter1_coefficients(7.0, 44100)
    j_hold = jiir.butter1_coefficients(7.0, 44100)
    x_conv, h = rng.randn(SHARDS * 4096), rng.randn(4096)
    x_lf = rng.randn(SHARDS * 2000)
    x_ff = np.abs(rng.randn(SHARDS * 1500))
    cut = SHARDS * 1500 - 5
    stereo = rng.randn(SHARDS * 1000, 2)
    x_hold = np.abs(rng.randn(SHARDS * 1000))
    x_rms = rng.randn(SHARDS * 3000)
    mask = (rng.rand(8) > 0.4).astype(np.float64)

    def front_end(length=None):
        lengths = None if length is None else RowInts.of([length], "cpu")
        got = envelope.limiter_front_end(torch.from_numpy(stereo)[None], THRESHOLD, ATTACK, lengths)
        return got[1][0].numpy()

    def jax_attack(length=None):
        g = gains(stereo)
        if length is None:
            return lambda m: jax_sharded(m, lambda x: jts.sliding_max_attack_sharded(x, ATTACK, "time"), g)
        g = np.where(np.arange(g.size) < length, g, 0.0)

        def local(x):
            slided = jts.sliding_max_attack_sharded(x, ATTACK, "time")
            return jts._attack_tail_patch_sharded(slided, x, ATTACK, jnp.int32(length), "time")

        return lambda m: jax_sharded(m, local, g)[:length]

    def port_attack(length=None):
        parts = shards(stereo)
        slided = timeshard.limiter_front_end_sharded(parts, THRESHOLD, ATTACK, GRID, length)[1]
        got = whole(slided, stereo.shape[0])
        return got if length is None else got[:length]

    spectrum_args = (2900, 8, 512)
    return {
        "convolve": (
            lambda: whole(timeshard.convolve_same_sharded(shards(x_conv), torch.from_numpy(h), GRID), x_conv.size),
            lambda: convolve.fft_convolve_same_batch(torch.from_numpy(x_conv)[None], torch.from_numpy(h)[None])[0].numpy(),
            lambda m: jax_sharded(m, lambda x: jts.convolve_same_sharded(x, jnp.asarray(h), "time"), x_conv),
        ),
        "lfilter": (
            lambda: whole(timeshard.lfilter_first_order_sharded(hold, shards(x_lf), GRID), x_lf.size),
            lambda: iir.lfilter_first_order(hold, torch.from_numpy(x_lf)).numpy(),
            lambda m: jax_sharded(m, lambda x: jts.lfilter_first_order_sharded(j_hold, x, "time"), x_lf),
        ),
        "filtfilt": (
            lambda: whole(timeshard.filtfilt_first_order_sharded(attack, shards(x_ff), GRID), x_ff.size),
            lambda: iir.filtfilt_first_order(attack, torch.from_numpy(x_ff)).numpy(),
            lambda m: jax_sharded(m, lambda x: jts.filtfilt_first_order_sharded(j_attack, x, "time"), x_ff),
        ),
        "filtfilt_truncated": (
            lambda: whole(
                timeshard.filtfilt_first_order_sharded_truncated(attack, shards(x_ff), cut, GRID), x_ff.size
            ),
            lambda: iir.filtfilt_first_order(
                attack, torch.from_numpy(x_ff)[None], RowInts.of([cut], "cpu")
            )[0].numpy(),
            lambda m: jax_sharded(
                m, lambda x: jts.filtfilt_first_order_sharded_truncated(j_attack, x, jnp.int32(cut), "time"), x_ff
            ),
        ),
        "attack_max": (port_attack, front_end, jax_attack()),
        "attack_max_truncated": (
            lambda: port_attack(SHARDS * 1000 - 7),
            lambda: front_end(SHARDS * 1000 - 7)[: SHARDS * 1000 - 7],
            jax_attack(SHARDS * 1000 - 7),
        ),
        "hold_max": (
            lambda: whole(timeshard.sliding_max_hold_sharded(shards(x_hold), ATTACK, GRID), x_hold.size),
            lambda: sliding.sliding_max_hold(torch.from_numpy(x_hold), ATTACK).numpy(),
            lambda m: jax_sharded(m, lambda x: jts.sliding_max_hold_sharded(x, ATTACK, "time"), x_hold),
        ),
        "piece_rms": (
            lambda: timeshard.piece_rms_sharded(shards(x_rms), 1700, 14, GRID)[0].numpy(),
            lambda: basics.piece_rms_flat(torch.from_numpy(x_rms), 1700, 14).numpy(),
            lambda m: jax_sharded(m, lambda x: jts.piece_rms_sharded(x, 1700, 14, "time"), x_rms, out=P()),
        ),
        "spectrum": (
            lambda: timeshard.masked_average_spectrum_sharded(
                shards(x_rms), [torch.from_numpy(mask)], *spectrum_args, GRID
            )[0].numpy(),
            lambda: spectrum.masked_average_spectrum_flat_pair(
                torch.from_numpy(x_rms), torch.from_numpy(x_rms), torch.from_numpy(mask), *spectrum_args
            )[0].numpy(),
            lambda m: jax_sharded(
                m, lambda x: jts.masked_average_spectrum_sharded(x, jnp.asarray(mask), *spectrum_args, "time"),
                x_rms, out=P(),
            ),
        ),
        # JAX's keywords (mask=, piece_size=, ...) with the sharded form's parts and grid
        "spectrum_keywords": (
            lambda: timeshard.masked_average_spectrum_sharded(
                shards(x_rms), mask=[torch.from_numpy(mask)], piece_size=spectrum_args[0],
                divisions=spectrum_args[1], fft_size=spectrum_args[2], grid=GRID,
            )[0].numpy(),
            lambda: spectrum.masked_average_spectrum_flat_pair(
                torch.from_numpy(x_rms), torch.from_numpy(x_rms), torch.from_numpy(mask), *spectrum_args
            )[0].numpy(),
            lambda m: jax_sharded(
                m, lambda x: jts.masked_average_spectrum_sharded(
                    x, mask=jnp.asarray(mask), piece_size=spectrum_args[0], divisions=spectrum_args[1],
                    fft_size=spectrum_args[2], axis="time",
                ),
                x_rms, out=P(),
            ),
        ),
        "global_peak": (
            lambda: timeshard.global_peak(shards(stereo), GRID)[0].numpy(),
            lambda: np.abs(stereo).max(),
            lambda m: jax_sharded(m, lambda x: jts.global_peak(x, "time"), stereo, out=P()),
        ),
    }


OPS = list(_ops(np.random.RandomState(0)))


@pytest.fixture(scope="module")
def ops():
    return _ops(np.random.RandomState(0xC0FFEE))


@pytest.mark.parametrize("against", ["port", "jax"])
@pytest.mark.parametrize("name", OPS)
def test_sharded_op(ops, jax_mesh, name, against):
    port_sharded, port_single, jax_op = ops[name]
    got = port_sharded()
    want = port_single() if against == "port" else jax_op(jax_mesh)
    tol = 1e-8 if name == "convolve" else 1e-9
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("devices", [["cpu"] * 3, ["cpu", "cpu:0", "cpu"]], ids=["stacked", "interleaved"])
def test_halos_and_collectives_follow_shard_order(devices):
    """Shards stacked as rows of one tensor, or interleaved over two
    devices ("cpu" and "cpu:0" are two torch devices), see their true
    neighbours, and gathers come back in shard order."""
    grid = timeshard.TimeGrid(devices)
    x = torch.arange(12.0).reshape(12, 1)
    parts = grid.split(x, 4)
    assert sum(p.shape[0] for p in parts) == 3 and len(parts) == len(set(devices))
    left = grid.gather(grid.halo_left(parts, 2))[0][:, :, 0].tolist()
    right = grid.gather(grid.halo_right(parts, 1))[0][:, :, 0].tolist()
    assert left == [[0, 0], [2, 3], [6, 7]] and right == [[4], [8], [0]]
    assert grid.join(grid.split(x[:10], 4), 10, "cpu").equal(x[:10])
    assert [float(v) for v in grid.bcast([p[:, 0, 0] for p in parts], 2)] == [8.0] * len(parts)
    assert float(grid.psum([p.sum((1, 2)) for p in parts])[0]) == 66.0


@pytest.fixture(scope="module")
def loud():
    sr = 44100
    n = SHARDS * sr // 2  # 4 s, divisible by 8
    t = np.arange(n) / sr
    wave = 1.3 * np.sin(2 * np.pi * 440 * t) * (1 + 0.4 * np.sin(2 * np.pi * t))
    return np.stack([wave, 0.95 * wave], axis=1)


@pytest.mark.parametrize("against", ["port", "port-length", "jax"])
def test_limit_sharded(loud, jax_mesh, against):
    config = mt.Config(dtype="float64")
    n = loud.shape[0]
    length = n - 3 if against == "port-length" else None
    got = whole(timeshard.limit_sharded(shards(loud), config, GRID, length=length), n)
    if against == "port":
        want = mt.limit(torch.from_numpy(loud), config).numpy()
    elif against == "port-length":
        want = mt.limit(torch.from_numpy(loud)[None], config, length=[length])[0].numpy()
    else:
        jconfig = mj.Config(dtype="float64")
        want = jax_sharded(
            jax_mesh, lambda a: jts.limit_sharded(a, jconfig, "time"), loud, out=P("time", None)
        )
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_limit_sharded_refuses_higher_orders(loud):
    for orders in ((2, 1), (1, 2), (2, 2)):
        config = mt.Config(
            dtype="float64",
            limiter=mt.LimiterConfig(hold_filter_order=orders[0], release_filter_order=orders[1]),
        )
        with pytest.raises(NotImplementedError, match="first-order"):
            timeshard.limit_sharded(shards(loud), config, GRID)
        with pytest.raises(NotImplementedError, match="first-order"):
            timeshard.master_sharded(
                loud, loud * 0.5, config, mesh=mesh.single_axis_mesh("time", devices=["cpu"] * 2)
            )


# ---------------------------------------------------------------------------
# master_sharded

CUTS = {"divisible": (0, 0), "padded": (13, 5)}  # samples cut from (target, reference)


@pytest.fixture(scope="module")
def pairs():
    target, reference = make_pair(4, 5)  # 176,400 samples: divisible by 8
    return {
        name: (target[: target.shape[0] - t], reference[: reference.shape[0] - r])
        for name, (t, r) in CUTS.items()
    }


@pytest.fixture(scope="module")
def config64():
    return mj.Config(dtype="float64", max_piece_size=2)  # 3 pieces per track


@pytest.fixture(scope="module")
def port_sharded(pairs, config64):
    config = state.config_from_dict(dataclasses.asdict(config64))
    time_mesh = mesh.single_axis_mesh("time", devices=["cpu"] * SHARDS)
    return {
        name: timeshard.master_sharded(t, r, config, mesh=time_mesh, **ALL)
        for name, (t, r) in pairs.items()
    }


@pytest.fixture(scope="module")
def jax_padded(pairs, config64):
    out = jts.master_sharded(*pairs["padded"], config64, **ALL)
    return {k: np.asarray(getattr(out, k)) for k in VARIANTS}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("cut", list(CUTS))
def test_master_sharded_matches_port_master(pairs, config64, port_sharded, snr, cut, variant):
    config = state.config_from_dict(dataclasses.asdict(config64))
    want = getattr(mt.master(*pairs[cut], config, device="cpu", **ALL), variant).numpy()
    got = getattr(port_sharded[cut], variant).numpy()
    assert got.shape == want.shape == (pairs[cut][0].shape[0], 2)
    measured = snr(want, got)
    assert measured >= 200.0, measured


@pytest.mark.parametrize("variant", VARIANTS)
def test_master_sharded_matches_jax(port_sharded, jax_padded, snr, variant):
    got = getattr(port_sharded["padded"], variant).numpy()
    measured = snr(jax_padded[variant], got)
    assert measured >= 200.0, measured


@pytest.mark.parametrize("variant", VARIANTS)
def test_master_sharded_float32_above_jax_gate(pairs, jax_padded, snr, variant):
    time_mesh = mesh.single_axis_mesh("time", devices=["cpu"] * SHARDS)
    out = timeshard.master_sharded(*pairs["padded"], mt.Config(max_piece_size=2), mesh=time_mesh, **ALL)
    got = getattr(out, variant)
    assert got.dtype == torch.float32
    measured = snr(jax_padded[variant], got.numpy())
    assert measured > 95.0, measured


def test_master_sharded_report_matches_master(pairs, config64, port_sharded):
    config = state.config_from_dict(dataclasses.asdict(config64))
    want = mt.master(*pairs["padded"], config, device="cpu", **ALL).report
    got = port_sharded["padded"].report
    assert sorted(got) == sorted(want)
    for key in want:
        assert abs(float(got[key]) - float(want[key])) <= 1e-12 * abs(float(want[key])), key


def test_master_sharded_takes_integer_pcm_and_tensors(pairs):
    target, reference = pairs["divisible"]
    codes = [np.round(x * 32767).astype(np.int16) for x in (target, reference)]
    config = mt.Config(dtype="float64", max_piece_size=2)
    time_mesh = mesh.single_axis_mesh("time", devices=["cpu"] * 4)
    from_codes = timeshard.master_sharded(*codes, config, mesh=time_mesh)
    from_tensors = timeshard.master_sharded(*(torch.from_numpy(c) for c in codes), config, mesh=time_mesh)
    want = mt.master(*codes, config, device="cpu")
    assert torch.equal(from_codes.result, from_tensors.result)
    np.testing.assert_allclose(from_codes.result.numpy(), want.result.numpy(), rtol=0, atol=1e-12)


def test_master_sharded_refuses_short_shards():
    with pytest.raises(ValueError, match="widest halo"):
        timeshard.master_sharded(
            np.zeros((30_000, 2)), np.zeros((30_000, 2)), mt.Config(dtype="float64"),
            mesh=mesh.single_axis_mesh("time", devices=["cpu"] * 8),
        )


def test_master_sharded_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        timeshard.master_sharded(np.zeros((50_000, 2)), np.zeros((50_000, 2)))


def test_import_loads_no_jax():
    code = (
        "import sys, matchering_tpu_torch, matchering_tpu_torch.parallel.timeshard, "
        "matchering_tpu_torch.parallel.mesh; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'matchering_tpu')]; "
        "assert not bad, bad"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, timeout=120)
