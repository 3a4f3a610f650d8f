"""The port's dynamic-length path against the JAX package, on the CPU.

Rows of a zero-padded batch carry their true lengths; every length-aware
piece of the port (the kernels' plain twins in their length modes, the
per-row piece statistics and spectra, the limiter, ``master_batch`` and
``stages.main`` with ``length_bucketing``) is held to its JAX counterpart
at float64 on inputs made with numpy from a seed.  Tolerances: the twins
exactly (K1's composition) or to 1e-12 relative (scans, statistics);
masters >= 200 dB SNR (float64 rounding apart, the same chain), the
float32 port > 95 dB (the JAX package's float32 gate); samples past a
row's length exactly 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage, signal

import matchering_tpu as mj
import matchering_tpu_torch as mt
from matchering_tpu.limiter import limit as jlimit
from matchering_tpu.ops import basics as jb
from matchering_tpu.ops import iir as jiir
from matchering_tpu.ops import sliding as js
from matchering_tpu.ops import spectrum as jsp
from matchering_tpu.parallel import batch as jbatch
from matchering_tpu.stages import main as jmain
from matchering_tpu_torch import state, stages
from matchering_tpu_torch.kernels import envelope, scan
from matchering_tpu_torch.limiter import _limit, limit
from matchering_tpu_torch.ops import basics, iir, sliding, spectrum
from matchering_tpu_torch.parallel import batch
from matchering_tpu_torch.parallel.mesh import single_axis_mesh
from matchering_tpu_torch.utils import RowInts, make_odd

SR = 44100
THRESHOLD = 0.998138427734375  # Config().threshold
ATTACK = 44  # Config().limiter.attack at 44.1 kHz, in samples
VARIANTS = ("result", "result_no_limiter", "result_no_limiter_normalized")
ALL = dict(need_default=True, need_no_limiter=True, need_no_limiter_normalized=True)
FILTERS = {
    "attack": (iir.one_pole_filter(-2.0, ATTACK), jiir.one_pole_filter(-2.0, ATTACK)),
    "hold": (iir.butter1_coefficients(7.0, SR), jiir.butter1_coefficients(7.0, SR)),
    "release": (
        iir.butter1_coefficients(800.0 / 3000.0, SR),
        jiir.butter1_coefficients(800.0 / 3000.0, SR),
    ),
}


# the JAX references, compiled once per test module (traced lengths)
jax_limit = jax.jit(jlimit, static_argnums=1)
jax_filtfilt_truncated = jax.jit(jiir.filtfilt_first_order_truncated, static_argnums=0)
jax_sliding_truncated = jax.jit(js.sliding_max_attack_truncated, static_argnums=1)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rows(lengths):
    return RowInts.of(lengths, "cpu")


def assert_rel(port, reference, rtol=1e-12):
    port = np.asarray(port, np.float64)
    reference = np.asarray(reference, np.float64)
    assert port.shape == reference.shape
    err = np.max(np.abs(port - reference)) / max(np.max(np.abs(reference)), 1e-300)
    assert err <= rtol, err


def track(seconds, seed, gain):
    r = np.random.RandomState(seed)
    n = int(seconds * SR)
    env = 0.5 + 0.5 * np.sin(np.arange(n) / SR * 1.3)[:, None]
    return np.clip(gain * r.randn(n, 2) * env, -1, 1)


class TestTwinsWithLengths:
    WINDOW = envelope.window_for(ATTACK)

    @pytest.mark.parametrize(
        "length", [WINDOW, 4 * make_odd(ATTACK) - 2, 5003, 9000], ids=["window", "jax-min", "odd", "n"]
    )
    def test_envelope_twin(self, rng, length):
        """Gain and slided on [0, L) equal JAX's masked rectify and truncated
        sliding max (where its precondition L >= 4*make_odd(attack) - 2
        holds) and scipy's reflect filter on x[:L] at every L; both are 0
        from L on."""
        n = 9000
        x = rng.randn(2, n, 2) * 0.8
        lengths = [length, n]
        gain, slided = envelope.limiter_front_end_plain(t(x), THRESHOLD, ATTACK, rows(lengths))
        for r, L in enumerate(lengths):
            rectified = jb.rectify(jnp.asarray(x[r]), THRESHOLD)
            rectified = jnp.where(jnp.arange(n) < L, rectified, 1.0)
            jgain = np.asarray(jb.flip(1.0 / rectified))
            np.testing.assert_array_equal(gain[r, :L].numpy(), jgain[:L])
            want = ndimage.maximum_filter1d(jgain[:L], self.WINDOW, mode="reflect")
            np.testing.assert_array_equal(slided[r, :L].numpy(), want)
            if L >= 4 * make_odd(ATTACK) - 2:
                jslided = jax_sliding_truncated(jnp.asarray(jgain), ATTACK, jnp.int32(L))
                np.testing.assert_array_equal(slided[r, :L].numpy(), np.asarray(jslided)[:L])
            assert not gain[r, L:].any() and not slided[r, L:].any()

    @pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "0-d tensor"])
    @pytest.mark.parametrize("length", [4 * make_odd(ATTACK) - 2, 5003, 9000], ids=["jax-min", "odd", "n"])
    def test_sliding_max_attack_truncated_takes_the_jax_call_form(self, rng, length, as_tensor):
        """``sliding_max_attack_truncated(array, window_size, length)`` on
        one track with a scalar length returns what JAX returns over the
        whole track, past the length too (the max filter over the zeros)."""
        n = 9000
        x = np.abs(rng.randn(n)) * 2.0
        x[length:] = 0.0
        got = sliding.sliding_max_attack_truncated(t(x), ATTACK, torch.tensor(length) if as_tensor else length)
        want = jax_sliding_truncated(jnp.asarray(x), ATTACK, jnp.int32(length))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("pole", sorted(FILTERS))
    def test_filtfilt_rows(self, rng, pole):
        filt, jfilt = FILTERS[pole]
        n = 6000
        lengths = [7, 1001, 4097, n]
        x = rng.rand(len(lengths), n)
        for r, L in enumerate(lengths):
            x[r, L:] = 0.0  # the caller's padding
        got = iir.filtfilt_first_order(filt, t(x), rows(lengths)).numpy()
        for r, L in enumerate(lengths):
            want = jax_filtfilt_truncated(jfilt, jnp.asarray(x[r]), jnp.int32(L))
            assert_rel(got[r], np.asarray(want))
            if L > 7:  # scipy's filtfilt needs more than padlen samples
                assert_rel(got[r, :L], signal.filtfilt([filt.b0, filt.b1], [1.0, filt.a1], x[r, :L]))
            assert not got[r, L:].any()

    @pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
    def test_scan_twin(self, rng, reverse):
        filt = FILTERS["release"][0]
        n = 9000
        lengths = [1, 4095, 4097, n]
        x = rng.rand(len(lengths), n)
        zi = rng.rand(len(lengths))
        b, a = [filt.b0, filt.b1], [1.0, filt.a1]
        for with_zi in (False, True):
            got = scan.first_order_filter(
                t(x), *filt, zi=t(zi) if with_zi else None, reverse=reverse, lengths=rows(lengths)
            ).numpy()
            for r, L in enumerate(lengths):
                row = x[r, :L][::-1] if reverse else x[r, :L]
                want, _ = signal.lfilter(b, a, row, zi=[zi[r] if with_zi else 0.0])
                assert_rel(got[r, :L], want[::-1] if reverse else want)
                assert not got[r, L:].any()


class TestDynamicStatistics:
    def test_piece_rms_and_loudest_pieces(self, rng):
        """Rows with 1, 3 and 6 divisions in one padded batch."""
        n, max_piece = 60_000, 9_000
        lengths = [8_000, 25_001, n - 3]
        x = rng.randn(3, n) * np.repeat(rng.rand(3, 12), 5000, axis=1)
        for r, L in enumerate(lengths):
            x[r, L:] = 0.0
        divisions = [L // max_piece + 1 for L in lengths]
        pieces = [L // d for L, d in zip(lengths, divisions)]
        div_max = n // max_piece + 1
        rmses, valid = basics.piece_rms_dynamic(t(x), t(np.array(pieces)), t(np.array(divisions)), div_max)
        mask, match = basics.loudest_piece_stats_masked(rmses, valid, t(np.array(divisions)))
        for r in range(3):
            jr, jv = jb.piece_rms_dynamic(
                jnp.asarray(x[r]), jnp.int32(pieces[r]), jnp.int32(divisions[r]), div_max
            )
            jmask, jmatch = jb.loudest_piece_stats_masked(jr, jv, jnp.int32(divisions[r]))
            d = divisions[r]
            np.testing.assert_array_equal(valid[r].numpy(), np.asarray(jv))
            assert_rel(rmses[r, :d].numpy(), np.asarray(jr)[:d])
            np.testing.assert_array_equal(mask[r].numpy(), np.asarray(jmask))
            assert_rel(match[r].numpy(), np.asarray(jmatch))

    def test_spectrum_pair(self, rng):
        n, max_piece, fft_size = 60_000, 9_000, 1024
        lengths = [8_000, 25_001, n - 3]
        a = rng.randn(3, n)
        b = rng.randn(3, n) * 0.3
        divisions = [L // max_piece + 1 for L in lengths]
        div_max, fpp_max = n // max_piece + 1, max_piece // fft_size + 1
        mask = (rng.rand(3, div_max) > 0.4) * (np.arange(div_max) < np.array(divisions)[:, None])
        mask[:, 0] = 1.0
        piece = RowInts.of([L // d for L, d in zip(lengths, divisions)], "cpu")
        got = spectrum.masked_average_spectrum_dynamic_pair(
            t(a), t(b), t(mask.astype(np.float64)), piece, div_max, fft_size, fpp_max
        )
        for r in range(3):
            want = jsp.masked_average_spectrum_dynamic_pair(
                jnp.asarray(a[r]), jnp.asarray(b[r]), jnp.asarray(mask[r].astype(np.float64)),
                jnp.int32(piece.host[r]), div_max, fft_size, fpp_max,
            )
            assert_rel(got[0][r].numpy(), np.asarray(want[0]))
            assert_rel(got[1][r].numpy(), np.asarray(want[1]))


def test_limit_rows_match_jax(rng):
    """A batch of three rows, the last two with overage at their ends."""
    n = 1 << 15
    lengths = [n, 20_000, 9_001]
    x = 0.4 * rng.randn(3, n, 2)
    x[:, 1000:3000] *= 4.0
    for r, L in enumerate(lengths):
        x[r, L - 400 : L] *= 3.0
        x[r, L:] = 0.0
    config = mj.Config(dtype="float64")
    got = limit(t(x), state.config_from_dict(dataclasses.asdict(config)), length=lengths).numpy()
    for r, L in enumerate(lengths):
        want = np.asarray(jax_limit(jnp.asarray(x[r]), config, length=jnp.int32(L)))
        np.testing.assert_allclose(got[r], want, rtol=0, atol=1e-10)
        assert not got[r, L:].any()


@pytest.mark.parametrize("with_lengths", [False, True], ids=["static", "lengths"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scaled_limit_is_limit_times_the_scale(rng, dtype, with_lengths):
    """The limiter's private scaled entry (one K4 launch on a card) gives
    ``limit(x, config, length=L) * scale[:, None, None]`` bit for bit."""
    n = 1 << 14
    x = 0.4 * rng.randn(3, n, 2)
    x[:, 1000:3000] *= 4.0
    x[1] *= 0.1  # under the threshold: the row passes unlimited
    config = mt.Config(dtype=dtype)
    x = t(x).to(config.torch_dtype)
    lengths = rows([n, 9_001, 5_003]) if with_lengths else None
    scale = torch.tensor([0.75, 2.0, 1.5], dtype=config.torch_dtype)
    got = _limit(x, config, length=lengths, scale=scale)
    want = limit(x, config, length=lengths) * scale[:, None, None]
    assert torch.equal(got, want)
    assert torch.equal(got[1], x[1] * scale[1])


@pytest.mark.parametrize("with_lengths", [False, True], ids=["static", "lengths"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_master_graph_scales_the_limited_result(dtype, with_lengths):
    """``master_graph``'s limited result is ``limit(result_no_limiter,
    config, length) * final_amplitude_coefficient`` composed by hand, bit
    for bit, on the static path and with the rows' true lengths."""
    config = mt.Config(dtype=dtype, max_piece_size=1, fft_size=1024)
    targets = [track(s, 40 + i, 0.3) for i, s in enumerate((2.5, 1.7))]
    references = [track(s, 50 + i, 0.9) for i, s in enumerate((2.2, 2.6))]
    if with_lengths:
        target, t_lens = batch.bucket_pad(targets, 1 << 16, device="cpu")
        reference, r_lens = batch.bucket_pad(references, 1 << 16, device="cpu")
        lengths = dict(target_length=rows(t_lens), reference_length=rows(r_lens))
    else:
        n = min(len(a) for a in targets + references)
        target, reference = (t(np.stack([a[:n] for a in group])) for group in (targets, references))
        lengths = {}
    out = stages.master_graph(target, reference, config, True, True, **lengths)
    scale = out.report["final_amplitude_coefficient"]
    want = limit(out.result_no_limiter, config, length=lengths.get("target_length")) * scale[:, None, None]
    assert out.result.dtype == config.torch_dtype
    assert torch.equal(out.result, want)
    if with_lengths:
        for r, length in enumerate(t_lens):
            assert not out.result[r, length:].any()


# --- master_batch: three rows, mixed target and reference lengths ---

T_SECONDS, R_SECONDS = (3.0, 4.5, 5.6), (5.1, 3.3, 5.9)


@pytest.fixture(scope="module")
def padded():
    targets = [track(s, i, 0.3) for i, s in enumerate(T_SECONDS)]
    references = [track(s, 10 + i, 0.9) for i, s in enumerate(R_SECONDS)]
    t_batch, t_lens = jbatch.bucket_pad(targets, 1 << 17)
    r_batch, r_lens = jbatch.bucket_pad(references, 1 << 17)
    return t_batch, r_batch, t_lens, r_lens


@pytest.fixture(scope="module")
def jax_batch(padded):
    t_batch, r_batch, t_lens, r_lens = padded
    config = mj.Config(dtype="float64", max_piece_size=2)  # rows of 2 and 3 pieces
    out = jbatch.master_batch(
        jnp.asarray(t_batch), jnp.asarray(r_batch), config, **ALL,
        target_lengths=t_lens, reference_lengths=r_lens,
    )
    return config, {k: np.asarray(getattr(out, k)) for k in VARIANTS}


@pytest.fixture(scope="module", params=["float64", "float32"])
def port_batch(request, padded, jax_batch):
    t_batch, r_batch, t_lens, r_lens = padded
    config = state.config_from_dict({**dataclasses.asdict(jax_batch[0]), "dtype": request.param})
    out = batch.master_batch(
        t_batch, r_batch, config, **ALL,
        target_lengths=t_lens, reference_lengths=r_lens, device="cpu",
    )
    return request.param, {k: getattr(out, k).numpy() for k in VARIANTS}


@pytest.mark.parametrize("variant", VARIANTS)
def test_master_batch_matches_jax(padded, jax_batch, port_batch, snr, variant):
    t_lens = padded[2]
    dtype, port = port_batch
    for r, L in enumerate(t_lens):
        got, want = port[variant][r], jax_batch[1][variant][r]
        measured = snr(want[:L], got[:L])
        if dtype == "float64":
            assert measured >= 200.0, (r, measured)
        else:
            assert measured > 95.0, (r, measured)
        assert not got[L:].any(), r


def test_master_takes_the_jax_call_form(padded, jax_batch, snr):
    """``master(target, reference, config, need_default, need_no_limiter,
    need_no_limiter_normalized, target_length, reference_length)``, JAX's
    positional form (``device`` keyword-only): row 0 of the padded batch
    at its true lengths against JAX ``master_batch``'s row 0 (the master
    of the unpadded pair), >= 200 dB."""
    t_batch, r_batch, t_lens, r_lens = padded
    config = state.config_from_dict(dataclasses.asdict(jax_batch[0]))
    out = mt.master(t_batch[0], r_batch[0], config, True, True, True, t_lens[0], r_lens[0], device="cpu")
    length = t_lens[0]
    for variant in VARIANTS:
        got, want = getattr(out, variant).numpy(), jax_batch[1][variant][0]
        measured = snr(want[:length], got[:length])
        assert measured >= 200.0, (variant, measured)
        assert not got[length:].any(), variant


def test_master_batch_checks_lengths_on_the_host(padded):
    t_batch, r_batch, t_lens, r_lens = padded
    with pytest.raises(ValueError, match="outside"):
        batch.master_batch(
            t_batch, r_batch, target_lengths=[50] + t_lens[1:], reference_lengths=r_lens,
            device="cpu",
        )
    with pytest.raises(ValueError, match="both"):
        batch.master_batch(t_batch, r_batch, target_lengths=t_lens, device="cpu")
    with pytest.raises(ValueError, match="'pairs' mesh axis"):
        batch.master_batch(
            t_batch, r_batch, mesh=single_axis_mesh("time", devices=["cpu"]), device="cpu"
        )


@pytest.fixture(scope="module")
def bucketed_pair():
    return track(4.2, 31, 0.3), track(3.7, 32, 0.9)


@pytest.mark.parametrize("against", ["jax-bucketed", "port-unbucketed"])
def test_stages_main_length_bucketing(bucketed_pair, snr, against):
    """``Config(length_bucketing=N)`` pads both tracks, masters them at
    their true lengths and trims: the JAX package's bucketed result to
    200 dB, the port's own unbucketed result above JAX's own 100 dB gate
    (tests/test_batch_lengths.py)."""
    target, reference = bucketed_pair
    bucketed = dict(dtype="float64", length_bucketing=1 << 17)
    got = stages.main(target, reference, mt.Config(**bucketed), **ALL, device="cpu")
    if against == "jax-bucketed":
        want = jmain(target, reference, mj.Config(**bucketed), **ALL)
        gate = 200.0
    else:
        want = stages.main(target, reference, mt.Config(dtype="float64"), **ALL, device="cpu")
        gate = 100.0
    for g, w in zip(got, want):
        assert g.shape == (target.shape[0], 2)
        assert snr(np.asarray(w), g.numpy()) > gate


def test_stages_main_takes_the_jax_call_form(bucketed_pair, snr):
    """``main(target, reference, config, need_default, need_no_limiter,
    need_no_limiter_normalized)`` positionally, as JAX's, ``device``
    keyword-only: the bucketed JAX result to 200 dB."""
    target, reference = bucketed_pair
    bucketed = dict(dtype="float64", length_bucketing=1 << 17)
    got = stages.main(target, reference, mt.Config(**bucketed), True, True, True, device="cpu")
    want = jmain(target, reference, mj.Config(**bucketed), **ALL)
    for g, w in zip(got, want):
        assert snr(np.asarray(w), g.numpy()) >= 200.0


def test_bucket_pad_matches_jax_and_refuses_mixed_dtypes(rng):
    tracks = [(rng.randn(n, 2) * 8000).astype(np.int16) for n in (5000, 70_000, 131_072)]
    got, lengths = batch.bucket_pad(tracks + [t(tracks[0])], 1 << 16, device="cpu")
    want, jax_lengths = jbatch.bucket_pad(tracks + [tracks[0]], 1 << 16)
    assert lengths == jax_lengths and got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="dtype"):
        batch.bucket_pad([tracks[0], tracks[1].astype(np.float64)], device="cpu")
