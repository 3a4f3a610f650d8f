"""The generator: one seed, one track; the pool's lengths and the work
are the same for every seed; the seed draws content, order and sample."""

import numpy as np
import pytest
import torch

from perfbench import signals
from perfbench.entries import process

TARGET = {"rms_db": -20.0, "tilt": 1.0, "bed_db": -6.0, "tones_db": -3.0, "width": 0.3, "voices": 3,
          "harmonics": 6, "segment_s": 0.5, "envelope_s": 2.0, "drive": 0.0}
LOUD = dict(TARGET, rms_db=-12.0, drive=2.5)


def make(seed, n=44100 * 3, params=TARGET):
    return signals.track(n, 44100, params, signals.generator(seed, "cpu"), "cpu")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_one_seed_one_track(seed):
    assert torch.equal(make(seed), make(seed))


def test_seeds_differ_and_levels_do_not():
    a, b = make(1), make(2)
    assert not torch.equal(a, b)
    for x in (a, b):
        assert x.shape == (44100 * 3, 2) and x.dtype == torch.float32
        assert float(torch.sqrt(torch.mean(x.double() ** 2))) == pytest.approx(0.1, rel=1e-4)
        assert float(torch.amax(torch.abs(x))) <= 0.98 + 1e-6
        assert float(torch.std(x[:, 0] - x[:, 1])) > 0.01  # a side channel


def test_a_saturated_reference_is_louder():
    loud = make(3, params=LOUD)
    assert float(torch.sqrt(torch.mean(loud.double() ** 2))) > 0.2
    assert float(torch.amax(torch.abs(loud))) == pytest.approx(0.98, rel=1e-6)


@pytest.mark.parametrize("n", [4095, 4097, 44100 * 2 + 13])
def test_any_length(n):
    assert make(4, n).shape == (n, 2)
    m = signals._fft_length(n)
    assert m >= n and m % 4096 == 0


def test_pcm16_rounds_half_to_even_and_clips():
    x = torch.tensor([[0.5 / 32768, 1.5 / 32768], [1.0, -1.5]])
    assert signals.pcm16(x).tolist() == [[0, 2], [32767, -32768]]


def test_fixed_lengths_are_the_strata_midpoints():
    assert process.fixed_lengths([120, 420], 4, 100) == [15750, 23250, 30750, 38250]
    assert sum(process.fixed_lengths([120, 420], 8, 44100)) == pytest.approx(270 * 8 * 44100, abs=8)


def test_the_seed_draws_order_and_sample_not_the_work(tiny, tmp_path):
    import matchering_tpu_torch as mt
    from perfbench import harness

    cell = tiny("song44k.process_wav16")

    def state(seed):
        folder = tmp_path / f"{seed}-{len(list(tmp_path.iterdir()))}"
        folder.mkdir()
        ctx = harness.Context(cell, seed, torch.device("cpu"), str(folder), False, mt, torch)
        return process.prepare(ctx)

    a, a2, b = state(11), state(11), state(12)
    pairs = lambda s: [tuple(t.path[-12:] for t in s.pair(i)) for i in range(10)]
    assert pairs(a) == pairs(a2) and sorted(a.compared) == sorted(a2.compared)
    for s in (a, b):  # each cycle holds every pair once
        s.pair(3)
        cycle = {s.order[i] for i in range(4)}
        assert cycle == set(range(4))
    lengths = lambda s: sorted(t.codes.shape[0] for t in s.targets + s.references)
    assert lengths(a) == lengths(b)
    assert not np.array_equal(a.targets[0].codes, b.targets[0].codes)


def test_wav_files_round_trip_and_read_the_ports_output(tmp_path):
    from perfbench import wavfile
    from matchering_tpu_torch.io import codecs

    codes = signals.pcm16(make(6, 4410)).numpy()
    wavfile.write(str(tmp_path / "a.wav"), codes, 44100)
    back, rate = wavfile.read(str(tmp_path / "a.wav"))
    assert rate == 44100 and np.array_equal(back, codes)
    decoded, rate = codecs.read(str(tmp_path / "a.wav"), raw_int=True)  # the port reads the harness's file
    assert rate == 44100 and np.array_equal(decoded, codes)
    codecs.write(str(tmp_path / "b.wav"), codes / 32768.0, 44100, "PCM_16")  # and the harness reads the port's
    assert np.array_equal(wavfile.read(str(tmp_path / "b.wav"))[0], codes)
