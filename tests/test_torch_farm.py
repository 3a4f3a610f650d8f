"""``process_batch`` of the port against the JAX package's, on the CPU.

Three PCM_16 WAV jobs of mixed lengths, one asking for both previews, one
for a raw ``FLOAT`` variant, through one bucketed batch at float64.  Each
job's files must match the JAX farm's (PCM_16 within one LSB, ``FLOAT``
>= 200 dB SNR) and the port's own single-pair ``process()`` (one LSB);
the two dispatches must agree above the JAX package's own 120 dB gate
(tests/test_farm.py).  The CLI's ``--length_bucketing`` must match the
JAX CLI's output within one PCM_16 LSB.
"""

import numpy as np
import pytest

import matchering_tpu as mj
import matchering_tpu_torch as mt
from matchering_tpu.__main__ import main as jax_cli
from matchering_tpu_torch.__main__ import main as port_cli
from matchering_tpu_torch.io import wav
from matchering_tpu_torch.parallel import batch
from matchering_tpu_torch.parallel.mesh import make_mesh, single_axis_mesh

SR = 44100
SECONDS = [(3.0, 4.6), (4.4, 3.2), (5.5, 5.8)]  # (target, reference) per job


def _track(seconds, seed, gain):
    r = np.random.RandomState(seed)
    n = int(seconds * SR)
    env = 0.5 + 0.5 * np.sin(np.arange(n) / SR * 1.5)[:, None]
    return np.clip(gain * r.randn(n, 2) * env, -0.99, 0.99)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    folder = tmp_path_factory.mktemp("farm")
    out = []
    for i, (t_sec, r_sec) in enumerate(SECONDS):
        paths = (str(folder / f"t{i}.wav"), str(folder / f"r{i}.wav"))
        wav.write(paths[0], _track(t_sec, 100 + i, 0.22), SR, "PCM_16")
        wav.write(paths[1], _track(r_sec, 200 + i, 0.8), SR, "PCM_16")
        out.append(paths)
    return out


def _jobs(package, pairs, folder, tag):
    """Job 0 asks for a raw FLOAT variant beside its PCM_16 master, job 1
    for both previews (WAV: the port writes no FLAC yet)."""
    jobs = []
    for i, (tp, rp) in enumerate(pairs):
        results = [package.pcm16(str(folder / f"{tag}{i}.wav"))]
        if i == 0:
            results.append(package.Result(str(folder / f"{tag}{i}_raw.wav"), "FLOAT",
                                          use_limiter=False, normalize=False))
        previews = {}
        if i == 1:
            previews = dict(preview_target=package.pcm16(str(folder / f"{tag}_pt.wav")),
                            preview_result=package.pcm16(str(folder / f"{tag}_pr.wav")))
        jobs.append(package.PairJob(target=tp, reference=rp, results=results, **previews))
    return jobs


FILES = ["0.wav", "1.wav", "2.wav", "_pt.wav", "_pr.wav"]


def _read(folder, tag, name, raw_int=True):
    audio, rate = wav.read(str(folder / f"{tag}{name}"), raw_int=raw_int)
    assert rate == SR
    return audio


def _within_one_lsb(a, b):
    assert a.dtype == b.dtype == np.int16 and a.shape == b.shape
    assert np.max(np.abs(a.astype(np.int32) - b)) <= 1


@pytest.fixture(scope="module")
def farm(pairs, tmp_path_factory):
    """The JAX farm and the port's two dispatches on the same jobs."""
    folder = tmp_path_factory.mktemp("farm_out")
    mj.process_batch(_jobs(mj, pairs, folder, "jax"), mj.Config(dtype="float64"))
    for dispatch in ("pipelined", "vmapped"):
        mt.process_batch(
            _jobs(mt, pairs, folder, dispatch), mt.Config(dtype="float64"),
            dispatch=dispatch, device="cpu",
        )
    return folder


@pytest.mark.parametrize("name", FILES)
def test_process_batch_matches_jax(farm, name):
    _within_one_lsb(_read(farm, "pipelined", name), _read(farm, "jax", name))


def test_raw_float_variant_matches_jax(farm, snr):
    got = _read(farm, "pipelined", "0_raw.wav", raw_int=False)
    want = _read(farm, "jax", "0_raw.wav", raw_int=False)
    assert got.shape == want.shape == (int(SECONDS[0][0] * SR), 2)
    assert snr(want, got) >= 200.0


def test_process_batch_matches_process(farm, pairs):
    for i, (tp, rp) in enumerate(pairs):
        single = str(farm / f"single{i}.wav")
        mt.process(tp, rp, [mt.pcm16(single)], mt.Config(dtype="float64"), device="cpu")
        _within_one_lsb(_read(farm, "pipelined", f"{i}.wav"), _read(farm, "single", f"{i}.wav"))


@pytest.mark.parametrize("name", FILES + ["0_raw.wav"])
def test_dispatches_agree(farm, snr, name):
    a = _read(farm, "pipelined", name, raw_int=False)
    b = _read(farm, "vmapped", name, raw_int=False)
    assert a.shape == b.shape
    assert snr(a, b) > 120.0


@pytest.mark.parametrize(
    "call, error",
    [
        (lambda p, f: mt.process_batch(_jobs(mt, p, f, "x"), dispatch="sideways", device="cpu"), ValueError),
        (lambda p, f: mt.process_batch(_jobs(mt, p, f, "x"), mesh=single_axis_mesh("time", devices=["cpu"]),
                                       device="cpu"), ValueError),
        (lambda p, f: mt.process_batch(_jobs(mt, p, f, "x"), mesh=make_mesh(1, 2, devices=["cpu"] * 2),
                                       dispatch="pipelined", device="cpu"), ValueError),
        (lambda p, f: mt.process_batch([], device="cpu"), RuntimeError),
        (lambda p, f: mt.process_batch([mt.PairJob(*p[0])], device="cpu"), RuntimeError),
    ],
    ids=["unknown-dispatch", "mesh", "pipelined-time-mesh", "empty", "outputless"],
)
def test_process_batch_rejects(pairs, tmp_path, call, error):
    with pytest.raises(error):
        call(pairs, tmp_path)


def test_master_pairs_round_robin_over_devices(pairs):
    tracks = [(wav.read(tp, raw_int=True)[0], wav.read(rp, raw_int=True)[0]) for tp, rp in pairs[:2]]
    t_batch, t_lens = batch.bucket_pad([t for t, _ in tracks], 1 << 17, device="cpu")
    r_batch, r_lens = batch.bucket_pad([r for _, r in tracks], 1 << 17, device="cpu")
    devices = ["cpu", "cpu"]
    outs = batch.master_pairs(
        list(t_batch), list(r_batch), mt.Config(dtype="float64"),
        target_lengths=t_lens, reference_lengths=r_lens, devices=devices,
    )
    assert len(outs) == 2
    for out, length in zip(outs, t_lens):
        assert out.result.device.type == "cpu" and out.result.shape == t_batch.shape[1:]
        assert not out.result[length:].any()


def test_mixed_pcm_role_matches_one_by_one(pairs, tmp_path):
    """A reference role mixing PCM_16 and PCM_24 files converts on the
    device to the working float before stacking; each master equals the
    same pair run on its own."""
    r24 = str(tmp_path / "r24.wav")
    wav.write(r24, _track(4.0, 300, 0.8), SR, "PCM_24")
    jobs = [
        mt.PairJob(pairs[0][0], pairs[0][1], [mt.pcm16(str(tmp_path / "b0.wav"))]),
        mt.PairJob(pairs[1][0], r24, [mt.pcm16(str(tmp_path / "b1.wav"))]),
    ]
    mt.process_batch(jobs, mt.Config(dtype="float64"), device="cpu")
    for i, job in enumerate(jobs):
        mt.process_batch(
            [mt.PairJob(job.target, job.reference, [mt.pcm16(str(tmp_path / f"s{i}.wav"))])],
            mt.Config(dtype="float64"), device="cpu",
        )
        _within_one_lsb(_read(tmp_path, "b", f"{i}.wav"), _read(tmp_path, "s", f"{i}.wav"))


def test_cli_length_bucketing_matches_jax(pairs, tmp_path):
    args = [pairs[2][0], pairs[2][1]]
    assert port_cli(args + [str(tmp_path / "port.wav"), "--length_bucketing", "131072", "--quiet"],
                    device="cpu") == 0
    assert jax_cli(args + [str(tmp_path / "jax.wav"), "--length_bucketing", "131072", "--quiet"]) == 0
    _within_one_lsb(_read(tmp_path, "port", ".wav"), _read(tmp_path, "jax", ".wav"))
