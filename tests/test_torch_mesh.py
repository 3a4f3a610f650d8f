"""The port's device meshes, ``master_farm`` and the farm's ``mesh=``, on
the CPU.

Meshes of CPU entries (``["cpu"] * 8``: a device may appear more than
once) stand in for cards.  ``master_farm`` on a ``(pairs=2, time=4)`` mesh
must give each row >= 200 dB SNR against the port's single-pair ``master``
at float64 (float64 rounding apart, the same chain) and 0 past each true
length, and, with true lengths, >= 200 dB against the JAX package's
``master_farm`` on its 8-device virtual CPU mesh (one JAX graph).
``master_batch`` and ``process_batch`` over a mesh must give what they
give without one: masters to 200 dB, PCM_16 files within one LSB.
"""

import dataclasses

import numpy as np
import pytest
import torch

import matchering_tpu as mj
import matchering_tpu_torch as mt
from matchering_tpu.parallel import make_mesh as jax_make_mesh
from matchering_tpu.parallel import timeshard as jts
from matchering_tpu_torch import state
from matchering_tpu_torch.io import wav
from matchering_tpu_torch.parallel import batch, mesh, timeshard

SR = 44100
VARIANTS = ("result", "result_no_limiter", "result_no_limiter_normalized")
ALL = dict(need_default=True, need_no_limiter=True, need_no_limiter_normalized=True)
BUCKET = 1 << 17


def track(seconds, seed, gain):
    r = np.random.RandomState(seed)
    n = int(seconds * SR)
    env = 0.5 + 0.5 * np.sin(np.arange(n) / SR * 1.3)[:, None]
    return np.clip(gain * r.randn(n, 2) * env, -1, 1)


# -- meshes -----------------------------------------------------------------


def test_make_mesh_lays_out_pairs_and_time():
    m = mesh.make_mesh(pairs=2, time=3, devices=["cpu"] * 7)
    assert m.shape == {"pairs": 2, "time": 3} and m.axis_names == ("pairs", "time")
    assert m.devices.shape == (2, 3) and all(d == torch.device("cpu") for d in m.devices.flat)
    assert m.rows("pairs", "time") == [[torch.device("cpu")] * 3] * 2
    assert m.along("time") == [torch.device("cpu")] * 3
    assert mesh.single_axis_mesh("time", size=2, devices=["cpu"] * 5).shape == {"time": 2}
    with pytest.raises(ValueError, match="needs 8 devices"):
        mesh.make_mesh(pairs=2, time=4, devices=["cpu"] * 7)


def test_default_meshes_take_every_card_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: mesh.make_mesh(), lambda: mesh.single_axis_mesh("time")):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert list(mesh.make_mesh(pairs=1, time=2).devices.flat) == cards
    assert list(mesh.single_axis_mesh("time").devices.flat) == cards


# -- master_farm --------------------------------------------------------------


@pytest.fixture(scope="module")
def bucket():
    targets = [track(2.6, 11, 0.3), track(1.9, 12, 0.25)]
    references = [track(2.2, 13, 0.9), track(2.9, 14, 0.8)]
    t_batch, t_lens = batch.bucket_pad(targets, BUCKET, device="cpu")
    r_batch, r_lens = batch.bucket_pad(references, BUCKET, device="cpu")
    return targets, references, t_batch, r_batch, t_lens, r_lens


@pytest.fixture(scope="module")
def config64():
    return mj.Config(dtype="float64", max_piece_size=1)


@pytest.fixture(scope="module")
def farm(bucket, config64):
    """The port's farm on (pairs=2, time=4), with and without lengths."""
    _, _, t_batch, r_batch, t_lens, r_lens = bucket
    config = state.config_from_dict(dataclasses.asdict(config64))
    grid = mesh.make_mesh(pairs=2, time=4, devices=["cpu"] * 8)
    return {
        "lengths": timeshard.master_farm(
            t_batch, r_batch, config, mesh=grid, **ALL, target_lengths=t_lens, reference_lengths=r_lens
        ),
        "bucket": timeshard.master_farm(t_batch, r_batch, config, mesh=grid, **ALL),
    }


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("lengths", ["lengths", "bucket"])
def test_master_farm_matches_port_master(bucket, config64, farm, snr, lengths, variant):
    targets, references, t_batch, r_batch, t_lens, _ = bucket
    config = state.config_from_dict(dataclasses.asdict(config64))
    out = getattr(farm[lengths], variant)
    assert out.shape == t_batch.shape
    for i in range(2):
        if lengths == "lengths":
            want = mt.master(targets[i], references[i], config, device="cpu", **ALL)
            end = t_lens[i]
        else:
            want = mt.master(t_batch[i], r_batch[i], config, device="cpu", **ALL)
            end = t_batch.shape[1]
        measured = snr(getattr(want, variant).numpy(), out[i, :end].numpy())
        assert measured >= 200.0, (i, measured)
        assert not out[i, end:].any()


@pytest.fixture(scope="module")
def jax_farm(bucket, config64):
    _, _, t_batch, r_batch, t_lens, r_lens = bucket
    out = jts.master_farm(
        t_batch.numpy(), r_batch.numpy(), config64, mesh=jax_make_mesh(pairs=2, time=4), **ALL,
        target_lengths=t_lens, reference_lengths=r_lens,
    )
    return {k: np.asarray(getattr(out, k)) for k in VARIANTS}


@pytest.mark.parametrize("variant", VARIANTS)
def test_master_farm_matches_jax(bucket, farm, jax_farm, snr, variant):
    t_lens = bucket[4]
    got = getattr(farm["lengths"], variant).numpy()
    for i, end in enumerate(t_lens):
        measured = snr(jax_farm[variant][i, :end], got[i, :end])
        assert measured >= 200.0, (i, measured)


def test_master_farm_checks_its_arguments(bucket):
    _, _, t_batch, r_batch, t_lens, _ = bucket
    grid = mesh.make_mesh(pairs=2, time=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="both"):
        timeshard.master_farm(t_batch, r_batch, mesh=grid, target_lengths=t_lens)
    with pytest.raises(ValueError, match="not divisible"):
        timeshard.master_farm(t_batch[:1], r_batch[:1], mesh=grid)
    with pytest.raises(ValueError, match="'pairs'"):
        timeshard.master_farm(t_batch, r_batch, mesh=mesh.single_axis_mesh("time", devices=["cpu"]))


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["pairs", "pairs-time"])
def test_master_batch_over_a_mesh(bucket, snr, shape):
    """``master_batch(mesh=)`` cuts the rows over the pairs axis (a time
    axis only replicates them, as in JAX) and gives what it gives alone."""
    _, _, t_batch, r_batch, t_lens, r_lens = bucket
    config = mt.Config(dtype="float64", max_piece_size=1)
    grid = mesh.make_mesh(*shape, devices=["cpu"] * 4)
    lengths = dict(target_lengths=t_lens, reference_lengths=r_lens)
    got = batch.master_batch(t_batch, r_batch, config, mesh=grid, **ALL, **lengths)
    want = batch.master_batch(t_batch, r_batch, config, **ALL, **lengths, device="cpu")
    for variant in VARIANTS:
        for i, end in enumerate(t_lens):
            measured = snr(getattr(want, variant)[i, :end].numpy(), getattr(got, variant)[i, :end].numpy())
            assert measured >= 200.0, (variant, i, measured)
    assert sorted(got.report) == sorted(want.report) and got.report["rms_coefficient"].shape == (2,)


# -- process_batch(mesh=) ----------------------------------------------------


@pytest.fixture(scope="module")
def job_files(tmp_path_factory):
    folder = tmp_path_factory.mktemp("mesh_farm")
    files = []
    for i, (t_sec, r_sec) in enumerate([(2.4, 2.9), (2.8, 2.1), (1.7, 2.5)]):
        paths = (str(folder / f"t{i}.wav"), str(folder / f"r{i}.wav"))
        wav.write(paths[0], track(t_sec, 40 + i, 0.25), SR, "PCM_16")
        wav.write(paths[1], track(r_sec, 50 + i, 0.85), SR, "PCM_16")
        files.append(paths)
    return folder, files


def _run_farm(job_files, tag, **kwargs):
    folder, files = job_files
    jobs = [mt.PairJob(t, r, [mt.pcm16(str(folder / f"{tag}{i}.wav"))]) for i, (t, r) in enumerate(files)]
    mt.process_batch(jobs, mt.Config(dtype="float64"), bucket_multiple=BUCKET, **kwargs)
    return [wav.read(str(folder / f"{tag}{i}.wav"), raw_int=True)[0] for i in range(len(files))]


@pytest.fixture(scope="module")
def unmeshed(job_files):
    return _run_farm(job_files, "plain", dispatch="vmapped", device="cpu")


@pytest.mark.parametrize(
    "shape, dispatch",
    [((2, 1), "pipelined"), ((2, 1), "vmapped"), ((2, 2), "auto")],
    ids=["pairs-pipelined", "pairs-vmapped", "pairs-time-auto"],
)
def test_process_batch_over_a_mesh(job_files, unmeshed, shape, dispatch):
    """Three jobs over two pairs rows (the vmapped dispatches repeat the
    last pair to fill them); with a time axis each pair is time-sharded
    (``"auto"`` is ``"vmapped"`` there).  The mesh's first device loads."""
    grid = mesh.make_mesh(*shape, devices=["cpu"] * 4)
    got = _run_farm(job_files, f"{dispatch}{shape[1]}", mesh=grid, dispatch=dispatch)
    for g, w in zip(got, unmeshed):
        assert g.dtype == np.int16 and g.shape == w.shape
        assert np.max(np.abs(g.astype(np.int32) - w)) <= 1
