"""Multi-process runs of the port (``matchering_tpu_torch.parallel.launch``)
on the CPU, against the JAX package.

Mirrors tests/test_multihost.py: the guards of ``global_mesh``, the rows
``local_pair_slice`` hands each process and ``agree_bucket`` in one
process; then real two-process ``gloo`` groups through the package's own
self-test (``python -m matchering_tpu_torch.parallel.launch selftest
--device cpu``), which holds every owned pair to the single-process
float64 master.  The first self-test also encodes each process's owned
pairs to PCM_16 WAV: those files must be within one PCM_16 step of the
JAX package's master of the same pairs, made from the same seeds.
"""

import json
import socket

import numpy as np
import pytest
import torch

import matchering_tpu as mj
from matchering_tpu.io import wav as jwav
from matchering_tpu.parallel import batch as jbatch
from matchering_tpu_torch.io import wav
from matchering_tpu_torch.parallel import launch

SR = 44100


def _selftest_tracks(total_pairs):
    """The self-test's synthetic pairs (``launch._selftest_worker``)."""
    secs = [3.0 + 0.7 * i for i in range(total_pairs)]

    def synth(seed, seconds, amp):
        r = np.random.RandomState(seed)
        n = int(seconds * SR)
        env = 0.5 + 0.5 * np.sin(np.arange(n) / SR * 2.0)[:, None]
        return np.clip(amp * r.randn(n, 2) * env, -0.99, 0.99)

    targets = [synth(10 + i, secs[i], 0.25) for i in range(total_pairs)]
    references = [synth(50 + i, secs[-1 - i], 0.85) for i in range(total_pairs)]
    return targets, references


class TestGlobalMesh:
    def test_shape_and_axis_names(self):
        mesh = launch.global_mesh(time=2, devices=["cpu"] * 8)
        assert mesh.axis_names == ("pairs", "time")
        assert mesh.shape == {"pairs": 4, "time": 2}
        assert mesh.rows == range(0, 4)
        assert mesh.local().shape == {"pairs": 4, "time": 2}

    def test_time_axis_must_fit_locally(self):
        with pytest.raises(ValueError, match="does not divide 8 devices"):
            launch.global_mesh(time=16, devices=["cpu"] * 8)

    def test_time_larger_than_local_devices(self, monkeypatch):
        """Two processes of 2 devices: time=4 divides the 4 devices but
        would put a row across both processes."""
        monkeypatch.setattr(launch, "_all_gather_ints", lambda value: [value, value])
        with pytest.raises(ValueError, match="exceeds 2 local devices"):
            launch.global_mesh(time=4, devices=["cpu"] * 2)

    def test_time_must_divide_local_devices(self, monkeypatch):
        monkeypatch.setattr(launch, "_all_gather_ints", lambda value: [value, value])
        with pytest.raises(ValueError, match="does not divide the 3 local devices"):
            launch.global_mesh(time=2, devices=["cpu"] * 3)

    def test_pairs_times_time_must_match(self):
        with pytest.raises(ValueError, match="mesh 3x2 != 8 devices"):
            launch.global_mesh(pairs=3, time=2, devices=["cpu"] * 8)

    def test_processes_must_hold_equal_device_counts(self, monkeypatch):
        monkeypatch.setattr(launch, "_all_gather_ints", lambda value: [value, value + 1])
        with pytest.raises(ValueError, match="different device counts"):
            launch.global_mesh(devices=["cpu"] * 2)

    def test_without_devices_asks_for_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            launch.global_mesh()

    def test_local_pair_slice_covers_batch(self):
        mesh = launch.global_mesh(time=1, devices=["cpu"] * 8)
        assert launch.local_pair_slice(mesh, 16) == (0, 16)  # one process owns everything

    def test_local_pair_slice_of_the_second_process(self, monkeypatch):
        monkeypatch.setattr(launch, "_all_gather_ints", lambda value: [value, value])
        monkeypatch.setattr(launch, "process_index", lambda: 1)
        monkeypatch.setattr(launch, "process_count", lambda: 2)
        mesh = launch.global_mesh(time=2, devices=["cpu"] * 4)
        assert mesh.shape == {"pairs": 4, "time": 2} and mesh.rows == range(2, 4)
        assert launch.local_pair_slice(mesh, 16) == (8, 16)
        with pytest.raises(ValueError, match="do not tile"):
            launch.local_pair_slice(mesh, 6)

    def test_agree_bucket_single_process(self):
        assert launch.agree_bucket(100_000, multiple=1 << 16) == 2 * (1 << 16)


def test_initialize_without_arguments_is_a_no_op(monkeypatch):
    for name in ("MATCHERING_TPU_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    launch.initialize()
    assert not torch.distributed.is_initialized()
    assert (launch.process_index(), launch.process_count()) == (0, 1)


def test_initialize_from_torchrun_environment(monkeypatch):
    """torchrun's four variables bring a one-process group up, idempotently."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for name, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                        ("RANK", "0"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("MATCHERING_TPU_COORDINATOR", raising=False)
    try:
        launch.initialize(timeout_s=60)
        launch.initialize(timeout_s=60)
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
        assert (launch.process_index(), launch.process_count()) == (0, 1)
        assert launch.agree_bucket(5, multiple=4) == 8
    finally:
        launch.shutdown()
    assert not torch.distributed.is_initialized()


def test_selftest_without_device_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["selftest", "--processes", "2"])


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """Two CPU processes of two devices each, (pairs=4, time=1): each
    encodes its two owned pairs and writes its report."""
    folder = tmp_path_factory.mktemp("launch")
    report = str(folder / "run")
    launch.run_selftest(num_processes=2, devices_per_process=2, device="cpu", encode=2,
                        report_path=report, timeout=300)
    return [json.load(open(f"{report}.proc{p}.json")) for p in range(2)]


def test_two_process_selftest(two_process_run):
    rows = [tuple(r["owned_rows"]) for r in two_process_run]
    assert rows == [(0, 2), (2, 4)]
    for r in two_process_run:
        assert r["device"] == "cpu" and r["checked"] == 2 and r["min_snr_db"] >= 100.0


def test_workers_agree_on_the_global_bucket(two_process_run):
    """Each process gathers only its own tracks' longest length; both
    agree on the bucket of the longest track of all."""
    targets, _ = _selftest_tracks(4)
    want = -(-max(len(t) for t in targets) // (1 << 16)) * (1 << 16)
    own = [max(len(t) for t in targets[a:b]) for a, b in (r["owned_rows"] for r in two_process_run)]
    assert own[0] < own[1] <= want  # the processes' own maxima differ
    assert [r["agreed_bucket"] for r in two_process_run] == [want, want]


def test_encoded_rows_match_the_jax_master(two_process_run):
    """Each process's PCM_16 files against the JAX package's master of the
    same pairs (its bucketed batch at their true lengths: the vmapped
    ``master_graph``), written by the JAX package's PCM_16 writer."""
    targets, references = _selftest_tracks(4)
    t_batch, t_lens = jbatch.bucket_pad(targets, 1 << 16)
    r_batch, r_lens = jbatch.bucket_pad(references, 1 << 16)
    want = np.asarray(jbatch.master_batch(
        t_batch, r_batch, mj.Config(dtype="float64"),
        target_lengths=np.asarray(t_lens), reference_lengths=np.asarray(r_lens),
    ).result)
    files = [path for r in two_process_run for path in r["encoded"]]
    assert [int(p[-8:-4]) for p in files] == [0, 1, 2, 3]
    for row, path in enumerate(files):
        jax_path = path.replace(".wav", "_jax.wav")
        jwav.write(jax_path, want[row, : t_lens[row]], SR, "PCM_16")
        jax_codes, _ = wav.read(jax_path, raw_int=True)
        codes, rate = wav.read(path, raw_int=True)
        assert rate == SR and codes.shape == jax_codes.shape == (t_lens[row], 2)
        assert np.max(np.abs(codes.astype(np.int32) - jax_codes)) <= 1


def test_two_process_time_sharded_selftest(tmp_path):
    """The 2-D farm with pairs across the process boundary while each
    pair's time blocks shard over that process's own devices: a
    (pairs=4, time=2) mesh over 2 processes x 4 devices."""
    report = str(tmp_path / "farm")
    launch.run_selftest(num_processes=2, devices_per_process=4, time=2, device="cpu",
                        report_path=report, timeout=300)
    rows = [json.load(open(f"{report}.proc{p}.json")) for p in range(2)]
    assert [tuple(r["owned_rows"]) for r in rows] == [(0, 2), (2, 4)]
    assert all(r["time_axis"] == 2 and r["min_snr_db"] >= 100.0 for r in rows)
