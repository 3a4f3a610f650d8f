"""Multi-process runs on ``torch.distributed`` (PyTorch).

Counterpart of ``matchering_tpu/parallel/launch.py``.  Layout doctrine, as
there: the ``pairs`` axis is embarrassingly parallel, so it crosses
processes (hosts); the ``time`` axis carries halos and carried scans, so
it stays on one process's devices.  :func:`global_mesh` builds that
process-major ``(pairs, time)`` grid once :func:`initialize` has brought
the process group up.

No audio crosses processes: each process masters the batch rows it owns
on its own devices, and only host integers (device counts, the longest
track) are gathered, over ``gloo``, on the card too.  NCCL would gain
nothing here, and it refuses two ranks on one card.

Usage, one process per host (or per card)::

    from matchering_tpu_torch.parallel import launch
    launch.initialize(coordinator_address="host0:8476",
                      num_processes=N, process_id=i)   # or from the env
    mesh = launch.global_mesh()
    out = launch.master_batch_distributed(local_targets, local_references,
                                          t_lens, r_lens, config, mesh)
    # each process encodes the pairs it owns:
    for row, result in launch.local_results(out):
        ...

Under ``torchrun`` (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``), ``initialize()`` with no arguments joins the group.  A
two-process self-test of this flow::

    python -m matchering_tpu_torch.parallel.launch selftest --processes 2

(spawns the workers on the card, or on the CPU with ``--device cpu``, and
checks every owned pair against the single-process float64 master).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..stages import MasterOutput
from ..utils import resolve_device
from .mesh import Mesh, _devices, make_mesh

_COORD_ENV = "MATCHERING_TPU_COORDINATOR"
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
DEFAULT_TIMEOUT_S = 600.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group (idempotent), on the ``gloo`` backend.

    Arguments fall back to the environment: ``MATCHERING_TPU_COORDINATOR``
    (``host:port``) for the address, ``WORLD_SIZE`` and ``RANK`` for the
    count and index; with none of them given and torchrun's four variables
    set, the group comes up from those (``init_method="env://"``).  With
    nothing given this is a no-op: one process.  ``timeout_s`` bounds the
    rendezvous and every collective, so a peer that died cannot hold the
    others for longer."""
    if dist.is_initialized():
        return
    timeout = timedelta(seconds=timeout_s)
    coordinator_address = coordinator_address or os.environ.get(_COORD_ENV)
    if coordinator_address is None and num_processes is None:
        if all(name in os.environ for name in _TORCHRUN_ENV):
            dist.init_process_group("gloo", init_method="env://", timeout=timeout)
        return
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=num_processes, rank=process_id, timeout=timeout,
    )


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _all_gather_ints(value: int) -> List[int]:
    """``value`` from every process, in process order (one process: itself)."""
    if process_count() == 1:
        return [int(value)]
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, int(value))
    return [int(v) for v in gathered]


class GlobalMesh:
    """A ``(pairs, time)`` mesh over every process's devices, as far as
    callers read a global ``jax.sharding.Mesh``: ``shape`` and
    ``axis_names``.  A torch device belongs to one process, so the grid
    itself is held only for this process's rows: :meth:`local` is their
    ``Mesh``, and ``rows`` is their range among the global pairs rows."""

    axis_names = ("pairs", "time")

    def __init__(self, pairs: int, time: int, local_devices: Sequence[torch.device], rows: range):
        self.shape = {"pairs": pairs, "time": time}
        self.local_devices = list(local_devices)
        self.rows = rows

    def local(self) -> Mesh:
        """This process's rows as a ``(pairs, time)`` mesh of its devices."""
        return make_mesh(len(self.rows), self.shape["time"], devices=self.local_devices)

    def __repr__(self) -> str:
        return f"GlobalMesh({self.shape}, rows={self.rows}, local={[str(d) for d in self.local_devices]})"


def global_mesh(pairs: Optional[int] = None, time: int = 1, devices: Optional[Sequence] = None) -> GlobalMesh:
    """A ``(pairs, time)`` mesh over every device of every process,
    process-major: each process's local devices fill whole consecutive
    ``pairs`` rows, so the pairs axis crosses processes and the time axis
    stays on one process's devices.

    ``devices``: this process's devices (default: every visible CUDA
    device; a device may repeat, as in ``make_mesh``).  The processes
    gather their device counts, which must be equal."""
    local_devices = _devices(devices)
    counts = _all_gather_ints(len(local_devices))
    if len(set(counts)) != 1:
        raise ValueError(f"the processes hold different device counts: {counts}")
    n = sum(counts)
    if n % time:
        raise ValueError(f"time={time} does not divide {n} devices")
    if pairs is None:
        pairs = n // time
    if pairs * time != n:
        raise ValueError(f"mesh {pairs}x{time} != {n} devices")
    local = len(local_devices)
    if time > local:
        raise ValueError(
            f"time={time} exceeds {local} local devices — the time axis "
            "must stay within one process"
        )
    if local % time:
        raise ValueError(
            f"time={time} does not divide the {local} local devices — a "
            "pairs row would straddle two processes, putting time-axis halo "
            "exchange between processes and breaking the process-major row "
            "ownership that local_pair_slice relies on"
        )
    per_process = local // time
    first = process_index() * per_process
    return GlobalMesh(pairs, time, local_devices, range(first, first + per_process))


def local_pair_slice(mesh, total_pairs: int) -> Tuple[int, int]:
    """[start, stop) of the batch rows this process owns under ``mesh``'s
    pairs axis (process-major by construction)."""
    pairs = mesh.shape["pairs"]
    if total_pairs % pairs:
        raise ValueError(f"{total_pairs} pairs do not tile the {pairs}-row mesh")
    per_row = total_pairs // pairs
    rows_per_proc = pairs // process_count()
    start = process_index() * rows_per_proc * per_row
    return start, start + rows_per_proc * per_row


class LocalOutput(NamedTuple):
    """What one process of a distributed master holds: ``output``, the
    ``MasterOutput`` of the batch rows it owns (on its first device), and
    ``rows``, their global batch rows."""

    output: MasterOutput
    rows: range


def master_batch_distributed(
    targets_local,
    references_local,
    target_lengths_local: Sequence[int],
    reference_lengths_local: Sequence[int],
    config: Optional[Config] = None,
    mesh: Optional[GlobalMesh] = None,
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
) -> LocalOutput:
    """Data-parallel mastering across processes: every process passes the
    bucket-padded pairs it owns (one bucket shape everywhere — see
    :func:`agree_bucket`) and their true lengths, and masters them as one
    batch-first graph per pairs row of its devices
    (``batch.master_batch`` over ``mesh.local()``).  Returns this process's
    rows; pull them out with :func:`local_results`."""
    from .batch import master_batch

    config = config or Config()
    if mesh is None:
        mesh = global_mesh()
    count = len(targets_local)
    start, stop = local_pair_slice(mesh, count * process_count())
    out = master_batch(
        targets_local, references_local, config, mesh=mesh.local(),
        need_default=need_default, need_no_limiter=need_no_limiter,
        need_no_limiter_normalized=need_no_limiter_normalized,
        target_lengths=list(target_lengths_local), reference_lengths=list(reference_lengths_local),
    )
    return LocalOutput(out, range(start, stop))


def local_results(local: LocalOutput, variant: str = "result") -> List[Tuple[int, np.ndarray]]:
    """(global batch row, host array) for every row this process owns —
    the save-side counterpart of the host-sharded load.

    Unlike the JAX function, which takes a global array and stitches its
    addressable shards, this takes the :class:`LocalOutput` of
    :func:`master_batch_distributed` or :func:`master_farm_distributed`
    and the name of the variant to read (``"result"``,
    ``"result_no_limiter"`` or ``"result_no_limiter_normalized"``): its
    rows come back whole, time shards already joined.  Each row keeps the
    bucket's padded length; trim it to the track's true length."""
    values = getattr(local.output, variant)
    if values is None:
        raise ValueError(f"the distributed master did not render '{variant}'")
    host = values.cpu().numpy()
    return [(row, host[i]) for i, row in enumerate(local.rows)]


def master_farm_distributed(
    targets_local,
    references_local,
    target_lengths_global: Sequence[int],
    reference_lengths_global: Sequence[int],
    config: Optional[Config] = None,
    mesh: Optional[GlobalMesh] = None,
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
) -> LocalOutput:
    """The 2-D ``(pairs, time)`` farm across processes: pairs cross
    processes, each pair's time blocks stay on its process's devices.

    Every process passes the bucket-padded pairs it owns
    (:func:`local_pair_slice` rows of the global batch) plus the *global*
    length lists (small host metadata every job submitter knows), and runs
    ``timeshard.master_farm`` over its rows of the mesh (default: one
    pairs row per process, time over all its devices).  Returns this
    process's rows; pull them out with :func:`local_results`."""
    from .timeshard import master_farm

    config = config or Config()
    if mesh is None:
        mesh = global_mesh(time=len(_devices(None)))
    start, stop = local_pair_slice(mesh, len(target_lengths_global))
    if len(targets_local) != stop - start or len(references_local) != stop - start:
        raise ValueError(
            f"this process owns rows [{start}, {stop}) but was given "
            f"{len(targets_local)} targets and {len(references_local)} references"
        )
    out = master_farm(
        targets_local, references_local, config, mesh=mesh.local(),
        need_default=need_default, need_no_limiter=need_no_limiter,
        need_no_limiter_normalized=need_no_limiter_normalized,
        target_lengths=list(target_lengths_global)[start:stop],
        reference_lengths=list(reference_lengths_global)[start:stop],
    )
    return LocalOutput(out, range(start, stop))


def agree_bucket(local_max_length: int, multiple: int = 1 << 18) -> int:
    """Global bucket length: gather each process's longest track and round
    the global maximum up to ``multiple`` — every process must pad to the
    same shape before :func:`master_batch_distributed`."""
    longest = max(_all_gather_ints(local_max_length))
    return -(-longest // multiple) * multiple


# ---------------------------------------------------------------------------
# Self-test: N processes against the single-process answer


def _selftest_worker(
    process_id: int,
    num_processes: int,
    port: int,
    time: int = 1,
    pairs: Optional[int] = None,
    dtype: str = "float64",
    check: Optional[int] = None,
    encode: int = 0,
    report_path: Optional[str] = None,
    devices_per_process: int = 2,
    device: str = "cuda",
    timeout: float = DEFAULT_TIMEOUT_S,
) -> None:
    """One worker of the distributed self-test.

    Its local devices are ``devices_per_process`` copies of one device: the
    CPU, or one card (card ``process_id`` modulo the visible cards).
    Defaults reproduce the JAX self-test (one pair per mesh row, ~3-5 s
    tracks, every pair checked); ``pairs`` sets the global batch size with
    short (~0.6-1 s) tracks, ``check`` limits the comparison with the
    single-process float64 master to an evenly sampled subset, ``encode``
    writes that many sampled owned results to PCM_16 WAV, and
    ``report_path`` makes each process write a JSON row with its wall
    time, checks and the bucket the processes agreed on."""
    import json
    import tempfile
    import time as _time

    from ..stages import master
    from .batch import bucket_pad

    if device == "cpu":
        local_device = torch.device("cpu")
    else:
        local_device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(local_device)
    initialize(
        coordinator_address=f"localhost:{port}", num_processes=num_processes,
        process_id=process_id, timeout_s=timeout,
    )
    try:
        config = Config(dtype=dtype)
        sr = config.internal_sample_rate
        scale_mode = pairs is not None
        total_pairs = pairs if scale_mode else num_processes * devices_per_process // time
        if scale_mode:
            secs = [0.6 + 0.05 * (i % 8) for i in range(total_pairs)]
        else:
            secs = [3.0 + 0.7 * i for i in range(total_pairs)]
        np_dtype = np.dtype(dtype)

        def synth(seed: int, seconds: float, amp: float) -> np.ndarray:
            r = np.random.RandomState(seed)
            n = int(seconds * sr)
            env = 0.5 + 0.5 * np.sin(np.arange(n) / sr * 2.0)[:, None]
            return np.clip(amp * r.randn(n, 2) * env, -0.99, 0.99).astype(np_dtype)

        targets = [synth(10 + i, secs[i], 0.25) for i in range(total_pairs)]
        references = [synth(50 + i, secs[-1 - i], 0.85) for i in range(total_pairs)]
        multiple = 1 << 15 if scale_mode else 1 << 16
        t_all, t_lens = bucket_pad(targets, multiple=multiple, device="cpu")
        r_all, r_lens = bucket_pad(references, multiple=multiple, device="cpu")

        mesh = global_mesh(time=time, devices=[local_device] * devices_per_process)
        start, stop = local_pair_slice(mesh, total_pairs)
        # the bucket from the owned tracks alone equals the global one
        agreed = agree_bucket(max(t_lens[start:stop]), multiple)
        if agreed != t_all.shape[1]:
            raise SystemExit(f"[proc {process_id}] agree_bucket gave {agreed}, not {t_all.shape[1]}")
        t_start = _time.perf_counter()
        if time > 1:
            out = master_farm_distributed(
                t_all[start:stop], r_all[start:stop], t_lens, r_lens, config, mesh,
            )
        else:
            out = master_batch_distributed(
                t_all[start:stop], r_all[start:stop], t_lens[start:stop], r_lens[start:stop],
                config, mesh,
            )
        owned = local_results(out)  # reads every owned row back to the host
        n_owned = len(owned)
        wall_s = _time.perf_counter() - t_start

        # float64 keeps the JAX self-test's exactness gate; float32 is held
        # to the float64 single-process master on the same device, so its
        # gate is the float32 pipeline's accuracy floor
        gate_db = 100.0 if dtype == "float64" else 90.0
        oracle_config = Config(dtype="float64")
        if check is None:
            checked = list(range(n_owned))
        else:
            stride = max(1, n_owned // max(1, check))
            checked = list(range(0, n_owned, stride))[:check]
        failures, snrs = [], []
        for k in checked:
            row, got = owned[k]
            expected = master(
                targets[row].astype(np.float64), references[row].astype(np.float64),
                oracle_config, device=local_device,
            ).result.cpu().numpy()
            err = expected - got[: t_lens[row]]
            denom = float(np.sum(err * err))
            snr = np.inf if denom == 0 else 10.0 * np.log10(np.sum(expected**2) / denom)
            snrs.append(float(snr))
            print(f"[proc {process_id}] pair {row}: {snr:.1f} dB", flush=True)
            if snr < gate_db:
                failures.append((row, snr))

        encoded = []
        if encode:
            from ..io.saver import save

            folder = os.path.dirname(os.path.abspath(report_path)) if report_path else None
            enc_dir = tempfile.mkdtemp(prefix=f"mtpu_farm_p{process_id}_", dir=folder)
            stride = max(1, n_owned // encode)
            for k in list(range(0, n_owned, stride))[:encode]:
                row, got = owned[k]
                path = os.path.join(enc_dir, f"pair{row:04d}.wav")
                save(path, got[: t_lens[row]], sr, "PCM_16", "result")
                encoded.append(path)
            print(f"[proc {process_id}] encoded {len(encoded)} results", flush=True)

        if report_path:
            row_report = {
                "process": process_id,
                "processes": num_processes,
                "devices_per_process": devices_per_process,
                "device": str(local_device),
                "time_axis": time,
                "total_pairs": total_pairs,
                "owned_pairs": n_owned,
                "owned_rows": [start, stop],
                "bucket_samples": int(t_all.shape[1]),
                "agreed_bucket": agreed,
                "dtype": dtype,
                "wall_s": wall_s,
                "audio_seconds_total": float(np.sum(secs)),
                "checked": len(checked),
                "min_snr_db": min(snrs) if snrs else None,
                "encoded": encoded,
            }
            with open(f"{report_path}.proc{process_id}.json", "w") as f:
                json.dump(row_report, f, indent=2)
                f.write("\n")
        if failures:
            raise SystemExit(f"[proc {process_id}] SELFTEST FAILED: {failures}")
        print(f"[proc {process_id}] SELFTEST OK", flush=True)
    finally:
        shutdown()


def worker_env(num_processes: int) -> dict:
    """The environment for ``num_processes`` worker processes on this host:
    the package importable, and each process's thread pools (OpenMP, the
    BLAS under numpy and scipy) sized to its share of the cores.  The
    workers build their smoothing operators on the host at the same time,
    and pools of every core in each spin against one another (a 2-process
    build took 7x as long as one alone)."""
    package_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [package_parent, env.get("PYTHONPATH")]))
    threads = str(max(1, (os.cpu_count() or 1) // num_processes))
    for name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        env[name] = threads
    return env


def run_selftest(
    num_processes: int = 2,
    devices_per_process: int = 2,
    time: int = 1,
    pairs: Optional[int] = None,
    dtype: str = "float64",
    check: Optional[int] = None,
    encode: int = 0,
    report_path: Optional[str] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
    device: str = "cuda",
) -> None:
    """Spawn ``num_processes`` workers and verify that the distributed farm
    reproduces the single-process master for every pair.

    ``device``: ``"cuda"`` (the default: raises without a card) or
    ``"cpu"``; each worker holds ``devices_per_process`` copies of it.
    ``time`` > 1 runs the 2-D farm: pairs across the processes, each
    pair's time blocks over that process's devices (``--processes 2
    --devices_per_process 4 --time 2`` builds a (pairs=4, time=2) mesh
    whose rows cross the process boundary).  The scale knobs
    (``pairs``/``dtype``/``check``/``encode``/``report_path``) are the JAX
    self-test's.  A worker that fails stops the others; one that outlives
    ``timeout`` seconds is killed."""
    import socket
    import subprocess
    import sys
    import time as _time

    resolve_device(device)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = worker_env(num_processes)
    extra = ["--devices_per_process", str(devices_per_process), "--device", device,
             "--timeout", str(timeout)]
    if pairs is not None:
        extra += ["--pairs", str(pairs)]
    if dtype != "float64":
        extra += ["--dtype", dtype]
    if check is not None:
        extra += ["--check", str(check)]
    if encode:
        extra += ["--encode", str(encode)]
    if report_path:
        extra += ["--report_path", report_path]
    workers = [
        subprocess.Popen(
            [
                sys.executable, "-m", "matchering_tpu_torch.parallel.launch", "worker",
                "--process_id", str(i), "--processes", str(num_processes),
                "--port", str(port), "--time", str(time), *extra,
            ],
            env=env,
        )
        for i in range(num_processes)
    ]
    deadline = _time.monotonic() + timeout
    try:
        while any(w.poll() is None for w in workers):
            if any(w.returncode for w in workers if w.returncode is not None):
                break  # one failed: the others would wait on it
            if _time.monotonic() > deadline:
                raise SystemExit("selftest timed out — killed remaining workers")
            _time.sleep(0.1)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
            w.wait()
    codes = [w.returncode for w in workers]
    if any(codes):
        raise SystemExit(f"selftest worker exit codes: {codes}")
    print(f"multi-process selftest passed ({num_processes} processes, time={time}, {device})")


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m matchering_tpu_torch.parallel.launch",
        description="multi-process runs: the self-test and its worker entry",
    )
    parser.add_argument("command", choices=["selftest", "worker"])
    parser.add_argument("--processes", type=int, default=2)
    parser.add_argument("--devices_per_process", type=int, default=2)
    parser.add_argument("--process_id", type=int, default=0)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument(
        "--time", type=int, default=1,
        help="time-axis size of the (pairs, time) mesh (must divide each "
        "process's local device count)",
    )
    parser.add_argument(
        "--pairs", type=int, default=None,
        help="scale mode: global batch size with short tracks",
    )
    parser.add_argument("--dtype", default="float64")
    parser.add_argument(
        "--check", type=int, default=None,
        help="check only this many evenly-sampled owned pairs against the "
        "single-process float64 master (default: all)",
    )
    parser.add_argument(
        "--encode", type=int, default=0,
        help="encode this many sampled owned results to WAV (ownership proof)",
    )
    parser.add_argument("--report_path", default=None)
    parser.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the workers run (default: the card)",
    )
    args = parser.parse_args(argv)
    knobs = dict(pairs=args.pairs, dtype=args.dtype, check=args.check, encode=args.encode,
                 report_path=args.report_path, timeout=args.timeout, device=args.device)
    if args.command == "selftest":
        run_selftest(args.processes, args.devices_per_process, args.time, **knobs)
    else:
        _selftest_worker(
            args.process_id, args.processes, args.port, args.time,
            devices_per_process=args.devices_per_process, **knobs,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
