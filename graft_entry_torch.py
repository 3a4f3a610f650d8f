"""Driver entry points of the PyTorch port: the flagship forward step and a
multi-device dry run (the twins of ``__graft_entry__.py``).

Both run on the card unless the caller names another device
(``device="cpu"``), and raise without one.  The module imports numpy and
``matchering_tpu_torch`` only, nothing of JAX.

    python3 graft_entry_torch.py    # entry() and dryrun_multichip(4) on the card
"""

import numpy as np


def _tiny_pair(seconds_t=1.5, seconds_r=1.2, sr=44100):
    n_t, n_r = int(seconds_t * sr), int(seconds_r * sr)
    rng = np.random.RandomState(0)
    t = np.arange(max(n_t, n_r)) / sr
    target = np.stack(
        [
            0.4 * np.sin(2 * np.pi * 220 * t[:n_t]) + 0.03 * rng.randn(n_t),
            0.4 * np.sin(2 * np.pi * 221 * t[:n_t]) + 0.03 * rng.randn(n_t),
        ],
        axis=1,
    ).astype(np.float32)
    reference = np.stack(
        [
            0.8 * np.sign(np.sin(2 * np.pi * 110 * t[:n_r])) + 0.03 * rng.randn(n_r),
            0.8 * np.sign(np.sin(2 * np.pi * 110 * t[:n_r])) + 0.03 * rng.randn(n_r),
        ],
        axis=1,
    ).astype(np.float32)
    return target, reference


def entry(device=None):
    """(forward, example_args) for the flagship forward step: the full
    mastering graph (level match -> FIR EQ -> RMS correction -> limiter)
    on a 1.5 s / 1.2 s pair, whose tensors sit on ``device`` (``cuda``
    unless named).  The kernels build at their first launch; there is no
    compile cache to enable."""
    import matchering_tpu_torch as mt
    from matchering_tpu_torch.utils import resolve_device, to_device

    device = resolve_device(device)
    config = mt.Config()

    def forward(target, reference):
        out = mt.master_graph(target, reference, config, need_default=True)
        return out.result

    target, reference = _tiny_pair()
    return forward, (to_device(target, device), to_device(reference, device))


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One full mastering step over an ``n_devices`` mesh with the
    production layout: pairs over the outer axis, time blocks of each pair
    over the inner axis, with the halo exchange, the carried IIR scans and
    the cross-shard statistics.  Every place of the mesh is ``device``
    (``cuda`` unless named): a device may repeat, so one card or the CPU
    holds the ``n_devices`` shards as rows of its tensors."""
    import matchering_tpu_torch as mt
    from matchering_tpu_torch.parallel import make_mesh, timeshard
    from matchering_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    pairs = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    time = n_devices // pairs
    mesh = make_mesh(pairs=pairs, time=time, devices=[device] * n_devices)

    target, reference = _tiny_pair(seconds_t=1.0 * time / 4 + 1.0, seconds_r=1.1)
    targets = np.stack([target] * (2 * pairs))
    references = np.stack([reference] * (2 * pairs))

    out = timeshard.master_farm(
        targets,
        references,
        mt.Config(),
        mesh=mesh,
        need_default=True,
        need_no_limiter=True,
        need_no_limiter_normalized=True,
    )
    assert out.result.shape == targets.shape
    assert np.isfinite(out.result.cpu().numpy()).all()

    # true per-track lengths through the same 2-D farm (the bucket-padded
    # serving path): every entry analysed at its own length
    lengths_t = [target.shape[0] - 1000 * i for i in range(2 * pairs)]
    lengths_r = [reference.shape[0] - 700 * i for i in range(2 * pairs)]
    out_dyn = timeshard.master_farm(
        targets,
        references,
        mt.Config(),
        mesh=mesh,
        need_default=True,
        target_lengths=lengths_t,
        reference_lengths=lengths_r,
    )
    assert np.isfinite(out_dyn.result.cpu().numpy()).all()


if __name__ == "__main__":
    fn, args = entry()
    print("entry output:", tuple(fn(*args).shape))
    dryrun_multichip(4)
    print("dryrun_multichip OK")
