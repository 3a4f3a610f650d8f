"""Mastering many (target, reference) pairs (PyTorch).

Counterpart of ``matchering_tpu/parallel/batch.py``.  Pairs of one batch
are zero-padded to a shared bucket per role (``bucket_pad``), and each
track's true length rides along, host ints beside a staged device tensor
(``utils.RowInts``): piece division, analysis and the limiter's end follow
each track's exact length, so row i reproduces the single-pair master of
unpadded pair i (the reference analyses the exact track length,
``match_levels.py:47-59``), and samples past the length come back 0.

Two dispatches, as in the JAX package:

* ``master_batch`` runs ONE batch-first graph over the B rows: one set of
  launches for the batch (with the default filter orders, one K1 and four
  K2 launches in its limiter), or one per row of a mesh's ``pairs`` axis;
* ``master_pairs`` runs one graph per pair, all enqueued before any result
  is read, optionally round-robin over several devices.

There is no compile to amortise in eager PyTorch, so the two differ only
in launch count and kernel widths; their speed on the card is measured by
``chip_smoke.py`` (``PERF.md``).  Lengths are checked while they are host
ints, and tracks, lengths and the smoothing state (the operators and any
LOWESS plan) are staged before any graph runs, since a pageable
host-to-device copy waits for the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import trace
from ..config import Config
from ..stages import MasterOutput, check_lengths, master_graph
from ..state import operators_for_config
from ..utils import RowInts, resolve_device, to_device
from .mesh import Mesh, require_pairs_axis


def bucket_pad(
    tracks: Sequence, multiple: int = 1 << 18, *, device=None
) -> Tuple[torch.Tensor, List[int]]:
    """Zero-pad (n_i, 2) tracks (host arrays or tensors) to one shared
    length, the longest rounded up to ``multiple``, as one (B, n_pad, 2)
    tensor built on ``device`` (``cuda`` unless named), each track copied
    straight into its row.  Returns the batch and the true lengths.

    The tracks must share one dtype: stacking raw integer PCM with floats
    would promote the codes unscaled (convert first, as ``process_batch``
    does with ``basics.to_working_float``).  The span ``bucket``, timed
    on the device."""
    device = resolve_device(device)
    lengths = [int(t.shape[0]) for t in tracks]
    n_pad = -(-max(lengths) // multiple) * multiple
    batch = None
    with trace.span("bucket", device=device):
        for i, track in enumerate(tracks):
            track = to_device(track, device)
            if batch is None:
                batch = track.new_zeros((len(tracks), n_pad) + tuple(track.shape[1:]))
            if track.dtype != batch.dtype:
                raise ValueError(f"tracks of one bucket must share a dtype: {track.dtype} and {batch.dtype}")
            batch[i, : lengths[i]] = track
    return batch, lengths


def master_batch(
    targets,
    references,
    config: Config = Config(),
    mesh: Optional[Mesh] = None,
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
    target_lengths: Optional[Sequence[int]] = None,
    reference_lengths: Optional[Sequence[int]] = None,
    *,
    device=None,
) -> MasterOutput:
    """Master a batch of pairs, targets (B, n, 2) x references (B, m, 2),
    as one batch-first graph on ``device`` (``cuda`` unless named).

    ``target_lengths`` / ``reference_lengths`` (B host ints each, both or
    neither): the true lengths of bucket-padded rows (``bucket_pad``);
    row i then equals the single-pair master of unpadded pair i, and its
    samples past the length are 0 (trim on the host).  Without them the
    padded length is the analysis length (right only for tracks that fill
    the bucket).

    ``mesh`` (optional, with a ``pairs`` axis; ``parallel.make_mesh``):
    the B rows are cut into ``shape["pairs"]`` consecutive runs, run p a
    graph on the first device of the mesh's row p (a JAX mesh replicates
    the rows over its ``time`` axis), and the outputs are gathered on the
    mesh's first device; ``device`` is then not used.

    The span ``batch``, timed on the device: the lengths' and tracks'
    staging and the graph (one per row of a mesh).  Counters: ``batch.rows``
    (B), ``batch.padded_samples`` (B x (n + m), both roles) and
    ``batch.true_samples`` (the sum of every row's true lengths, both
    roles; the padded lengths where none are given)."""
    if mesh is not None:
        return _master_batch_over_mesh(
            targets, references, config, mesh, need_default, need_no_limiter,
            need_no_limiter_normalized, target_lengths, reference_lengths,
        )
    device = resolve_device(device)
    if len(targets) != len(references):
        raise ValueError("targets and references differ in count")
    if (target_lengths is None) != (reference_lengths is None):
        raise ValueError("pass both target_lengths and reference_lengths, or neither")
    rows, n, m = len(targets), targets.shape[1], references.shape[1]
    with trace.span("batch", device=device):
        if target_lengths is None:
            true_samples = rows * (n + m)
        else:  # checked on the host, then staged
            target_lengths = RowInts.of(check_lengths(target_lengths, n, config, "target"), device)
            reference_lengths = RowInts.of(check_lengths(reference_lengths, m, config, "reference"), device)
            true_samples = sum(target_lengths.host) + sum(reference_lengths.host)
        trace.count("batch.rows", rows)
        trace.count("batch.padded_samples", rows * (n + m))
        trace.count("batch.true_samples", true_samples)
        return master_graph(
            to_device(targets, device),
            to_device(references, device),
            config,
            need_default=need_default,
            need_no_limiter=need_no_limiter,
            need_no_limiter_normalized=need_no_limiter_normalized,
            target_length=target_lengths,
            reference_length=reference_lengths,
        )


def _master_batch_over_mesh(
    targets, references, config, mesh, need_default, need_no_limiter,
    need_no_limiter_normalized, target_lengths, reference_lengths,
) -> MasterOutput:
    """:func:`master_batch` with its rows sharded over ``mesh``'s pairs
    axis (``matchering_tpu/parallel/batch.py:215-226``)."""
    require_pairs_axis(mesh)
    devices = [row[0] for row in mesh.rows("pairs", "time")]
    count = len(targets)
    if count % len(devices):
        raise ValueError(f"batch {count} not divisible by pairs axis {len(devices)}")
    per = count // len(devices)
    outs = []
    for p, device in enumerate(devices):
        rows = slice(p * per, (p + 1) * per)
        outs.append(master_batch(
            targets[rows], references[rows], config,
            need_default=need_default,
            need_no_limiter=need_no_limiter,
            need_no_limiter_normalized=need_no_limiter_normalized,
            target_lengths=None if target_lengths is None else list(target_lengths)[rows],
            reference_lengths=None if reference_lengths is None else list(reference_lengths)[rows],
            device=device,
        ))
    home = devices[0]
    return MasterOutput(
        *(None if outs[0][k] is None else torch.cat([o[k].to(home) for o in outs]) for k in range(3)),
        report={key: torch.cat([o.report[key].to(home) for o in outs]) for key in outs[0].report},
    )


def master_pairs(
    targets: Sequence,
    references: Sequence,
    config: Config = Config(),
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
    target_lengths: Optional[Sequence[int]] = None,
    reference_lengths: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
    *,
    device=None,
) -> List[MasterOutput]:
    """Master pairs as independent graphs, one per pair, every one
    enqueued before any result is read.  Each track runs at its true
    length (``target_lengths`` / ``reference_lengths``, default: its
    padded length).

    ``devices`` (optional): torch devices the pairs go round-robin over,
    pair i on ``devices[i % len(devices)]``; the smoothing state is
    staged once per device and the results stay there.  Without it every
    pair runs on ``device`` (``cuda`` unless named).  Returns one
    ``MasterOutput`` per pair, in order.

    The span ``pairs``, on the host: the staging and the enqueue of every
    graph.  Each pair counts as one row of ``master_batch``'s counters
    (``batch.rows``, ``batch.padded_samples``, ``batch.true_samples``)."""
    if len(targets) != len(references):
        raise ValueError("targets and references differ in count")
    if (target_lengths is None) != (reference_lengths is None):
        raise ValueError("pass both target_lengths and reference_lengths, or neither")
    if target_lengths is None:
        target_lengths = [t.shape[0] for t in targets]
        reference_lengths = [r.shape[0] for r in references]
    if devices is None:
        devices = [resolve_device(device)]
    else:
        devices = [resolve_device(d) for d in devices]
    with trace.span("pairs"):
        operators = {d: operators_for_config(config, d) for d in set(devices)}

        # stage every pair first: a pageable copy would wait for the graphs
        staged = []
        for i, (t, r, tl, rl) in enumerate(zip(targets, references, target_lengths, reference_lengths)):
            on = devices[i % len(devices)]
            (tl,) = check_lengths([tl], t.shape[0], config, "target")
            (rl,) = check_lengths([rl], r.shape[0], config, "reference")
            trace.count("batch.rows")
            trace.count("batch.padded_samples", t.shape[0] + r.shape[0])
            trace.count("batch.true_samples", tl + rl)
            staged.append((
                to_device(t, on), to_device(r, on),
                RowInts.of([tl], on), RowInts.of([rl], on), operators[on],
            ))
        return [
            master_graph(
                t, r, config,
                need_default=need_default,
                need_no_limiter=need_no_limiter,
                need_no_limiter_normalized=need_no_limiter_normalized,
                interp_ops=ops,
                target_length=tl,
                reference_length=rl,
            )
            for t, r, tl, rl, ops in staged
        ]
