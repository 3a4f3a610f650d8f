"""Batch mastering: many (target, reference) pairs in one call.

Counterpart of ``matchering_tpu.farm`` (reference semantics per pair:
``matchering/core.py:32-121``).  Each job is decoded and conditioned as in
the single-pair path, both roles are bucket-padded on the device, every
track is analysed and limited at its true length (``master_graph``'s
dynamic path), and the outputs are cut back to their true lengths before
encoding, so each job's files are what ``process()`` writes for its pair.
A device mesh (``parallel.make_mesh``) spreads the pairs over its
``pairs`` rows and, with a ``time`` axis, time-shards each pair over its
row (``parallel.timeshard``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

from . import trace
from .config import Config
from .core import _VARIANT_FIELDS, _assert_graph_ready, _export, _ingest, _variant_key
from .checker import check_equality
from .log import Code, debug, debug_line, info
from .ops import basics
from .parallel.batch import bucket_pad, master_batch, master_pairs
from .parallel.mesh import require_pairs_axis
from .parallel.timeshard import master_farm
from .preview import create_preview
from .results import Result
from .utils import get_temp_folder, resolve_device


@dataclass(frozen=True)
class PairJob:
    """One mastering job: a target/reference file pair plus the outputs it
    wants (the single-pair API's descriptors)."""

    target: str
    reference: str
    results: List[Result] = field(default_factory=list)
    preview_target: Optional[Result] = None
    preview_result: Optional[Result] = None


def _one_dtype(tracks, config: Config):
    """A role's staged tracks as they are if they share a dtype; otherwise
    each converted where it lies to the working float
    (``basics.to_working_float``), so raw integer codes are never promoted
    unscaled.  The JAX package converts on the host to float64 instead;
    both round each code once to the working dtype, so the values are the
    same."""
    if len({t.dtype for t in tracks}) == 1:
        return tracks
    return [basics.to_working_float(t, config.torch_dtype) for t in tracks]


def process_batch(
    jobs: Sequence[PairJob],
    config: Config = Config(),
    mesh=None,
    bucket_multiple: Optional[int] = None,
    dispatch: str = "auto",
    *,
    device=None,
) -> None:
    """Master every job as one bucketed batch on ``device`` (``cuda``
    unless named; no CPU fallback), or over ``mesh``.

    Each role is padded to its longest track rounded up to
    ``bucket_multiple`` (default ``config.length_bucketing``, else 2^18
    samples).  ``dispatch``: ``"pipelined"`` runs one graph per pair
    (``master_pairs``), all enqueued before any result is read, and with a
    pairs-only ``mesh`` goes round-robin over its devices; ``"vmapped"``
    runs one batch-first graph over all pairs (``master_batch``): one set
    of kernel launches for the batch (one K1 and four K2 with the default
    filter orders), its rows sharded over the mesh's ``pairs`` axis; with
    a ``time`` axis too, each pair is time-sharded over its row
    (``parallel.timeshard.master_farm``).  ``"auto"`` is ``"vmapped"``
    when the mesh has a ``time`` axis, else ``"pipelined"``, as in the
    JAX package.  ``mesh`` (``parallel.make_mesh``) must have a ``pairs``
    axis; its first device loads the jobs unless ``device`` is named.
    The call's root span is ``process_batch`` (``trace``)."""
    with trace.span("process_batch"):
        time_sharded = mesh is not None and mesh.shape.get("time", 1) > 1
        if mesh is not None:
            require_pairs_axis(mesh)
        if bucket_multiple is None:
            bucket_multiple = config.length_bucketing or (1 << 18)
        if dispatch == "auto":
            dispatch = "vmapped" if time_sharded else "pipelined"
        if dispatch not in ("pipelined", "vmapped"):
            raise ValueError(f"unknown dispatch strategy '{dispatch}'")
        if dispatch == "pipelined" and time_sharded:
            raise ValueError(
                "pipelined dispatch runs whole pairs on single devices — it "
                "composes with a pairs-only mesh (round-robin), not a time axis"
            )
        jobs = list(jobs)
        if not jobs:
            raise RuntimeError("The job list is empty")
        for job in jobs:
            if not job.results and not (job.preview_target or job.preview_result):
                raise RuntimeError(f"Job '{job.target}' requests no outputs")
        if device is None and mesh is not None:
            device = mesh.devices.flat[0]
        device = resolve_device(device)

        debug(f"matchering_tpu_torch farm: {len(jobs)} pairs in one dispatch")
        debug_line()
        info(Code.INFO_LOADING)

        targets, references = [], []
        for job in jobs:
            anchor = job.results or [
                r for r in (job.preview_target, job.preview_result) if r is not None
            ]
            temp_folder = config.temp_folder or get_temp_folder(anchor)
            target_track = _ingest(job.target, "target", config, temp_folder, device)
            reference_track = _ingest(job.reference, "reference", config, temp_folder, device)
            if not config.allow_equality:
                check_equality(target_track[0], reference_track[0])
            _assert_graph_ready((target_track, reference_track), config)
            targets.append(target_track[0])
            references.append(reference_track[0])
        targets = _one_dtype(targets, config)
        references = _one_dtype(references, config)

        # the union of variants over all jobs: the graph renders each variant
        # once for the batch, and each job takes what it asked for
        wanted = {_variant_key(r) for job in jobs for r in job.results} or {"limited"}
        needs = dict(
            need_default="limited" in wanted,
            need_no_limiter="raw" in wanted,
            need_no_limiter_normalized="normalized" in wanted,
        )
        t_batch, t_lens = bucket_pad(targets, multiple=bucket_multiple, device=device)
        r_batch, r_lens = bucket_pad(references, multiple=bucket_multiple, device=device)
        debug(
            f"buckets: targets {tuple(t_batch.shape)}, references {tuple(r_batch.shape)} "
            f"(true lengths {t_lens} / {r_lens})"
        )

        if mesh is not None and dispatch == "vmapped":
            # the batch is cut over the mesh's pairs rows: round the job count
            # up by repeating the last pair (its extra outputs are not encoded)
            short = -len(jobs) % mesh.shape["pairs"]
            if short:
                t_batch = torch.cat([t_batch, t_batch[-1:].expand(short, -1, -1)])
                r_batch = torch.cat([r_batch, r_batch[-1:].expand(short, -1, -1)])
                t_lens, r_lens = t_lens + [t_lens[-1]] * short, r_lens + [r_lens[-1]] * short

        if dispatch == "pipelined":
            outs = master_pairs(
                list(t_batch), list(r_batch), config, **needs,
                target_lengths=t_lens, reference_lengths=r_lens, device=device,
                devices=None if mesh is None else list(mesh.devices.flat),
            )
        else:
            if time_sharded:
                out = master_farm(
                    t_batch, r_batch, config, mesh=mesh, **needs,
                    target_lengths=t_lens, reference_lengths=r_lens,
                )
            else:
                out = master_batch(
                    t_batch, r_batch, config, mesh=mesh, **needs,
                    target_lengths=t_lens, reference_lengths=r_lens, device=device,
                )
            outs = [out.row(i) for i in range(len(jobs))]

        debug_line()
        info(Code.INFO_EXPORTING)
        for job, out, length, target in zip(jobs, outs, t_lens, targets):
            # each job's variants cut back to its true length
            variants = {
                k: getattr(out, attr)[:length]
                for k, attr in _VARIANT_FIELDS.items()
                if getattr(out, attr) is not None
            }
            _export(job.results, variants, config)
            if job.preview_target or job.preview_result:
                # the preview source is the first variant THIS job asked for
                # (reference ``core.py:111-118``; the batch's union may hold
                # variants the job never asked for); a preview-only job takes
                # any rendered variant in the same order
                job_wanted = {_variant_key(r) for r in job.results}
                order = [k for k in _VARIANT_FIELDS if k in job_wanted] or list(_VARIANT_FIELDS)
                source = next(variants[k] for k in order if k in variants)
                create_preview(target, source, config, job.preview_target, job.preview_result)

        debug_line()
        info(Code.INFO_COMPLETED)
