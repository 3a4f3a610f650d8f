"""Entry ``staged``: the port's masters on tracks staged on the device,
each call ending in a synchronisation of the device.

The traffic file's ``batch`` chooses the call:

* ``batch: 1``: ``mt.master(target, reference, config,
  need_default=True)`` on one pair; the pool's target x reference pairs
  run in a new seeded permutation each cycle;
* ``batch: B > 1``: the farm's length-aware batch, as a caller of the
  port's batch API makes it: ``parallel.batch.bucket_pad`` of B targets
  and, apart, of B references (to the configuration's
  ``length_bucketing``), then ``parallel.batch.master_batch`` with the
  true lengths.  The calls take the ``target_sets`` sets of B targets in
  turn, and give a set's rows the references, each ``B / references``
  times, in a new seeded order each call.

Set-up makes every track on the device from the seed (``signals.track``,
float32) at fixed lengths, the midpoints of equal shares of the traffic
file's ranges, so every seed costs the same work; the seed draws the
content, the orders and the compared call, one among the first calls
that master the longest target.  The compared call's result stays on the
device until the window has closed.  Then its compared rows (one pair;
for a batch, the longest target's row and one seeded other row) cross to
the host with their unpadded inputs, the program's tensors are freed, and
the plain reference masters the same pairs in float64, zero-padded to the
call's bucket (``reference/farm.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import signals
from ..harness import port_config
from ..reference import farm as reference_farm
from ..reference import matchering as reference
from .process import fixed_lengths

SPANS = ("pad", "master_batch", "master", "synchronize")


@dataclass
class State:
    config: object
    rate: int
    batch: int
    bucket: int  # samples a batch pads each role to a multiple of
    sets: List[list]  # the target sets (batch 1: one set, the pool)
    references: list
    rng: np.random.Generator
    compared: int
    rows: List[int]  # the compared call's compared rows
    api: object  # matchering_tpu_torch.parallel.batch
    order: list = field(default_factory=list)
    held: Optional[object] = None  # the compared call's result, on the device
    host: Optional[tuple] = None  # (targets, references, results, padded length) as numpy, after release

    def pairing(self, index: int):
        """The targets and references of call ``index``, row by row."""
        if self.batch == 1:
            pool = self.sets[0]
            while len(self.order) <= index:
                self.order.extend(int(k) for k in self.rng.permutation(len(pool) * len(self.references)))
            t, r = divmod(self.order[index], len(self.references))
            return [pool[t]], [self.references[r]]
        slots = np.arange(self.batch) % len(self.references)
        while len(self.order) <= index:
            self.order.append([int(k) for k in self.rng.permutation(slots)])
        return self.sets[index % len(self.sets)], [self.references[r] for r in self.order[index]]


def _tracks(ctx, role: str, count: int, rng, gen) -> list:
    traffic, rate = ctx.cell.traffic, ctx.cell.config["parameters"]["internal_sample_rate"]
    lengths = rng.permutation(fixed_lengths(traffic[f"{role}_seconds"], count, rate))
    return [signals.track(int(n), rate, traffic[role], gen, ctx.device) for n in lengths]


def prepare(ctx) -> State:
    from matchering_tpu_torch.parallel import batch as api

    traffic, parameters = ctx.cell.traffic, ctx.cell.config["parameters"]
    batch = traffic["batch"]
    if batch > 1 and (traffic["targets"] != batch or batch % traffic["references"]):
        raise ValueError("a batch takes one target set and each reference equally often")
    rng = np.random.default_rng(ctx.seed % (1 << 64))
    gen = signals.generator(ctx.seed, ctx.device)
    sets = [_tracks(ctx, "target", traffic["targets"], rng, gen) for _ in range(traffic["target_sets"])]
    references = _tracks(ctx, "reference", traffic["references"], rng, gen)
    state = State(
        config=port_config(ctx.mt, parameters),
        rate=parameters["internal_sample_rate"],
        batch=batch,
        bucket=parameters.get("length_bucketing") or 1,
        sets=sets,
        references=references,
        rng=rng,
        compared=-1,
        rows=[],
        api=api,
    )
    # the compared call holds the longest target, so the result it keeps
    # on the device, and the run's peak memory, are the same for every seed
    longest = max(t.shape[0] for targets in sets for t in targets)
    holding = {i: [r for r, t in enumerate(state.pairing(i)[0]) if t.shape[0] == longest]
               for i in range(traffic["compare_among_first"])}
    state.compared = int(rng.choice([i for i, rows in holding.items() if rows]))
    row = holding[state.compared][0]
    others = [r for r in range(batch) if r != row]
    state.rows = [row] + [int(r) for r in rng.choice(others, traffic["compared_rows"] - 1, replace=False)]
    return state


def _synchronize(ctx) -> None:
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize(ctx.device)


def _master(ctx, state: State, targets, references):
    """One call's work: the result on the device, and the padded length."""
    if state.batch == 1:
        with ctx.span("master"):
            out = ctx.mt.master(targets[0], references[0], state.config, need_default=True, device=ctx.device)
        return out.result[None], targets[0].shape[0]
    with ctx.span("pad"):
        padded_targets, target_lengths = state.api.bucket_pad(targets, state.bucket, device=ctx.device)
        padded_references, reference_lengths = state.api.bucket_pad(references, state.bucket, device=ctx.device)
    with ctx.span("master_batch"):
        out = state.api.master_batch(
            padded_targets, padded_references, state.config, need_default=True,
            target_lengths=target_lengths, reference_lengths=reference_lengths, device=ctx.device,
        )
    return out.result, padded_targets.shape[1]


def warm(ctx, state: State) -> None:
    """Every target set, or every target and every reference once: the
    device's shapes follow the padded lengths, or each track's own
    (cuFFT plans, the allocator's blocks)."""
    if state.batch == 1:
        pool = state.sets[0]
        calls = [([t], [state.references[i % len(state.references)]]) for i, t in enumerate(pool)]
    else:
        calls = [(targets, [state.references[r] for r in np.arange(state.batch) % len(state.references)])
                 for targets in state.sets]
    for targets, references in calls:
        result, _ = _master(ctx, state, targets, references)
        _synchronize(ctx)
        del result


def call(ctx, state: State, index: int) -> dict:
    targets, references = state.pairing(index)
    result, n_pad = _master(ctx, state, targets, references)
    with ctx.span("synchronize"):
        _synchronize(ctx)
    if index == state.compared:
        state.held = result
    true = sum(t.shape[0] for t in targets)
    # samples: the padded targets' samples, which the device works through
    return {"audio_s": true / state.rate, "samples": len(targets) * n_pad, "itemsize": result.element_size()}


def compared_indices(state: State) -> List[int]:
    return [state.compared]


def release(ctx, state: State) -> None:
    if state.held is not None:
        targets, references = state.pairing(state.compared)
        state.host = (
            [targets[r].cpu().numpy() for r in state.rows],
            [references[r].cpu().numpy() for r in state.rows],
            [state.held[r].cpu().numpy() for r in state.rows],
            state.held.shape[1],
        )
    state.held = None
    state.sets.clear()
    state.references.clear()
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def compare(ctx, state: State, calls) -> List[dict]:
    """Each compared row against the reference's float64 master of its
    unpadded pair, zero-padded to the bucket: over all compared rows, the
    RMS of the difference over the RMS of the reference's, the largest
    difference of a sample, and (a batch) the largest magnitude past a
    row's true length, which must be exactly 0."""
    limits = ctx.cell.limits
    rel = widest = leak = None
    missing = len(state.rows)
    if state.host is not None:
        targets, references, results, n_pad = state.host
        expected = reference_farm.master_rows(targets, references, ctx.cell.config["parameters"], n_pad)
        sums = []
        for result, want in zip(results, expected):
            sums += reference.blocks(n_pad, lambda a, b: (
                float(np.sum(np.square(result[a:b] - want[a:b]))),
                float(np.sum(np.square(want[a:b]))),
                float(np.max(np.abs(result[a:b] - want[a:b]))),
            ))
        rel = float(np.sqrt(sum(s[0] for s in sums) / sum(s[1] for s in sums)))
        widest = max(s[2] for s in sums)
        leak = max(float(np.max(np.abs(result[t.shape[0]:]), initial=0.0)) for result, t in zip(results, targets))
        missing = 0
    checks = [
        {"name": "rel_rms_error", "value": rel, "limit": limits["rel_rms_error"]},
        {"name": "max_abs_error", "value": widest, "limit": limits["max_abs_error"]},
    ]
    if "padding_leak" in limits:
        checks.append({"name": "padding_leak", "value": leak, "limit": limits["padding_leak"]})
    checks.append({"name": "missing_results", "value": missing, "limit": limits["missing_results"]})
    return checks
