"""Entry ``master``: ``mt.master(target, reference, config,
need_default=True)`` on tracks staged on the device, each call ending in
a synchronisation of the device.

Set-up makes ``targets`` targets and one reference on the device from the
seed (``signals.track``, float32); the calls take the targets in turn, so
no call's input is the one before it.  The seed draws the content and
which of the first calls is compared; that call's result stays on the
device until the window has closed, then crosses to the host with its
inputs, and the program's tensors are freed before the plain reference
masters the same inputs in float64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import signals
from ..reference import matchering as reference
from ..harness import port_config

SPANS = ("master", "synchronize")


@dataclass
class State:
    config: object
    rate: int
    targets: list
    reference: object
    compared: int
    held: Optional[tuple] = None
    host: Optional[tuple] = None  # (target, reference, result) as numpy, after release


def prepare(ctx) -> State:
    traffic, parameters = ctx.cell.traffic, ctx.cell.config["parameters"]
    rate = parameters["internal_sample_rate"]
    rng = np.random.default_rng(ctx.seed % (1 << 64))
    gen = signals.generator(ctx.seed, ctx.device)
    n = int(round(traffic["target_seconds"] * rate))
    targets = [signals.track(n, rate, traffic["target"], gen, ctx.device) for _ in range(traffic["targets"])]
    ref = signals.track(int(round(traffic["reference_seconds"] * rate)), rate, traffic["reference"], gen, ctx.device)
    return State(
        config=port_config(ctx.mt, parameters),
        rate=rate,
        targets=targets,
        reference=ref,
        compared=int(rng.integers(traffic["compare_among_first"])),
    )


def _synchronize(ctx) -> None:
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize(ctx.device)


def warm(ctx, state: State) -> None:
    for target in state.targets:
        out = ctx.mt.master(target, state.reference, state.config, need_default=True, device=ctx.device)
        _synchronize(ctx)
        del out


def call(ctx, state: State, index: int) -> dict:
    which = index % len(state.targets)
    with ctx.span("master"):
        out = ctx.mt.master(state.targets[which], state.reference, state.config, need_default=True, device=ctx.device)
    with ctx.span("synchronize"):
        _synchronize(ctx)
    if index == state.compared:
        state.held = (which, out.result)
    n = state.targets[which].shape[0]
    return {"audio_s": n / state.rate, "samples": n, "itemsize": out.result.element_size()}


def compared_indices(state: State) -> List[int]:
    return [state.compared]


def release(ctx, state: State) -> None:
    if state.held is not None:
        which, result = state.held
        state.host = (
            state.targets[which].cpu().numpy(),
            state.reference.cpu().numpy(),
            result.cpu().numpy(),
        )
    state.held = None
    state.targets.clear()
    state.reference = None
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def compare(ctx, state: State, calls) -> List[dict]:
    """The compared call's result against the reference's float64 master:
    the RMS of the difference over the RMS of the reference's, and the
    largest difference of a sample."""
    limits = ctx.cell.limits
    if state.host is None:
        rel, widest, missing = None, None, 1
    else:
        target, ref, result = state.host
        expected = reference.master(target, ref, ctx.cell.config["parameters"])
        energy = reference.blocks(expected.shape[0], lambda a, b: (
            float(np.sum(np.square(result[a:b] - expected[a:b]))),
            float(np.sum(np.square(expected[a:b]))),
            float(np.max(np.abs(result[a:b] - expected[a:b]))),
        ))
        rel = float(np.sqrt(sum(e[0] for e in energy) / sum(e[1] for e in energy)))
        widest = max(e[2] for e in energy)
        missing = 0
    return [
        {"name": "rel_rms_error", "value": rel, "limit": limits["rel_rms_error"]},
        {"name": "max_abs_error", "value": widest, "limit": limits["max_abs_error"]},
        {"name": "missing_results", "value": missing, "limit": limits["missing_results"]},
    ]
