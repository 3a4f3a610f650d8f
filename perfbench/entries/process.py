"""Entry ``process``: ``mt.process(target.wav, reference.wav,
[mt.pcm16(result.wav)], config)``, file to file, one call at a time.

Set-up makes a pool of targets and references on the device from the seed
(``signals.track``), quantises them to PCM_16 there and writes them as WAV
files under the run's temporary folder.  Their lengths are fixed by the
traffic file (the midpoints of equal shares of its range), the same for
every seed; the seed draws their content, the order of the pairs (each
cycle a new permutation of all target-reference pairs) and which calls
are compared.  A compared call writes its result to a file; every other
call encodes its result in full into a path that discards the bytes, so a
run writes the pool and a few results to disk, not every result.

The check decodes each compared file and holds its codes to the plain
reference's float64 master of the same codes, encoded by the same rule.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from .. import signals, wavfile
from ..harness import port_config
from ..reference import matchering as reference

# the port's info codes that open (or, None, close) a phase span
PHASES = {2003: "decode_check", 2004: "graph", 2008: "export", 2010: None}
SPANS = ("decode_check", "graph", "export")


def fixed_lengths(seconds_range, count: int, rate: int) -> List[int]:
    """``count`` lengths in samples: the midpoints of ``count`` equal
    shares of the range, so every seed masters the same amount of audio."""
    lo, hi = seconds_range
    return [int(round((lo + (hi - lo) * (i + 0.5) / count) * rate)) for i in range(count)]


@dataclass
class Track:
    path: str
    codes: np.ndarray  # (n, 2) int16, as written


@dataclass
class State:
    config: object
    rate: int
    targets: List[Track]
    references: List[Track]
    rng: np.random.Generator
    compared: Dict[int, str]
    discard: str
    order: List[int] = field(default_factory=list)

    def pair(self, index: int):
        pairs = len(self.targets) * len(self.references)
        while len(self.order) <= index:
            self.order.extend(int(k) for k in self.rng.permutation(pairs))
        t, r = divmod(self.order[index], len(self.references))
        return self.targets[t], self.references[r]


def _pool(ctx, role: str, lengths, rng, gen) -> List[Track]:
    traffic, rate = ctx.cell.traffic, ctx.cell.config["parameters"]["internal_sample_rate"]
    tracks = []
    for i, n in enumerate(rng.permutation(lengths)):
        codes = signals.pcm16(signals.track(int(n), rate, traffic[role], gen, ctx.device)).cpu().numpy()
        path = os.path.join(ctx.workdir, f"{role}_{i}.wav")
        wavfile.write(path, codes, rate)
        tracks.append(Track(path, codes))
    return tracks


def prepare(ctx) -> State:
    traffic, parameters = ctx.cell.traffic, ctx.cell.config["parameters"]
    rate = parameters["internal_sample_rate"]
    rng = np.random.default_rng(ctx.seed % (1 << 64))
    gen = signals.generator(ctx.seed, ctx.device)
    targets = _pool(ctx, "target", fixed_lengths(traffic["target_seconds"], traffic["targets"], rate), rng, gen)
    references = _pool(
        ctx, "reference", fixed_lengths(traffic["reference_seconds"], traffic["references"], rate), rng, gen
    )
    compared = sorted(int(i) for i in rng.choice(traffic["compare_among_first"], traffic["compared"], replace=False))
    discard = os.path.join(ctx.workdir, "discard.wav")
    os.symlink(os.devnull, discard)
    return State(
        config=port_config(ctx.mt, parameters),
        rate=rate,
        targets=targets,
        references=references,
        rng=rng,
        compared={i: os.path.join(ctx.workdir, f"result_{i}.wav") for i in compared},
        discard=discard,
    )


def _process(ctx, state: State, target: Track, ref: Track, out: str) -> None:
    ctx.mt.process(target.path, ref.path, [ctx.mt.pcm16(out)], state.config, device=ctx.device)


def warm(ctx, state: State) -> None:
    """Every target and every reference once: the device's shapes follow
    one track each (cuFFT plans, the allocator's blocks, page-locked
    buffers)."""
    for i, target in enumerate(state.targets):
        _process(ctx, state, target, state.references[i % len(state.references)], state.discard)


def call(ctx, state: State, index: int) -> dict:
    target, ref = state.pair(index)
    _process(ctx, state, target, ref, state.compared.get(index, state.discard))
    n = target.codes.shape[0]
    return {"audio_s": n / state.rate, "samples": n, "itemsize": 4}


def compared_indices(state: State) -> List[int]:
    return sorted(state.compared)


def release(ctx, state: State) -> None:
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def compare(ctx, state: State, calls) -> List[dict]:
    """Each compared call's file against the reference: the worst file's
    share of samples whose code differs, in %, the widest difference in
    codes, and the compared calls with no readable file of the right
    shape."""
    limits, parameters = ctx.cell.limits, ctx.cell.config["parameters"]
    worst_share, widest, missing = 0.0, 0, 0
    for index, path in state.compared.items():
        if index >= len(calls):
            continue
        target, ref = state.pair(index)
        try:
            codes, rate = wavfile.read(path)
        except (OSError, ValueError):
            missing += 1
            continue
        if rate != state.rate or codes.shape != target.codes.shape:
            missing += 1
            continue
        expected = reference.pcm16_codes(
            reference.master(target.codes / 32768.0, ref.codes / 32768.0, parameters)
        )
        steps = np.abs(codes.astype(np.int32) - expected)
        worst_share = max(worst_share, 100.0 * float(np.count_nonzero(steps)) / steps.size)
        widest = max(widest, int(steps.max()))
    compared = sum(1 for i in state.compared if i < len(calls))
    if compared == 0:
        missing = len(state.compared)
    return [
        {"name": "code_mismatch_pct", "value": worst_share, "limit": limits["code_mismatch_pct"]},
        {"name": "max_code_steps", "value": widest, "limit": limits["max_code_steps"]},
        {"name": "missing_files", "value": missing, "limit": limits["missing_files"]},
    ]
