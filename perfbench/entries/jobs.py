"""Entry ``jobs``: ``mt.process_batch(jobs, config)``, file to file, each
call one dispatch of the traffic file's ``batch`` jobs, each job writing
its PCM_16 master and both PCM_16 previews.

Set-up writes the song pool (``entries/process.py``): targets and
references made on the device from the seed, quantised to PCM_16 and
written as WAV files under the run's temporary folder, at the fixed
lengths of the traffic file.  Each call takes every target once, in a new
seeded permutation, and gives the jobs the references, each ``batch /
references`` times, in a new seeded order, so every call masters the same
audio.  The call passes no dispatch and no bucket: what the port does
with ``process_batch``'s defaults is what is measured.  One seeded call
among the first ``compare_among_first`` writes its files; every other
call encodes each of its outputs in full into a path that discards the
bytes.

The check decodes every file of the compared call and holds its codes to
the plain reference: each job's float64 master of the same codes
(``reference/matchering.py``) and that master's previews
(``reference/preview.py``), encoded by the same rule.  The port's
preview window is read from its target preview, whose unfaded middle is
the clipped target's codes at that window, exactly.  Standard error
shows the smallest gap between a reference's best and second-best window
energies, and the largest distance of a master file's window energies
from the reference's, both relative to the best: exact windows are a
sound test while the gap stays well above the distance.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import harness, signals, wavfile
from ..reference import matchering as reference
from ..reference import preview as reference_preview
from .process import Track, _pool, fixed_lengths

OUTPUTS = ("master", "preview_target", "preview_result")


@dataclass
class State:
    config: object
    parameters: dict
    rate: int
    batch: int
    targets: List[Track]
    references: List[Track]
    rng: np.random.Generator
    compared: int
    discard: str
    order: list = field(default_factory=list)

    def pairing(self, index: int):
        """The (target, reference) of each job of call ``index``."""
        slots = np.arange(self.batch) % len(self.references)
        while len(self.order) <= index:
            self.order.append(([int(k) for k in self.rng.permutation(len(self.targets))],
                               [int(k) for k in self.rng.permutation(slots)]))
        targets, references = self.order[index]
        return [(self.targets[t], self.references[r]) for t, r in zip(targets, references)]


def _path(ctx, job: int, output: str) -> str:
    """Where the compared call's job ``job`` writes ``output``."""
    return os.path.join(ctx.workdir, f"job{job}_{output}.wav")


def prepare(ctx) -> State:
    traffic, parameters = ctx.cell.traffic, ctx.cell.config["parameters"]
    rate, batch = parameters["internal_sample_rate"], traffic["batch"]
    if traffic["targets"] != batch or batch % traffic["references"]:
        raise ValueError("a call takes every target once and each reference equally often")
    rng = np.random.default_rng(ctx.seed % (1 << 64))
    gen = signals.generator(ctx.seed, ctx.device)
    targets = _pool(ctx, "target", fixed_lengths(traffic["target_seconds"], traffic["targets"], rate), rng, gen)
    references = _pool(
        ctx, "reference", fixed_lengths(traffic["reference_seconds"], traffic["references"], rate), rng, gen
    )
    discard = os.path.join(ctx.workdir, "discard.wav")
    os.symlink(os.devnull, discard)
    return State(
        config=harness.port_config(ctx.mt, parameters),
        parameters=parameters,
        rate=rate,
        batch=batch,
        targets=targets,
        references=references,
        rng=rng,
        compared=int(rng.integers(traffic["compare_among_first"])),
        discard=discard,
    )


def _dispatch(ctx, state: State, index: int, write: bool) -> None:
    mt = ctx.mt
    jobs = []
    for job, (target, ref) in enumerate(state.pairing(index)):
        master, preview_target, preview_result = (
            _path(ctx, job, output) if write else state.discard for output in OUTPUTS
        )
        jobs.append(mt.PairJob(target.path, ref.path, [mt.pcm16(master)],
                               preview_target=mt.pcm16(preview_target), preview_result=mt.pcm16(preview_result)))
    mt.process_batch(jobs, state.config, device=ctx.device)


def warm(ctx, state: State) -> None:
    """The first two calls' dispatches, discarded: every target and
    reference in its call's role (each job's cut, export and window
    search) and the buckets' shapes (cuFFT plans, the allocator's blocks,
    page-locked buffers)."""
    for index in (0, 1):
        _dispatch(ctx, state, index, write=False)


def call(ctx, state: State, index: int) -> dict:
    _dispatch(ctx, state, index, write=index == state.compared)
    n = sum(t.codes.shape[0] for t, _ in state.pairing(index))
    return {"audio_s": n / state.rate, "samples": n, "itemsize": 4}


def compared_indices(state: State) -> List[int]:
    return [state.compared]


def release(ctx, state: State) -> None:
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def _read(path: str, rate: int, shape) -> Optional[np.ndarray]:
    try:
        codes, file_rate = wavfile.read(path)
    except (OSError, ValueError):
        return None
    return codes if file_rate == rate and codes.shape == shape else None


def window_of(codes: np.ndarray, target: np.ndarray, parameters: dict) -> Optional[int]:
    """The window whose clipped target codes equal the unfaded middle of
    the target preview ``codes``; 0 where the piece is the whole track;
    None where no window does."""
    window, step, fade_size, coefficient = reference_preview.sizes(parameters)
    n = target.shape[0]
    if window >= n:
        return 0
    fade = min(fade_size, int(window // coefficient))
    limit = int(round(parameters["threshold"] * 32768))
    middle = codes[fade : window - fade]
    for b in range((n - window) // step + 1):
        start = b * step + fade
        if np.array_equal(np.clip(target[start : start + middle.shape[0]], -limit, limit), middle):
            return b
    return None


def compare(ctx, state: State, calls) -> List[dict]:
    """Every file of the compared call against the reference: the worst
    file's share of samples whose code differs, in %, the widest
    difference in codes, the jobs whose preview window is not the
    reference's, and the files missing or of the wrong shape."""
    limits, parameters = ctx.cell.limits, state.parameters
    window, step = reference_preview.sizes(parameters)[:2]
    worst_share, widest, windows, missing, gaps, drifts = 0.0, 0, 0, 0, [], []
    if state.compared >= len(calls):
        missing = len(OUTPUTS) * state.batch
    else:
        for job, (target, ref) in enumerate(state.pairing(state.compared)):
            master = reference.master(target.codes / 32768.0, ref.codes / 32768.0, parameters)
            target_piece, result_piece, index, gap = reference_preview.preview(
                target.codes / 32768.0, master, parameters)
            gaps.append(gap)
            expected = {"master": master, "preview_target": target_piece, "preview_result": result_piece}
            for output in OUTPUTS:
                want = reference.pcm16_codes(expected[output])
                got = _read(_path(ctx, job, output), state.rate, want.shape)
                if got is None:
                    missing += 1
                    continue
                steps = np.abs(got.astype(np.int32) - want)
                worst_share = max(worst_share, 100.0 * float(np.count_nonzero(steps)) / steps.size)
                widest = max(widest, int(steps.max()))
                if output == "preview_target":
                    windows += window_of(got, target.codes, parameters) != index
                if output == "master" and gap is not None:
                    # how far the file's window energies lie from the reference's, against the best one
                    want_energies = reference_preview.window_energies(master, window, step)
                    got_energies = reference_preview.window_energies(got / 32768.0, window, step)
                    drifts.append(float(np.max(np.abs(got_energies - want_energies)) / np.max(want_energies)))
        found = [g for g in gaps if g is not None]
        harness.say(f"preview windows: smallest top-two energy gap {min(found) if found else None!r}, "
                    f"largest energy drift of a master {max(drifts) if drifts else None!r}")
    return [
        {"name": "code_mismatch_pct", "value": worst_share, "limit": limits["code_mismatch_pct"]},
        {"name": "max_code_steps", "value": widest, "limit": limits["max_code_steps"]},
        {"name": "preview_window_mismatch", "value": windows, "limit": limits["preview_window_mismatch"]},
        {"name": "missing_files", "value": missing, "limit": limits["missing_files"]},
    ]
