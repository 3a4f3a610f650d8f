"""Hyrax brickwall limiter (PyTorch + kernels K1 to K4).

Counterpart of ``matchering_tpu.limiter.limit`` (reference
``matchering/limiter/hyrax.py:32-99``): hard-clip gain from the
cross-channel peak, attack stage (centred sliding max + zero-phase
one-pole smoothing), hold/release stage (causal sliding max + Butterworth
low-passes of ``hold_filter_order`` and ``release_filter_order``), final
gain = 1 - max of the three envelopes.

Batch-first: one (n, 2) track or a (B, n, 2) batch, whose rows may end at
their own true lengths (the JAX package's ``length`` branch; a track with
its length runs as a batch of one row).  On every
device the front end (gain and attack sliding max) is
``kernels.envelope.limiter_front_end``: K1 on CUDA, its plain twin on the
CPU.  The IIR passes go through ``ops.iir``: the attack's filtfilt is two
K2 launches, and a Butterworth low-pass of order h is one K2 launch at
order 1, else one K3 launch per scipy section, ``ceil(h / 2)`` in all.
The back end (the envelopes' mix, the length mask, the early-out and the
gain's product with the track) is ``kernels.back_end.limiter_back_end``:
K4 on CUDA, its plain twin on the CPU.  With the default orders 1/1 that is
one K1, four K2 and one K4 launch per call, whatever the batch size.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import Config
from .kernels import back_end, envelope
from .ops import iir, sliding
from .utils import RowInts, ms_to_samples, stage_host_arrays


def _release_stage(slided_attack: torch.Tensor, config: Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal hold max + hold/release Butterworth low-passes
    (reference ``hyrax.py:56-75``): the hold and release envelopes, whose
    maximum is the release-stage gain (taken in K4)."""
    fs = config.internal_sample_rate
    hold = ms_to_samples(config.limiter.hold, fs)
    slided = sliding.sliding_max_hold(slided_attack, hold)
    hold_out = iir.butter_lowpass(
        config.limiter.hold_filter_order,
        config.limiter.hold_filter_coefficient,
        fs,
        slided,
    )
    release_out = iir.butter_lowpass(
        config.limiter.release_filter_order,
        config.limiter.release_filter_coefficient / config.limiter.release,
        fs,
        torch.maximum(slided, hold_out),
    )
    return hold_out, release_out


@stage_host_arrays
def limit(array: torch.Tensor, config: Config, length=None) -> torch.Tensor:
    """Brickwall-limit a stereo (n, 2) tensor, or each row of a (B, n, 2)
    batch, at ``config.threshold`` on the tensor's own device.

    ``length``: the track's true length, the JAX package's form (an int, a
    numpy int, or a 0-d array or tensor, on an (n, 2) track), or each
    row's, the port's (``RowInts`` or a sequence of ints, on a batch).
    The envelope at and past it is "no overage", the attack stage reflects
    at it, and the output there is 0 (``matchering_tpu/limiter.py:93-143``):
    row r on [0, L_r) equals ``limit(array[r, :L_r])``.  A track with a
    length runs as a batch of one row (``RowInts.per_row``: a 0-d tensor
    on a card is read back to the host once, since K1 and K2 check lengths
    on the host).  Every length must lie in [attack window, n] (K1's
    reflection at the end): a shorter one raises ValueError.  The JAX
    package's own length form is off below 4 * make_odd(attack) - 2
    samples (its recomputed tail reads a clamped window); this one follows
    ``limit(array[:L])`` at every length it takes.

    The reference's early-out (``hyrax.py:83-85``: nothing exceeds the
    threshold within ``np.isclose`` tolerance, so the input passes through)
    is per row and stays branch-free, a ``torch.where`` on the device with
    no host sync.  It reads K1's gain: |rectified - 1| <= tol  <=>
    gain <= tol/(1+tol), since rectified >= 1 and gain = 1 - 1/rectified
    is monotone."""
    return _limit(array, config, length)


def _limit(array: torch.Tensor, config: Config, length=None, scale=None) -> torch.Tensor:
    """``limit``, each row of the output then times its ``scale`` (one
    factor a row, in the array's dtype; None: no product) in the same K4
    launch: ``stages.master_graph``'s final amplitude coefficient."""
    single = length is not None and array.ndim == 2
    if single:
        array = array[None]
    if length is not None:
        length = RowInts.per_row(length, array.device)
    array = array.contiguous()
    tolerance = 1e-8 + 1e-5 * 1.0  # np.isclose defaults (hyrax.py:83)
    attack = ms_to_samples(config.limiter.attack, config.internal_sample_rate)
    gain_hard_clip, slided = envelope.limiter_front_end(array, config.threshold, attack, length)
    smoother = iir.one_pole_filter(config.limiter.attack_filter_coefficient, attack)
    gain_attack = iir.filtfilt_first_order(smoother, slided, length)
    hold_out, release_out = _release_stage(slided, config)
    not_needed = torch.all(gain_hard_clip <= tolerance / (1.0 + tolerance), dim=-1)
    limited = back_end.limiter_back_end(
        array, gain_hard_clip, gain_attack, hold_out, release_out, not_needed, length, scale
    )
    return limited[0] if single else limited
