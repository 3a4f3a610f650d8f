"""The mastering core (PyTorch).

Counterpart of ``matchering_tpu.stages`` (reference
``matchering/stages.py:38-272`` and ``matchering/stage_helpers/``): level
matching via piecewise loudest-piece RMS, frequency matching via averaged
framed spectra and a LOWESS-smoothed linear-phase FIR, iterative RMS
correction, and the three output variants (limited / no-limiter /
no-limiter-normalized).

``master_graph`` runs eagerly on the device of its inputs, over one pair or
a (B, n, 2) batch (the graph is batch-first; a single pair is one row).
Piece division is host arithmetic on static lengths or, on the dynamic path
(zero-padded tracks with their true lengths: the farm and
``Config(length_bucketing=N)``), per-row integer arithmetic done alike on
the host ints and on the staged device tensor.  No statistic leaves the
device until ``main`` reads the report, and the dynamic path makes no host
sync at all.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from . import trace
from .config import Config
from .limiter import _limit
from .log import Code, debug, debug_line, info
from .ops import basics, convolve, fir, smoothing, spectrum
from .state import operators_for_config
from .utils import (
    RowInts,
    host_int,
    make_odd,
    ms_to_samples,
    read_back,
    resolve_device,
    stage_host_arrays,
    to_db,
    to_device,
)


class MasterOutput(NamedTuple):
    """Rendered variants (None where not requested) plus a report of
    diagnostics for host-side debug logging: each a 0-dim tensor for one
    pair, a (B,) tensor for a batch."""

    result: Optional[torch.Tensor]
    result_no_limiter: Optional[torch.Tensor]
    result_no_limiter_normalized: Optional[torch.Tensor]
    report: Dict[str, torch.Tensor]

    def row(self, index) -> "MasterOutput":
        """Row ``index`` (an int or a slice) of a batch's output."""
        return MasterOutput(
            *(None if x is None else x[index] for x in self[:3]),
            report={key: value[index] for key, value in self.report.items()},
        )


_VARIANTS = ("result", "result_no_limiter", "result_no_limiter_normalized")


def piece_division(n: int, max_piece_size: int) -> Tuple[int, int]:
    """(divisions, piece_size) of a track of ``n`` samples, on the host
    (reference ``match_levels.py:47-59``): ``divisions = n //
    max_piece_size + 1``, ``piece_size = n // divisions``."""
    divisions = n // max_piece_size + 1
    return divisions, n // divisions


class _Division(NamedTuple):
    """Piece geometry of the tracks of a batch (reference
    ``match_levels.py:47-59``): ``divisions = n // max_piece_size + 1``,
    ``piece_size = n // divisions``.  Static: host ints shared by every
    row (the padded length is the analysis length).  Dynamic: one value
    per row from its true length, as ``RowInts`` (host ints for strided
    views, a device tensor for the graph), with ``div_max`` bounding the
    division count on the host."""

    divisions: Union[int, RowInts]
    piece_size: Union[int, RowInts]
    div_max: Optional[int]  # None: static geometry

    @classmethod
    def static(cls, n: int, max_piece_size: int) -> "_Division":
        return cls(*piece_division(n, max_piece_size), None)

    @classmethod
    def dynamic(cls, n: int, lengths: RowInts, max_piece_size: int) -> "_Division":
        """Each row's geometry from its length, by the same integer
        arithmetic on the host ints and on the device tensor (no copy)."""
        divisions_device = lengths.device // max_piece_size + 1
        divisions = RowInts(
            tuple(v // max_piece_size + 1 for v in lengths.host), divisions_device
        )
        piece_size = RowInts(
            tuple(v // d for v, d in zip(lengths.host, divisions.host)),
            lengths.device // divisions_device,
        )
        return cls(divisions, piece_size, n // max_piece_size + 1)


def _analyze_levels(mid: torch.Tensor, division: _Division):
    """Loudest-piece mask and match RMS of (B, n) mid channels (reference
    ``analyze_levels``, ``match_levels.py:134-161``)."""
    if division.div_max is None:
        rmses = basics.piece_rms_flat(mid, division.piece_size, division.divisions)
        return basics.loudest_piece_stats(rmses)
    rmses, valid = basics.piece_rms_dynamic(
        mid, division.piece_size.device, division.divisions.device, division.div_max
    )
    return basics.loudest_piece_stats_masked(rmses, valid, division.divisions.device)


def _masked_spectrum_pair(mid, side, mask, division: _Division, config: Config):
    """Both channels' masked average spectra, static or per-row geometry."""
    if division.div_max is None:
        return spectrum.masked_average_spectrum_flat_pair(
            mid, side, mask, division.piece_size, division.divisions, config.fft_size
        )
    fpp_max = config.max_piece_size // config.fft_size + 1
    return spectrum.masked_average_spectrum_dynamic_pair(
        mid, side, mask, division.piece_size, division.div_max, config.fft_size, fpp_max
    )


def _fir_from_spectra(
    target_fft: torch.Tensor,
    reference_fft: torch.Tensor,
    config: Config,
    operators: smoothing.Smoothing,
) -> torch.Tensor:
    """Matching-EQ FIRs (B, fft_size) from averaged spectra (reference
    ``get_fir``, ``match_frequencies.py:78-99``): matching curve, log-grid
    smoothing (the folded operators, or the plain ones around the device
    LOWESS), linear-phase FIR synthesis."""
    matching_fft = reference_fft / torch.clamp(target_fft, min=config.min_value)
    smoothed = smoothing.smooth_exponentially(
        matching_fft,
        config.internal_sample_rate,
        config.fft_size,
        config.lin_log_oversampling,
        *smoothing.lowess_parameters(config),
        operators=operators,
    )
    return fir.fir_from_magnitude(smoothed, config.fft_size)


@stage_host_arrays
def master_graph(
    target: torch.Tensor,
    reference: torch.Tensor,
    config: Config,
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
    interp_ops=None,
    target_length=None,
    reference_length=None,
) -> MasterOutput:
    """The full mastering computation on the inputs' device.

    target/reference: (n, 2) stereo, or (B, n, 2) and (B, m, 2) batches,
    at ``config.internal_sample_rate``, float or raw int16/int32 PCM
    (converted on the device).  ``interp_ops``: the smoothing state of
    ``config`` on that device.  None builds it there through the staged
    cache (``state.operators_for_config``: the two operators in the
    working dtype, and the LOWESS plan where it does not fold into them);
    a ``smoothing.Smoothing`` is used as it is; a (to_log, to_lin) pair,
    the port's ``smoothing.operator_arrays_for_config`` or the JAX
    package's, gets the staged LOWESS plan of ``config`` beside it where
    it is not folded (``smoothing.as_smoothing``): every form runs the
    LOWESS once.  With ``lowess_it > 0`` the robustness
    iterations run here too, still with no host sync (the median comes
    from a device sort).

    ``target_length`` / ``reference_length`` (each optional): the true
    lengths of zero-padded tracks, ``RowInts`` or ints, one per row, or
    for one pair an int, a numpy int or a 0-d array or tensor, as in the
    JAX package (``RowInts.per_row``: a 0-d tensor on a card is read back
    to the host once).  Every length-dependent quantity of that track
    (piece division, loudest-piece statistics, averaged spectra, and for
    the target the limiter's end) then follows its true length, so row r
    reproduces the master of the unpadded pair r, and output samples past
    ``target_length`` are 0.  Given as ``RowInts`` everything is already
    on the device: the graph makes no host sync on this path.

    Its five stages are the spans ``levels``, ``spectra``, ``convolve``,
    ``correction`` and ``finalize`` (``trace``), each timed on the device."""
    device = target.device
    with trace.span("levels", device=device):
        single = target.ndim == 2  # one pair is one row
        if single:
            target, reference = target[None], reference[None]
        if target_length is not None:
            target_length = RowInts.per_row(target_length, target.device)
        if reference_length is not None:
            reference_length = RowInts.per_row(reference_length, reference.device)
        dtype = config.torch_dtype
        if interp_ops is None:
            operators = operators_for_config(config, target.device)
        else:
            operators = smoothing.as_smoothing(
                interp_ops,
                config.log_grid_size,
                smoothing.lowess_parameters(config),
                dtype,
                target.device,
                rates=smoothing.grid_rates(config),
            )
        target = basics.to_working_float(target, dtype)
        reference = basics.to_working_float(reference, dtype)
        report: Dict[str, torch.Tensor] = {}

        # --- Stage 1: match levels (stages.py:38-104) ---
        reference, final_amplitude_coefficient = basics.normalize(
            reference, config.threshold, config.min_value, normalize_clipped=False
        )
        report["final_amplitude_coefficient"] = final_amplitude_coefficient

        t_division, r_division = (
            _Division.static(track.shape[1], config.max_piece_size)
            if length is None
            else _Division.dynamic(track.shape[1], length, config.max_piece_size)
            for track, length in ((target, target_length), (reference, reference_length))
        )
        n = target.shape[1]

        target_mid, target_side = basics.lr_to_ms(target)
        reference_mid, reference_side = basics.lr_to_ms(reference)

        t_mask, t_match_rms = _analyze_levels(target_mid, t_division)
        r_mask, r_match_rms = _analyze_levels(reference_mid, r_division)
        report["target_match_rms"] = t_match_rms
        report["reference_match_rms"] = r_match_rms

        rms_coefficient = r_match_rms / torch.clamp(t_match_rms, min=config.min_value)
        report["rms_coefficient"] = rms_coefficient

    # --- Stage 2: match frequencies (stages.py:107-135) ---
    with trace.span("spectra", device=device):
        # spectra come from the unamplified target channels and are scaled by
        # the RMS coefficient (|FFT| is positively homogeneous)
        t_mid_fft, t_side_fft = _masked_spectrum_pair(
            target_mid, target_side, t_mask, t_division, config
        )
        r_mid_fft, r_side_fft = _masked_spectrum_pair(
            reference_mid, reference_side, r_mask, r_division, config
        )
        coefficient = rms_coefficient[:, None]
        mid_fir = _fir_from_spectra(t_mid_fft * coefficient, r_mid_fft, config, operators)
        side_fir = _fir_from_spectra(t_side_fft * coefficient, r_side_fft, config, operators)

    with trace.span("convolve", device=device):
        # the 2B mid and side rows go through one convolution call
        rows = target.shape[0]
        convolved = convolve.fft_convolve_same_batch(
            torch.stack([target_mid * coefficient, target_side * coefficient], dim=1).reshape(2 * rows, n),
            torch.stack([mid_fir, side_fir], dim=1).reshape(2 * rows, -1),
        ).reshape(rows, 2, n)
        if target_length is not None:
            # the FIR tail bleeds past the true end of a padded track; the
            # reference's result stops there, so zero the overhang before any
            # peak-sensitive stage (normalize, limiter) sees it
            convolved = convolved * target_length.mask(n, convolved.dtype)[:, None, :]
        result_mid = convolved[:, 0]
        result = basics.ms_to_lr(result_mid, convolved[:, 1])

    # --- Stage 3: RMS correction (stages.py:138-170) ---
    # clip(c*x, 1) = c * clip(x, 1/c) and piece RMS is homogeneous, so each
    # step reads the unscaled mid channel with a scaled threshold and one
    # final scale touches the stereo track
    with trace.span("correction", device=device):
        c_total = torch.ones(rows, dtype=dtype, device=result.device)
        for step in range(config.rms_correction_steps):
            clipped = basics.clip(result_mid, 1.0 / c_total)
            _, clipped_match_rms = _analyze_levels(clipped, t_division)
            coefficient = r_match_rms / torch.clamp(
                c_total * clipped_match_rms, min=config.min_value
            )
            report[f"rms_correction_{step + 1}"] = coefficient
            c_total = c_total * coefficient
        result = result * c_total[:, None, None]

    # --- Stage 4: finalize (stages.py:173-207) ---
    with trace.span("finalize", device=device):
        result_no_limiter_normalized = None
        if need_no_limiter_normalized:
            result_no_limiter_normalized, normalized_coefficient = basics.normalize(
                result, config.threshold, config.min_value, normalize_clipped=True
            )
            report["normalized_coefficient"] = normalized_coefficient

        result_default = None
        if need_default:
            result_default = _limit(
                result, config, length=target_length, scale=final_amplitude_coefficient
            )

        out = MasterOutput(
            result=result_default,
            result_no_limiter=result if need_no_limiter else None,
            result_no_limiter_normalized=result_no_limiter_normalized,
            report=report,
        )
        return out.row(0) if single else out


def minimum_length(config: Config) -> int:
    """The shortest true length the dynamic path takes: the limiter's
    attack window (K1's reflection at the row's end) and the 7 samples
    of filtfilt's tail extension."""
    attack = ms_to_samples(config.limiter.attack, config.internal_sample_rate)
    return max(2 * make_odd(attack) - 1, 7)


def check_lengths(lengths, n: int, config: Config, role: str) -> Tuple[int, ...]:
    """Host ints -> a tuple, after checking each against the padded length
    ``n`` and :func:`minimum_length`; raises ValueError."""
    lengths = tuple(int(v) for v in lengths)
    shortest = minimum_length(config)
    for length in lengths:
        if not shortest <= length <= n:
            raise ValueError(
                f"{role} length {length} is outside [{shortest}, {n}] (the padded length)"
            )
    return lengths


def master(
    target,
    reference,
    config: Config,
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
    target_length=None,
    reference_length=None,
    *,
    device=None,
) -> MasterOutput:
    """:func:`master_graph` of one pair on ``device`` (``cuda`` unless
    named; no CPU fallback), with the smoothing state built on the host
    and moved there.  Inputs may be numpy arrays or tensors.

    ``target_length`` / ``reference_length`` (each optional; an int, a
    numpy int, or a 0-d array or tensor, which is read back once): the
    true lengths of zero-padded tracks, checked here against the padded
    lengths and :func:`minimum_length` before anything is staged.  The
    span ``master``, timed on the device: a call's root, or a child of
    ``graph`` under ``process()``."""
    device = resolve_device(device)
    with trace.span("master", device=device):
        lengths = []
        for length, track, role in (
            (target_length, target, "target"), (reference_length, reference, "reference")
        ):
            if length is not None:
                (length,) = check_lengths([host_int(length)], track.shape[0], config, role)
                length = RowInts.of([length], device)
            lengths.append(length)
        return master_graph(
            to_device(target, device),
            to_device(reference, device),
            config,
            need_default=need_default,
            need_no_limiter=need_no_limiter,
            need_no_limiter_normalized=need_no_limiter_normalized,
            target_length=lengths[0],
            reference_length=lengths[1],
        )


def main(
    target,
    reference,
    config: Config,
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
    *,
    device=None,
):
    """Reference-compatible stage runner (``matchering/stages.py:210-272``):
    returns the (result, result_no_limiter, result_no_limiter_normalized)
    triple of tensors, emitting the stage codes in the reference's order.

    With ``config.length_bucketing`` both tracks are zero-padded on the
    device up to a multiple of it, mastered at their true lengths (the
    dynamic path), and the results cut back to the target's length
    (``matchering_tpu/stages.py:446-480``).  The span ``graph``: the
    graph's enqueue and the report's read, which waits for the device."""
    with trace.span("graph"):
        debug_line()
        info(Code.INFO_MATCHING_LEVELS)
        info(Code.INFO_MATCHING_FREQS)
        info(Code.INFO_CORRECTING_LEVELS)
        start = time.perf_counter()
        device = resolve_device(device)
        bucket = config.length_bucketing
        if bucket:
            from .parallel.batch import bucket_pad

            t_batch, (t_len,) = bucket_pad([target], multiple=bucket, device=device)
            r_batch, (r_len,) = bucket_pad([reference], multiple=bucket, device=device)
            out = master(
                t_batch[0],
                r_batch[0],
                config,
                need_default=need_default,
                need_no_limiter=need_no_limiter,
                need_no_limiter_normalized=need_no_limiter_normalized,
                device=device,
                target_length=t_len,
                reference_length=r_len,
            )
            out = out._replace(
                **{key: getattr(out, key)[:t_len] for key in _VARIANTS if getattr(out, key) is not None}
            )
        else:
            out = master(
                target,
                reference,
                config,
                need_default=need_default,
                need_no_limiter=need_no_limiter,
                need_no_limiter_normalized=need_no_limiter_normalized,
                device=device,
            )
        # reading the report waits for the device to finish the chain
        report_host = {key: float(read_back(value)) for key, value in out.report.items()}
        debug(f"Mastering graph (all four stages) took {time.perf_counter() - start:.3f} s")
        debug_line()
        info(Code.INFO_FINALIZING)
        for key, value in report_host.items():
            try:
                debug(f"{key}: {to_db(value)}")
            except (ValueError, OverflowError):
                debug(f"{key}: {value}")
        return out.result, out.result_no_limiter, out.result_no_limiter_normalized
