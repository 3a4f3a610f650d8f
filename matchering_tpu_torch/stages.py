"""The mastering core (PyTorch).

Counterpart of the static path of ``matchering_tpu.stages`` (reference
``matchering/stages.py:38-272`` and ``matchering/stage_helpers/``): level
matching via piecewise loudest-piece RMS, frequency matching via averaged
framed spectra and a LOWESS-smoothed linear-phase FIR, iterative RMS
correction, and the three output variants (limited / no-limiter /
no-limiter-normalized).

``master_graph`` runs eagerly on the device of its inputs; piece division
is host arithmetic on static lengths, and no statistic leaves the device
until ``main`` reads the report.  The bucketed (dynamic-length) path of the
JAX package is not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .config import Config
from .limiter import limit
from .log import Code, debug, debug_line, info
from .ops import basics, convolve, fir, smoothing, spectrum
from .utils import resolve_device, to_db, to_device


class MasterOutput(NamedTuple):
    """Rendered variants (None where not requested) plus a report of 0-dim
    diagnostics for host-side debug logging."""

    result: Optional[torch.Tensor]
    result_no_limiter: Optional[torch.Tensor]
    result_no_limiter_normalized: Optional[torch.Tensor]
    report: Dict[str, torch.Tensor]


class _Division(NamedTuple):
    """Piece geometry of one track (reference ``match_levels.py:47-59``):
    ``divisions = n // max_piece_size + 1``, ``piece_size = n // divisions``."""

    divisions: int
    piece_size: int

    @classmethod
    def static(cls, n: int, max_piece_size: int) -> "_Division":
        divisions = n // max_piece_size + 1
        return cls(divisions, n // divisions)


def _analyze_levels(mid: torch.Tensor, division: _Division):
    """Loudest-piece mask and match RMS of a mid channel (reference
    ``analyze_levels``, ``match_levels.py:134-161``)."""
    rmses = basics.piece_rms_flat(mid, division.piece_size, division.divisions)
    return basics.loudest_piece_stats(rmses)


def _fir_from_spectra(
    target_fft: torch.Tensor,
    reference_fft: torch.Tensor,
    config: Config,
    operators: Tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Matching-EQ FIR from averaged spectra (reference ``get_fir``,
    ``match_frequencies.py:78-99``): matching curve, log-grid smoothing,
    linear-phase FIR synthesis."""
    matching_fft = reference_fft / torch.clamp(target_fft, min=config.min_value)
    smoothed = smoothing.smooth_exponentially(matching_fft, operators)
    return fir.fir_from_magnitude(smoothed, config.fft_size)


def master_graph(
    target: torch.Tensor,
    reference: torch.Tensor,
    config: Config,
    operators: Tuple[torch.Tensor, torch.Tensor],
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
) -> MasterOutput:
    """The full mastering computation on the inputs' device.

    target/reference: (n, 2) stereo at ``config.internal_sample_rate``,
    float or raw int16/int32 PCM (converted on the device).
    ``operators``: the folded smoothing matrices on that device, in the
    working dtype (see :func:`master`)."""
    if config.length_bucketing:
        raise NotImplementedError("length_bucketing is not ported yet")
    dtype = config.torch_dtype
    target = basics.to_working_float(target, dtype)
    reference = basics.to_working_float(reference, dtype)
    report: Dict[str, torch.Tensor] = {}

    # --- Stage 1: match levels (stages.py:38-104) ---
    reference, final_amplitude_coefficient = basics.normalize(
        reference, config.threshold, config.min_value, normalize_clipped=False
    )
    report["final_amplitude_coefficient"] = final_amplitude_coefficient

    t_division = _Division.static(target.shape[0], config.max_piece_size)
    r_division = _Division.static(reference.shape[0], config.max_piece_size)

    target_mid, target_side = basics.lr_to_ms(target)
    reference_mid, reference_side = basics.lr_to_ms(reference)

    t_mask, t_match_rms = _analyze_levels(target_mid, t_division)
    r_mask, r_match_rms = _analyze_levels(reference_mid, r_division)
    report["target_match_rms"] = t_match_rms
    report["reference_match_rms"] = r_match_rms

    rms_coefficient = r_match_rms / torch.clamp(t_match_rms, min=config.min_value)
    report["rms_coefficient"] = rms_coefficient

    # --- Stage 2: match frequencies (stages.py:107-135) ---
    # spectra come from the unamplified target channels and are scaled by
    # the RMS coefficient (|FFT| is positively homogeneous)
    t_mid_fft, t_side_fft = spectrum.masked_average_spectrum_flat_pair(
        target_mid, target_side, t_mask,
        t_division.piece_size, t_division.divisions, config.fft_size,
    )
    r_mid_fft, r_side_fft = spectrum.masked_average_spectrum_flat_pair(
        reference_mid, reference_side, r_mask,
        r_division.piece_size, r_division.divisions, config.fft_size,
    )
    mid_fir = _fir_from_spectra(t_mid_fft * rms_coefficient, r_mid_fft, config, operators)
    side_fir = _fir_from_spectra(t_side_fft * rms_coefficient, r_side_fft, config, operators)

    convolved = convolve.fft_convolve_same_batch(
        torch.stack([target_mid * rms_coefficient, target_side * rms_coefficient]),
        torch.stack([mid_fir, side_fir]),
    )
    result_mid = convolved[0]
    result = basics.ms_to_lr(result_mid, convolved[1])

    # --- Stage 3: RMS correction (stages.py:138-170) ---
    # clip(c*x, 1) = c * clip(x, 1/c) and piece RMS is homogeneous, so each
    # step reads the unscaled mid channel with a scaled threshold and one
    # final scale touches the stereo track
    c_total = torch.ones((), dtype=dtype, device=result.device)
    for step in range(config.rms_correction_steps):
        clipped = basics.clip(result_mid, 1.0 / c_total)
        clipped_rmses = basics.piece_rms_flat(
            clipped, t_division.piece_size, t_division.divisions
        )
        _, clipped_match_rms = basics.loudest_piece_stats(clipped_rmses)
        coefficient = r_match_rms / torch.clamp(
            c_total * clipped_match_rms, min=config.min_value
        )
        report[f"rms_correction_{step + 1}"] = coefficient
        c_total = c_total * coefficient
    result = result * c_total

    # --- Stage 4: finalize (stages.py:173-207) ---
    result_no_limiter_normalized = None
    if need_no_limiter_normalized:
        result_no_limiter_normalized, normalized_coefficient = basics.normalize(
            result, config.threshold, config.min_value, normalize_clipped=True
        )
        report["normalized_coefficient"] = normalized_coefficient

    result_default = None
    if need_default:
        result_default = limit(result, config) * final_amplitude_coefficient

    return MasterOutput(
        result=result_default,
        result_no_limiter=result if need_no_limiter else None,
        result_no_limiter_normalized=result_no_limiter_normalized,
        report=report,
    )


def master(
    target,
    reference,
    config: Config,
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
    device=None,
) -> MasterOutput:
    """:func:`master_graph` on ``device`` (``cuda`` unless named; no CPU
    fallback), with the smoothing operators built on the host and moved
    there.  Inputs may be numpy arrays or tensors."""
    device = resolve_device(device)
    # the smoothing operators are float32 matmuls on the card: keep them
    # at full float32 precision (TF32 keeps about three decimal digits);
    # this is PyTorch's default, set here so the run does not depend on it
    torch.backends.cuda.matmul.allow_tf32 = False
    to_log, to_lin = smoothing.host_operators_for_config(config)
    operators = (
        torch.as_tensor(to_log, dtype=config.torch_dtype, device=device),
        torch.as_tensor(to_lin, dtype=config.torch_dtype, device=device),
    )
    return master_graph(
        to_device(target, device),
        to_device(reference, device),
        config,
        operators,
        need_default=need_default,
        need_no_limiter=need_no_limiter,
        need_no_limiter_normalized=need_no_limiter_normalized,
    )


def main(
    target,
    reference,
    config: Config,
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
    device=None,
):
    """Reference-compatible stage runner (``matchering/stages.py:210-272``):
    returns the (result, result_no_limiter, result_no_limiter_normalized)
    triple of tensors, emitting the stage codes in the reference's order."""
    debug_line()
    info(Code.INFO_MATCHING_LEVELS)
    info(Code.INFO_MATCHING_FREQS)
    info(Code.INFO_CORRECTING_LEVELS)
    start = time.perf_counter()
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
    report_host = {key: float(value) for key, value in out.report.items()}
    debug(f"Mastering graph (all four stages) took {time.perf_counter() - start:.3f} s")
    debug_line()
    info(Code.INFO_FINALIZING)
    for key, value in report_host.items():
        try:
            debug(f"{key}: {to_db(value)}")
        except (ValueError, OverflowError):
            debug(f"{key}: {value}")
    return out.result, out.result_no_limiter, out.result_no_limiter_normalized
