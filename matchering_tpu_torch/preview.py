"""Preview rendering (reference ``matchering/preview_creator.py:30-94``).

Counterpart of ``matchering_tpu.preview``: finds the loudest
``preview_size`` window of the mastered result on a
``preview_analysis_step`` grid and cuts matching target/result snippets
with linear fades, on the result's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import trace
from .config import Config
from .io import save
from .log import Code, debug, debug_line, info
from .ops import basics
from .results import Result
from .utils import read_back, time_str, to_device


def _window_count(n: int, window: int, step: int) -> int:
    return 1 if window > n else (n - window) // step + 1


def _loudest_window_index(result: torch.Tensor, window: int, step: int) -> int:
    """argmax over strided windows of the result's energy (reference
    ``preview_creator.py:47-54``, where windows are ``as_strided`` views).

    The window energies are assembled from per-step segment sums: window b
    is steps b .. b+window//step-1 plus a width-(window%step) partial.  They
    are sums over millions of samples, and in float32 another summation
    order can move the argmax to a neighbouring window, so they are taken
    in float64 whatever the result's dtype."""
    n = result.shape[0]
    count = _window_count(n, window, step)
    if count == 1:
        return 0
    energy = torch.sum(torch.square(result.to(torch.float64)), dim=1)
    nseg = n // step
    seg = torch.sum(energy[: nseg * step].reshape(nseg, step), dim=1)
    k, r = divmod(window, step)
    # sum of k consecutive segments starting at b, for b in [0, count)
    cums = torch.cat([energy.new_zeros(1), torch.cumsum(seg, dim=0)])
    sums = cums[k : k + count] - cums[:count]
    if r:
        # remainder of window b: energy[(b+k)*step : (b+k)*step + r)
        tail = energy[k * step : k * step + count * step]
        tail = torch.nn.functional.pad(tail, (0, count * step - tail.shape[0]))
        sums = sums + torch.sum(tail.reshape(count, step)[:, :r], dim=1)
    return int(read_back(torch.argmax(sums)))


def _cut_pieces(
    target,
    result: torch.Tensor,
    index: int,
    window: int,
    step: int,
    fade_size: int,
    threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The target's and the result's piece at window ``index``, the target
    clipped to ``threshold``; both faded unless the piece is the whole
    track.  ``target`` may be staged integer PCM, on the host or not: only
    its piece crosses to the result's device, which converts it there."""
    n = result.shape[0]
    if window <= n:
        start = index * step
        target = target[start : start + window]
        result = result[start : start + window]
    target = basics.to_working_float(to_device(target, result.device), result.dtype)
    target = basics.clip(target, threshold)
    if window < n and fade_size > 0:
        target = basics.fade(target, fade_size)
        result = basics.fade(result, fade_size)
    return target, result


def create_preview(
    target,
    result: torch.Tensor,
    config: Config,
    preview_target: Optional[Result],
    preview_result: Optional[Result],
) -> None:
    """Write the loudest ``config.preview_size`` stretch of the ``result``
    tensor, and the same stretch of ``target``, to the preview outputs.
    The span ``preview``."""
    with trace.span("preview"):
        debug_line()
        info(Code.INFO_MAKING_PREVIEWS)

        window = config.preview_size
        step = config.preview_analysis_step
        debug(
            f"The maximum duration of the preview is "
            f"{window / config.internal_sample_rate} seconds, "
            f"with the analysis step of {step / config.internal_sample_rate} seconds"
        )

        index = _loudest_window_index(result, window, step)

        n = result.shape[0]
        piece_len = min(window, n)
        fade_size = (
            min(config.preview_fade_size, int(piece_len // config.preview_fade_coefficient))
            if piece_len != n
            else 0
        )
        target_piece, result_piece = _cut_pieces(
            target, result, index, window, step, fade_size, config.threshold
        )

        begin = step * index if piece_len != n else 0
        debug(
            f"The best part to preview: "
            f"{time_str(begin, config.internal_sample_rate)} "
            f"- {time_str(begin + piece_len, config.internal_sample_rate)}"
        )

        for piece, output, name in (
            (target_piece, preview_target, "target preview"),
            (result_piece, preview_result, "result preview"),
        ):
            if output:
                save(
                    output.file,
                    piece,
                    config.internal_sample_rate,
                    output.subtype,
                    name,
                )
