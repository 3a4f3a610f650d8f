"""Single-pair mastering entry point (PyTorch port).

Counterpart of ``matchering_tpu.core.process`` (reference
``matchering/core.py:32-121``): decode and condition both tracks, run
``stages.main`` on the device, encode the requested output variants and,
if asked, the previews.  The coded event stream and the validation rules
are the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import trace
from .checker import check, check_equality
from .config import Config
from .io import save
from .io.saver import writes_codes
from .io.loader import load_staged
from .log import Code, ModuleError, debug, debug_line, info
from .preview import create_preview
from .results import Result
from .stages import main as stages_main
from .utils import get_temp_folder, resolve_device, to_host


def _ingest(path: str, role: str, config: Config, temp_folder: str, device):
    """Decode one file and condition it: the track crosses to ``device``
    once (``check``), and the equality check, the graph and the previews
    read it there.  Integer-PCM WAV keeps its raw int16/int32 payload
    (``raw_int=True``): that is what crosses, and the device converts it
    (``ops.basics.to_working_float``), resampling it there if its rate is
    not the internal one.  A 16- or 32-bit payload is read straight into
    the staging block it crosses from (``load_staged``)."""
    audio, rate = load_staged(path, role, temp_folder, device=device)
    return check(audio, rate, config, role, device=device)


def _assert_graph_ready(tracks, config: Config) -> None:
    """Post-conditioning invariants the graph relies on (reference
    ``core.py:69-74``); a violation is a bug, hence the generic code."""
    for audio, rate in tracks:
        ready = (
            rate == config.internal_sample_rate
            and audio.ndim == 2
            and audio.shape[1] == 2
            and audio.shape[0] > config.fft_size
        )
        if not ready:
            raise ModuleError(Code.ERROR_VALIDATION)


# each variant's field of ``stages.MasterOutput``
_VARIANT_FIELDS = {
    "limited": "result",
    "raw": "result_no_limiter",
    "normalized": "result_no_limiter_normalized",
}


def _variant_key(result: Result) -> str:
    if result.use_limiter:
        return "limited"
    return "normalized" if result.normalize else "raw"


def render_variants(target_audio, reference_audio, config: Config, keys, *, device=None) -> dict:
    """Run the mastering graph on ``device`` (``cuda`` unless named),
    rendering exactly the variants in ``keys`` ("limited", "raw",
    "normalized"): a dict of variant key -> (n, 2) tensor, the keys not
    asked for absent."""
    keys = set(keys)
    limited, raw, normalized = stages_main(
        target_audio,
        reference_audio,
        config,
        need_default="limited" in keys,
        need_no_limiter="raw" in keys,
        need_no_limiter_normalized="normalized" in keys,
        device=resolve_device(device),
    )
    rendered = {"limited": limited, "raw": raw, "normalized": normalized}
    return {k: v for k, v in rendered.items() if v is not None}


def _export(results: List[Result], variants: Dict[str, torch.Tensor], config: Config) -> None:
    """Write each result from its variant (``render_variants``' dict).  A
    WAV result of a subtype the card quantises (``saver.writes_codes``)
    gets its variant as a tensor: ``save`` quantises it on its device and
    its codes cross to the host, once per result.  Any other result's
    variant crosses once, at its working dtype (``to_host``), and the
    writers widen the samples to float64 where they quantise.  Either way
    the bytes are those of a float64 export."""
    host = {}
    for result in results:
        key = _variant_key(result)
        if variants.get(key) is None:  # unreachable: the graph renders every key asked for
            raise ModuleError(Code.ERROR_VALIDATION)
        samples = variants[key]
        if not writes_codes(result.file, samples, result.subtype):
            if key not in host:
                host[key] = to_host(samples)
            samples = host[key]
        save(result.file, samples, config.internal_sample_rate, result.subtype)


def process(
    target: str,
    reference: str,
    results: List[Result],
    config: Config = Config(),
    preview_target: Optional[Result] = None,
    preview_result: Optional[Result] = None,
    *,
    device=None,
) -> None:
    """Master ``target`` against ``reference`` and write each of
    ``results``, and the loudest-section previews if asked.  Runs on
    ``device`` (``cuda`` unless named; raises if there is no card rather
    than falling back to the CPU).  The call's root span ``process``
    (``trace``)."""
    with trace.span("process"):
        debug("matchering_tpu_torch — audio matching & mastering on PyTorch")
        debug_line()
        device = resolve_device(device)
        info(Code.INFO_LOADING)

        if isinstance(results, Result):
            results = [results]
        if not results:
            raise RuntimeError("The result list is empty")

        temp_folder = config.temp_folder or get_temp_folder(results)

        target_track = _ingest(target, "target", config, temp_folder, device)
        reference_track = _ingest(reference, "reference", config, temp_folder, device)

        if not config.allow_equality:
            check_equality(target_track[0], reference_track[0])
        _assert_graph_ready((target_track, reference_track), config)

        wanted = {_variant_key(r) for r in results}
        variants = render_variants(target_track[0], reference_track[0], config, wanted, device=device)

        debug_line()
        info(Code.INFO_EXPORTING)
        _export(results, variants, config)

        if preview_target or preview_result:
            # any rendered variant serves as the preview source, preferring the
            # limited one (reference ``core.py:112-118``)
            source = next(variants[k] for k in ("limited", "raw", "normalized") if k in variants)
            create_preview(target_track[0], source, config, preview_target, preview_result)

        debug_line()
        info(Code.INFO_COMPLETED)
