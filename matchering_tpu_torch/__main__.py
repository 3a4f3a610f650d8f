"""Command-line interface: ``python -m matchering_tpu_torch target ref result``.

Counterpart of ``matchering_tpu.__main__``, with the same parser: positional
target / reference / result plus flags for bit depth, limiter bypass,
normalization, previews, length bucketing and time sharding.  It runs on
the card; ``--time_sharded`` cuts the track's time axis over every visible
CUDA device (``parallel.timeshard.master_sharded``).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m matchering_tpu_torch",
        description=(
            "Audio matching & mastering on PyTorch and CUDA: make TARGET sound "
            "like REFERENCE (RMS, frequency response, peak amplitude, stereo width)."
        ),
    )
    parser.add_argument("target", help="the track to master")
    parser.add_argument("reference", help="the reference track to match")
    parser.add_argument("result", help="output file (.wav, .aiff, .w64 or .caf)")
    parser.add_argument(
        "-b",
        "--bit",
        choices=["16", "24", "32f"],
        default="16",
        help="output bit depth (default: 16)",
    )
    parser.add_argument(
        "--no_limiter",
        action="store_true",
        help="disable the brickwall limiter (output may exceed 0 dB)",
    )
    parser.add_argument(
        "--dont_normalize",
        action="store_true",
        help="with --no_limiter: skip peak normalization of the result",
    )
    parser.add_argument(
        "--preview_target", help="write a loudest-section preview of the target"
    )
    parser.add_argument(
        "--preview_result", help="write a loudest-section preview of the result"
    )
    parser.add_argument(
        "--time_sharded",
        action="store_true",
        help="shard the track's time axis across all local devices",
    )
    parser.add_argument(
        "--length_bucketing",
        type=int,
        metavar="N",
        help="pad tracks to a multiple of N samples and analyze at the true length",
    )
    parser.add_argument("-q", "--quiet", action="store_true", help="silence output")
    parser.add_argument(
        "--debug", action="store_true", help="print debug diagnostics too"
    )
    return parser


def main(argv=None, *, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` if None) on ``device``
    (``cuda`` unless named).  With ``--time_sharded``, ``device`` may be
    a list: one time shard on each (default: every visible CUDA device)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.time_sharded and args.length_bucketing:
        parser.error(
            "--length_bucketing applies to the single-device graph; "
            "--time_sharded derives its shapes from the shard grid"
        )

    import matchering_tpu_torch as mt

    if not args.quiet:
        if args.debug:
            mt.log(print)
        else:
            mt.log(info_handler=print, warning_handler=print)

    subtype = {"16": "PCM_16", "24": "PCM_24", "32f": "FLOAT"}[args.bit]
    result = mt.Result(
        args.result,
        subtype,
        use_limiter=not args.no_limiter,
        normalize=not args.dont_normalize,
    )
    preview_target = mt.pcm16(args.preview_target) if args.preview_target else None
    preview_result = mt.pcm16(args.preview_result) if args.preview_result else None
    if args.time_sharded:
        devices = device if device is None or isinstance(device, (list, tuple)) else [device]
        _time_sharded(args, result, preview_target, preview_result, devices)
        return 0
    mt.process(
        target=args.target,
        reference=args.reference,
        results=[result],
        config=mt.Config(length_bucketing=args.length_bucketing),
        preview_target=preview_target,
        preview_result=preview_result,
        device=device,
    )
    return 0


def _time_sharded(args, result, preview_target, preview_result, devices) -> None:
    """``process()``'s host shell (loading, checks, the equality check,
    saving, previews) around ``master_sharded`` over a ``time`` mesh of
    ``devices`` (``matchering_tpu/__main__.py:90-137``): both tracks staged
    on the mesh's first device, as ``process()`` stages them."""
    import matchering_tpu_torch as mt
    from .core import _VARIANT_FIELDS, _assert_graph_ready, _export, _ingest, _variant_key
    from .parallel.mesh import single_axis_mesh
    from .parallel.timeshard import master_sharded
    from .utils import get_temp_folder

    mesh = single_axis_mesh("time", devices=devices)
    device = mesh.devices.flat[0]
    config = mt.Config()
    temp_folder = config.temp_folder or get_temp_folder([result])
    target_track = _ingest(args.target, "target", config, temp_folder, device)
    reference_track = _ingest(args.reference, "reference", config, temp_folder, device)
    if not config.allow_equality:
        mt.check_equality(target_track[0], reference_track[0])
    _assert_graph_ready((target_track, reference_track), config)

    key = _variant_key(result)
    out = master_sharded(
        target_track[0],
        reference_track[0],
        config,
        mesh=mesh,
        need_default=key == "limited",
        need_no_limiter=key == "raw",
        need_no_limiter_normalized=key == "normalized",
    )
    rendered = getattr(out, _VARIANT_FIELDS[key])
    _export([result], {key: rendered}, config)
    if preview_target or preview_result:
        mt.create_preview(target_track[0], rendered, config, preview_target, preview_result)


if __name__ == "__main__":
    sys.exit(main())
