"""Command-line interface: ``python -m matchering_tpu_torch target ref result``.

Counterpart of ``matchering_tpu.__main__``, with the same parser: positional
target / reference / result plus flags for bit depth, limiter bypass,
normalization, previews and length bucketing.  It runs on the card;
``--time_sharded`` is parsed but not ported yet, and ends in a parser
error.
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
        help="shard the track's time axis across all local devices (not ported yet)",
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


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` if None) on ``device``
    (``cuda`` unless named)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.time_sharded:
        parser.error("--time_sharded is not ported to matchering_tpu_torch yet")

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


if __name__ == "__main__":
    sys.exit(main())
