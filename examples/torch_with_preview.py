"""Mastering run on the PyTorch port that also renders before/after
preview snippets.

Usage: python examples/torch_with_preview.py [target] [reference] [out_prefix] [--device NAME]
(the PyTorch twin of examples/with_preview.py; it runs on the card unless
``--device`` names another device)

The two preview files hold the loudest ``preview_size`` seconds of the
input and of the master — a quick A/B without opening the full tracks.
"""

import sys

import matchering_tpu_torch as mg

argv = sys.argv[1:]
device = None  # the card
if len(argv) >= 2 and argv[-2] == "--device":
    device, argv = argv[-1], argv[:-2]
target, reference, prefix = (
    argv[:3] if len(argv) >= 3 else ("my_song.wav", "some_popular_song.wav", "my_song_master")
)

# only surface warnings; progress/debug stay silent
mg.log(warning_handler=print)

mg.process(
    target=target,
    reference=reference,
    results=[
        mg.pcm16(f"{prefix}_16bit.wav"),
        mg.pcm24(f"{prefix}_24bit.wav"),
    ],
    preview_target=mg.pcm16(f"{prefix}_preview_before.flac"),
    preview_result=mg.pcm16(f"{prefix}_preview_after.flac"),
    device=device,
)
