"""Smallest possible run on the PyTorch port: master one track against one
reference.

Usage: python examples/torch_basic.py [target] [reference] [out_prefix] [--device NAME]
(the PyTorch twin of examples/basic.py; it runs on the card unless
``--device`` names another device, e.g. ``--device cpu``)
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

# route the coded progress stream to stdout; omit for a silent run
mg.log(print)

# one call: decode, analyze, match, limit, encode
mg.process(
    target=target,
    reference=reference,
    results=[
        mg.pcm16(f"{prefix}_16bit.wav"),
        mg.pcm24(f"{prefix}_24bit.wav"),
    ],
    device=device,
)
