"""Overriding the processing configuration on the PyTorch port.

Usage: python examples/torch_edited_config.py [target] [reference] [out_prefix] [--device NAME]
(the PyTorch twin of examples/edited_config.py; it runs on the card unless
``--device`` names another device)

``Config`` carries every tunable; construct one with only the fields you
want to change.  This run masters at 96 kHz, admits half-hour tracks, backs
the brickwall threshold off to -3 dB, and computes in float32 (the port's
default on the card).
"""

import sys
import tempfile

import matchering_tpu_torch as mg

argv = sys.argv[1:]
device = None  # the card
if len(argv) >= 2 and argv[-2] == "--device":
    device, argv = argv[-1], argv[:-2]
target, reference, prefix = (
    argv[:3] if len(argv) >= 3 else ("my_song.wav", "some_popular_song.wav", "my_song_master")
)

tweaked = mg.Config(
    max_length=30 * 60,  # seconds; default admits 15 minutes
    internal_sample_rate=96000,  # default 44100
    threshold=0.7079,  # linear amplitude ~= -3 dB; default -0.01 dB
    temp_folder=tempfile.gettempdir(),  # staging area for codec conversions
    preview_size=15,  # seconds of preview; default 30
    allow_equality=True,  # permit target == reference
    dtype="float32",  # on-device precision
)

mg.process(
    target=target,
    reference=reference,
    results=[
        mg.pcm16(f"{prefix}_16bit.wav"),
        mg.pcm24(f"{prefix}_24bit.wav"),
    ],
    config=tweaked,
    device=device,
)
