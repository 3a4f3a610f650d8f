"""Every output-variant knob on one run of the PyTorch port.

Usage: python examples/torch_advanced_results.py [target] [reference] [out_prefix] [--device NAME]
(the PyTorch twin of examples/advanced_results.py; it runs on the card
unless ``--device`` names another device)

A ``Result`` descriptor picks the container/subtype from the file name and
chooses between three rendered variants:

* ``use_limiter=True``            -> the finished master (default)
* ``use_limiter=False``           -> EQ+level match only, peak-normalized
* ``use_limiter=False, normalize=False`` -> match only, raw level — may sit
  above 0 dB, so store it in a float subtype and feed it to your own
  limiter chain
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

mg.log(info_handler=print, warning_handler=print)

outputs = [
    mg.pcm16(f"{prefix}_16bit.wav"),  # shortcut for Result(..., "PCM_16")
    mg.Result(f"{prefix}_no_limiter.flac", subtype="PCM_24", use_limiter=False),
    mg.Result(
        f"{prefix}_no_limiter_raw_level.aiff",
        subtype="FLOAT",
        use_limiter=False,
        normalize=False,
    ),
    mg.pcm32f(f"{prefix}_float32.wav"),  # float32 WAV shortcut
]

mg.process(target=target, reference=reference, results=outputs, device=device)
