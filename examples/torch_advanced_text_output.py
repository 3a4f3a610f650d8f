"""Custom log handlers on the PyTorch port.

Usage: python examples/torch_advanced_text_output.py [target] [reference] [out_prefix] [--device NAME]
(the PyTorch twin of examples/advanced_text_output.py; it runs on the card
unless ``--device`` names another device)
"""

import sys
from datetime import datetime

import matchering_tpu_torch as mg

argv = sys.argv[1:]
device = None  # the card
if len(argv) >= 2 and argv[-2] == "--device":
    device, argv = argv[-1], argv[:-2]
target, reference, prefix = (
    argv[:3] if len(argv) >= 3 else ("my_song.wav", "some_popular_song.wav", "my_song_master")
)


# A basic text output function that also prints the current datetime
def my_print(text):
    print(f"{datetime.now()}: {text}")


# The information output will be marked with a prefix
def info(text):
    my_print(f"INFO: {text}")


# The warning output will be highlighted with exclamation marks
def warning(text):
    my_print(f"! {text} !")


# Debug output stays plain
def debug(text):
    my_print(text)


mg.log(
    info_handler=info,
    warning_handler=warning,
    debug_handler=debug,
    # Show the machine-readable four-digit codes next to the text
    # (LOG_CODES.md semantics, same numbering as the reference)
    show_codes=True,
)

mg.process(
    target=target,
    reference=reference,
    results=[mg.pcm16(f"{prefix}_16bit.wav")],
    device=device,
)
