"""Host-side audio I/O for the port: the numpy WAV/RF64 codec, loader and
saver.  Other containers (AIFF, CAF, W64, FLAC, lossy codecs via ffmpeg)
are not ported yet: loading one raises a coded ``ModuleError``."""

from . import pcm, wav
from .loader import load
from .saver import save

__all__ = ["pcm", "wav", "load", "save"]
