"""Host-side audio I/O for the port: the numpy WAV/RF64, AIFF, W64 and CAF
codecs, the codec registry, loader and saver.  FLAC, the lossy codecs and
the ffmpeg fallback are not ported: loading such a file raises a coded
``ModuleError``."""

from . import codecs, pcm, wav
from .loader import load
from .saver import save

__all__ = ["codecs", "pcm", "wav", "load", "save"]
