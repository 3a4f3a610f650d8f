"""Host-side audio I/O for the port: the native FLAC codec (``native``),
the numpy WAV/RF64, AIFF, W64 and CAF codecs, the system
Vorbis, MP3 and Opus libraries, the codec registry, the loader (with its
ffmpeg fallback) and the saver."""

from . import codecs, pcm, wav
from .loader import load
from .saver import save

__all__ = ["codecs", "pcm", "wav", "load", "save"]
