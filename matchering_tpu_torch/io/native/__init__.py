"""Native codecs: the C++ WAV/FLAC library (built on first use) and the
system Vorbis, MP3 and Opus libraries through ctypes."""
