"""Native codecs: the C++ FLAC library (built on first use) and the
system Vorbis, MP3 and Opus libraries through ctypes."""
