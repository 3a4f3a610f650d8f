"""Seconds of target audio mastered by the calls completed in the window,
over the window's wall seconds (host clock): all the work over all the
time, the wait of a failed call included."""


def read(run):
    start, end = run.window
    if end <= start:
        return None
    return sum(c.audio_s for c in run.calls if c.ok) / (end - start)
