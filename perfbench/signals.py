"""Music-like stereo tracks made on the device from a seed.

A track is a 1/f^tilt noise bed (white noise shaped in the frequency
domain, its two channels partly correlated), chords of harmonic tones that
change every ``segment_s`` seconds, and a slow envelope, scaled to a fixed
RMS and, for a mastered reference, saturated (tanh) to a loud, dense
signal.  Every draw comes from one ``torch.Generator`` on the device, so a
seed gives the same track there every time; the work a track costs
depends only on its length, since its level is fixed.

Parameters (a traffic file's ``target`` / ``reference`` objects):
``rms_db`` (RMS after mixing, dBFS), ``tilt`` (bed power ~ 1/f^tilt),
``bed_db`` and ``tones_db`` (mix levels), ``width`` (share of the bed in
the side channel), ``voices``, ``harmonics``, ``segment_s``,
``envelope_s`` (period of the slow envelope) and ``drive`` (0: none).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

CHUNK = 1 << 24  # samples per pass of the tone and envelope synthesis


def _fft_length(n: int) -> int:
    """The least multiple of 4096 at or above ``n`` whose factors are all
    2, 3, 5 or 7 (a fast cuFFT size)."""
    m = -(-n // 4096) * 4096
    while True:
        r = m
        for p in (2, 3, 5, 7):
            while r % p == 0:
                r //= p
        if r == 1:
            return m
        m += 4096


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    return gen


def _bed(n: int, rate: int, tilt: float, width: float, gen, device) -> torch.Tensor:
    """(n, 2) float32 1/f^tilt noise, unit RMS per channel before mixing."""
    m = _fft_length(n)
    freqs = torch.arange(m // 2 + 1, device=device, dtype=torch.float32) * (rate / m)
    shape = torch.clamp(freqs, min=20.0) ** (-0.5 * tilt)
    shape[0] = 0.0
    shape /= torch.sqrt(torch.mean(shape * shape))
    channels = []
    for _ in range(2):  # one channel at a time bounds the FFT's memory
        spectrum = torch.fft.rfft(torch.randn(m, generator=gen, device=device))
        spectrum *= shape
        channels.append(torch.fft.irfft(spectrum, n=m)[:n].clone())
        del spectrum
    common, difference = channels
    return torch.stack([common + width * difference, common - width * difference], dim=1)


def track(n: int, rate: int, params: Dict, gen, device) -> torch.Tensor:
    """One (n, 2) float32 track of ``n`` samples at ``rate`` Hz."""
    out = _bed(n, rate, params["tilt"], params["width"], gen, device)
    out *= 10 ** (params["bed_db"] / 20)
    voices, harmonics = params["voices"], params["harmonics"]
    segment = int(params["segment_s"] * rate)
    segments = -(-n // segment)
    # per segment and voice: fundamental 55-880 Hz, level, phase, pan
    fundamental = 55.0 * 2.0 ** (4.0 * torch.rand(segments, voices, generator=gen, device=device))
    level = 0.5 + 0.5 * torch.rand(segments, voices, generator=gen, device=device)
    phase = 2 * math.pi * torch.rand(segments, voices, generator=gen, device=device)
    pan = 0.5 * math.pi * torch.rand(segments, voices, generator=gen, device=device)
    pan_gains = torch.stack([torch.cos(pan), torch.sin(pan)], dim=-1)  # (S, V, 2)
    tone_gain = 10 ** (params["tones_db"] / 20) / math.sqrt(voices)
    period = int(params["envelope_s"] * rate)
    envelope_phase = math.pi * float(torch.rand((), generator=gen, device=device))
    for start in range(0, n, CHUNK):
        index = torch.arange(start, min(n, start + CHUNK), device=device)
        seg = index // segment
        local = (index - seg * segment).to(torch.float32) / rate
        tones = torch.zeros(index.shape[0], 2, device=device)
        for v in range(voices):
            f0 = fundamental[seg, v]
            voice = torch.zeros_like(local)
            for h in range(1, harmonics + 1):
                voice += torch.sin(2 * math.pi * h * f0 * local + h * phase[seg, v]) / h
            tones += (voice * level[seg, v])[:, None] * pan_gains[seg, v]
        out[start : start + index.shape[0]] += tone_gain * tones
        envelope = (index % period).to(torch.float32) * (math.pi / period) + envelope_phase
        out[start : start + index.shape[0]] *= (0.55 + 0.45 * torch.sin(envelope) ** 2)[:, None]
    out *= 10 ** (params["rms_db"] / 20) / torch.sqrt(torch.mean(out * out))
    drive = params.get("drive", 0.0)
    if drive:
        out = torch.tanh(drive * out) / math.tanh(drive)
    peak = torch.amax(torch.abs(out))
    out *= torch.clamp(0.98 / peak, max=1.0)  # full scale is never reached
    return out


def pcm16(track_: torch.Tensor) -> torch.Tensor:
    """int16 codes of a float track: round half to even of x * 2^15,
    clipped to [-2^15, 2^15 - 1]."""
    return torch.clamp(torch.round(track_ * 32768.0), -32768, 32767).to(torch.int16)
