"""Plain float64 matchering: the mastering chain in NumPy and SciPy.

Independent of the program under test: it imports nothing of it and takes
nothing it made.  It follows the published algorithm of sergree/matchering
2.0 (``stages.py``, ``stage_helpers/``, ``limiter/hyrax.py``, ``dsp.py``):

1. level matching: the reference peak-normalised below the threshold;
   each track's mid cut into ``n // (n // max_piece + 1)``-sample pieces,
   the pieces whose RMS reaches the RMS of all piece RMSes are the loudest,
   and the RMS of their RMSes is the track's match RMS; the target is
   scaled by reference / target match RMS;
2. frequency matching: per channel (mid, side) the mean magnitude
   spectrum of the loudest pieces' boxcar frames (``scipy.signal.stft``'s
   scaling, 1 / fft_size), the reference's over the target's (floored at
   ``min_value``), cubic-interpolated onto a log grid, LOWESS-smoothed,
   interpolated back; bin 0 set to 0 and bin 1 kept; the linear-phase FIR
   is the centred inverse rFFT under a Hann window; each channel convolved
   with it ("same" alignment);
3. RMS correction: ``rms_correction_steps`` times, the mid clipped to
   [-1, 1], its loudest-piece RMS taken with the target's pieces, and both
   the mid and the stereo result scaled to the reference's match RMS;
4. the Hyrax limiter on the result, then the reference's normalisation
   coefficient multiplied back.

Everything runs in float64.  Work that is local in time (elementwise
steps, per-piece sums, the convolution, the sliding maxima) runs on
threads over blocks of samples, each block with the neighbours its window
needs, so an hour-long track takes tens of seconds; the recurrences run
whole, in SciPy.  A PCM_16 file holds round-half-even(x * 2^15) clipped
to [-2^15, 2^15 - 1] (:func:`pcm16_codes`).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

import numpy as np
from scipy import interpolate, ndimage, signal

from .lowess import lowess

DEFAULTS = {
    "internal_sample_rate": 44100,
    "max_piece_size": 15.0,
    "threshold": (2**15 - 61) / 2**15,
    "min_value": 1e-6,
    "fft_size": 4096,
    "lin_log_oversampling": 4,
    "rms_correction_steps": 4,
    "lowess_frac": 0.0375,
    "lowess_it": 0,
    "lowess_delta": 0.001,
    "limiter": {
        "attack": 1.0,
        "hold": 1.0,
        "release": 3000.0,
        "attack_filter_coefficient": -2.0,
        "hold_filter_order": 1,
        "hold_filter_coefficient": 7.0,
        "release_filter_order": 1,
        "release_filter_coefficient": 800.0,
    },
}

BLOCK = 1 << 21  # samples per block of the threaded steps


def parameters(overrides: Dict) -> Dict:
    """The defaults with ``overrides`` (a configuration file's
    ``parameters``) laid over them; keys the chain does not read are kept
    and ignored."""
    merged = {**DEFAULTS, **overrides}
    merged["limiter"] = {**DEFAULTS["limiter"], **overrides.get("limiter", {})}
    if merged["lowess_it"] != 0:
        raise ValueError("the reference smooths with lowess_it = 0 only")
    return merged


def blocks(n: int, fn: Callable[[int, int], object]) -> list:
    """``fn(start, stop)`` over [0, n) in blocks, on threads (NumPy and
    SciPy release the interpreter lock in their loops)."""
    bounds = [(a, min(n, a + BLOCK)) for a in range(0, n, BLOCK)]
    with ThreadPoolExecutor(min(len(bounds), os.cpu_count() or 1)) as pool:
        return list(pool.map(lambda ab: fn(*ab), bounds))


def ms_to_samples(ms: float, rate: int) -> int:
    return int(rate * ms * 1e-3)


def make_odd(n: int) -> int:
    return n if n % 2 else n + 1


def lr_to_ms(track: np.ndarray):
    mid = np.empty(track.shape[0])
    side = np.empty(track.shape[0])

    def step(a, b):
        block = np.asarray(track[a:b], dtype=np.float64)
        np.multiply(block[:, 0] + block[:, 1], 0.5, out=mid[a:b])
        np.subtract(mid[a:b], block[:, 1], out=side[a:b])

    blocks(track.shape[0], step)
    return mid, side


def peak(track: np.ndarray) -> float:
    return max(blocks(track.shape[0], lambda a, b: float(np.max(np.abs(track[a:b])))))


def normalize(track: np.ndarray, threshold: float, epsilon: float, normalize_clipped: bool):
    top = peak(track)
    coefficient = 1.0
    if top < threshold or normalize_clipped:
        coefficient = max(epsilon, top / threshold)
    return track / coefficient, coefficient


def piece_geometry(n: int, max_piece: int):
    divisions = n // max_piece + 1
    return divisions, n // divisions


def piece_rms(channel: np.ndarray, geometry, clip_at=None) -> np.ndarray:
    divisions, size = geometry

    def one(i):
        piece = channel[i * size : (i + 1) * size]
        if clip_at is not None:
            piece = np.clip(piece, -clip_at, clip_at)
        return math.sqrt(float(np.dot(piece, piece)) / size)

    with ThreadPoolExecutor(min(divisions, os.cpu_count() or 1)) as pool:
        return np.array(list(pool.map(one, range(divisions))))


def loudest(rmses: np.ndarray):
    """(mask of the loudest pieces, their match RMS) from piece RMSes."""
    mask = rmses >= np.sqrt(np.mean(np.square(rmses)))
    return mask, float(np.sqrt(np.mean(np.square(rmses[mask]))))


def average_spectrum(channel: np.ndarray, geometry, mask: np.ndarray, fft_size: int) -> np.ndarray:
    """Mean |STFT| over the loudest pieces' boxcar frames (no overlap, no
    padding), scaled by 1 / fft_size as ``scipy.signal.stft`` does."""
    size = geometry[1]
    frames = size // fft_size

    def one(i):
        piece = channel[i * size : i * size + frames * fft_size]
        return np.abs(np.fft.rfft(piece.reshape(frames, fft_size), axis=1)).sum(axis=0)

    selected = np.flatnonzero(mask)
    with ThreadPoolExecutor(min(len(selected), os.cpu_count() or 1)) as pool:
        total = np.sum(list(pool.map(one, selected)), axis=0)
    return total / (fft_size * frames * len(selected))


def smooth(matching: np.ndarray, p: Dict) -> np.ndarray:
    sr, fft_size = p["internal_sample_rate"], p["fft_size"]
    linear = sr * 0.5 * np.linspace(0.0, 1.0, fft_size // 2 + 1)
    logarithmic = sr * 0.5 * np.logspace(
        np.log10(4 / fft_size), 0.0, (fft_size // 2) * p["lin_log_oversampling"] + 1
    )
    on_log = interpolate.interp1d(linear, matching, "cubic")(logarithmic)
    smoothed = lowess(on_log, np.linspace(0.0, 1.0, len(on_log)), p["lowess_frac"], p["lowess_delta"])
    back = interpolate.interp1d(logarithmic, smoothed, "cubic", fill_value="extrapolate")(linear)
    back[0] = 0.0
    back[1] = matching[1]
    return back


def fir(target_spectrum: np.ndarray, reference_spectrum: np.ndarray, p: Dict) -> np.ndarray:
    matching = reference_spectrum / np.maximum(p["min_value"], target_spectrum)
    taps = np.fft.irfft(smooth(matching, p))
    return np.fft.ifftshift(taps) * signal.windows.hann(len(taps))


def convolve_same(channel: np.ndarray, taps: np.ndarray, gain: float) -> np.ndarray:
    """``scipy.signal.fftconvolve(gain * channel, taps, "same")``, block by
    block: output i reads inputs i - L/2 .. i + L/2 - 1 for L taps."""
    n, length = channel.shape[0], taps.shape[0]
    before = (length - 1) // 2 + (length + 1) % 2  # inputs before i
    after = length - 1 - before
    out = np.empty(n)

    def step(a, b):
        lo, hi = max(0, a - before), min(n, b + after)
        segment = np.zeros(b - a + length - 1)
        segment[lo - (a - before) : hi - (a - before)] = channel[lo:hi] * gain
        out[a:b] = signal.oaconvolve(segment, taps, mode="valid")

    blocks(n, step)
    return out


def _windowed_max(x: np.ndarray, size: int, before: int, pad_zeros: bool) -> np.ndarray:
    """``maximum_filter1d`` block by block: a window of ``size`` samples
    that reaches ``before`` samples back; the ends reflect as in SciPy,
    or, with ``pad_zeros``, the head sees zeros (the hold stage's pad)."""
    n = x.shape[0]
    after = size - 1 - before
    out = np.empty(n)

    def step(a, b):
        lo, hi = max(0, a - before), min(n, b + after)
        segment = x[lo:hi]
        if pad_zeros and lo == 0 and a - before < 0:
            segment = np.concatenate([np.zeros(before - a), segment])
            lo = a - before
        origin = before - size // 2  # SciPy's window is centred at size // 2
        full = ndimage.maximum_filter1d(segment, size=size, origin=origin)
        out[a:b] = full[a - lo : b - lo]

    blocks(n, step)
    return out


def limit(track: np.ndarray, p: Dict) -> np.ndarray:
    """The Hyrax brick-wall limiter (``limiter/hyrax.py``): hard-clip gain
    from the cross-channel peak; a centred sliding max of 2 * odd(attack)
    - 1 samples smoothed forward and back by a one-pole filter; a causal
    hold max of ``hold`` samples through the hold and release Butterworth
    low-passes; the gain is 1 minus the largest of the three."""
    sr, lim, threshold = p["internal_sample_rate"], p["limiter"], p["threshold"]
    n = track.shape[0]
    gain_hard_clip = np.empty(n)

    def rectify(a, b):
        peak_ab = np.max(np.abs(track[a:b]), axis=1)
        np.maximum(peak_ab, threshold, out=peak_ab)
        peak_ab /= threshold
        np.divide(1.0, peak_ab, out=gain_hard_clip[a:b])
        np.subtract(1.0, gain_hard_clip[a:b], out=gain_hard_clip[a:b])
        return bool(np.all(np.isclose(peak_ab, 1.0)))

    if all(blocks(n, rectify)):
        return track
    attack = ms_to_samples(lim["attack"], sr)
    window = 2 * make_odd(attack) - 1
    slided = _windowed_max(gain_hard_clip, window, window // 2, pad_zeros=False)
    c = math.exp(lim["attack_filter_coefficient"] / attack)
    gain = signal.filtfilt([1.0 - c], [1.0, -c], slided)
    blocks(n, lambda a, b: np.maximum(gain[a:b], gain_hard_clip[a:b], out=gain[a:b]))
    del gain_hard_clip

    hold = ms_to_samples(lim["hold"], sr)
    held = _windowed_max(slided, hold, hold - 1, pad_zeros=True)
    del slided
    b, a = signal.butter(lim["hold_filter_order"], lim["hold_filter_coefficient"], fs=sr)
    hold_out = signal.lfilter(b, a, held)
    b, a = signal.butter(
        lim["release_filter_order"], lim["release_filter_coefficient"] / lim["release"], fs=sr
    )
    blocks(n, lambda lo, hi: np.maximum(held[lo:hi], hold_out[lo:hi], out=held[lo:hi]))
    release_out = signal.lfilter(b, a, held)
    del held
    out = np.empty_like(track)

    def finish(lo, hi):
        g = np.maximum(np.maximum(gain[lo:hi], hold_out[lo:hi]), release_out[lo:hi])
        np.multiply(track[lo:hi], (1.0 - g)[:, None], out=out[lo:hi])

    blocks(n, finish)
    return out


def master(target: np.ndarray, reference: np.ndarray, overrides: Dict) -> np.ndarray:
    """The limited master of the (n, 2) ``target`` against the (m, 2)
    ``reference``, both at the internal sample rate, in float64."""
    p = parameters(overrides)
    sr, fft_size, floor = p["internal_sample_rate"], p["fft_size"], p["min_value"]
    max_piece = int(p["max_piece_size"] * sr)
    reference, final_coefficient = normalize(
        np.asarray(reference, dtype=np.float64), p["threshold"], floor, False
    )
    t_geometry = piece_geometry(target.shape[0], max_piece)
    r_geometry = piece_geometry(reference.shape[0], max_piece)
    t_mid, t_side = lr_to_ms(target)
    r_mid, r_side = lr_to_ms(reference)
    del reference
    t_mask, t_rms = loudest(piece_rms(t_mid, t_geometry))
    r_mask, r_rms = loudest(piece_rms(r_mid, r_geometry))
    gain = r_rms / max(floor, t_rms)

    channels = []
    for t_channel, r_channel in ((t_mid, r_mid), (t_side, r_side)):
        taps = fir(
            gain * average_spectrum(t_channel, t_geometry, t_mask, fft_size),
            average_spectrum(r_channel, r_geometry, r_mask, fft_size),
            p,
        )
        channels.append(convolve_same(t_channel, taps, gain))
    del t_mid, t_side, r_mid, r_side
    mid, side = channels
    del channels

    scale = 1.0  # the RMS correction's product: the mid is read scaled
    for _ in range(p["rms_correction_steps"]):
        # clip(scale * mid, 1) = scale * clip(mid, 1 / scale)
        clipped_rms = scale * loudest(piece_rms(mid, t_geometry, clip_at=1.0 / scale))[1]
        scale *= r_rms / max(floor, clipped_rms)
    result = np.empty((mid.shape[0], 2))

    def to_lr(a, b):
        result[a:b, 0] = (mid[a:b] + side[a:b]) * scale
        result[a:b, 1] = (mid[a:b] - side[a:b]) * scale

    blocks(mid.shape[0], to_lr)
    del mid, side
    limited = limit(result, p)
    del result
    blocks(limited.shape[0], lambda a, b: np.multiply(limited[a:b], final_coefficient, out=limited[a:b]))
    return limited


def pcm16_codes(track: np.ndarray) -> np.ndarray:
    """The int16 codes a PCM_16 file holds for float samples."""
    out = np.empty(track.shape, np.int16)

    def step(a, b):
        out[a:b] = np.clip(np.rint(np.asarray(track[a:b], dtype=np.float64) * 32768.0), -32768, 32767)

    blocks(track.shape[0], step)
    return out
