"""Time sharding: the mastering chain over a track cut into blocks (PyTorch).

Counterpart of ``matchering_tpu/parallel/timeshard.py``.  There one track's
time axis is sharded over a mesh axis under ``shard_map``; here one
controller drives a list of devices.  A :class:`TimeGrid` cuts a track into
D equal blocks, shard i on ``devices[i]``; a device may appear more than
once, and the shards that share a device are the rows of one tensor, so
each stage launches once per device, not once per shard.  A sharded value
is a list with one tensor per device: (R, block) or (R, block, C), the
device's R shards in order.  The collectives become tensor work: the
JAX package's ``ppermute`` halos are copies of the neighbours' edge samples
to the shard's device, ``all_gather`` a concatenation there, ``psum`` and
``pmax`` a sum and a max over it.  Nothing is read back to the host.

* **overlap-save convolution** — each block takes ``taps - 1`` halo
  samples from its neighbours (zeros at the track's edges, as
  ``fftconvolve`` pads) and keeps the valid part of a local convolution;
* **sliding maxima** — the attack's centred max is K1 (the limiter's front
  end) on each block's stereo samples with ``window // 2`` halo samples on
  either side, mirrored at the track's edges (``ndimage``'s 'reflect'); the
  hold's causal max takes a left halo;
* **first-order IIR stages** on K2, carried across blocks: each block is
  filtered from zero state (in float64, for its exact end state), the D
  affine summaries ``z_out = pole**len * z_in + z_end`` are composed on the
  device, and each block is filtered again with its carry as K2's ``zi``
  (``carried_scan`` is that carry for a bare drive and pole); filtfilt's
  6-sample odd extensions are computed at the edge blocks as in the
  single-device ``ops.iir.filtfilt_first_order``;
* **global statistics** — piece RMS from per-block piece sums, averaged
  spectra from the frames that start in each block (one ``fft_size`` right
  halo), and peaks, each combined over the blocks.

Launches per call (the default filter orders), for each device holding
shards: ``limit_sharded`` (and so ``master_sharded`` with the limited
variant) one K1 and eight K2 launches: the attack's filtfilt four (each
direction a summary pass and a carried pass), the hold and release
low-passes two each.  ``master_farm`` makes that per pair.

Padding follows the JAX package: both tracks are zero-padded to a multiple
of the shard count, the limiter of ``master_sharded`` sees the padded
track, and ``master_farm`` with true lengths limits each pair at its exact
length.  Butterworth hold/release orders other than 1 raise
``NotImplementedError``, as in the JAX package
(``matchering_tpu/parallel/timeshard.py:656-660``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..kernels import envelope
from ..ops import basics, convolve, iir, sliding
from ..stages import MasterOutput, _fir_from_spectra, check_lengths, piece_division
from ..state import operators_for_config
from ..utils import RowInts, host_int, make_odd, ms_to_samples, resolve_device, to_device
from .mesh import Mesh, make_mesh, single_axis_mesh

Sharded = List[torch.Tensor]  # one (R, block, ...) tensor per device


class TimeGrid:
    """D time shards over ``devices`` (shard i on ``devices[i]``; repeats
    allowed).  ``devices`` lists each distinct device once, ``members``
    its shard indices, ``index`` the same as an int64 tensor there."""

    def __init__(self, devices: Sequence):
        shards = [resolve_device(d) for d in devices]
        if not shards:
            raise ValueError("a time grid needs at least one device")
        groups: Dict[torch.device, List[int]] = {}
        for i, device in enumerate(shards):
            groups.setdefault(device, []).append(i)
        self.count = len(shards)
        self.devices = list(groups)
        self.members = [tuple(m) for m in groups.values()]
        self.index = [torch.tensor(m, device=d) for d, m in zip(self.devices, self.members)]
        # (device position, row) of each shard, in shard order
        self._where = [(g, m.index(i)) for i in range(self.count) for g, m in enumerate(self.members) if i in m]
        self._natural = [i for m in self.members for i in m] == list(range(self.count))

    # -- staging --------------------------------------------------------

    def split(self, track, block: int) -> Sharded:
        """A (n, ...) host array or tensor, zero-padded to ``count * block``
        samples, as one (R, block, ...) tensor per device (a view of the
        track where it lies there whole)."""
        n = track.shape[0]
        parts = []
        for device, members in zip(self.devices, self.members):
            if list(members) == list(range(members[0], members[-1] + 1)):
                spans = [(members[0] * block, (members[-1] + 1) * block)]
            else:
                spans = [(i * block, (i + 1) * block) for i in members]
            chunks = []
            for start, stop in spans:
                chunk = to_device(track[start:min(stop, n)], device)
                if stop > n:
                    tail = chunk.new_zeros((stop - max(start, n),) + tuple(chunk.shape[1:]))
                    chunk = torch.cat([chunk, tail])
                chunks.append(chunk.reshape((-1, block) + tuple(chunk.shape[1:])))
            parts.append(chunks[0] if len(chunks) == 1 else torch.cat(chunks))
        return parts

    def _in_order(self, values: Sharded) -> torch.Tensor:
        """Every device's rows, already moved to one device, as one tensor
        in shard order."""
        if self._natural:
            return values[0] if len(values) == 1 else torch.cat(values)
        return torch.cat([values[g][r : r + 1] for g, r in self._where])

    def join(self, parts: Sharded, n: int, device) -> torch.Tensor:
        """The first ``n`` samples of the whole track on ``device``."""
        whole = self._in_order([p.to(device) for p in parts])
        return whole.reshape((-1,) + tuple(whole.shape[2:]))[:n]

    # -- collectives ----------------------------------------------------

    def gather(self, values: Sharded) -> List[torch.Tensor]:
        """Per-shard values, (R, ...) on each device, as one (D, ...)
        tensor in shard order on every device (``all_gather``)."""
        return [self._in_order([v.to(d) for v in values]) for d in self.devices]

    def psum(self, values: Sharded) -> List[torch.Tensor]:
        return [v.sum(0) for v in self.gather(values)]

    def pmax(self, values: Sharded) -> List[torch.Tensor]:
        return [v.amax(0) for v in self.gather(values)]

    def bcast(self, values: Sharded, source: int) -> List[torch.Tensor]:
        """Shard ``source``'s value on every device."""
        return [v[source] for v in self.gather(values)]

    def halo_left(self, parts: Sharded, width: int) -> Sharded:
        """The last ``width`` samples of each shard's left neighbour (zeros
        for shard 0), as (R, width, ...) per device."""
        edges = self.gather([p[:, p.shape[1] - width:] for p in parts])
        return [
            torch.cat([torch.zeros_like(e[:1]), e[:-1]])[index]
            for e, index in zip(edges, self.index)
        ]

    def halo_right(self, parts: Sharded, width: int) -> Sharded:
        """The first ``width`` samples of each shard's right neighbour
        (zeros for the last shard)."""
        edges = self.gather([p[:, :width] for p in parts])
        return [
            torch.cat([e[1:], torch.zeros_like(e[:1])])[index]
            for e, index in zip(edges, self.index)
        ]

    def in_track(self, g: int, block: int, length: int) -> torch.Tensor:
        """(R, block) bool: which samples of device g's shards lie before
        global sample ``length``."""
        local = torch.arange(block, device=self.devices[g])
        return local[None, :] < (length - self.index[g] * block)[:, None]

    def last_rows(self, g: int, full: int, last: int) -> RowInts:
        """Per-row lengths of device g's shards for a kernel's length mode:
        ``full`` for every row, ``last`` for the track's last shard.  Built
        on the device, with no host-to-device copy."""
        members = self.members[g]
        host = tuple(last if i == self.count - 1 else full for i in members)
        lengths = torch.full((len(members),), full, dtype=torch.int64, device=self.devices[g])
        if members[-1] == self.count - 1:
            lengths[-1] = last
        return RowInts(host, lengths)


def _per_device(value, grid: TimeGrid) -> List[torch.Tensor]:
    """One tensor, or one per device, as one on each device."""
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value.to(d) for d in grid.devices]


# ---------------------------------------------------------------------------
# Overlap-save convolution


def convolve_same_sharded(parts: Sharded, h, grid: TimeGrid) -> Sharded:
    """Sharded ``fftconvolve(x, h, "same")`` of (R, block) shards with one
    (taps,) FIR ``h``, or of (R, block, C) shards with C FIRs (C, taps),
    one convolution call per device (reference
    ``match_frequencies.py:112-113``)."""
    firs = _per_device(h, grid)
    taps = firs[0].shape[-1]
    start = (taps - 1) // 2
    left = taps - 1 - start
    out = []
    for x, h, head, tail in zip(parts, firs, grid.halo_left(parts, left), grid.halo_right(parts, start)):
        z = torch.cat([head, x, tail], dim=1)
        z = z[..., None] if x.ndim == 2 else z  # (R, block + taps - 1, C)
        rows, width, channels = z.shape
        same = convolve.fft_convolve_same_batch(
            z.permute(0, 2, 1).reshape(rows * channels, width),
            h.reshape(1, channels, taps).expand(rows, channels, taps).reshape(-1, taps),
        ).reshape(rows, channels, width)
        out.append(same[:, :, left:left + x.shape[1]].permute(0, 2, 1).reshape(x.shape))
    return out


# ---------------------------------------------------------------------------
# Carried first-order scans on K2


def _carried(
    filt: iir.FirstOrderFilter,
    parts: Sharded,
    grid: TimeGrid,
    reverse: bool = False,
    init: Optional[List[torch.Tensor]] = None,
    last: Optional[int] = None,
) -> Tuple[Sharded, List[torch.Tensor]]:
    """``lfilter`` of the whole track (its shards in chain order: left to
    right, or right to left with ``reverse``), from the DF2T state
    ``init`` (float64, per device; zero if None) entering the chain's
    first sample.  ``last`` (``reverse`` only): where the track ends inside
    its last shard; the chain starts there (K2's length mode), and that
    shard is 0 past it.

    Two K2 launches per device: each shard from zero state, in float64,
    whose end state ``b1*x[end] - a1*y[end]`` gives the shard's affine map
    ``z -> pole**len * z + z_end``; the maps are composed in chain order
    on every device; then each shard again, its carry entering as ``zi``.
    Returns the output shards and, per device, the state leaving the
    chain's last shard (float64)."""
    block = parts[0].shape[1]
    span = block if last is None else last
    lengths = [None if last is None else grid.last_rows(g, block, last) for g in range(len(parts))]
    edge = 0 if reverse else -1
    ends = []
    for x, rows in zip(parts, lengths):
        x64 = x.to(torch.float64).contiguous()
        y0 = iir.lfilter_first_order(filt, x64, reverse=reverse, lengths=rows)
        ends.append(filt.b1 * x64[:, edge] - filt.a1 * y0[:, edge])
    summaries = grid.gather(ends)
    decay, decay_last = filt.pole**block, filt.pole**span
    order = range(grid.count - 1, -1, -1) if reverse else range(grid.count)
    out, leaving = [], []
    for g, (x, z_end, rows) in enumerate(zip(parts, summaries, lengths)):
        carry = torch.zeros((), dtype=torch.float64, device=x.device) if init is None else init[g]
        carries = [None] * grid.count
        for d in order:
            carries[d] = carry
            carry = (decay_last if d == grid.count - 1 else decay) * carry + z_end[d]
        zi = torch.stack(carries)[grid.index[g]]
        out.append(iir.lfilter_first_order(filt, x.contiguous(), zi=zi, reverse=reverse, lengths=rows))
        leaving.append(carry)
    return out, leaving


def carried_scan(parts: Sharded, pole, grid: TimeGrid, init=None, reverse: bool = False) -> Sharded:
    """The solve of ``y[i] = drive[i] + pole * y[i-1]`` over the whole
    sharded drive ``parts``, left to right, or right to left with
    ``reverse`` (``y[i] = drive[i] + pole * y[i+1]``): the sharded
    ``ops.iir.scan_first_order``.  ``init``: None (zero state), or the
    affine map ``(a0, u0)`` applied before the chain's first block, as in
    the JAX package; the global entry state is zero, so only ``u0``, the
    value of ``y`` before the chain's first sample, matters.  ``pole`` is
    a host float or a 0-d tensor read back once (``ops.iir.scan_first_order``).

    The drive is ``lfilter([1, 0], [1, -pole])``'s input, so this is
    :func:`_carried` of that filter, whose DF2T state is ``pole * y``: two
    K2 launches per device, as for the sharded filters, which go through
    the same carry (their drives ``b0*x[i] + b1*x[i-1]`` are formed by K2
    itself, in float64, across the shards' edges)."""
    pole = iir._host_pole(pole)
    states = None
    if init is not None:
        u0 = init[1]
        states = [pole * torch.as_tensor(u0, dtype=torch.float64).to(d) for d in grid.devices]
    return _carried(iir.FirstOrderFilter(1.0, 0.0, -pole), parts, grid, reverse=reverse, init=states)[0]


def lfilter_first_order_sharded(filt: iir.FirstOrderFilter, parts: Sharded, grid: TimeGrid) -> Sharded:
    """Sharded ``scipy.signal.lfilter([b0, b1], [1, a1], x)`` with zero
    state: two K2 launches per device."""
    return _carried(filt, parts, grid)[0]


_PADLEN = 6  # scipy.signal.filtfilt's default odd extension, first order


def _steps(filt: iir.FirstOrderFilter, state, samples):
    """DF2T steps over a few float64 samples: the outputs and the state."""
    outputs = []
    for sample in samples:
        y = filt.b0 * sample + state
        state = filt.b1 * sample - filt.a1 * y
        outputs.append(y)
    return outputs, state


def _head_states(filt: iir.FirstOrderFilter, parts: Sharded, grid: TimeGrid) -> List[torch.Tensor]:
    """The forward state after the head extension ``2*x[0] - x[6..1]``,
    from scipy's ``zi * ext[0]``, on every device (the extension and the
    scaled state rounded to the working dtype as in
    ``ops.iir.filtfilt_first_order``)."""
    heads = grid.bcast([x[:, : _PADLEN + 1] for x in parts], 0)
    states = []
    for head in heads:
        ext = 2.0 * head[:1] - torch.flip(head[1:], (0,))
        _, state = _steps(filt, (filt.zi() * ext[0]).to(torch.float64), ext.to(torch.float64))
        states.append(state)
    return states


def filtfilt_first_order_sharded(filt: iir.FirstOrderFilter, parts: Sharded, grid: TimeGrid) -> Sharded:
    """Sharded ``scipy.signal.filtfilt(b, a, x)`` with scipy's defaults
    (odd extension of 6 samples, ``lfilter_zi`` scaling), as
    ``ops.iir.filtfilt_first_order`` computes it: four K2 launches per
    device.  The extensions live at the edge shards: the head's state
    enters the forward chain, the forward pass continues through the tail
    extension from the chain's exact end state, and the backward pass
    starts there, each extension rounded to the working dtype where the
    single-device filter rounds it."""
    y1, leaving = _carried(filt, parts, grid, init=_head_states(filt, parts, grid))
    tails = grid.bcast([x[:, x.shape[1] - _PADLEN - 1:] for x in parts], grid.count - 1)
    init = []
    for tail, state in zip(tails, leaving):
        ext = 2.0 * tail[-1:] - torch.flip(tail[:-1], (0,))  # x[-1] - (x[-2] .. x[-7])
        outputs, _ = _steps(filt, state, ext.to(torch.float64))
        y_ext = torch.stack(outputs).to(tail.dtype)
        backward = (filt.zi() * y_ext[-1]).to(torch.float64)
        _, backward = _steps(filt, backward, torch.flip(y_ext, (0,)).to(torch.float64))
        init.append(backward)
    return _carried(filt, y1, grid, reverse=True, init=init)[0]


def filtfilt_first_order_sharded_truncated(
    filt: iir.FirstOrderFilter, parts: Sharded, length, grid: TimeGrid
) -> Sharded:
    """``scipy.signal.filtfilt(b, a, x[:length])`` where ``length`` ends
    inside the last shard, 0 past it: the sharded form of
    ``ops.iir._filtfilt_rows``.  The forward chain is causal; the tail
    extension reads ``x[length-7 .. length-1]`` and the forward output at
    ``length - 1``, and the backward chain starts at ``length - 1`` (K2's
    length mode on the last shard).  Four K2 launches per device.
    ``length``: an int, a numpy int or a 0-d array or tensor, as in the
    JAX package (a tensor on a card is read back once, ``utils.host_int``)."""
    length = host_int(length)
    block = parts[0].shape[1]
    last = length - (grid.count - 1) * block
    y1, _ = _carried(filt, parts, grid, init=_head_states(filt, parts, grid))
    xs = grid.bcast([x[:, last - _PADLEN - 1:last] for x in parts], grid.count - 1)
    y_last = grid.bcast([y[:, last - 1] for y in y1], grid.count - 1)
    init = []
    for x_end, y_end in zip(xs, y_last):
        x_end, y_end = x_end.to(torch.float64), y_end.to(torch.float64)
        state = filt.b1 * x_end[-1] - filt.a1 * y_end
        outputs, _ = _steps(filt, state, 2.0 * x_end[-1] - torch.flip(x_end[:-1], (0,)))
        _, backward = _steps(filt, filt.zi() * outputs[-1], outputs[::-1])
        init.append(backward)
    return _carried(filt, y1, grid, reverse=True, init=init, last=last)[0]


# ---------------------------------------------------------------------------
# Sliding maxima


def _reflected(parts: Sharded, half: int, grid: TimeGrid) -> Sharded:
    """Each shard (R, block, ...) extended by ``half`` samples of its
    neighbours on either side, mirrored at the track's edges (ndimage's
    'reflect', which repeats the edge sample)."""
    block = parts[0].shape[1]
    out = []
    for g, (x, left, right) in enumerate(zip(parts, grid.halo_left(parts, half), grid.halo_right(parts, half))):
        index = grid.index[g].reshape((-1,) + (1,) * (x.ndim - 1))
        left = torch.where(index == 0, torch.flip(x[:, :half], (1,)), left)
        right = torch.where(index == grid.count - 1, torch.flip(x[:, block - half:], (1,)), right)
        out.append(torch.cat([left, x, right], dim=1))
    return out


def sliding_max_attack_sharded(parts: Sharded, window_size: int, grid: TimeGrid) -> Sharded:
    """Sharded centred sliding max of the attack stage (reference
    ``hyrax.py:35-37``, ``ops.sliding.sliding_max_attack``) over (R, block)
    shards: odd window ``2*make_odd(window_size) - 1``, 'reflect' at the
    track's edges.  The limiter runs this max inside K1
    (:func:`limiter_front_end_sharded`); this is the max alone, in torch
    ops."""
    size = 2 * make_odd(window_size) - 1
    return [sliding._start_max(rows, size) for rows in _reflected(parts, size // 2, grid)]


def limiter_front_end_sharded(
    parts: Sharded, threshold: float, attack: int, grid: TimeGrid, length: Optional[int] = None
) -> Tuple[Sharded, Sharded]:
    """Stereo shards (R, block, 2) -> (hard-clip gain, attack-slided gain),
    each (R, block): one K1 launch per device over its shards, each
    extended by ``window // 2`` samples of its neighbours and mirrored at
    the track's edges (K1's own 'reflect').  With ``length`` (ending in the
    last shard) the last shard reflects there, K1's length mode, and both
    outputs are 0 past it."""
    half = envelope.window_for(attack) // 2
    block = parts[0].shape[1]
    gains, slided = [], []
    for g, rows in enumerate(_reflected(parts, half, grid)):
        lengths = None
        if length is not None:
            last = length - (grid.count - 1) * block
            lengths = grid.last_rows(g, rows.shape[1], half + last)
        gain, slide = envelope.limiter_front_end(rows, threshold, attack, lengths)
        gains.append(gain[:, half:half + block])
        slided.append(slide[:, half:half + block])
    return gains, slided


def sliding_max_hold_sharded(parts: Sharded, window_size: int, grid: TimeGrid) -> Sharded:
    """Sharded causal sliding max of the hold stage (reference
    ``hyrax.py:38-40``): a left halo of ``window_size - 1`` samples, whose
    zeros before the track are the track's own."""
    width = (window_size - 1) // 2 + window_size // 2
    return [
        sliding._start_max(torch.cat([halo, x], dim=1), window_size)
        for x, halo in zip(parts, grid.halo_left(parts, width))
    ]


# ---------------------------------------------------------------------------
# Global statistics


def global_peak(parts: Sharded, grid: TimeGrid) -> List[torch.Tensor]:
    """max |x| over the whole track, on every device."""
    return grid.pmax([torch.abs(x).reshape(x.shape[0], -1).amax(1) for x in parts])


def _piece_sums(x: torch.Tensor, members, piece_size: int, divisions: int) -> torch.Tensor:
    """(R, divisions) sums of each shard's samples per global piece
    (pieces ``[k * piece_size, (k + 1) * piece_size)``, ``k < divisions``;
    samples past the last piece count nowhere): the whole pieces inside a
    shard in one reduction, the two cut by its edges one each."""
    block = x.shape[1]
    end_of_pieces = piece_size * divisions
    rows = []
    for r, shard in enumerate(members):
        lo, hi = shard * block, min((shard + 1) * block, end_of_pieces)
        if lo >= hi:
            rows.append(x.new_zeros(divisions))
            continue
        first = -(-lo // piece_size)  # the first whole piece
        whole = max(0, min(hi // piece_size, divisions) - first)
        sums = []
        if lo < first * piece_size:  # the piece cut by the shard's left edge
            sums.append(x[r, : min(first * piece_size, hi) - lo].sum()[None])
        if whole:
            start = first * piece_size - lo
            sums.append(x[r, start:start + whole * piece_size].reshape(whole, piece_size).sum(-1))
        cut = (first + whole) * piece_size
        if max(cut, lo) < hi:  # the piece cut by the right edge
            sums.append(x[r, max(cut, lo) - lo:hi - lo].sum()[None])
        sums = torch.cat(sums)
        before = lo // piece_size
        rows.append(torch.nn.functional.pad(sums, (before, divisions - before - sums.shape[0])))
    return torch.stack(rows)


def piece_rms_sharded(parts: Sharded, piece_size: int, divisions: int, grid: TimeGrid) -> List[torch.Tensor]:
    """Per-piece RMS (divisions,) of the whole track, on every device
    (reference ``dsp.py:80-86`` over ``unfold``-ed pieces)."""
    sums = [_piece_sums(torch.square(x), m, piece_size, divisions) for x, m in zip(parts, grid.members)]
    return [torch.sqrt(total / piece_size) for total in grid.psum(sums)]


def piece_rms_sharded_dynamic(
    parts: Sharded, piece_size, divisions, div_max: int, grid: TimeGrid
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """:func:`piece_rms_sharded` with the piece geometry as 0-d int tensors
    (or ints), never read back to the host: the true-length analysis of a
    zero-padded track.  Each shard's piece sums are differences of its
    float64 running energy at the piece boundaries that fall in it.
    Returns ``(rmses, valid)``, each one (div_max,) tensor per device;
    entries at or past ``divisions`` are meaningless and 0 in ``valid``."""
    block = parts[0].shape[1]
    sums, sizes, counts = [], [], []
    for g, x in enumerate(parts):
        size = torch.as_tensor(piece_size).to(x.device)
        count = torch.as_tensor(divisions).to(x.device)
        lo = grid.index[g][:, None] * block  # (R, 1)
        in_pieces = lo + torch.arange(block, device=x.device) < size * count
        energy = torch.square(x.to(torch.float64)) * in_pieces
        running = torch.nn.functional.pad(torch.cumsum(energy, dim=1), (1, 0))  # (R, block + 1)
        bounds = torch.clamp(torch.arange(div_max + 1, device=x.device) * size - lo, 0, block)
        ends = torch.gather(running, 1, bounds)
        sums.append(ends[:, 1:] - ends[:, :-1])
        sizes.append(size)
        counts.append(count)
    dtype = parts[0].dtype
    rmses = [torch.sqrt(total / size).to(dtype) for total, size in zip(grid.psum(sums), sizes)]
    valid = [(torch.arange(div_max, device=c.device) < c).to(dtype) for c in counts]
    return rmses, valid


def masked_average_spectrum_sharded_dynamic(
    parts: Sharded, mask, piece_size, divisions, div_max: int, fft_size: int, grid: TimeGrid
) -> List[torch.Tensor]:
    """:func:`masked_average_spectrum_sharded` with the piece geometry as
    0-d int tensors (or ints), never read back to the host
    (``matchering_tpu/parallel/timeshard.py:410-461``).  Frames are
    numbered by their ordinal ``f`` (piece ``f // fpp``, frame ``f % fpp``
    in it), so each shard takes the ``block // fft_size + 2`` ordinals
    from the first frame starting in it; ``mask`` (div_max,), one tensor
    or one per device, must already be zero past ``divisions``.  Returns
    the (fft_size//2 + 1,) spectrum on every device."""
    block = parts[0].shape[1]
    local_frames = block // fft_size + 2
    masks = _per_device(mask, grid)
    partial, per_piece = [], []
    for g, (x, halo, m) in enumerate(zip(parts, grid.halo_right(parts, fft_size), masks)):
        size = torch.as_tensor(piece_size).to(x.device)
        count = torch.as_tensor(divisions).to(x.device)
        fpp = torch.clamp(size // fft_size, min=1)
        lo = grid.index[g] * block  # (R,)
        p_lo = torch.clamp(lo // torch.clamp(size, min=1), 0, div_max - 1)
        k_lo = torch.minimum(torch.clamp(-((p_lo * size - lo) // fft_size), min=0), fpp)
        f = (p_lo * fpp + k_lo)[:, None] + torch.arange(local_frames, device=x.device)
        p = torch.clamp(f // fpp, 0, div_max - 1)
        starts = p * size + (f % fpp) * fft_size
        owned = (f < count * fpp) & (starts >= lo[:, None]) & (starts < lo[:, None] + block)
        offsets = torch.clamp(starts - lo[:, None], 0, block)
        windows = torch.cat([x, halo], dim=1).unfold(1, fft_size, 1)
        frames = windows[torch.arange(x.shape[0], device=x.device)[:, None], offsets]
        magnitude = torch.abs(torch.fft.rfft(frames, dim=-1)) / fft_size
        # pieces shorter than one frame contribute nothing
        weights = m[p] * owned.to(x.dtype) * (size // fft_size > 0).to(x.dtype)
        partial.append(torch.einsum("rfk,rf->rk", magnitude, weights))
        per_piece.append(fpp)
    return [
        total / (torch.clamp(torch.sum(m), min=1.0) * fpp)
        for total, m, fpp in zip(grid.psum(partial), masks, per_piece)
    ]


def masked_average_spectrum_sharded(
    parts: Sharded, mask, piece_size: int, divisions: int, fft_size: int, grid: TimeGrid
) -> List[torch.Tensor]:
    """Mask-weighted average |rFFT|/fft_size over the analysis frames of
    the whole track (reference ``match_frequencies.py:30-42``): frames of
    ``fft_size`` from the start of each piece, a piece's tail dropped.
    Each shard takes the frames that start inside it, through one
    ``fft_size`` right halo; their ordinals and offsets are computed on
    the device from the shard index (``matchering_tpu/parallel/timeshard.py:410-461``)."""
    frames_per_piece = piece_size // fft_size
    fpp = max(frames_per_piece, 1)
    total_frames = divisions * frames_per_piece
    block = parts[0].shape[1]
    local_frames = block // fft_size + 2
    partial = []
    for g, (x, halo, m) in enumerate(zip(parts, grid.halo_right(parts, fft_size), mask)):
        lo = grid.index[g] * block
        p_lo = torch.clamp(lo // max(piece_size, 1), 0, divisions - 1)
        k_lo = torch.clamp(-((p_lo * piece_size - lo) // fft_size), 0, frames_per_piece)
        f = (p_lo * frames_per_piece + k_lo)[:, None] + torch.arange(local_frames, device=x.device)
        p = torch.clamp(f // fpp, 0, divisions - 1)
        starts = p * piece_size + (f % fpp) * fft_size
        owned = (f < total_frames) & (starts >= lo[:, None]) & (starts < lo[:, None] + block)
        offsets = torch.clamp(starts - lo[:, None], 0, block)
        windows = torch.cat([x, halo], dim=1).unfold(1, fft_size, 1)
        frames = windows[torch.arange(x.shape[0], device=x.device)[:, None], offsets]
        magnitude = torch.abs(torch.fft.rfft(frames, dim=-1)) / fft_size
        weights = m[p] * owned.to(x.dtype) * float(frames_per_piece > 0)
        partial.append(torch.einsum("rfk,rf->rk", magnitude, weights))
    return [
        total / (torch.clamp(torch.sum(m), min=1.0) * fpp)
        for total, m in zip(grid.psum(partial), mask)
    ]


# ---------------------------------------------------------------------------
# Limiter


def _require_first_order(config: Config) -> None:
    """The sharded limiter carries first-order filters only
    (``matchering_tpu/parallel/timeshard.py:656-660``)."""
    if config.limiter.hold_filter_order != 1 or config.limiter.release_filter_order != 1:
        raise NotImplementedError(
            "time-sharded limiter supports first-order hold/release filters "
            "(the defaults); use the single-device path for higher orders"
        )


def limit_sharded(parts: Sharded, config: Config, grid: TimeGrid, length=None) -> Sharded:
    """Time-sharded Hyrax limiter (``limiter.limit``) over stereo shards
    (R, block, 2): one K1 and eight K2 launches per device.

    ``length`` (ending inside the last shard; an int, a numpy int or a 0-d
    array or tensor, read back once from a card): the track's true
    length; the gain envelope then ends there (K1's length mode, the
    truncated filtfilt) and the output past it is 0.  The reference's
    early-out (nothing over the threshold: the input passes through) is a
    ``torch.where`` on the device, over every shard."""
    _require_first_order(config)
    if length is not None:
        length = host_int(length)
    limiter = config.limiter
    fs = config.internal_sample_rate
    attack = ms_to_samples(limiter.attack, fs)
    gain_hard_clip, slided = limiter_front_end_sharded(parts, config.threshold, attack, grid, length)
    smoother = iir.one_pole_filter(limiter.attack_filter_coefficient, attack)
    if length is None:
        gain_attack = filtfilt_first_order_sharded(smoother, slided, grid)
    else:
        gain_attack = filtfilt_first_order_sharded_truncated(smoother, slided, length, grid)

    hold_slided = sliding_max_hold_sharded(slided, ms_to_samples(limiter.hold, fs), grid)
    hold_out = lfilter_first_order_sharded(
        iir.butter1_coefficients(limiter.hold_filter_coefficient, fs), hold_slided, grid
    )
    release_in = [torch.maximum(s, h) for s, h in zip(hold_slided, hold_out)]
    release_out = lfilter_first_order_sharded(
        iir.butter1_coefficients(limiter.release_filter_coefficient / limiter.release, fs),
        release_in, grid,
    )

    tolerance = 1e-8 + 1e-5 * 1.0  # np.isclose defaults (hyrax.py:83)
    quiet = grid.gather([torch.all(g <= tolerance / (1.0 + tolerance), dim=1) for g in gain_hard_clip])
    out = []
    for g, (x, hard, attack_gain, hold, release, still) in enumerate(
        zip(parts, gain_hard_clip, gain_attack, hold_out, release_out, quiet)
    ):
        gain = basics.flip(basics.max_mix(hard, attack_gain, torch.maximum(hold, release)))
        if length is not None:
            gain = gain * grid.in_track(g, x.shape[1], length).to(gain.dtype)
        out.append(torch.where(torch.all(still), x, x * gain[..., None]))
    return out


# ---------------------------------------------------------------------------
# The mastering chain


def widest_halo(config: Config) -> int:
    """The most samples a shard lends a neighbour: the FIR's halves, one
    spectrum frame, the hold window and the attack's half window."""
    fs = config.internal_sample_rate
    taps = config.fft_size
    attack = envelope.window_for(ms_to_samples(config.limiter.attack, fs))
    hold = ms_to_samples(config.limiter.hold, fs)
    return max(taps - 1 - (taps - 1) // 2, config.fft_size, hold - 1, attack // 2, 1)


def _body(
    grid: TimeGrid,
    target: Sharded,
    reference: Sharded,
    config: Config,
    t_len: int,
    r_len: int,
    needs: Tuple[bool, bool, bool],
    exact_end: bool,
):
    """One pair's mastering graph over its shards (``master_graph``'s
    stages, ``matchering_tpu/parallel/timeshard.py:686-824``).  Returns
    the three variants as sharded values (None where not asked) and the
    report of device 0."""
    need_default, need_no_limiter, need_no_limiter_normalized = needs
    dtype = config.torch_dtype
    target = [basics.to_working_float(x, dtype) for x in target]
    reference = [basics.to_working_float(x, dtype) for x in reference]
    operators = [operators_for_config(config, d) for d in grid.devices]
    block = target[0].shape[1]
    t_div, t_piece = piece_division(t_len, config.max_piece_size)
    r_div, r_piece = piece_division(r_len, config.max_piece_size)
    report: Dict[str, torch.Tensor] = {}

    # --- Stage 1: match levels ---
    peak = global_peak(reference, grid)
    amplitude = [
        torch.where(p < config.threshold, torch.clamp(p / config.threshold, min=config.min_value),
                    torch.ones_like(p))
        for p in peak
    ]
    reference = [x / a for x, a in zip(reference, amplitude)]
    report["final_amplitude_coefficient"] = amplitude[0]
    t_mid, t_side = zip(*(basics.lr_to_ms(x) for x in target))
    r_mid, r_side = zip(*(basics.lr_to_ms(x) for x in reference))

    def levels(channel, piece, div):
        return list(zip(*(basics.loudest_piece_stats(v) for v in piece_rms_sharded(channel, piece, div, grid))))

    t_mask, t_rms = levels(t_mid, t_piece, t_div)
    r_mask, r_rms = levels(r_mid, r_piece, r_div)
    report["target_match_rms"] = t_rms[0]
    report["reference_match_rms"] = r_rms[0]
    coefficient = [r / torch.clamp(t, min=config.min_value) for r, t in zip(r_rms, t_rms)]
    report["rms_coefficient"] = coefficient[0]

    # --- Stage 2: match frequencies (spectra of the unamplified target,
    # scaled by the RMS coefficient, as in master_graph) ---
    def spectrum(channel, mask, piece, div):
        return masked_average_spectrum_sharded(channel, mask, piece, div, config.fft_size, grid)

    t_specs = [spectrum(ch, t_mask, t_piece, t_div) for ch in (t_mid, t_side)]
    r_specs = [spectrum(ch, r_mask, r_piece, r_div) for ch in (r_mid, r_side)]
    firs = [
        torch.stack([_fir_from_spectra(t_specs[k][g] * c, r_specs[k][g], config, operators[g]) for k in (0, 1)])
        for g, c in enumerate(coefficient)
    ]
    mid_side = [torch.stack([m * c, s * c], dim=-1) for m, s, c in zip(t_mid, t_side, coefficient)]
    convolved = convolve_same_sharded(mid_side, firs, grid)
    # the "same" convolution stops at the track's end: zero what spills
    # into the shard padding before any peak-sensitive stage
    convolved = [
        c * grid.in_track(g, block, t_len).to(dtype)[..., None] for g, c in enumerate(convolved)
    ]
    result_mid = [c[..., 0] for c in convolved]
    result = [basics.ms_to_lr(c[..., 0], c[..., 1]) for c in convolved]

    # --- Stage 3: RMS correction, folded into the clip threshold ---
    c_total = [torch.ones((), dtype=dtype, device=d) for d in grid.devices]
    for step in range(config.rms_correction_steps):
        clipped = [basics.clip(m, 1.0 / c) for m, c in zip(result_mid, c_total)]
        _, clipped_rms = levels(clipped, t_piece, t_div)
        correction = [
            r / torch.clamp(c * v, min=config.min_value) for r, c, v in zip(r_rms, c_total, clipped_rms)
        ]
        report[f"rms_correction_{step + 1}"] = correction[0]
        c_total = [c * k for c, k in zip(c_total, correction)]
    result = [x * c for x, c in zip(result, c_total)]

    # --- Stage 4: finalize ---
    normalized = None
    if need_no_limiter_normalized:
        norm = [torch.clamp(p / config.threshold, min=config.min_value) for p in global_peak(result, grid)]
        normalized = [x / k for x, k in zip(result, norm)]
        report["normalized_coefficient"] = norm[0]
    limited = None
    if need_default:
        limited = limit_sharded(result, config, grid, length=t_len if exact_end else None)
        limited = [x * a for x, a in zip(limited, amplitude)]
    return (limited, result if need_no_limiter else None, normalized), report


def _master_pair(
    grid: TimeGrid, target, reference, config: Config, needs, exact_end: bool, device
) -> MasterOutput:
    """Pad both tracks to a multiple of the shard count, shard them, run
    the body and join each variant on ``device``, cut to the target's
    length.  ``exact_end``: limit at the target's length, not at the
    padded one."""
    if needs[0]:
        _require_first_order(config)
    t_len, r_len = target.shape[0], reference.shape[0]
    t_block, r_block = -(-t_len // grid.count), -(-r_len // grid.count)
    halo = widest_halo(config)
    for role, block in (("target", t_block), ("reference", r_block)):
        if block < halo:
            raise ValueError(
                f"{role} shards of {block} samples are shorter than the widest halo, {halo} "
                f"samples: use fewer than {grid.count} shards"
            )
    if exact_end:
        window = envelope.window_for(ms_to_samples(config.limiter.attack, config.internal_sample_rate))
        last = t_len - (grid.count - 1) * t_block
        if last < max(window, _PADLEN + 1):
            raise ValueError(
                f"the last of {grid.count} target shards holds {last} samples, fewer than "
                f"the attack window of {window}"
            )
    variants, report = _body(
        grid, grid.split(target, t_block), grid.split(reference, r_block), config,
        t_len, r_len, needs, exact_end,
    )
    joined = [None if v is None else grid.join(v, t_len, device) for v in variants]
    return MasterOutput(*joined, report={k: v.to(device) for k, v in report.items()})


def master_sharded(
    target,
    reference,
    config: Config = Config(),
    mesh: Optional[Mesh] = None,
    axis: str = "time",
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
) -> MasterOutput:
    """Master one (target, reference) pair with its time axis sharded over
    ``mesh``'s ``axis`` (default: every visible CUDA device, one shard
    each; a device listed twice holds two shards).

    Inputs: (n, 2) and (m, 2) host arrays or tensors, float or raw
    integer PCM.  Both are zero-padded to a multiple of the shard count
    (exact for the convolution; piece statistics use the true lengths;
    the limiter sees the padded track, as in the JAX package).  Returns
    the variants on the mesh's first device, cut to the target's length,
    and the report there.  A shard shorter than the widest halo
    (:func:`widest_halo`) raises ValueError before anything is staged."""
    if mesh is None:
        mesh = single_axis_mesh(axis)
    devices = mesh.along(axis)
    return _master_pair(
        TimeGrid(devices), target, reference, config,
        (need_default, need_no_limiter, need_no_limiter_normalized), False, devices[0],
    )


def master_farm(
    targets,
    references,
    config: Config = Config(),
    mesh: Optional[Mesh] = None,
    pairs_axis: str = "pairs",
    time_axis: str = "time",
    need_default: bool = True,
    need_no_limiter: bool = False,
    need_no_limiter_normalized: bool = False,
    target_lengths=None,
    reference_lengths=None,
) -> MasterOutput:
    """A batch of pairs over a ``(pairs, time)`` mesh: the batch is cut
    into ``shape[pairs]`` consecutive runs of pairs, run p on the mesh's
    row p, and each pair is time-sharded over its row's devices
    (``matchering_tpu/parallel/timeshard.py:915-1050``).  Default mesh: one row over every
    visible CUDA device.

    targets (B, n, 2), references (B, m, 2), host arrays or tensors; B
    divisible by the pairs axis.  ``target_lengths`` /
    ``reference_lengths`` (B host ints each, both or neither): the true
    lengths of bucket-padded rows.  Each pair is then cut to them, mastered
    and limited at its exact length, so row i equals the single-pair
    master of unpadded pair i, and is 0 past its length.  Without them the
    padded length is the analysis length.  The pairs run one after another
    from this controller, each over its row (see the module docstring for
    the launches per pair); every geometry is host ints.  Returns (B, n, 2)
    variants and (B,) reports on the mesh's first device."""
    if (target_lengths is None) != (reference_lengths is None):
        raise ValueError("pass both target_lengths and reference_lengths, or neither")
    if mesh is None:
        mesh = make_mesh(pairs=1, time=torch.cuda.device_count())  # raises without a card
    for name in (pairs_axis, time_axis):
        if name not in mesh.shape:
            raise ValueError(f"master_farm needs a '{name}' mesh axis, the mesh has {mesh.axis_names}")
    rows = mesh.rows(pairs_axis, time_axis)
    count, n = len(targets), targets.shape[1]
    if count % len(rows):
        raise ValueError(f"batch {count} not divisible by pairs axis {len(rows)}")
    exact = target_lengths is not None
    if exact:
        t_lens = check_lengths(target_lengths, n, config, "target")
        r_lens = check_lengths(reference_lengths, references.shape[1], config, "reference")
    else:
        t_lens, r_lens = (n,) * count, (references.shape[1],) * count
    grids = [TimeGrid(row) for row in rows]
    device = rows[0][0]
    needs = (need_default, need_no_limiter, need_no_limiter_normalized)
    per_row = count // len(rows)
    outs = [
        _master_pair(
            grids[i // per_row], targets[i][: t_lens[i]], references[i][: r_lens[i]], config,
            needs, exact, device,
        )
        for i in range(count)
    ]
    variants = []
    for k in range(3):
        if outs[0][k] is None:
            variants.append(None)
            continue
        batch = outs[0][k].new_zeros((count, n) + tuple(outs[0][k].shape[1:]))
        for i, out in enumerate(outs):
            batch[i, : t_lens[i]] = out[k]
        variants.append(batch)
    report = {key: torch.stack([out.report[key] for out in outs]) for key in outs[0].report}
    return MasterOutput(*variants, report=report)
