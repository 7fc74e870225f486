"""Batched device synthesis for CELT/Opus streams.

The host half (formats/opus/celt_host.py) entropy-decodes packets into
denormalised spectra + postfilter parameters; this module runs the dense
half on the device, a whole segment at a time:

  [F, N2] spectra --matmul--> frame contributions --shifted add-->
  raw synthesis --comb (CUDA kernel on a card / plain loop on the CPU)-->
  postfiltered --deemph (Toeplitz matmul + carry)--> PCM in [-1, 1]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..device import resolve_device
from ..formats.opus.celt_host import COMBFILTER_MINPERIOD
from ..formats.opus.celt_plc import DECODE_BUFFER_SIZE
from ..formats.opus.celt_tables import COMB_GAINS, mode48000
from ..ops import comb as comb_ops
from ..ops import imdct as imdct_ops
from ..ops import scan_iir
from .batching import bucket_size

CELT_SIG_SCALE = 32768.0


@dataclass
class PostfilterCarry:
    """The postfilter parameters one frame hands the next (the fields of
    the same names in ``CeltDecoderState``)."""
    postfilter_period: int = 0
    postfilter_gain: float = 0.0
    postfilter_tapset: int = 0
    postfilter_period_old: int = 0
    postfilter_gain_old: float = 0.0
    postfilter_tapset_old: int = 0


def postfilter_step(carry, info: dict) -> dict:
    """One frame of the decoder's postfilter state machine (reference:
    celt_decoder_clean.c:652-685): the parameters of the frame's two
    comb_filter calls from ``carry`` (a ``PostfilterCarry`` or a
    ``CeltDecoderState``), which then rolls over to the frame's own."""
    LM = info["LM"]
    p = max(carry.postfilter_period, COMBFILTER_MINPERIOD)
    p_old = max(carry.postfilter_period_old, COMBFILTER_MINPERIOD)
    g = [x * carry.postfilter_gain
         for x in COMB_GAINS[carry.postfilter_tapset]]
    g_old = [x * carry.postfilter_gain_old
             for x in COMB_GAINS[carry.postfilter_tapset_old]]
    pitch_new = max(info["postfilter_pitch"], COMBFILTER_MINPERIOD)
    g_new = [x * info["postfilter_gain"]
             for x in COMB_GAINS[info["postfilter_tapset"]]]
    out = dict(T0a=p_old, T1a=p, g0a=g_old, g1a=g,
               T0b=p, T1b=pitch_new, g0b=g, g1b=g_new,
               frame_size=info["N"], LM=LM)
    carry.postfilter_period_old = carry.postfilter_period
    carry.postfilter_gain_old = carry.postfilter_gain
    carry.postfilter_tapset_old = carry.postfilter_tapset
    carry.postfilter_period = info["postfilter_pitch"]
    carry.postfilter_gain = info["postfilter_gain"]
    carry.postfilter_tapset = info["postfilter_tapset"]
    if LM != 0:
        carry.postfilter_period_old = carry.postfilter_period
        carry.postfilter_gain_old = carry.postfilter_gain
        carry.postfilter_tapset_old = carry.postfilter_tapset
    return out


def postfilter_frame_params(infos: List[dict]) -> List[dict]:
    """The postfilter state machine over a frame sequence from a fresh
    state, yielding per frame the parameters of the two comb_filter
    calls."""
    carry = PostfilterCarry()
    return [postfilter_step(carry, info) for info in infos]


@dataclass
class SynthState:
    """Per-stream state carried across pipeline segments, on ``device``
    (required: the caller resolves it, see device.resolve_device)."""
    channels: int
    device: torch.device
    imdct_tail: list = None              # per channel [overlap] or None
    comb_hist: torch.Tensor = None       # [C, HIST]
    deemph_mem: torch.Tensor = None      # [C]
    plc_hist: torch.Tensor = None        # [C, DECODE_BUFFER_SIZE] or None

    def __post_init__(self):
        if self.imdct_tail is None:
            self.imdct_tail = [None] * self.channels
        if self.comb_hist is None:
            self.comb_hist = torch.zeros(
                self.channels, comb_ops.HIST, device=self.device)
        if self.deemph_mem is None:
            self.deemph_mem = torch.zeros(self.channels, device=self.device)

    @classmethod
    def from_numpy(cls, imdct_tail, comb_hist, deemph_mem, device):
        """State from host arrays: imdct_tail [C, overlap] (or a list of
        per-channel arrays / None), comb_hist [C, HIST], deemph_mem [C]."""
        dev = torch.device(device)

        def up(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, np.float32)).to(dev)

        hist = up(comb_hist)
        C = hist.shape[0]
        tails = [None] * C if imdct_tail is None else [
            None if t is None else up(t) for t in imdct_tail]
        return cls(channels=C, device=dev, imdct_tail=tails,
                   comb_hist=hist, deemph_mem=up(deemph_mem))


def _chunk_tensors(chunk: dict, rows: int, device) -> tuple:
    """Per-chunk comb params [n, ...] -> contiguous [rows, n, ...] tensors
    (int32 lags) in comb_filter's argument order."""
    def up(a):
        a = np.broadcast_to(a, (rows,) + a.shape).copy()   # writable
        return torch.from_numpy(a).to(device)

    return (up(chunk["T0"]), up(chunk["T1"]), up(chunk["gains0"]),
            up(chunk["gains1"]), up(chunk["fade"]))


def synthesize_segment(
    infos: List[dict], state: SynthState, fparams: List[dict]
) -> torch.Tensor:
    """Synthesize a run of equal-(LM, shortBlocks) frames on the device.

    Args:
      infos: frame dicts from the host decode, all with the same
        (LM, shortBlocks) bucket.
      fparams: per-frame postfilter params for these frames, from the
        postfilter state machine run over the whole state epoch
        (``postfilter_frame_params`` / ``postfilter_step``: the machine
        spans segment boundaries).
    Returns: [S, channels] float32 PCM in [-1, 1] on state.device.
    """
    mode = mode48000()
    overlap = mode.overlap
    dev = state.device
    CC = state.channels
    LM = infos[0]["LM"]
    shortBlocks = infos[0]["shortBlocks"]
    N = infos[0]["N"]
    F = len(infos)

    if shortBlocks:
        B = shortBlocks
        Nmdct = 2 * mode.shortMdctSize
    else:
        B = 1
        Nmdct = (2 * mode.shortMdctSize) << LM

    # Bucket the frame count (padding frames: zero spectra, zero gains),
    # exactly as the reference does, so segment paths stay in step.
    Fb = bucket_size(F, 8)
    S = F * N

    # IMDCT + overlap-add, per channel (batched over frames).
    spectra = np.zeros((Fb, CC, N), np.float32)
    spectra[:F] = np.stack([info["freq"] for info in infos])
    spec_d = torch.from_numpy(spectra).to(dev)
    raw = torch.empty(CC, S, device=dev)
    for c in range(CC):
        pcm, new_tail = imdct_ops.celt_imdct_batch_padded(
            spec_d[:, c, :], F, Nmdct, overlap, B=B,
            init_tail=state.imdct_tail[c],
        )
        raw[c] = pcm[:S]
        state.imdct_tail[c] = new_tail

    # Postfilter over the REAL frames only: the filter is causal, so the
    # padding frames the reference also filters (T=15, gains 0) change
    # nothing before them, and the history is the one after the last
    # real frame either way.
    chunk = comb_ops.build_chunk_params(
        fparams, N, mode.window, mode.shortMdctSize)
    y, state.comb_hist = comb_ops.comb_filter(
        raw, state.comb_hist,
        *_chunk_tensors(chunk, CC, dev))
    if state.plc_hist is not None:       # what loss concealment reads
        state.plc_hist = torch.cat([state.plc_hist, y], dim=1)[
            :, -DECODE_BUFFER_SIZE:]

    # Deemphasis (pad to the block size then trim).
    pad = (-S) % scan_iir.BLOCK
    out, _ = scan_iir.deemphasis(
        torch.nn.functional.pad(y, (0, pad)), state.deemph_mem)
    out = out[:, :S]
    # The carry must reflect the last REAL sample, not the padding.
    state.deemph_mem = out[:, S - 1].clone()
    return out.T * (1.0 / CELT_SIG_SCALE)


def synthesize_stream(infos: List[dict], channels: int,
                      device=None) -> torch.Tensor:
    """Full-stream device synthesis, segmented by (LM, shortBlocks).
    Returns [S, channels] float32 PCM on the device."""
    state = SynthState(channels=channels, device=resolve_device(device))
    fparams = postfilter_frame_params(infos)  # whole-stream state machine
    outs = []
    i = 0
    while i < len(infos):
        j = i
        key = (infos[i]["LM"], infos[i]["shortBlocks"])
        while j < len(infos) and (infos[j]["LM"],
                                  infos[j]["shortBlocks"]) == key:
            j += 1
        outs.append(synthesize_segment(infos[i:j], state, fparams[i:j]))
        i = j
    if not outs:
        return torch.zeros(0, channels, device=state.device)
    return torch.cat(outs, dim=0)


# --------------------------------------------------------------------------
# The general Opus path: frames queue per CELT state, samples compose
# lazily, and the card does both at a flush.
# --------------------------------------------------------------------------
class CeltLane:
    """One CELT decoder state's synthesis on the card.

    Frames queue with their postfilter parameters and synthesize only
    when samples or a fresh history are needed: as runs of equal
    (LM, shortBlocks), one ``synthesize_segment`` per run. The lane's
    positions count samples from its creation; each ``synthesize`` keeps
    its output as a chunk until the decoder's mix consumes it. The state
    keeps the last DECODE_BUFFER_SIZE postfiltered samples, which pitch
    concealment reads on the host (``history`` / ``restore``)."""

    def __init__(self, channels: int, device, stats: dict):
        self.channels = channels
        self.state = SynthState(
            channels=channels, device=device,
            plc_hist=torch.zeros(channels, DECODE_BUFFER_SIZE,
                                 device=device))
        self.stats = stats
        self.frames = []          # (info, fparams) queued
        self.queued = 0           # lane position of the next queued sample
        self.done = []            # (lane position, [n, C] tensor) chunks
        self.synthesized = 0      # lane position synthesized up to
        self.host = None          # (decode_mem, preemph_memD) from restore

    def push(self, info: dict, fparams: dict) -> int:
        """Queue one frame; returns its lane position."""
        pos = self.queued
        self.frames.append((info, fparams))
        self.queued += info["N"]
        self.host = None
        return pos

    def synthesize(self) -> None:
        """Synthesize the queued frames (a no-op when none are)."""
        if not self.frames:
            return
        outs = []
        i = 0
        frames = self.frames
        while i < len(frames):
            key = (frames[i][0]["LM"], frames[i][0]["shortBlocks"])
            j = i
            while j < len(frames) and (frames[j][0]["LM"],
                                       frames[j][0]["shortBlocks"]) == key:
                j += 1
            outs.append(synthesize_segment(
                [f[0] for f in frames[i:j]], self.state,
                [f[1] for f in frames[i:j]]))
            self.stats["segments"] += 1
            i = j
        self.stats["flushes"] += 1
        self.done.append((self.synthesized, torch.cat(outs, dim=0)))
        self.synthesized = self.queued
        self.frames = []

    def history(self):
        """The synthesis state on the host, as pitch concealment reads it:
        (decode_mem [C, DECODE_BUFFER_SIZE + overlap] float64, the
        postfiltered history then the raw overlap tail; preemph_memD [C],
        coef times the last output). Synthesizes the queue first."""
        if self.host is not None:
            return self.host
        self.synthesize()
        self.stats["syncs"] += 1
        mode = mode48000()
        ov, half = mode.overlap, mode.overlap // 2
        st = self.state
        mem = np.zeros((self.channels, DECODE_BUFFER_SIZE + ov))
        mem[:, :DECODE_BUFFER_SIZE] = st.plc_hist.cpu().numpy()
        wr = mode.window[ov - 1: half - 1: -1]
        for c, tail in enumerate(st.imdct_tail):
            if tail is not None:
                mem[c, DECODE_BUFFER_SIZE: DECODE_BUFFER_SIZE + half] = (
                    tail[:half].cpu().numpy() / wr)
        pre = scan_iir.COEF * st.deemph_mem.cpu().numpy().astype(np.float64)
        return mem, pre

    def restore(self, mem: np.ndarray, pre: np.ndarray) -> None:
        """Take back a state the host changed (``history``'s layout)."""
        mode = mode48000()
        ov, half = mode.overlap, mode.overlap // 2
        DB = DECODE_BUFFER_SIZE
        w = mode.window
        raw = mem[:, DB: DB + half]
        tails = np.concatenate(
            [raw * w[ov - 1: half - 1: -1], (raw * w[:half])[:, ::-1]],
            axis=1)
        dev = self.state.device
        self.state = SynthState.from_numpy(
            list(tails), mem[:, DB - comb_ops.HIST: DB],
            pre / scan_iir.COEF, dev)
        self.state.plc_hist = torch.from_numpy(
            np.ascontiguousarray(mem[:, :DB], np.float32)).to(dev)
        self.host = (mem, pre)


HOST = "host"   # the source of host-made samples (SILK, concealment)


class Mix:
    """A block of ``n`` samples composed lazily, as a sum of terms.

    A term is (dst, src, off, n, scale, ramp): ``n`` samples of a source
    from position ``off``, placed at ``dst``, times ``scale`` and, when
    ``ramp`` is not None, times a per-sample weight array. A source is a
    ``CeltLane`` (lane positions) or ``HOST`` (rows of the decoder's host
    buffer). The decoder's state machine builds its crossfades with
    ``weight`` / ``clear`` / ``add``; ``mix_on_device`` evaluates a run
    of blocks at once."""

    __slots__ = ("n", "terms")

    def __init__(self, n: int, terms=None):
        self.n = n
        self.terms = terms if terms is not None else []

    @classmethod
    def of(cls, src, off: int, n: int) -> "Mix":
        return cls(n, [(0, src, off, n, 1.0, None)])

    def scale(self, g: float) -> "Mix":
        self.terms = [(d, s, o, n, sc * g, r)
                      for d, s, o, n, sc, r in self.terms]
        return self

    def add(self, other: "Mix", at: int = 0) -> "Mix":
        self.terms += [(d + at, s, o, n, sc, r)
                       for d, s, o, n, sc, r in other.terms]
        return self

    def clip(self, lo: int, hi: int) -> "Mix":
        """Samples [lo, hi) as a new block."""
        out = []
        for d, s, o, n, sc, r in self.terms:
            a, b = max(d, lo), min(d + n, hi)
            if a < b:
                out.append((a - lo, s, o + a - d, b - a, sc,
                            None if r is None else r[a - d: b - d]))
        return Mix(hi - lo, out)

    def weight(self, lo: int, w: np.ndarray) -> "Mix":
        """Multiply samples [lo, lo + len(w)) by ``w``."""
        hi = lo + len(w)
        out = []
        for d, s, o, n, sc, r in self.terms:
            a, b = max(d, lo), min(d + n, hi)
            if a >= b:
                out.append((d, s, o, n, sc, r))
                continue
            for x, y in ((d, a), (b, d + n)):     # the parts outside
                if x < y:
                    out.append((x, s, o + x - d, y - x, sc,
                                None if r is None else r[x - d: y - d]))
            rw = w[a - lo: b - lo]
            if r is not None:
                rw = rw * r[a - d: b - d]
            out.append((a, s, o + a - d, b - a, sc, rw))
        self.terms = out
        return self

    def clear(self, lo: int, hi: int) -> "Mix":
        """Drop samples [lo, hi)."""
        self.terms = self.clip(0, lo).terms + [
            (d + hi, s, o, n, sc, r)
            for d, s, o, n, sc, r in self.clip(hi, self.n).terms]
        return self


def mix_on_device(blocks: List[Mix], lanes: List[CeltLane], host: list,
                  channels: int, device) -> torch.Tensor:
    """Evaluate ``blocks`` back to back into one [sum n, channels]
    float32 tensor on ``device``: every lane's synthesized chunks and the
    host buffer (one upload) form one source; each term becomes a run of
    gather indices and weights, expanded on the card from one small
    table; one ``index_add_`` sums the terms. Consumes the lanes' chunks
    and the host buffer."""
    total = sum(b.n for b in blocks)
    out = torch.zeros(total, channels, device=device)
    srcs, bases = [], {}
    pos = 0
    for lane in lanes:
        for k, (lpos, t) in enumerate(lane.done):
            bases[(id(lane), k)] = (lpos, pos)
            srcs.append(t)
            pos += t.shape[0]
    host_base = pos
    if host:
        srcs.append(torch.from_numpy(np.ascontiguousarray(
            np.concatenate(host, axis=0), np.float32)).to(device))
    starts = {id(lane): [c[0] for c in lane.done] for lane in lanes}
    host_rows = sum(h.shape[0] for h in host)
    rows, ramps = [], [np.ones(1)]
    ramp_len = 1
    at = 0
    for b in blocks:
        for d, s, o, n, sc, r in b.terms:
            # Every gather index is checked here, on the host: an index
            # out of range on the card would be a device-side assert.
            if s is HOST:
                src, lo, hi = host_base + o, host_base, host_base + host_rows
            else:
                k = int(np.searchsorted(starts[id(s)], o, side="right")) - 1
                lpos, base = bases[(id(s), max(k, 0))]
                src = base + o - lpos
                lo = base
                hi = base + s.done[max(k, 0)][1].shape[0]
            if n > 0 and not (lo <= src and src + n <= hi
                              and 0 <= d and d + n <= b.n):
                raise RuntimeError("Opus mix term out of its source's range")
            if r is None:
                rows.append((at + d, src, n, 0, 0, sc))
            else:
                rows.append((at + d, src, n, ramp_len, 1, sc))
                ramps.append(np.asarray(r, np.float64))
                ramp_len += len(r)
        at += b.n
    for lane in lanes:
        lane.done = []
    rows = [r for r in rows if r[2] > 0]
    if not rows or total == 0:
        return out
    src_all = torch.cat(srcs, dim=0)
    tab = np.asarray([r[:5] for r in rows], np.int64)
    scale = np.asarray([r[5] for r in rows], np.float32)
    dev_tab = torch.from_numpy(tab).to(device)
    dev_scale = torch.from_numpy(scale).to(device)
    dev_ramp = torch.from_numpy(np.concatenate(ramps).astype(np.float32)
                                ).to(device)
    lens = dev_tab[:, 2]
    n_all = int(tab[:, 2].sum())
    seg = torch.repeat_interleave(
        torch.arange(len(rows), device=device), lens, output_size=n_all)
    first = torch.cumsum(lens, 0) - lens
    k = torch.arange(n_all, device=device) - first[seg]
    dst = dev_tab[seg, 0] + k
    src = dev_tab[seg, 1] + k
    w = dev_scale[seg] * dev_ramp[dev_tab[seg, 3] + dev_tab[seg, 4] * k]
    out.index_add_(0, dst, src_all[src] * w[:, None])
    return out
