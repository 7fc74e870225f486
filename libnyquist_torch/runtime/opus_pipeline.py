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
from ..formats.opus.celt_tables import COMB_GAINS, mode48000
from ..ops import comb as comb_ops
from ..ops import imdct as imdct_ops
from ..ops import scan_iir
from .batching import bucket_size

CELT_SIG_SCALE = 32768.0


def postfilter_frame_params(infos: List[dict]) -> List[dict]:
    """Replay the decoder's postfilter state machine
    (reference: celt_decoder_clean.c:652-685) over a frame sequence,
    yielding per frame the parameters of the two comb_filter calls."""
    period = period_old = 0
    gain = gain_old = 0.0
    tapset = tapset_old = 0
    out = []
    for info in infos:
        LM = info["LM"]
        p = max(period, COMBFILTER_MINPERIOD)
        p_old = max(period_old, COMBFILTER_MINPERIOD)
        g = [x * gain for x in COMB_GAINS[tapset]]
        g_old = [x * gain_old for x in COMB_GAINS[tapset_old]]
        pitch_new = max(info["postfilter_pitch"], COMBFILTER_MINPERIOD)
        g_new = [
            x * info["postfilter_gain"]
            for x in COMB_GAINS[info["postfilter_tapset"]]
        ]
        out.append(
            dict(
                T0a=p_old, T1a=p, g0a=g_old, g1a=g,
                T0b=p, T1b=pitch_new, g0b=g, g1b=g_new,
                frame_size=info["N"], LM=LM,
            )
        )
        # state rollover
        period_old, gain_old, tapset_old = period, gain, tapset
        period = info["postfilter_pitch"]
        gain = info["postfilter_gain"]
        tapset = info["postfilter_tapset"]
        if LM != 0:
            period_old, gain_old, tapset_old = period, gain, tapset
    return out


@dataclass
class SynthState:
    """Per-stream state carried across pipeline segments, on ``device``
    (required: the caller resolves it, see device.resolve_device)."""
    channels: int
    device: torch.device
    imdct_tail: list = None              # per channel [overlap] or None
    comb_hist: torch.Tensor = None       # [C, HIST]
    deemph_mem: torch.Tensor = None      # [C]

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
      fparams: per-frame postfilter params for these frames, produced by
        postfilter_frame_params over the WHOLE stream (the postfilter
        state machine spans segment boundaries).
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
