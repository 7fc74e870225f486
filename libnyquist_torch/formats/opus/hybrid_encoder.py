"""Hybrid (SILK+CELT) Opus encoder: fullband 20 ms frames, mono or
stereo.

The hybrid mode codes the low band with SILK (WB, internal 16 kHz) and
everything from 8 kHz up with CELT starting at band 17, both halves
sharing one range coder per packet (reference:
libopus/src/opus_encoder.c — SILK first via silk_Encode, then
celt_encode_with_ec on the same ec; RFC 6716 §2 "Hybrid mode", TOC
config 15 = FB hybrid 20 ms).

Packet layout produced here, mirrored from the decoder's read order
(formats/opus/decoder.py decode_packet):
  VAD flag(s), LBRR flag per channel, [stereo predictors,] SILK WB
  mid frame [+ side frame], redundancy flag (0, logp 12), then the
  CELT frame (start band 17, C channels) on the same coder.

Rate: SILK runs closed-loop VBR (the bits are what they are); the
CELT half gets the remaining bytes of a per-frame budget derived from
bitrate_kbps.  The SILK half is probed on a state copy first so the
total packet size — which the CELT allocator needs up front — is
known exactly.
"""

from __future__ import annotations

import copy

import numpy as np

from .celt_encoder import (
    FRAME,
    PREEMPH_COEF,
    PRESKIP,
    CeltEncoderState,
    celt_encode_frame,
    mode48000,
    ogg_opus_wrap,
)
from .range_coder import RangeEncoder
from .silk_encoder import (
    BANDWIDTHS,
    BANDWIDTHS_10MS,
    DELAY_COMP_48K,
    SilkEncoderState,
    _encode_frame,
    _StereoState,
    resample_on,
    silk_stereo_frame,
)


def encode_ogg_opus_hybrid(samples: np.ndarray, sample_rate: int,
                           bitrate_kbps: int = 40,
                           channels: int = 1,
                           frame_ms: int = 20,
                           bandwidth: str = "fb",
                           preskip: int | None = None,
                           return_packets: bool = False,
                           device=None):
    """Encode float32 [-1, 1] PCM (interleaved when channels=2) as
    hybrid Ogg Opus.  frame_ms 10/20 and bandwidth "swb"/"fb" span
    the four hybrid TOC configs 12-15 (SWB caps the CELT half at band
    19, matching the decoder's _endband_for_bandwidth). The resamples
    (to 48 kHz, and to SILK's 16 kHz) run on ``device``."""

    if frame_ms not in (10, 20):
        raise ValueError("hybrid frames are 10 or 20 ms")
    if bandwidth not in ("swb", "fb"):
        raise ValueError("hybrid bandwidth is swb or fb")
    lm = 3 if frame_ms == 20 else 2
    n_celt = FRAME >> (3 - lm)          # 960 / 480 samples @48 kHz
    silk_bw = (BANDWIDTHS if frame_ms == 20 else BANDWIDTHS_10MS)["wb"]
    silk_len = silk_bw.frame_len
    toc_cfg = 12 + 2 * (bandwidth == "fb") + (frame_ms == 20)

    ch = channels
    x = np.asarray(samples, np.float64).reshape(-1, ch)
    if sample_rate != 48000:
        x = np.stack([
            resample_on(x[:, c].astype(np.float32), sample_rate, 48000,
                        device) for c in range(ch)], 1)
    S48 = len(x)

    # 48 kHz plane for CELT: preskip priming + frame padding + preemph.
    # The CELT half is delayed by DELAY_COMP_48K so it lands where the
    # decoder's SILK resampler puts the low band (the reference encoder
    # does the same buffering: opus_encoder.c delay_compensation); the
    # standalone wrap below then absorbs preskip+delay in OpusHead.
    mode = mode48000()
    if preskip is None:
        preskip = PRESKIP
    d48 = DELAY_COMP_48K["wb"]
    lead = np.zeros((preskip + d48, ch))
    x48 = np.concatenate([lead, x])
    # Frame count: packet mode (the auto-mode mixer) must emit exactly
    # the segment's frame count — the caller advances the input window
    # by d48; standalone extends coverage so the granule budget
    # preskip+d48+S48 exists.  The last d48 high-band samples falling
    # off the packet-mode grid belong to the next segment's boundary
    # crossfade.
    n_cover = (preskip + len(x)) if return_packets else len(x48)
    F = -(-n_cover // n_celt)
    pad = F * n_celt + mode.overlap - len(x48)
    if pad < 0:
        x48 = x48[:F * n_celt + mode.overlap]
        pad = 0
    x48 = np.concatenate([x48, np.zeros((pad, ch))]).T  # [ch, T]
    pre = np.empty_like(x48)
    pre[:, 0] = 32768.0 * x48[:, 0]
    pre[:, 1:] = 32768.0 * (x48[:, 1:] - PREEMPH_COEF * x48[:, :-1])

    # 16 kHz plane for SILK: same preskip convention as the SILK-only
    # path (PRESKIP is 48 kHz samples; 16 kHz sees a third of them)
    x16 = np.stack([
        resample_on(np.asarray(x[:, c], np.float32), 48000, 16000, device)
        for c in range(ch)], 1)
    x16 = np.concatenate([np.zeros((preskip // 3, ch)), x16]) * 32767.0
    x16 = np.concatenate(
        [x16, np.zeros((F * silk_len - len(x16), ch))])

    base_total = max(
        20, int(bitrate_kbps * 1000 * (n_celt / 48000.0) / 8))
    # Our SILK half is closed-loop VBR with no rate control (the bits
    # are what they are, ~40-50 kbps on busy speech), so the high band
    # gets max(total-target minus SILK, this floor) — the actual total
    # rate can exceed bitrate_kbps when SILK overruns it (documented).
    MIN_CELT = 30 * ch                  # bytes the high band always gets

    silk_st = SilkEncoderState(silk_bw)
    silk_side = SilkEncoderState(silk_bw) if ch == 2 else None
    sstate = _StereoState() if ch == 2 else None
    celt_st = CeltEncoderState(ch)
    celt_st.start = 17                  # hybrid: CELT codes 8 kHz up
    celt_st.end = 21 if bandwidth == "fb" else 19
    if ch == 2:
        mid_all = np.round((x16[:, 0] + x16[:, 1]) / 2.0)
        side_all = np.round((x16[:, 0] - x16[:, 1]) / 2.0)
    packets = []
    toc = (toc_cfg << 3) | ((1 << 2) if ch == 2 else 0)

    def silk_half(enc, states):
        st_m, st_s, ss = states
        lo = k * silk_len
        enc.enc_bit_logp(1, 1)          # VAD ch0: active
        enc.enc_bit_logp(0, 1)          # LBRR ch0
        if ch == 1:
            _encode_frame(enc, st_m, x16[lo:lo + silk_len, 0])
            return
        enc.enc_bit_logp(1, 1)          # VAD ch1 (side always coded)
        enc.enc_bit_logp(0, 1)          # LBRR ch1
        silk_stereo_frame(enc, st_m, st_s, ss,
                          mid_all[lo:lo + silk_len],
                          side_all[lo:lo + silk_len])

    for k in range(F):
        # probe pass: SILK bit count on a state copy (deterministic)
        probe = RangeEncoder(1275)
        silk_half(probe, copy.deepcopy((silk_st, silk_side, sstate)))
        silk_bytes = (probe.tell() + 12 + 7) >> 3

        total = min(max(base_total, silk_bytes + MIN_CELT), 1275)

        enc = RangeEncoder(total)
        silk_half(enc, (silk_st, silk_side, sstate))
        # redundancy flag (decoder reads it when 37 bits fit)
        if enc.tell() + 37 <= 8 * total:
            enc.enc_bit_logp(0, 12)
        win = pre[:, k * n_celt : k * n_celt + n_celt + mode.overlap]
        celt_encode_frame(celt_st, win, total, lm, enc=enc)
        payload = enc.done()
        if enc.error:
            raise RuntimeError("hybrid range encoder overflow")
        packets.append(bytes([toc]) + payload)

    if return_packets:
        return packets, S48
    return ogg_opus_wrap(packets, ch, S48, n_celt, preskip + d48)
