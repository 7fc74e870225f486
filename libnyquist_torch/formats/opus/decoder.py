"""Top-level Opus decoder: SILK/CELT/hybrid mode dispatch per packet.

Equivalent of opus_decode_native / opus_decode_frame (reference:
libopus/src/opus_decoder_clean.c:210-723), with loss concealment:
``decode_packet(None)`` conceals one lost packet, by CELT pitch or noise
concealment (upstream celt_decoder.c:351 celt_decode_lost), the native
SILK concealment, or a waveform fade for hybrid.

The state machine runs on the host, one packet at a time; the samples do
not. Each CELT frame's spectra queue with its state's ``CeltLane`` and
each frame's output is a lazy ``Mix`` of CELT, SILK and concealment
terms with the reference's window-squared crossfades and gain. The card
synthesizes a lane only where the state machine needs samples or a
fresh history (pitch concealment, the hybrid fade, the end), and
composes the output in one pass per ``flush`` (``runtime/opus_pipeline``
``mix_on_device``). ``push_packet`` queues a packet; ``flush`` returns
the samples pushed since the last flush; ``decode_packet`` does both.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from ...errors import DecodeError
from ...runtime import opus_pipeline as pipe
from .celt_frame import celt_decode_frame_to_freq
from .celt_host import CeltDecoderState
from .celt_plc import celt_decode_lost_pitch, celt_noise_frame, uses_pitch
from .celt_tables import mode48000
from .packet import (
    BW_MEDIUMBAND,
    BW_NARROWBAND,
    MODE_CELT_ONLY,
    MODE_HYBRID,
    MODE_SILK_ONLY,
    _endband_for_bandwidth,
    parse_packet,
)
from .range_coder import RangeDecoder
from .silk import NativeSilkDecoder


class OpusDecoder:
    """Single-stream Opus decoder producing 48 kHz float32 PCM on
    ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, channels: int, Fs: int = 48000, device=None):
        if channels not in (1, 2):
            raise DecodeError("opus supports 1 or 2 channels per stream")
        if Fs != 48000:
            raise DecodeError("the decoder runs at 48 kHz (resample after)")
        self.Fs = Fs
        self.channels = channels
        self.device = resolve_device(device)
        self.celt = CeltDecoderState(channels=channels)
        self.silk = None
        self.prev_mode = 0
        self.prev_redundancy = False
        self.stream_channels = channels
        self.bandwidth = 0
        self.mode = 0
        self.frame_size = 0
        self.decode_gain = 0       # Q8 dB (OPUS_SET_GAIN)
        self.rangeFinal = 0
        self.loss_count = 0        # consecutive concealed packets
        self._last_pcm = None      # last packet's output: Mix or ndarray
        # flushes: lane synthesis passes; segments: synthesize_segment
        # calls; syncs: histories brought to the host; mixes: mix passes
        self.stats = dict(flushes=0, segments=0, syncs=0, mixes=0)
        self._lanes = []           # lanes holding queued or unmixed samples
        self._host = []            # host sample blocks of the coming mix
        self._host_rows = 0
        self._pending = []         # one Mix per pushed packet
        self._done = []            # mixed output not yet returned

    # -- public API ---------------------------------------------------------
    def decode_packet(self, data: Optional[bytes],
                      fec: bool = False) -> torch.Tensor:
        """Decode one packet -> [samples, channels] float32 at 48 kHz.
        data=None (or empty) conceals one packet duration (reference:
        opus_decode with data==NULL).

        fec=True recovers the previous (lost) frame from this packet's
        in-band LBRR data instead (opus_decode(..., decode_fec=1)): a
        SILK-only packet, one 10 or 20 ms frame, decoded on the SILK
        state the stream has built up."""
        if fec:
            out = self._decode_fec(data)
            self._last_pcm = out
            self._pending.append(self._host_mix(out))
            return self.flush()
        self.push_packet(data)
        return self.flush()

    def _decode_fec(self, data: Optional[bytes]) -> np.ndarray:
        if not data:
            raise DecodeError("FEC recovery needs the next packet")
        pkt = parse_packet(data)
        if pkt.mode != MODE_SILK_ONLY:
            raise DecodeError("in-band FEC lives in SILK packets")
        if self.silk is None:
            self.silk = NativeSilkDecoder(self.channels)
        if self.bandwidth == BW_NARROWBAND:
            internal_rate = 8000
        elif self.bandwidth == BW_MEDIUMBAND:
            internal_rate = 12000
        else:
            internal_rate = 16000
        payload_ms = max(10, 1000 * pkt.frame_size // self.Fs)
        out = self.silk.decode_fec(pkt.frames[0], self.stream_channels or 1,
                                   internal_rate, payload_ms) / 32768.0
        if out.shape[1] != self.channels:
            out = (np.repeat(out[:, :1], self.channels, axis=1)
                   if out.shape[1] < self.channels else
                   out[:, : self.channels])
        self.loss_count = 0
        return out

    def push_packet(self, data: Optional[bytes]) -> int:
        """Queue one packet's decode; returns its sample count. The
        samples come out of the next ``flush``."""
        if data is None or len(data) == 0:
            out = self._conceal_packet(self.frame_size or 960)
            self.loss_count += 1
        else:
            pkt = parse_packet(data)
            self.mode = pkt.mode
            self.bandwidth = pkt.bandwidth
            self.frame_size = pkt.frame_size
            self.stream_channels = pkt.stream_channels
            out = pipe.Mix(0)
            for fr in pkt.frames:
                m = self._decode_frame(fr, pkt.frame_size)
                out.add(m, out.n)
                out.n += m.n
            self.loss_count = 0
        if isinstance(out, np.ndarray):
            self._last_pcm = out
            out = self._host_mix(out)
        else:
            self._last_pcm = out
        self._pending.append(out)
        return out.n

    def flush(self) -> torch.Tensor:
        """The samples of every packet pushed since the last flush,
        [n, channels] float32 on the decoder's device."""
        self._mix()
        done, self._done = self._done, []
        if not done:
            return torch.zeros(0, self.channels, device=self.device)
        return done[0] if len(done) == 1 else torch.cat(done, dim=0)

    # -- the card side --------------------------------------------------------
    def _mix(self) -> None:
        if not self._pending:
            return
        for lane in self._lanes:
            lane.synthesize()
        out = pipe.mix_on_device(self._pending, self._lanes, self._host,
                                 self.channels, self.device)
        self.stats["mixes"] += 1
        if isinstance(self._last_pcm, pipe.Mix):
            self._last_pcm = out[out.shape[0] - self._last_pcm.n:]
        self._done.append(out)
        self._pending = []
        self._lanes = [ln for ln in self._lanes if ln.frames]
        self._host = []
        self._host_rows = 0

    def _host_mix(self, pcm: np.ndarray) -> pipe.Mix:
        """Samples made on the host as a block of the coming mix."""
        self._host.append(pcm)
        row = self._host_rows
        self._host_rows += pcm.shape[0]
        return pipe.Mix.of(pipe.HOST, row, pcm.shape[0])

    def _lane(self, st: CeltDecoderState) -> pipe.CeltLane:
        if st.lane is None:
            st.lane = pipe.CeltLane(self.channels, self.device, self.stats)
        if st.lane not in self._lanes:
            self._lanes.append(st.lane)
        return st.lane

    def _celt_queue(self, st: CeltDecoderState, info: dict) -> pipe.Mix:
        fparams = pipe.postfilter_step(st, info)
        info["freq"] = info["freq"][: self.channels]
        pos = self._lane(st).push(info, fparams)
        return pipe.Mix.of(st.lane, pos, info["N"])

    def _celt_frame(self, st, data, frame_size, dec=None) -> pipe.Mix:
        """Decode one CELT frame; its synthesis queues on st's lane."""
        return self._celt_queue(
            st, celt_decode_frame_to_freq(st, data, frame_size, dec))

    def _celt_lost(self, frame_size: int):
        """celt_decode_lost: pitch concealment on the host over the lane's
        history (an ndarray), or a noise frame queued on the lane."""
        st = self.celt
        if uses_pitch(st, self.loss_count):
            lane = self._lane(st)
            mem, pre = lane.history()
            pcm = celt_decode_lost_pitch(st, frame_size, self.loss_count,
                                         mem, pre)
            lane.restore(mem, pre)
            return pcm
        return self._celt_queue(
            st, celt_noise_frame(st, frame_size, self.loss_count))

    def _as_mix(self, pcm) -> pipe.Mix:
        return self._host_mix(pcm) if isinstance(pcm, np.ndarray) else pcm

    def _last_samples(self) -> np.ndarray:
        """The last packet's output on the host (mixes what is pending)."""
        if isinstance(self._last_pcm, pipe.Mix):
            self._mix()
        last = self._last_pcm
        if isinstance(last, torch.Tensor):
            last = last.cpu().numpy().astype(np.float64)
        return last

    def _conceal_packet(self, frame_size: int):
        """Concealment for one packet duration: CELT pitch or noise
        concealment, the SILK decoder's own, or for hybrid a repeat and
        fade of the last output with a 2.5 ms raised-cosine splice."""
        channels = self.channels
        if self.prev_mode == 0 or self._last_pcm is None:
            return np.zeros((frame_size, channels))
        if self.prev_mode == MODE_CELT_ONLY:
            return self._celt_lost(frame_size)
        if self.prev_mode == MODE_SILK_ONLY and self.silk is not None:
            return self._decode_frame(None, frame_size)
        F2_5 = self.Fs // 400
        last = self._last_samples()
        reps = int(np.ceil(frame_size / max(len(last), 1)))
        tiled = np.tile(last, (reps, 1))[:frame_size]
        gain = 0.8 * (0.6 ** self.loss_count)
        out = tiled * gain
        ramp = np.linspace(1.0, 0.8, frame_size)[:, None]
        out = out * ramp
        n = min(F2_5, frame_size)
        w = 0.5 - 0.5 * np.cos(np.pi * (np.arange(n) + 0.5) / n)
        out[:n] = (w[:, None] * out[:n]
                   + (1.0 - w[:, None]) * last[-n:] * gain)
        return out

    # -- the state machine ----------------------------------------------------
    def _decode_frame(self, data: Optional[bytes], frame_size: int) -> pipe.Mix:
        F20 = self.Fs // 50
        F10, F5, F2_5 = F20 // 2, F20 // 4, F20 // 8

        if data is not None and len(data) <= 1:
            data = None
        if data is not None:
            audiosize = self.frame_size
            mode = self.mode
            dec = RangeDecoder(data)
            length = len(data)
        else:
            audiosize = frame_size
            mode = self.prev_mode
            length = 0
            if mode == 0:
                return self._host_mix(np.zeros((audiosize, self.channels)))
            if audiosize > F20:
                out = pipe.Mix(0)
                remaining = audiosize
                while remaining > 0:
                    m = self._decode_frame(None, min(remaining, F20))
                    out.add(m, out.n)
                    out.n += m.n
                    remaining -= m.n
                return out
            if audiosize < F20:
                if audiosize > F10:
                    audiosize = F10
                elif mode != MODE_SILK_ONLY and F5 < audiosize < F10:
                    audiosize = F5
            if mode == MODE_CELT_ONLY:
                # CELT concealment, also the CELT->SILK/hybrid transition
                # frame (opus_decoder.c:471-476, :528)
                out = self._as_mix(self._celt_lost(audiosize))
                self.prev_mode = mode
                return out
            dec = RangeDecoder(b"")

        transition = False
        pcm_transition = None
        if (
            data is not None
            and self.prev_mode > 0
            and (
                (mode == MODE_CELT_ONLY and self.prev_mode != MODE_CELT_ONLY
                 and not self.prev_redundancy)
                or (mode != MODE_CELT_ONLY
                    and self.prev_mode == MODE_CELT_ONLY)
            )
        ):
            transition = True
            if mode == MODE_CELT_ONLY:
                pcm_transition = self._decode_frame(None, min(F5, audiosize))

        frame_size = audiosize

        # SILK half (host C, int16-valued)
        pcm_silk = None
        if mode != MODE_CELT_ONLY:
            if self.silk is None or self.prev_mode == MODE_CELT_ONLY:
                self.silk = NativeSilkDecoder(self.channels)
            if mode == MODE_SILK_ONLY:
                if self.bandwidth == BW_NARROWBAND:
                    internal_rate = 8000
                elif self.bandwidth == BW_MEDIUMBAND:
                    internal_rate = 12000
                else:
                    internal_rate = 16000
            else:
                internal_rate = 16000
            payload_ms = max(10, 1000 * audiosize // self.Fs)
            if data is None:
                pcm_silk = self.silk.conceal(self.stream_channels,
                                             internal_rate, payload_ms)
            else:
                pcm_silk = self.silk.decode(dec, self.stream_channels,
                                            internal_rate, payload_ms)

        # Redundancy signaling
        redundancy = False
        celt_to_silk = 0
        redundancy_bytes = 0
        start_band = 0
        if (
            mode != MODE_CELT_ONLY
            and data is not None
            and dec.tell() + 17 + 20 * (1 if self.mode == MODE_HYBRID else 0)
            <= 8 * length
        ):
            if mode == MODE_HYBRID:
                redundancy = bool(dec.dec_bit_logp(12))
            else:
                redundancy = True
            if redundancy:
                celt_to_silk = dec.dec_bit_logp(1)
                if mode == MODE_HYBRID:
                    redundancy_bytes = dec.dec_uint(256) + 2
                else:
                    redundancy_bytes = length - ((dec.tell() + 7) >> 3)
                length -= redundancy_bytes
                if length * 8 < dec.tell():
                    length = 0
                    redundancy_bytes = 0
                    redundancy = False
                dec.storage -= redundancy_bytes

        if mode != MODE_CELT_ONLY:
            start_band = 17

        endband = _endband_for_bandwidth(self.bandwidth) if data is not None \
            else self.celt.end
        self.celt.end = endband
        self.celt.stream_channels = self.stream_channels

        if redundancy:
            transition = False

        if transition and mode != MODE_CELT_ONLY:
            pcm_transition = self._decode_frame(None, min(F5, audiosize))

        redundant_audio = None
        w2 = mode48000().window[:F2_5] ** 2
        if redundancy and celt_to_silk:
            self.celt.start = 0
            redundant_audio = self._celt_frame(
                self.celt, data[length: length + redundancy_bytes], F5)

        self.celt.start = start_band

        pcm = pipe.Mix(frame_size)
        if mode != MODE_SILK_ONLY:
            celt_frame_size = min(F20, frame_size)
            if mode != self.prev_mode and self.prev_mode > 0 \
                    and not self.prev_redundancy:
                self._reset_celt(endband, start_band)
            if data is None:
                # hybrid concealment: the MDCT half extrapolates too
                # (reference opus_decoder.c:528)
                pcm.add(self._as_mix(self._celt_lost(celt_frame_size)))
            else:
                pcm.add(self._celt_frame(self.celt, data[:length],
                                         celt_frame_size, dec))
        elif self.prev_mode == MODE_HYBRID and not (
            redundancy and celt_to_silk and self.prev_redundancy
        ):
            self.celt.start = 0
            pcm.add(self._celt_frame(self.celt, b"\xff\xff", F2_5))

        if pcm_silk is not None:
            pcm.add(self._host_mix(pcm_silk[:frame_size]).scale(1.0 / 32768.0))

        if redundancy and not celt_to_silk:
            self._reset_celt(endband, 0)
            redundant_audio = self._celt_frame(
                self.celt, data[length: length + redundancy_bytes], F5)
            # crossfade the tail into the redundant frame
            pcm.weight(frame_size - F2_5, 1.0 - w2)
            pcm.add(redundant_audio.clip(F2_5, 2 * F2_5).weight(0, w2),
                    frame_size - F2_5)
        if redundancy and celt_to_silk:
            self._splice(pcm, redundant_audio, F2_5, w2)
        if transition and pcm_transition is not None:
            if audiosize >= F5:
                self._splice(pcm, pcm_transition, F2_5, w2)
            else:
                pcm.weight(0, w2)
                pcm.add(pcm_transition.clip(0, F2_5).weight(0, 1.0 - w2))

        if self.decode_gain:
            pcm.scale(math.exp(0.6931471805599453094
                               * (6.48814081e-4 * self.decode_gain)))

        self.rangeFinal = dec.rng if data is not None else 0
        self.prev_mode = mode
        self.prev_redundancy = redundancy and not celt_to_silk
        return pcm.clip(0, audiosize)

    @staticmethod
    def _splice(pcm: pipe.Mix, other: pipe.Mix, F2_5: int, w2: np.ndarray) -> None:
        """pcm[:F2_5] = other[:F2_5], then a window-squared crossfade from
        other into pcm over the next F2_5 samples."""
        pcm.clear(0, F2_5)
        pcm.add(other.clip(0, F2_5))
        pcm.weight(F2_5, w2)
        pcm.add(other.clip(F2_5, 2 * F2_5).weight(0, 1.0 - w2), F2_5)

    def _reset_celt(self, endband: int, start_band: int) -> None:
        """A fresh CELT state (and with it a fresh lane)."""
        self.celt = CeltDecoderState(channels=self.channels)
        self.celt.end = endband
        self.celt.stream_channels = self.stream_channels
        self.celt.start = start_band
