"""Ogg Opus decoding: container, multistream split, host decode, device
synthesis, trimming.

Equivalent of the reference's OpusDecoder glue + opusfile slice
(reference: src/OpusDecoder.cpp:44-122, opusfile op_read_float /
op_pcm_total) and the multistream channel mapping
(libopus/src/opus_multistream_decoder.c:184). Output: float64
[samples, channels] at 48 kHz.

Routes, in the reference package's order:

* CELT-only files of one stream without lost pages: the native scan and
  one native whole-stream decode (mapping family 0), or the demux and the
  same decode (other families), then one device synthesis;
* family-1 multistream CELT-only files whose elementary streams share one
  frame-size sequence: the same per stream, then the mapping;
* everything else (SILK, hybrid, mode switches, lost pages): the general
  path, ``OpusMultistreamDecoder`` over the per-packet ``OpusDecoder``
  (``decoder.py``): host entropy decode, CELT synthesis and the
  output mix on the card at the stream's end. Lost pages conceal as many
  samples as the granule jump says (capped at 10 s). Chained files decode
  link by link.

Two host halves feed the serving path, which stays CELT-only: the full
native decode to spectra (``decode_celt_raw``) and the bits-only trace
with its replay arrays (``trace_celt_packets`` / ``trace_celt_ogg``: the
device replays the PVQ value plane, ops/celt_replay.py).
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ...audio_data import AudioData, PCMFormat
from ...device import resolve_device
from ...errors import DecodeError
from .. import ogg
from .decoder import OpusDecoder
from .celt_host import (
    CeltDecoderState,
    _raw_to_infos,
    celt_decode_ogg_raw,
    celt_decode_stream_native,
    celt_decode_stream_raw,
    celt_scan_ogg_native,
)
from .iy_split import celt_trace_stream_arrays, trace_frames
from .packet import MODE_CELT_ONLY, _endband_for_bandwidth, parse_packet
from .repacketizer import Repacketizer, packet_pad, packet_unpad  # noqa: F401

CELT_ONLY = ("the serving trace and the raw CELT decode take CELT-only "
             "packets, as the reference's do (ROADMAP.md, faults: kept); "
             "decode SILK and hybrid with OpusDecoder or load()")


@dataclass
class OpusHead:
    version: int
    channels: int
    pre_skip: int
    input_rate: int
    output_gain_q8: int
    mapping_family: int
    stream_count: int
    coupled_count: int
    mapping: List[int]


def parse_opus_head(data: bytes) -> OpusHead:
    if not data.startswith(b"OpusHead") or len(data) < 19:
        raise DecodeError("bad OpusHead")
    version = data[8]
    channels = data[9]
    pre_skip = struct.unpack_from("<H", data, 10)[0]
    input_rate = struct.unpack_from("<I", data, 12)[0]
    output_gain = struct.unpack_from("<h", data, 16)[0]
    family = data[18]
    if family == 0:
        if channels > 2:
            raise DecodeError("mapping family 0 allows at most 2 channels")
        streams, coupled = 1, channels - 1
        mapping = list(range(channels))
    else:
        if len(data) < 21 + channels:
            raise DecodeError("truncated OpusHead channel mapping")
        streams = data[19]
        coupled = data[20]
        mapping = list(data[21 : 21 + channels])
    return OpusHead(
        version=version,
        channels=channels,
        pre_skip=pre_skip,
        input_rate=input_rate,
        output_gain_q8=output_gain,
        mapping_family=family,
        stream_count=streams,
        coupled_count=coupled,
        mapping=mapping,
    )


def _map_channels(head: OpusHead, outs, n: int, device) -> torch.Tensor:
    """Elementary streams' [n, ch_s] outputs -> the head's channels."""
    result = torch.zeros(n, head.channels, device=device)
    for c, m in enumerate(head.mapping):
        if m == 255:
            continue
        if m < 2 * head.coupled_count:
            result[:, c] = outs[m >> 1][:n, m & 1]
        else:
            result[:, c] = outs[
                head.coupled_count + (m - 2 * head.coupled_count)][:n, 0]
    return result


class OpusMultistreamDecoder:
    """N elementary streams -> mapped output channels (reference:
    opus_multistream_decoder.c:184-404), on ``device``.

    ``push_packet`` splits a packet (self-delimited framing for all but
    the last stream) and queues each part on its stream's
    ``OpusDecoder``; ``flush`` mixes every stream on the card and maps
    the channels; ``decode_packet`` does both."""

    def __init__(self, head: OpusHead, device=None):
        self.head = head
        self.device = resolve_device(device)
        self.decoders = []
        for s in range(head.stream_count):
            ch = 2 if s < head.coupled_count else 1
            dec = OpusDecoder(ch, device=self.device)
            dec.decode_gain = head.output_gain_q8
            self.decoders.append(dec)

    def push_packet(self, data) -> int:
        head = self.head
        if data is None:
            ns = [d.push_packet(None) for d in self.decoders]
        else:
            parts = []
            pos = 0
            for s in range(head.stream_count):
                if s == head.stream_count - 1:
                    seg = data[pos:]
                    pos = len(data)
                else:
                    seg, pos = self._undelimit(data, pos)
                parts.append(seg)
            ns = [self.decoders[s].push_packet(parts[s])
                  for s in range(head.stream_count)]
        if any(n != ns[0] for n in ns):
            raise DecodeError("stream length mismatch in multistream")
        return ns[0]

    def flush(self) -> torch.Tensor:
        outs = [d.flush() for d in self.decoders]
        return _map_channels(self.head, outs, outs[0].shape[0], self.device)

    def decode_packet(self, data) -> torch.Tensor:
        self.push_packet(data)
        return self.flush()

    @staticmethod
    def _undelimit(data: bytes, pos: int):
        """Strip RFC 6716 Appendix B self-delimited framing.

        Returns (undelimited_packet_bytes, next_pos). Self-delimited
        packets carry one extra frame-length field (the otherwise-implicit
        last-frame size); reconstruct the equivalent undelimited packet
        for the standard packet parser.
        """
        if pos >= len(data):
            raise DecodeError("truncated multistream packet")
        toc = data[pos]
        code = toc & 0x3

        def parse_size(p):
            if p >= len(data):
                raise DecodeError("truncated multistream packet")
            b = data[p]
            p += 1
            if b < 252:
                return b, p
            if p >= len(data):
                raise DecodeError("truncated multistream packet")
            return 4 * data[p] + b, p + 1

        p = pos + 1
        if code == 0:
            size, p = parse_size(p)  # extra field: the single frame's size
            end = p + size
            return bytes([toc]) + data[p:end], end
        if code == 1:
            size, p = parse_size(p)  # extra field: per-frame size
            end = p + 2 * size
            return bytes([toc]) + data[p:end], end
        if code == 2:
            sz_field_start = p
            s1, p = parse_size(p)
            s2, p = parse_size(p)   # extra field: second frame's size
            end = p + s1 + s2
            pkt = bytes([toc]) + data[sz_field_start:sz_field_start + (
                1 if s1 < 252 else 2)] + data[p:end]
            return pkt, end
        # code 3
        ch = data[p]
        p += 1
        count = ch & 0x3F
        if count <= 0:
            raise DecodeError("invalid multistream frame count")
        padding = 0
        pad_start = p
        if ch & 0x40:
            while True:
                b = data[p]
                p += 1
                padding += b if b < 255 else 254
                if b != 255:
                    break
        pad_bytes = data[pad_start:p]
        if ch & 0x80:  # VBR: all `count` sizes present (extra = last one)
            size_fields_start = p
            sizes = []
            for _ in range(count):
                sz, p = parse_size(p)
                sizes.append(sz)
            # Undelimited keeps only the first count-1 size fields.
            q = size_fields_start
            for _ in range(count - 1):
                _, q = parse_size(q)
            kept_fields = data[size_fields_start:q]
            frames_start = p
            total = sum(sizes)
            end = frames_start + total + padding
            pkt = (bytes([toc, ch]) + pad_bytes + kept_fields
                   + data[frames_start:end])
            return pkt, end
        # CBR: one size field (extra; undelimited CBR has none)
        sz, p = parse_size(p)
        frames_start = p
        end = frames_start + sz * count + padding
        return bytes([toc, ch]) + pad_bytes + data[frames_start:end], end


def _celt_frame_feed(parsed_packets):
    """Flatten parsed CELT packets into the native decoder's per-frame
    feed: (frames, frame sizes, end bands, coded channels)."""
    frames, sizes, ends, chs = [], [], [], []
    for parsed in parsed_packets:
        eb = _endband_for_bandwidth(parsed.bandwidth)
        for fr in parsed.frames:
            frames.append(fr)
            sizes.append(parsed.frame_size)
            ends.append(eb)
            chs.append(parsed.stream_channels)
    return frames, sizes, ends, chs


def decode_celt_raw(packets, channels: int):
    """Host half for raw CELT-only packets: parse, then one native decode
    call with a fresh decoder state. Returns the array form (freq
    [n, CCout, nmax] float32, frame_sizes, stream_chs, short_blocks,
    pf_pitch, pf_gain, pf_tapset, silence)."""
    parsed = [parse_packet(p) for p in packets]
    if any(pp.mode != MODE_CELT_ONLY for pp in parsed):
        raise NotImplementedError(CELT_ONLY)
    return celt_decode_stream_raw(
        CeltDecoderState(channels=channels), *_celt_frame_feed(parsed))


# The serving trace: raw iy values in the compact heap, B <= 1 leaves as
# codeword indices for the device cwrsi.
_SERVING_TRACE = dict(with_heap=False, raw_iy=True, xs_heap=True,
                      idx_mode=True)


def _trace_result(tr):
    from ...ops.celt_replay import build_replay_arrays

    arrs, _static, key = build_replay_arrays(tr)
    return tr, arrs, key, float(np.sum(tr.fsz)) / 48000.0


def trace_celt_packets(packets, channels: int):
    """iy-split host half for raw CELT-only packets: parse, one native
    bits-only trace decode with a fresh decoder state (serving modes:
    raw_iy, xs_heap, idx_mode), then the replay-array assembly. The
    float value plane is left to the device (ops/celt_replay.py).
    Returns (CeltTrace, arrs, static_key, audio_seconds)."""
    parsed = [parse_packet(p) for p in packets]
    if any(pp.mode != MODE_CELT_ONLY for pp in parsed):
        raise NotImplementedError(CELT_ONLY)
    tr = trace_frames(CeltDecoderState(channels=channels),
                      *_celt_frame_feed(parsed), **_SERVING_TRACE)
    if tr is None:
        raise DecodeError("no CELT frames to trace")
    return _trace_result(tr)


def trace_celt_ogg(data: bytes):
    """trace_celt_packets for a whole Ogg Opus file through the native
    scan (single CELT-only stream, mapping family 0). Raises
    NotImplementedError for what the scan declines."""
    scan = celt_scan_ogg_native(data)
    if scan is None:
        raise NotImplementedError(CELT_ONLY)
    payload, offs, lens, fsz, ends, chs, info = scan
    pay_p = payload.ctypes.data_as(ctypes.c_char_p)
    tr = celt_trace_stream_arrays(
        CeltDecoderState(channels=int(info[0])), pay_p, offs, lens, fsz,
        ends, chs, **_SERVING_TRACE)
    del pay_p  # payload kept alive by this frame for the call's duration
    if tr is None:
        raise DecodeError("no CELT frames to trace")
    return _trace_result(tr)


def decode_celt_infos(packets, channels: int) -> List[dict]:
    """decode_celt_raw as per-frame info dicts (synthesize_stream's
    input)."""
    return _raw_to_infos(CeltDecoderState(channels=channels),
                         decode_celt_raw(packets, channels))


def decode_celt_packets(packets, channels: int, device=None) -> torch.Tensor:
    """Raw CELT-only Opus packets -> [S, channels] float32 PCM on the
    device (no container, no pre-skip trim)."""
    from ...runtime.opus_pipeline import synthesize_stream

    return synthesize_stream(decode_celt_infos(packets, channels), channels,
                             device=device)


def _apply_gain(pcm: np.ndarray, gain_q8: int) -> np.ndarray:
    if gain_q8:
        pcm = pcm * (10.0 ** (gain_q8 / (20.0 * 256.0)))
    return pcm


def _decode_celt_only_pipeline(st, head, device):
    """Single-stream route for the files the native scan declines (a
    mapping family other than 0): Python demux + packet split, one native
    decode call, device synthesis. Returns pcm [n, channels] or None
    when the stream is not CELT-only at the head's channel count."""
    from ...runtime.opus_pipeline import synthesize_stream

    pkts = []
    for pkt in st.packets[2:]:
        if len(pkt.data) == 0:
            continue
        try:
            parsed = parse_packet(pkt.data)
        except DecodeError:
            return None
        if (parsed.mode != MODE_CELT_ONLY
                or parsed.stream_channels != head.channels
                or parsed.frame_size < 120):
            return None
        pkts.append(parsed)
    if not pkts:
        return None
    infos = celt_decode_stream_native(
        CeltDecoderState(channels=head.channels), *_celt_frame_feed(pkts))
    pcm = synthesize_stream(infos, head.channels, device=device)
    return _apply_gain(pcm.cpu().numpy().astype(np.float64),
                       head.output_gain_q8)


def _decode_celt_multistream_pipeline(st, head, device):
    """Family-1 multistream CELT-only route: each elementary stream runs
    the whole-stream native decode and the device synthesis, and the
    mapping table assembles the output channels. Returns pcm
    [n, channels] or None when the streams are not all CELT-only with
    one shared frame-size sequence."""
    from ...runtime.opus_pipeline import synthesize_stream

    S = head.stream_count
    per_stream = [[] for _ in range(S)]     # parsed packets per stream
    for pkt in st.packets[2:]:
        if len(pkt.data) == 0:
            continue
        pos = 0
        try:
            for s in range(S):
                if s == S - 1:
                    seg = pkt.data[pos:]
                    pos = len(pkt.data)
                else:
                    seg, pos = OpusMultistreamDecoder._undelimit(
                        pkt.data, pos)
                parsed = parse_packet(seg)
                if parsed.mode != MODE_CELT_ONLY:
                    return None
                per_stream[s].append(parsed)
        except (DecodeError, IndexError):
            return None
    if not per_stream[0]:
        return None
    fsz0 = [p.frame_size for p in per_stream[0]]
    for s in range(1, S):
        if [p.frame_size for p in per_stream[s]] != fsz0:
            return None

    outs = []
    for s in range(S):
        ch = 2 if s < head.coupled_count else 1
        infos = celt_decode_stream_native(
            CeltDecoderState(channels=ch), *_celt_frame_feed(per_stream[s]))
        outs.append(synthesize_stream(infos, ch, device=device))

    n = min(o.shape[0] for o in outs)
    result = _map_channels(head, outs, n, device)
    return _apply_gain(result.cpu().numpy().astype(np.float64),
                       head.output_gain_q8)


def _decode_via_native_scan(data: bytes, device):
    """Fast load route: one C pass demuxes + TOC-splits the whole file
    (native/ogg_opus.c), one C call entropy-decodes every CELT frame,
    and the device synthesis runs once. Returns (pcm, head) or None when
    the stream needs another route (SILK/hybrid, multistream, lost
    pages)."""
    from ...runtime.opus_pipeline import synthesize_stream

    scan = celt_scan_ogg_native(data)
    if scan is None:
        return None
    channels = int(scan[6][0])
    if channels not in (1, 2):
        return None
    st = CeltDecoderState(channels=channels)
    out = celt_decode_ogg_raw(st, data)
    if out is None:
        return None
    raw, scan_info = out[:8], out[8]
    infos = _raw_to_infos(st, raw)
    if not infos:
        return None
    pcm = synthesize_stream(infos, channels, device=device)
    gain_q8 = int(scan_info[3])
    pcm = _apply_gain(pcm.cpu().numpy().astype(np.float64), gain_q8)
    start = int(scan_info[1])               # preskip
    end_granule = int(scan_info[7])
    end = min(pcm.shape[0], end_granule) if end_granule >= 0 \
        else pcm.shape[0]
    head = OpusHead(
        version=1, channels=channels, pre_skip=start,
        input_rate=int(scan_info[2]), output_gain_q8=gain_q8,
        mapping_family=int(scan_info[4]), stream_count=1,
        coupled_count=channels - 1, mapping=list(range(channels)),
    )
    return pcm[start:end], head


def decode_ogg_opus(data: bytes, device=None):
    """Ogg Opus decode -> (float64 [n, channels], head).

    Chained files (sequential links, each its own serial and OpusHead)
    decode link by link and concatenate, like opusfile's op_read loop
    across links; a later link that fails or changes the channel count
    ends the decode there."""
    dev = resolve_device(device)
    streams = ogg.demux(data)
    links = [s for s in streams.values()
             if s.packets and s.packets[0].data.startswith(b"OpusHead")]
    if len(links) > 1:
        first, head = _decode_one_link(data, links[0], dev)
        chunks = [first]
        for link in links[1:]:
            try:
                pcm, head_l = _decode_one_link(None, link, dev)
            except DecodeError:
                break
            if head_l.channels != head.channels:
                break
            chunks.append(pcm)
        return np.concatenate(chunks, axis=0), head
    return _decode_one_link(data, links[0] if links else None, dev)


def decode_general(st, head: OpusHead, device):
    """The general path over one link: every packet through
    ``OpusMultistreamDecoder`` on ``device``, lost pages concealed for
    the granule jump (capped at 10 s), one flush at the end. Returns the
    untrimmed [n, channels] float32 tensor on the device."""
    ms = OpusMultistreamDecoder(head, device)
    keep = []                 # (start, length) runs of the pushed samples
    total = 0

    def push(data, limit=None):
        nonlocal total
        n = ms.push_packet(data)
        k = n if limit is None else max(0, min(n, limit))
        if keep and keep[-1][0] + keep[-1][1] == total and k:
            keep[-1] = (keep[-1][0], keep[-1][1] + k)
        elif k:
            keep.append((total, k))
        total += n
        return n

    last_gran = None
    for pkt in st.packets[2:]:
        if pkt.hole:
            # Lost pages precede this packet (opusfile: OP_HOLE). Size
            # the concealment from the granule jump when both ends are
            # known, else conceal one packet duration.
            missing = None
            if last_gran is not None and pkt.granule_pos >= 0:
                try:
                    pp = parse_packet(pkt.data)
                    cur = pp.frame_size * len(pp.frames)
                    missing = min(pkt.granule_pos - last_gran - cur,
                                  48000 * 10)
                except Exception:
                    missing = None
            if missing is None:
                push(None)
            else:
                while missing > 0:
                    n = push(None, missing)
                    if n <= 0:
                        break
                    missing -= n
        if pkt.granule_pos >= 0:
            last_gran = pkt.granule_pos
        if len(pkt.data) == 0:
            continue
        push(pkt.data)
    pcm = ms.flush()
    if len(keep) != 1 or keep[0] != (0, pcm.shape[0]):
        pcm = (torch.cat([pcm[a: a + n] for a, n in keep], dim=0) if keep
               else pcm[:0])
    return pcm


def _decode_one_link(data, st, device):
    """Decode one logical Opus stream (link). ``data`` is the whole file
    for the first link (the native scan's route) or None."""
    if data is not None:
        fast = _decode_via_native_scan(data, device)
        if fast is not None:
            return fast
    if st is None:
        raise DecodeError("no Opus stream found in Ogg container")
    head = parse_opus_head(st.packets[0].data)
    if head.version >> 4 != 0:
        raise DecodeError("unsupported OpusHead version")
    end_granule = None
    for pkt in st.packets[2:]:
        if pkt.granule_pos >= 0:
            end_granule = pkt.granule_pos

    pcm = None
    if not any(p.hole for p in st.packets):
        if head.stream_count > 1 and head.mapping_family == 1:
            pcm = _decode_celt_multistream_pipeline(st, head, device)
        if pcm is None and (head.stream_count == 1
                            and head.coupled_count in (0, 1)):
            pcm = _decode_celt_only_pipeline(st, head, device)
    if pcm is None:
        # Trim: drop pre-skip, honor the final granule position
        # (opusfile op_pcm_total semantics), on the card.
        out = decode_general(st, head, device)
        end = out.shape[0] if end_granule is None else min(out.shape[0],
                                                            end_granule)
        out = out[head.pre_skip: max(end, head.pre_skip)]
        return out.cpu().numpy().astype(np.float64), head
    start = head.pre_skip
    end = pcm.shape[0] if end_granule is None else min(pcm.shape[0],
                                                       end_granule)
    return pcm[start:end], head


def decode_opus_buffer(data: bytes, audio: AudioData, device=None) -> None:
    pcm, head = decode_ogg_opus(data, device)
    audio.channel_count = head.channels
    audio.sample_rate = 48000  # fixed like the reference (OpusDecoder.cpp:75)
    audio.source_format = PCMFormat.PCM_FLT
    audio.samples = np.ascontiguousarray(pcm.reshape(-1), dtype=np.float32)
    audio.length_seconds = pcm.shape[0] / 48000.0
