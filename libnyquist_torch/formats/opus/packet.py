"""Opus packet (TOC) parsing, RFC 6716 §3.

Equivalent of opus_packet_parse_impl / opus_packet_get_samples_per_frame /
get_bandwidth / get_mode (reference: third_party/opus/libopus/src/opus.c,
opus_decoder_clean.c:758-850).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ...errors import DecodeError

MODE_SILK_ONLY = 1000
MODE_HYBRID = 1001
MODE_CELT_ONLY = 1002

BW_NARROWBAND = 1101
BW_MEDIUMBAND = 1102
BW_WIDEBAND = 1103
BW_SUPERWIDEBAND = 1104
BW_FULLBAND = 1105


def samples_per_frame(toc: int, Fs: int = 48000) -> int:
    if toc & 0x80:
        return (Fs << ((toc >> 3) & 0x3)) // 400
    if (toc & 0x60) == 0x60:
        return Fs // 50 if (toc & 0x08) else Fs // 100
    sz = (toc >> 3) & 0x3
    if sz == 3:
        return Fs * 60 // 1000
    return (Fs << sz) // 100


def packet_mode(toc: int) -> int:
    if toc & 0x80:
        return MODE_CELT_ONLY
    if (toc & 0x60) == 0x60:
        return MODE_HYBRID
    return MODE_SILK_ONLY


def packet_bandwidth(toc: int) -> int:
    if toc & 0x80:
        bw = BW_MEDIUMBAND + ((toc >> 5) & 0x3)
        if bw == BW_MEDIUMBAND:
            bw = BW_NARROWBAND
        return bw
    if (toc & 0x60) == 0x60:
        return BW_FULLBAND if (toc & 0x10) else BW_SUPERWIDEBAND
    return BW_NARROWBAND + ((toc >> 5) & 0x3)


def packet_channels(toc: int) -> int:
    return 2 if (toc & 0x4) else 1


@dataclass
class ParsedPacket:
    toc: int
    mode: int
    bandwidth: int
    stream_channels: int
    frame_size: int  # samples per frame at 48 kHz
    frames: List[bytes]


def _parse_size(data: bytes, pos: int):
    """1- or 2-byte frame length (reference: opus.c parse_size)."""
    if pos >= len(data):
        return -1, pos
    b = data[pos]
    pos += 1
    if b < 252:
        return b, pos
    if pos >= len(data):
        return -1, pos
    return 4 * data[pos] + b, pos + 1


def parse_packet(data: bytes, Fs: int = 48000) -> ParsedPacket:
    """Split an Opus packet into its frames (RFC 6716 §3.2)."""
    if len(data) < 1:
        raise DecodeError("empty opus packet")
    toc = data[0]
    frame_size = samples_per_frame(toc, Fs)
    code = toc & 0x3
    pos = 1
    payload_len = len(data) - 1

    sizes: List[int] = []
    if code == 0:
        count = 1
        sizes = [payload_len]
    elif code == 1:
        count = 2
        if payload_len & 1:
            raise DecodeError("code-1 packet with odd payload")
        sizes = [payload_len // 2] * 2
    elif code == 2:
        count = 2
        sz, pos = _parse_size(data, pos)
        if sz < 0 or sz > len(data) - pos:
            raise DecodeError("bad code-2 frame length")
        sizes = [sz, len(data) - pos - sz]
    else:
        if payload_len < 1:
            raise DecodeError("truncated code-3 packet")
        ch = data[pos]
        pos += 1
        count = ch & 0x3F
        if count <= 0 or frame_size * count > 5760 * (Fs // 48000):
            raise DecodeError("invalid code-3 frame count")
        padding = 0
        if ch & 0x40:  # padding
            while True:
                if pos >= len(data):
                    raise DecodeError("truncated padding")
                p = data[pos]
                pos += 1
                padding += p if p < 255 else 254
                if p != 255:
                    break
        avail = len(data) - pos - padding
        if avail < 0:
            raise DecodeError("padding exceeds packet")
        if ch & 0x80:  # VBR
            sizes = []
            for _ in range(count - 1):
                sz, pos = _parse_size(data, pos)
                if sz < 0:
                    raise DecodeError("bad VBR frame length")
                sizes.append(sz)
            last = len(data) - pos - padding - sum(sizes)
            if last < 0:
                raise DecodeError("VBR frames exceed packet")
            sizes.append(last)
        else:  # CBR
            if avail % count:
                raise DecodeError("CBR payload not divisible")
            sizes = [avail // count] * count

    frames = []
    for sz in sizes:
        if sz > len(data) - pos:
            raise DecodeError("frame exceeds packet")
        frames.append(data[pos : pos + sz])
        pos += sz

    return ParsedPacket(
        toc=toc,
        mode=packet_mode(toc),
        bandwidth=packet_bandwidth(toc),
        stream_channels=packet_channels(toc),
        frame_size=frame_size,
        frames=frames,
    )


def _endband_for_bandwidth(bw: int) -> int:
    """Last coded CELT band for a TOC bandwidth (reference:
    opus_decoder_clean.c, CELT_SET_END_BAND)."""
    if bw == BW_NARROWBAND:
        return 13
    if bw in (BW_MEDIUMBAND, BW_WIDEBAND):
        return 17
    if bw == BW_SUPERWIDEBAND:
        return 19
    return 21
