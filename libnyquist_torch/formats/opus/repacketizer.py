"""Opus repacketizer: merge/split packets, pad/unpad (RFC 6716 §3.2).

Equivalent of the reference's repacketizer (libopus/src/repacketizer.c:
opus_repacketizer_cat :61-90, opus_repacketizer_out_range_impl
:102-228, opus_packet_pad :238, opus_packet_unpad :259). Self-delimited
framing (only the multistream encoder writes it) is not implemented; the
multistream decoder splits such packets itself.
"""

from __future__ import annotations

from typing import List, Optional

from ...errors import DecodeError
from .packet import parse_packet, samples_per_frame

__all__ = ["Repacketizer", "packet_pad", "packet_unpad"]


def _encode_size(n: int) -> bytes:
    """1- or 2-byte frame length (reference: opus.c encode_size)."""
    if n < 252:
        return bytes([n])
    first = 252 + (n & 0x3)
    return bytes([first, (n - first) >> 2])


class Repacketizer:
    """opus_repacketizer_*: collect frames, emit one merged packet."""

    def __init__(self) -> None:
        self.toc = 0
        self.frame_size = 0  # samples per frame at 48 kHz
        self.frames: List[bytes] = []

    def reset(self) -> None:
        self.frames = []

    @property
    def nb_frames(self) -> int:
        return len(self.frames)

    def cat(self, packet: bytes) -> None:
        """Append a packet's frames (repacketizer.c:61 cat_impl)."""
        if len(packet) < 1:
            raise DecodeError("empty opus packet")
        if not self.frames:
            self.toc = packet[0]
            self.frame_size = samples_per_frame(packet[0])
        elif (self.toc ^ packet[0]) & 0xFC:
            raise DecodeError("repacketizer TOC mismatch")
        p = parse_packet(packet)
        # 120 ms maximum (repacketizer.c:80 checks 960 at Fs=8000)
        if (len(self.frames) + len(p.frames)) * self.frame_size > 5760:
            raise DecodeError("repacketized packet exceeds 120 ms")
        self.frames.extend(p.frames)

    def out(self, begin: int = 0, end: Optional[int] = None,
            pad_to: Optional[int] = None) -> bytes:
        """Emit frames [begin, end) as one packet
        (repacketizer.c:102 out_range_impl; pad_to = maxlen with pad)."""
        if end is None:
            end = len(self.frames)
        if begin < 0 or begin >= end or end > len(self.frames):
            raise DecodeError("bad repacketizer range")
        frames = self.frames[begin:end]
        count = len(frames)
        lens = [len(f) for f in frames]
        tc = self.toc & 0xFC

        out = b""
        if count == 1:
            out = bytes([tc]) + frames[0]
        elif count == 2 and lens[0] == lens[1]:
            out = bytes([tc | 0x1]) + frames[0] + frames[1]
        elif count == 2:
            out = (bytes([tc | 0x2]) + _encode_size(lens[0])
                   + frames[0] + frames[1])
        if count <= 2 and not (pad_to is not None and len(out) < pad_to):
            if pad_to is not None and len(out) > pad_to:
                raise DecodeError("repacketizer output exceeds maxlen")
            return out

        # Code 3 (also the padding path for any count)
        vbr = any(ln != lens[0] for ln in lens[1:])
        head = bytearray([tc | 0x3, count | (0x80 if vbr else 0)])
        size_bytes = b"".join(_encode_size(ln) for ln in lens[:-1]) \
            if vbr else b""
        body = b"".join(frames)
        tot = len(head) + len(size_bytes) + len(body)
        pad_amount = 0
        pad_field = b""
        if pad_to is not None:
            if tot > pad_to:
                raise DecodeError("repacketizer output exceeds maxlen")
            pad_amount = pad_to - tot
        if pad_amount:
            head[1] |= 0x40
            nb_255s = (pad_amount - 1) // 255
            pad_field = (b"\xff" * nb_255s
                         + bytes([pad_amount - 255 * nb_255s - 1]))
        packet = bytes(head) + pad_field + size_bytes + body
        if pad_to is not None:
            packet += b"\x00" * (pad_to - len(packet))
        return packet


def packet_pad(packet: bytes, new_len: int) -> bytes:
    """Grow a packet to new_len with padding (opus_packet_pad)."""
    if new_len < len(packet):
        raise DecodeError("packet_pad: new_len smaller than packet")
    if new_len == len(packet):
        return packet
    rp = Repacketizer()
    rp.cat(packet)
    return rp.out(pad_to=new_len)


def packet_unpad(packet: bytes) -> bytes:
    """Strip padding, re-emit minimal framing (opus_packet_unpad)."""
    rp = Repacketizer()
    rp.cat(packet)
    return rp.out()
