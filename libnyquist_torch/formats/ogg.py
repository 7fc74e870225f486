"""Ogg container demuxer (host side).

Equivalent in function to libogg's page framing + packet assembly
(reference: third_party/libogg/src/framing.c) and the slice of opusfile's
stream logic the decoders need (reference:
third_party/opus/opusfile/src/opusfile.c: op_test_memory :1658,
op_pcm_total :1711). Implemented from the Ogg page structure itself:
27-byte header, segment lacing table, 255-terminated packet continuation.

Pure-Python byte shuffling: this layer is control flow, not compute.
The port's copy keeps the demux half only (no CRC check, no muxer).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional


@dataclass
class OggPage:
    version: int
    header_type: int
    granule_pos: int
    serial: int
    page_seq: int
    segments: List[bytes]
    continued_first: bool  # first segment continues a previous packet

    @property
    def is_eos(self) -> bool:
        return bool(self.header_type & 0x04)


def parse_pages(data: bytes) -> Iterator[OggPage]:
    """Iterate Ogg pages, resyncing on garbage like libogg's sync layer."""
    pos = 0
    n = len(data)
    while pos < n:
        idx = data.find(b"OggS", pos)
        if idx < 0:
            return
        if idx + 27 > n:
            return
        (
            version,
            htype,
            granule,
            serial,
            pageseq,
            _crc,
            nsegs,
        ) = struct.unpack_from("<BBqIIIB", data, idx + 4)
        lacing_end = idx + 27 + nsegs
        if lacing_end > n:
            return
        lacing = data[idx + 27 : lacing_end]
        body_len = sum(lacing)
        body_end = lacing_end + body_len
        if body_end > n:
            return
        segments = []
        off = lacing_end
        for lace in lacing:
            segments.append(data[off : off + lace])
            off += lace
        yield OggPage(
            version=version,
            header_type=htype,
            granule_pos=granule,
            serial=serial,
            page_seq=pageseq,
            segments=segments,
            continued_first=bool(htype & 0x01),
        )
        pos = body_end


@dataclass
class OggPacket:
    data: bytes
    granule_pos: int  # granule of the page the packet *ends* on (-1 if mid)
    eos: bool
    hole: bool = False  # a page-sequence gap precedes this packet


@dataclass
class LogicalStream:
    serial: int
    packets: List[OggPacket] = field(default_factory=list)
    last_granule: int = -1
    _partial: bytearray = field(default_factory=bytearray)
    _partial_open: bool = False
    _last_seq: int = -1
    _hole_pending: bool = False


def demux(data: bytes) -> Dict[int, LogicalStream]:
    """Assemble packets for every logical stream in the physical stream.

    Packets are built from lacing values: segments of 255 continue, a
    segment < 255 terminates the packet. A packet may span pages
    (continuation flag).
    """
    streams: Dict[int, LogicalStream] = {}
    for page in parse_pages(data):
        st = streams.setdefault(page.serial, LogicalStream(page.serial))
        if page.granule_pos >= 0:
            st.last_granule = max(st.last_granule, page.granule_pos)
        # Page-sequence gap = lost pages: flag the next completed packet
        # so decoders can conceal (opusfile reports OP_HOLE similarly).
        if st._last_seq >= 0 and page.page_seq > st._last_seq + 1:
            st._hole_pending = True
        st._last_seq = max(st._last_seq, page.page_seq)
        if not page.continued_first and st._partial_open:
            # Lost continuation (hole in the stream): drop the partial.
            st._partial = bytearray()
            st._partial_open = False
        segments = page.segments
        if page.continued_first and not st._partial_open:
            # Orphaned continuation (stream entered mid-file / first page
            # lost): discard fragments up to and including the segment
            # that ends the foreign packet, like libogg does.
            skip = 0
            for seg in segments:
                skip += 1
                if len(seg) < 255:
                    break
            else:
                continue  # whole page is the orphaned continuation
            segments = segments[skip:]
        lacing_sizes = [len(s) for s in segments]
        for i, seg in enumerate(segments):
            st._partial.extend(seg)
            st._partial_open = True
            if lacing_sizes[i] < 255:
                is_last_on_page = i == len(segments) - 1
                st.packets.append(
                    OggPacket(
                        data=bytes(st._partial),
                        granule_pos=page.granule_pos if is_last_on_page else -1,
                        eos=page.is_eos and is_last_on_page,
                        hole=st._hole_pending,
                    )
                )
                st._hole_pending = False
                st._partial = bytearray()
                st._partial_open = False
    return streams


def first_stream_matching(
    streams: Dict[int, LogicalStream], magic: bytes
) -> Optional[LogicalStream]:
    """The first logical stream whose first packet starts with ``magic``."""
    for st in streams.values():
        if st.packets and st.packets[0].data.startswith(magic):
            return st
    return None
