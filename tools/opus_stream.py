"""Ogg Opus files written from the golden libopus packets.

``tests/golden/opus_packets.bin`` holds 18 packet sequences that the
reference libopus encoder wrote in forced modes (CELT, SILK, hybrid, at
several frame sizes, mono and stereo), each with the PCM libopus's
``opus_decode_float`` gives for it. This module cuts and joins those
packets into Ogg Opus files (RFC 7845) the repo has no other source of:
streams that cycle through the cases, so every frame after a case
boundary is a mode switch, with seeded page loss, chained links and a
family-1 multistream file. It carries its own Ogg page writer and CRC
and imports NumPy and struct only.

    data, info = make_opus_stream(k, n_packets=3000)

``STREAMS`` lists the eight streams of k = 0..7: 0-3 stereo, cycling
cases (9, 12, 0, 13) from the k-th; 4-7 mono, cycling (8, 11, 2, 14, 17)
from the (k-4)-th; 2 and 6 lose 2 % of their pages; 3 is two chained
links.
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "tests" / "golden"
          / "opus_packets.bin")
PRE_SKIP = 312                 # what libopus encoders write
STEREO_ORDER = (9, 12, 0, 13)  # SILK, hybrid, CELT, CELT (auto mode)
MONO_ORDER = (8, 11, 2, 14, 17)
STREAMS = [
    dict(channels=2, order=STEREO_ORDER, start=0),
    dict(channels=2, order=STEREO_ORDER, start=1),
    dict(channels=2, order=STEREO_ORDER, start=2, loss=0.02, per_page=1),
    dict(channels=2, order=STEREO_ORDER, start=3, links=2),
    dict(channels=1, order=MONO_ORDER, start=0),
    dict(channels=1, order=MONO_ORDER, start=1),
    dict(channels=1, order=MONO_ORDER, start=2, loss=0.02),
    dict(channels=1, order=MONO_ORDER, start=3),
]


def read_cases(path=GOLDEN):
    """The golden cases: dicts of ch, packets (list of bytes) and pcm
    (interleaved float32, libopus's decode)."""
    raw = pathlib.Path(path).read_bytes()
    (n_cases,) = struct.unpack_from("<i", raw, 0)
    pos = 4
    cases = []
    for _ in range(n_cases):
        ch, _sr, n_packets, _frame = struct.unpack_from("<4i", raw, pos)
        pos += 16
        packets = []
        for _ in range(n_packets):
            (ln,) = struct.unpack_from("<i", raw, pos)
            pos += 4
            packets.append(raw[pos: pos + ln])
            pos += ln
        (n,) = struct.unpack_from("<q", raw, pos)
        pos += 8
        pcm = np.frombuffer(raw, "<f4", n, pos)
        pos += 4 * n
        cases.append(dict(ch=ch, packets=packets, pcm=pcm))
    return cases


# --- Opus packets (RFC 6716 §3) -------------------------------------------
def frame_samples(toc: int) -> int:
    """Samples per frame at 48 kHz of a TOC byte."""
    if toc & 0x80:                                   # CELT
        return 120 << ((toc >> 3) & 0x3)
    if (toc & 0x60) == 0x60:                         # hybrid
        return 960 if toc & 0x08 else 480
    sz = (toc >> 3) & 0x3                            # SILK
    return 2880 if sz == 3 else 480 << sz


def _size(data: bytes, p: int):
    b = data[p]
    if b < 252:
        return b, p + 1
    return 4 * data[p + 1] + b, p + 2


def _size_bytes(n: int) -> bytes:
    if n < 252:
        return bytes([n])
    first = 252 + (n & 3)
    return bytes([first, (n - first) >> 2])


def packet_samples(packet: bytes) -> int:
    code = packet[0] & 3
    count = 1 if code == 0 else 2 if code in (1, 2) else packet[1] & 0x3F
    return count * frame_samples(packet[0])


def self_delimit(packet: bytes) -> bytes:
    """The self-delimited form of a packet (RFC 6716 Appendix B): the
    framing of every stream but the last of a multistream packet."""
    toc, code = packet[0], packet[0] & 3
    if code == 0:
        return bytes([toc]) + _size_bytes(len(packet) - 1) + packet[1:]
    if code == 1:
        return (bytes([toc]) + _size_bytes((len(packet) - 1) // 2)
                + packet[1:])
    if code == 2:
        s1, p = _size(packet, 1)
        return (bytes([toc]) + packet[1:p]
                + _size_bytes(len(packet) - p - s1) + packet[p:])
    ch = packet[1]
    count, p = ch & 0x3F, 2
    pad = 0
    if ch & 0x40:
        while True:
            b = packet[p]
            p += 1
            pad += b if b < 255 else 254
            if b != 255:
                break
    head = packet[:p]
    if ch & 0x80:                                    # VBR
        sizes = []
        for _ in range(count - 1):
            s, p = _size(packet, p)
            sizes.append(s)
        last = len(packet) - p - pad - sum(sizes)
        return head + packet[len(head):p] + _size_bytes(last) + packet[p:]
    return head + _size_bytes((len(packet) - p - pad) // count) + packet[p:]


# --- Ogg (RFC 3533) ------------------------------------------------------
def _crc_table():
    t = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7) if r & 0x80000000 else r << 1
        t.append(r & 0xFFFFFFFF)
    return t


_CRC = _crc_table()


def ogg_crc(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC[(crc >> 24) ^ b]
    return crc


def ogg_page(packets, granule: int, serial: int, seq: int,
             bos: bool = False, eos: bool = False) -> bytes:
    """One page holding whole packets (each under 255 * 255 bytes)."""
    lacing = bytearray()
    for p in packets:
        lacing += b"\xff" * (len(p) // 255) + bytes([len(p) % 255])
    if len(lacing) > 255:
        raise ValueError("too many packets for one page")
    hdr = bytearray(b"OggS\x00")
    hdr.append((2 if bos else 0) | (4 if eos else 0))
    hdr += struct.pack("<qIII", granule, serial, seq, 0)
    hdr.append(len(lacing))
    page = bytes(hdr) + bytes(lacing) + b"".join(packets)
    crc = ogg_crc(page)
    return page[:22] + struct.pack("<I", crc) + page[26:]


def opus_head(channels: int, pre_skip: int = PRE_SKIP, gain_q8: int = 0,
              family: int = 0, streams: int = 1, coupled: int = None,
              mapping=None) -> bytes:
    head = b"OpusHead" + struct.pack("<BBHIhB", 1, channels, pre_skip,
                                     48000, gain_q8, family)
    if family:
        coupled = channels // 2 if coupled is None else coupled
        mapping = list(range(channels)) if mapping is None else mapping
        head += bytes([streams, coupled] + list(mapping))
    return head


def opus_tags() -> bytes:
    vendor = b"libnyquist tools/opus_stream.py"
    return (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor
            + struct.pack("<I", 0))


def ogg_opus(packets, head: bytes, serial: int, per_page: int = 10,
             lost_pages=()) -> bytes:
    """An Ogg Opus link: the two header pages, then ``per_page`` packets
    a page with the granule of the last sample each page completes. The
    last page's granule is the sample total, so a decoder keeps all but
    the pre-skip. Pages listed in ``lost_pages`` (data pages, from 0) are
    left out, with their sequence numbers, as a lost page would be."""
    out = [ogg_page([head], 0, serial, 0, bos=True),
           ogg_page([opus_tags()], 0, serial, 1)]
    lost = set(lost_pages)
    gran = 0
    n_pages = (len(packets) + per_page - 1) // per_page
    for k in range(n_pages):
        chunk = packets[k * per_page: (k + 1) * per_page]
        gran += sum(packet_samples(p) for p in chunk)
        if k in lost:
            continue
        out.append(ogg_page(chunk, gran, serial, 2 + k,
                            eos=k == n_pages - 1))
    return b"".join(out)


# --- the files -------------------------------------------------------------
def cycle_packets(cases, order, n_packets: int, start: int = 0):
    """Whole cases of ``order`` from its ``start``-th, round and round,
    cut at ``n_packets``. Returns (packets, case index per packet)."""
    pkts, which = [], []
    i = start
    while len(pkts) < n_packets:
        c = order[i % len(order)]
        pkts += cases[c]["packets"]
        which += [c] * len(cases[c]["packets"])
        i += 1
    return pkts[:n_packets], which[:n_packets]


def make_opus_stream(k: int, n_packets: int = 3000, cases=None):
    """Stream ``k`` of ``STREAMS`` as Ogg Opus bytes, and a dict of what
    it holds: channels, the first case and its packet count (decoded
    from a fresh state, they give that case's libopus PCM), packets,
    samples, the pages lost, and the links."""
    cases = read_cases() if cases is None else cases
    spec = {"loss": 0.0, "per_page": 10, "links": 1, **STREAMS[k]}
    ch = spec["channels"]
    pkts, which = cycle_packets(cases, spec["order"], n_packets,
                                spec["start"])
    first = spec["order"][spec["start"]]
    n_first = len(cases[first]["packets"])
    per_page = spec["per_page"]
    head = opus_head(ch)
    n_pages = (len(pkts) + per_page - 1) // per_page
    lost = []
    if spec["loss"]:
        rng = np.random.default_rng(1000 + k)
        safe = (n_first + per_page - 1) // per_page   # keep the first case
        pool = np.arange(safe, n_pages - 1)
        lost = sorted(int(x) for x in rng.choice(
            pool, max(1, int(round(spec["loss"] * n_pages))),
            replace=False))
    if spec["links"] == 1:
        data = ogg_opus(pkts, head, 0x4E590000 + k, per_page, lost)
    else:
        # the second link starts after the first case, half way or later
        cut = -(-max(len(pkts) // 2, n_first) // per_page) * per_page
        if cut >= len(pkts):
            raise ValueError("too few packets for two links")
        data = (ogg_opus(pkts[:cut], head, 0x4E590000 + k, per_page)
                + ogg_opus(pkts[cut:], head, 0x4E591000 + k, per_page))
    info = dict(channels=ch, first_case=first, first_packets=n_first,
                packets=len(pkts), cases=which,
                samples=sum(packet_samples(p) for p in pkts),
                lost_pages=lost, links=spec["links"])
    return data, info


def make_case_file(idx: int, cases=None) -> bytes:
    """One golden case as a whole Ogg Opus file: ``load()`` of it gives
    the case's libopus PCM after the pre-skip."""
    cases = read_cases() if cases is None else cases
    c = cases[idx]
    return ogg_opus(c["packets"], opus_head(c["ch"]), 0x4E5A0000 + idx)


def make_opus_multistream(n_packets: int = 100, silk_case: int = 8,
                          hybrid_case: int = 11, cases=None) -> bytes:
    """A family-1 file of two mono streams, SILK and hybrid, over two
    output channels (one per stream): the streams' packets cycle their
    case, the first self-delimited."""
    cases = read_cases() if cases is None else cases
    a, _ = cycle_packets(cases, (silk_case,), n_packets)
    b, _ = cycle_packets(cases, (hybrid_case,), n_packets)
    if [packet_samples(p) for p in a] != [packet_samples(p) for p in b]:
        raise ValueError("the two cases' frame sizes differ")
    pkts = [self_delimit(x) + y for x, y in zip(a, b)]
    head = opus_head(2, family=1, streams=2, coupled=0, mapping=[0, 1])
    return ogg_opus(pkts, head, 0x4E5B0000)
