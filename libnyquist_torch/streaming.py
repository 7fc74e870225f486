"""Positioned reads and seeks: decode-backed and by byte-range bisection.

The reference's Opus path exposes opusfile's positioned reader —
op_read_float, op_pcm_seek / op_pcm_tell / op_pcm_total, op_raw_total
and link management (reference: third_party/opus/opusfile/src/
opusfile.c:2911 op_read_float, :2400 op_pcm_seek, :2160
op_pcm_seek_page, :1711 op_pcm_total; vorbisfile has the same surface,
vorbisfile.c:2114 ov_read_float / ov_pcm_seek).

* ``StreamReader`` (default) decodes once through ``load()`` on the
  device and positions in the host array it gets back.
* ``StreamReader(lazy=True)`` / ``seek_reader`` picks a lazy reader by
  content: Ogg Opus, Vorbis and FLAC by granule bisection (chained links
  by serial bisection), native FLAC by frame-header bisection, MP3 by a
  frame index, Musepack by its seek table and block walk, WAV PCM by
  O(1) preads. Each seek decodes a bounded window around the target on
  the reader's device (CUDA unless the caller names another), through
  the codec modules ``load()`` uses: an Opus window's CELT frames queue
  on the card and synthesize in one ``flush`` (so through the comb
  kernel), Vorbis, MP3 and Musepack windows synthesize there, and FLAC
  and PCM windows scale and convert there. ``read`` returns host float32
  ``[k, channels]``.

``CountingSource`` counts read calls and bytes (the cost model of
opusfile's op_bisect, opusfile.c:1098); ``net.HTTPSource`` is one.
"""

from __future__ import annotations

import contextlib
import struct
import types
from typing import Optional

import numpy as np
import torch

from .audio_data import AudioData
from .device import resolve_device
from .errors import DecodeError, NyquistError
from .io import load

__all__ = ["StreamReader", "OggSeekReader", "ChainedOggSeekReader",
           "Mp3SeekReader", "FlacSeekReader", "MpcSeekReader",
           "WavSeekReader", "CountingSource", "seek_reader"]


@contextlib.contextmanager
def _malformed(what: str):
    """A window decode that trips an internal path on malformed input
    raises DecodeError, as ``load()`` does."""
    try:
        yield
    except (NyquistError, MemoryError):
        raise
    except Exception as e:
        raise DecodeError(
            f"malformed {what} window: {type(e).__name__}: {e}") from e


def _host(pcm: torch.Tensor, channels: int) -> np.ndarray:
    """A window's samples from the device as host float32 [n, ch]."""
    return np.ascontiguousarray(
        pcm.to(torch.float32).cpu().numpy().reshape(-1, channels))


class _Positioned:
    """The opusfile surface over ``pcm_total`` and a window cache
    (``_buf`` starting at sample ``_buf_start``); subclasses fill the
    cache in ``_decode_window``."""

    def pcm_tell(self) -> int:
        """Current sample offset (op_pcm_tell)."""
        return self._pos

    def pcm_seek(self, offset: int) -> None:
        """Seek to an absolute sample offset (op_pcm_seek)."""
        if offset < 0 or offset > self.pcm_total():
            raise DecodeError("seek out of range")
        self._pos = int(offset)

    def time_tell(self) -> float:
        return self._pos / self.sample_rate

    def time_seek(self, seconds: float) -> None:
        self.pcm_seek(int(round(seconds * self.sample_rate)))

    def read(self, n: int) -> np.ndarray:
        """Read up to n samples -> [k, channels] float32, k <= n; empty
        at end of stream (op_read_float semantics)."""
        if n < 0:
            raise DecodeError("negative read size")
        n = min(n, self.pcm_total() - self._pos)
        if n <= 0:
            return np.zeros((0, self.channel_count), np.float32)
        lo = self._pos - self._buf_start
        if self._buf is None or not (0 <= lo
                                     and lo + n <= self._buf.shape[0]):
            with _malformed(type(self).__name__):
                self._decode_window(self._pos, n)
            lo = self._pos - self._buf_start
        out = self._buf[lo : lo + n]
        self._pos += out.shape[0]
        return out

    def __iter__(self):
        """Iterate fixed 20 ms chunks from the current position."""
        step = max(1, self.sample_rate // 50)
        while True:
            chunk = self.read(step)
            if chunk.shape[0] == 0:
                return
            yield chunk


class StreamReader(_Positioned):
    """Sample-positioned reader over any supported format.

    >>> r = StreamReader("music.opus")
    >>> r.pcm_seek(48000)           # 1 s in
    >>> chunk = r.read(960)         # [960, channels] float32
    """

    def __new__(cls, source, extension: Optional[str] = None,
                lazy: bool = False, device=None):
        if lazy and cls is StreamReader:
            # content dispatch: Ogg (single or chained links), FLAC
            # frame bisection, MP3 frame index
            return seek_reader(source, device=device)
        return super().__new__(cls)

    def __init__(self, source, extension: Optional[str] = None,
                 lazy: bool = False, device=None):
        audio = load(source, extension, device)
        self.sample_rate = audio.sample_rate
        self.channel_count = audio.channel_count
        self._buf = np.asarray(audio.samples, np.float32).reshape(
            -1, audio.channel_count)
        self._buf_start = 0
        self._pos = 0

    def pcm_total(self) -> int:
        """Total samples per channel (op_pcm_total)."""
        return self._buf.shape[0]


# ======================================================================
# Lazy Ogg reader: opusfile-style granule bisection without full decode
# ======================================================================

class CountingSource:
    """Positioned byte source over bytes / a path / a file object,
    counting read operations and bytes (the op_bisect read-cost model:
    opusfile.c:1098 op_bisect_forward_serialno)."""

    def __init__(self, src):
        if isinstance(src, (bytes, bytearray, memoryview)):
            self._buf = bytes(src)
            self._f = None
            self.size = len(self._buf)
        else:
            self._f = open(src, "rb") if isinstance(src, str) else src
            self._f.seek(0, 2)
            self.size = self._f.tell()
            self._buf = None
        self.reads = 0
        self.bytes_read = 0

    def pread(self, off: int, n: int) -> bytes:
        off = max(0, min(off, self.size))
        n = max(0, min(n, self.size - off))
        self.reads += 1
        self.bytes_read += n
        if self._buf is not None:
            return self._buf[off : off + n]
        self._f.seek(off)
        return self._f.read(n)


class _SubSource(CountingSource):
    """A [base, base+size) byte-range view over another source (one
    chained-Ogg link); reads are counted on the parent."""

    def __init__(self, parent, base: int, size: int):
        self.parent = parent
        self.base = base
        self.size = size

    def pread(self, off: int, n: int) -> bytes:
        off = max(0, min(off, self.size))
        n = max(0, min(n, self.size - off))
        return self.parent.pread(self.base + off, n)

    @property
    def reads(self):
        return self.parent.reads

    @property
    def bytes_read(self):
        return self.parent.bytes_read


def _counting(source) -> CountingSource:
    return (source if isinstance(source, CountingSource)
            else CountingSource(source))


_WIN = 128 * 1024         # bisection window (>= 2 max Ogg pages, so a
#                           fresh read at a page start always completes)


def _scan_page(buf: bytes, base: int, serial=None, header_only=False):
    """First complete Ogg page in buf (file offset base); returns
    (granule, serial, start, end, continued, last_complete) or None.
    header_only=True accepts pages whose BODY extends past the buffer
    (bisection probes only need granule + extent, not packets)."""
    pos = 0
    while True:
        idx = buf.find(b"OggS", pos)
        if idx < 0 or idx + 27 > len(buf):
            return None
        ver, htype, gran, ser, seq, _crc, nseg = struct.unpack_from(
            "<BBqIIIB", buf, idx + 4)
        lace_end = idx + 27 + nseg
        if ver != 0:
            pos = idx + 1
            continue
        if lace_end > len(buf):
            return None
        lacing = buf[idx + 27 : lace_end]
        end = lace_end + sum(lacing)
        if not header_only and end > len(buf):
            return None
        if serial is not None and ser != serial:
            pos = end
            continue
        last_complete = len(lacing) > 0 and lacing[-1] < 255
        return (gran, ser, base + idx, base + end,
                bool(htype & 1), last_complete)


class OggSeekReader(_Positioned):
    """opusfile/vorbisfile-style positioned reader over one Ogg Opus,
    Ogg Vorbis or Ogg FLAC link: pcm_total from the tail page,
    pcm_seek by O(log) granule bisection, reads decode a bounded
    window with pre-roll on the reader's device.

    Output matches the full decode to float tolerance (Vorbis to the
    synthesis' rounding; Opus after SETTLE_OPUS of pre-roll, where
    opusfile itself guarantees only 80 ms; FLAC frames are independent,
    so windows are bit-exact)."""

    PREROLL_OPUS = 48000          # bisection target: 1 s before the read
    # an Opus window starts this far before the read: CELT predicts each
    # band energy from the last frame's, so a fresh decoder converges
    # slowly (1 s of pre-roll leaves up to 2.7e-3, 5 s none, on the
    # golden cases' streams; a mode switch resets CELT outright)
    SETTLE_OPUS = 5 * 48000
    # Opus packets kept before SETTLE_OPUS: two of the longest (120 ms)
    _KEEP_GRAN = 16384

    def __init__(self, source, device=None):
        self.device = resolve_device(device)
        self.src = _counting(source)
        head = self.src.pread(0, _WIN)
        page = _scan_page(head, 0)
        if page is None:
            raise DecodeError("not an Ogg stream")
        self.serial = page[1]
        # collect header packets from the first pages
        segs = []
        pkts = []
        off = 0
        need = 3
        while len(pkts) < need:
            buf = self.src.pread(off, _WIN)
            p = _scan_page(buf, off, self.serial)
            if p is None:
                raise DecodeError("truncated Ogg headers")
            gran, _ser, start, end, _cont, _lc = p
            raw = buf[start - off : end - off]
            nseg = raw[26]
            lacing = raw[27 : 27 + nseg]
            body = raw[27 + nseg :]
            o = 0
            for lace in lacing:
                segs.append(body[o : o + lace])
                o += lace
                if lace < 255:
                    pkts.append(b"".join(segs))
                    segs = []
            off = end
            if pkts and pkts[0][:8] == b"OpusHead":
                need = 2
            elif pkts and pkts[0][:5] == b"\x7fFLAC":
                if len(pkts[0]) < 9:
                    raise DecodeError("bad Ogg FLAC first packet")
                # Ogg FLAC mapping: u16 trailing-header count at 7:9
                nhdr = struct.unpack_from(">H", pkts[0], 7)[0]
                if nhdr == 0:
                    raise DecodeError(
                        "Ogg FLAC with unknown header count")
                need = 1 + nhdr
        first = pkts[0]
        if first[:8] == b"OpusHead" and len(first) >= 12:
            self.codec = "opus"
            self.channel_count = first[9]
            self.preskip = struct.unpack_from("<H", first, 10)[0]
            self.sample_rate = 48000
            self.headers = pkts[:2]
        elif first[:7] == b"\x01vorbis" and len(first) >= 16:
            self.codec = "vorbis"
            self.channel_count = first[11]
            self.sample_rate = struct.unpack_from("<I", first, 12)[0]
            self.preskip = 0
            self.headers = pkts[:3]
        elif (first[:5] == b"\x7fFLAC" and first[9:13] == b"fLaC"
              and len(first) >= 51):
            self.codec = "flac"
            info = first[17:51]                 # STREAMINFO body
            self.block_nominal = int.from_bytes(info[2:4], "big")
            self.sample_rate = int.from_bytes(info[10:13], "big") >> 4
            self.channel_count = ((info[12] >> 1) & 0x7) + 1
            self.preskip = 0
            # native-FLAC prefix for windowed decode: fLaC +
            # STREAMINFO with the last-metadata flag set
            self._meta = (b"fLaC" + bytes([first[13] | 0x80])
                          + first[14:51])
            self.headers = []
        else:
            raise DecodeError(
                "lazy reader supports Ogg Opus/Vorbis/FLAC")
        if self.channel_count < 1 or self.sample_rate < 1:
            raise DecodeError("bad Ogg stream header")
        self.data_off = off
        # tail granule -> total
        tail = self.src.pread(max(0, self.src.size - _WIN), _WIN)
        tbase = max(0, self.src.size - _WIN)
        last_gran = None
        o = 0
        while True:
            p = _scan_page(tail[o:], tbase + o, self.serial)
            if p is None:
                break
            if p[0] >= 0:
                last_gran = p[0]
            o = p[3] - tbase
        if last_gran is None:
            raise DecodeError("no tail granule (grow _WIN?)")
        self.end_gran = last_gran
        self._pos = 0
        self._buf = np.zeros((0, self.channel_count), np.float32)
        self._buf_start = 0
        self._cont = None           # an Opus window's (decoder, next page)

    def pcm_total(self) -> int:
        return max(self.end_gran - self.preskip, 0)

    # -- bisection + windowed decode ----------------------------------
    _PROBE = 66 * 1024     # > max Ogg page: a probe always finds the
    #                        next page HEADER in one read

    def _first_page_after(self, off):
        """First serial-matching page header at/after byte off
        (header-only: bisection probes don't need packet bodies)."""
        base = off
        while base < self.src.size:
            buf = self.src.pread(base, self._PROBE)
            p = _scan_page(buf, base, self.serial, header_only=True)
            if p is not None:
                return p
            if len(buf) < self._PROBE:
                return None
            base += self._PROBE - 300   # resync past a foreign header
        return None

    def _bisect(self, target_gran):
        """Byte offset whose next page has granule < target but is
        within ~2 windows of it (op_pcm_seek_page bisection)."""
        lo = self.data_off
        hi = self.src.size
        while hi - lo > 2 * _WIN:
            mid = (lo + hi) // 2
            p = self._first_page_after(mid)
            if p is None or p[0] < 0:
                hi = mid
                continue
            if p[0] < target_gran:
                lo = p[3]
            else:
                hi = mid
        return lo

    def _collect_packets(self, start_off, end_gran_needed, keep_from=-1):
        """Pages from start_off until a page that ends on a packet
        boundary with granule >= end_gran_needed.  Returns (packets,
        first_gran, k0, next_off): the granule of the first page that
        completes a packet, how many packets complete by it — the exact
        position
        anchor (a page's granule is the position of the final sample of
        the last packet completed on it, whether or not another packet
        continues past its end) — and the offset after the last page.
        The tail of a packet begun before the
        first page (a continued page) is dropped: it decodes to nothing,
        and no anchor counts it.  So are the packets of pages whose
        granule is at most keep_from."""
        pkts = []
        segs = []
        skip_tail = None          # the first page decides
        first_gran = None
        k0 = 0
        off = start_off
        buf = b""
        base = start_off
        while off < self.src.size:
            p = None
            if base <= off < base + len(buf):
                p = _scan_page(buf[off - base:], off, self.serial)
            if p is None:
                buf = self.src.pread(off, _WIN)
                base = off
                p = _scan_page(buf, off, self.serial)
                if p is None:
                    break
            gran, _ser, start, end, cont, last_complete = p
            raw = buf[start - base : end - base]
            nseg = raw[26]
            lacing = raw[27 : 27 + nseg]
            body = raw[27 + nseg :]
            if skip_tail is None:
                skip_tail = cont
            o = 0
            ncomplete = 0
            for lace in lacing:
                segs.append(body[o : o + lace])
                o += lace
                if lace < 255:
                    if skip_tail:
                        skip_tail = False
                    else:
                        pkts.append(b"".join(segs))
                        ncomplete += 1
                    segs = []
            off = end
            if gran >= 0 and ncomplete:
                if gran <= keep_from:
                    pkts = []           # all end before the window starts
                    continue
                if first_gran is None:
                    first_gran = gran
                    k0 = len(pkts)
                if gran >= end_gran_needed and last_complete:
                    break
        if first_gran is None:
            raise DecodeError("seek target beyond stream data")
        return pkts, first_gran, k0, off

    def _decode_window(self, pos, n):
        """Bisect + decode a window covering [pos, pos+n). A window that
        starts after pos (Opus: less than SETTLE_OPUS before it; or the
        page bisected to continues a packet begun before it) starts one
        probe earlier; an Opus window's start is known before it
        decodes. An Opus read that ends past the last window and starts
        in it, or at most SETTLE_OPUS after it, continues that window's
        decoder instead."""
        opus = self.codec == "opus"
        end_needed = min(pos + n + self.preskip, self.end_gran)
        if opus and self._cont is not None:
            dec, next_off = self._cont
            end = self._buf_start + self._buf.shape[0]
            if self._buf_start <= pos <= end + self.SETTLE_OPUS:
                pkts, _, _, next_off = self._collect_packets(
                    next_off, end_needed)
                head = self._buf[pos - self._buf_start:]
                self._opus_decode(dec, pkts, end, end, next_off)
                if head.shape[0]:           # the read began in the window
                    self._buf = np.concatenate([head, self._buf])
                    self._buf_start = pos
                return
        settle = self.SETTLE_OPUS if opus else 0
        target = pos + self.preskip
        preroll = self.PREROLL_OPUS if opus else 0
        start_off = self._bisect(max(target - preroll, 0))
        # an Opus window decodes from SETTLE_OPUS before the read, not from
        # where the bisection stopped (up to two windows of bytes back:
        # tens of seconds at a low bitrate, decoded packet by packet)
        keep_from = target - settle - self._KEEP_GRAN if opus else -1
        while True:
            pkts, first_gran, k0, next_off = self._collect_packets(
                start_off, end_needed, keep_from)
            at_start = start_off <= self.data_off
            if opus:
                durs = self._opus_durations(pkts)
                # anchor: the first completed page's granule = final-sample
                # position of packet k0-1 -> window start position
                start = first_gran - int(np.sum(durs[:k0])) - self.preskip
                if start <= pos - settle or at_start:
                    from .formats.opus.decoder import OpusDecoder

                    # from the stream's first packet every sample is the
                    # full decode's; else from SETTLE_OPUS on
                    settled = (start if start <= -self.preskip
                               else min(start + settle, pos))
                    dec = OpusDecoder(self.channel_count, device=self.device)
                    self._opus_decode(dec, pkts, start, settled, next_off)
                    return
            else:
                self._buf, self._buf_start = self._decode_packets(
                    pkts, first_gran, k0)
                if self._buf_start <= pos or at_start:
                    return
            start_off = max(self.data_off, start_off - self._PROBE)

    def _decode_packets(self, pkts, first_gran, k0):
        """A Vorbis or FLAC window's packets -> (pcm [k, ch] on the host,
        the stream position of its first sample)."""
        if self.codec == "flac":
            from .formats import flac as Fl

            body = [pk for pk in pkts if pk and pk[0] == 0xFF]
            if not body:
                raise DecodeError("no FLAC frame in Ogg window")
            a = AudioData()
            Fl.decode_flac_buffer(self._meta + b"".join(body), a,
                                  self.device)
            # FLAC frames self-describe their position: anchor on the
            # first frame's coded sample/frame number
            got = _flac_parse_header(body[0], 0, self.block_nominal)
            if got is None:
                raise DecodeError("bad FLAC frame in Ogg window")
            return (np.asarray(a.samples, np.float32).reshape(
                -1, self.channel_count), got[0])
        pcm, durs = self._vorbis_window(pkts)
        lead = int(np.sum(durs[:k0]))
        return pcm, first_gran - lead - self.preskip

    @staticmethod
    def _opus_durations(pkts):
        """Samples each packet decodes to (0 for an empty one)."""
        from .formats.opus.packet import parse_packet

        durs = []
        for pk in pkts:
            if pk:
                pr = parse_packet(pk)
                durs.append(pr.frame_size * len(pr.frames))
            else:
                durs.append(0)
        return durs

    def _opus_decode(self, dec, pkts, start, settled, next_off):
        """Push the packets into ``dec`` and flush once, so the queued
        CELT frames synthesize on the device together (not one synthesis
        per packet); their samples start at ``start``. Only those from
        ``settled`` on are kept: a later read in the pre-roll would get
        samples the decoder had not settled on."""
        self._cont = None
        for pk in pkts:
            if pk:
                dec.push_packet(pk)
        pcm = _host(dec.flush(), self.channel_count)
        self._buf, self._buf_start = pcm[settled - start:], settled
        self._cont = (dec, next_off)

    def _vorbis_window(self, pkts):
        """The window's packets behind the stream's headers through the
        host decode and the device synthesis, window-relative (no end
        trim); per-packet durations from the mode blockflags."""
        from .formats import vorbis as V

        st = types.SimpleNamespace(
            packets=[types.SimpleNamespace(data=d)
                     for d in self.headers + pkts],
            last_granule=-1)
        staged, bss, ch, _rate, _end = V._decode_stream_packets(st)
        pcm = _host(V.synthesize_link(staged, bss, ch, -1, self.device), ch)
        # per-packet output lengths from the mode blockflags (the setup
        # cache was just populated by the decode)
        idh = self.headers[0]
        b = V.LsbBits(idh[7:])
        b.read(32 + 8 + 32 + 96)
        bs = (1 << b.read(4), 1 << b.read(4))
        modes = V._SETUP_CACHE[(hash(self.headers[2]),
                                self.channel_count)][4]
        mode_bits = V.ilog(len(modes) - 1)

        def pk_n(d):
            bb = V.LsbBits(d)
            if bb.read1():
                raise DecodeError("not an audio packet")
            return bs[modes[bb.read(mode_bits)][0]]

        ns = [pk_n(d) for d in pkts if d]
        durs = [0] + [(ns[j - 1] + ns[j]) // 4 for j in range(1, len(ns))]
        return pcm, durs


# ======================================================================
# MP3: frame-index walk + windowed re-decode
# ======================================================================

class Mp3SeekReader(_Positioned):
    """Positioned reader over an MP3 stream without keeping the decode.

    MP3 carries no timestamps, so exact positioning needs a frame
    index: one buffered header walk (headers only — payload bytes are
    skipped by the frame-length arithmetic, so the scan is one
    sequential pass of cheap reads, built lazily on first use).  Seeks
    then decode a bounded window starting PREROLL frames early: the
    bit reservoir reaches <= 511 bytes back and the IMDCT/polyphase
    state converges within a frame, so the window is bit-identical to
    the full decode from the target frame on (frames the reservoir
    can't satisfy emit nothing; the anchor arithmetic accounts for
    them).  Layers I/II have no reservoir and converge immediately."""

    PREROLL = 10            # frames (minimp3-style safety margin)

    def __init__(self, source, device=None):
        from .formats import mp3 as M

        self.device = resolve_device(device)
        self._M = M
        self.src = _counting(source)
        head = self.src.pread(0, 64 * 1024)
        off = 0
        if head[:3] == b"ID3" and len(head) >= 10:      # skip ID3v2
            sz = ((head[6] & 0x7F) << 21) | ((head[7] & 0x7F) << 14) \
                | ((head[8] & 0x7F) << 7) | (head[9] & 0x7F)
            off = 10 + sz
            head = self.src.pread(off, 64 * 1024)
        i = self._find_header(head)
        if i is None:
            raise DecodeError("no MP3 frame header found")
        h = head[i : i + 4]
        if M.hdr_is_free_format(h):
            raise DecodeError("free-format MP3 not seekable")
        self._first_off = off + i
        self.sample_rate = M.hdr_sample_rate_hz(h)
        self.channel_count = 1 if M.hdr_is_mono(h) else 2
        self.spf = M.hdr_frame_samples(h)
        self._offs = None              # lazy frame index
        self._pos = 0
        self._buf = np.zeros((0, self.channel_count), np.float32)
        self._buf_start = 0

    def _find_header(self, buf, start=0):
        M = self._M
        i = start
        while True:
            i = buf.find(b"\xff", i)
            if i < 0 or i + 4 > len(buf):
                return None
            h = buf[i : i + 4]
            if M.hdr_valid(h) and not M.hdr_is_free_format(h):
                return i
            i += 1

    def _index(self):
        if self._offs is not None:
            return self._offs
        M = self._M
        offs = []
        off = self._first_off
        CHUNK = 256 * 1024
        buf = b""
        base = off
        while off + 4 <= self.src.size:
            if not (base <= off and off + 4 <= base + len(buf)):
                buf = self.src.pread(off, CHUNK)
                base = off
                if len(buf) < 4:
                    break
            h = buf[off - base : off - base + 4]
            if M.hdr_valid(h) and not M.hdr_is_free_format(h):
                offs.append(off)
                off += M.hdr_frame_bytes(h, 0) + M.hdr_padding(h)
            else:                       # resync
                j = self._find_header(buf, off - base + 1)
                if j is None:
                    if len(buf) < CHUNK:
                        break
                    off = base + len(buf) - 3
                else:
                    off = base + j
        if not offs:
            raise DecodeError("no MP3 frames indexed")
        self._offs = offs
        return offs

    def pcm_total(self) -> int:
        return len(self._index()) * self.spf

    def _decode_window(self, pos, n):
        offs = self._index()
        k = pos // self.spf
        j0 = max(k - self.PREROLL, 0)
        j1 = min(k + (n + self.spf - 1) // self.spf + 2, len(offs))
        end_off = offs[j1] if j1 < len(offs) else self.src.size
        raw = self.src.pread(offs[j0], end_off - offs[j0])
        a = AudioData()
        self._M.decode_mp3_buffer(raw, a, self.device)
        pcm = np.asarray(a.samples, np.float32).reshape(
            -1, a.channel_count)
        # reservoir-starved leading frames emit nothing: anchor by the
        # emitted length (every emitted frame is exactly spf samples)
        dropped = (j1 - j0) - pcm.shape[0] // self.spf
        buf_start = (j0 + dropped) * self.spf
        if j0 == 0 and buf_start > pos:
            # a mid-stream rip whose FIRST frame needs reservoir bytes
            # that never existed: those lead samples exist in no decode
            # (the full decode drops them too) — surface silence there
            # rather than mis-sliced audio
            pad = np.zeros((buf_start - pos, pcm.shape[1]), np.float32)
            pcm = np.concatenate([pad, pcm], axis=0)
            buf_start = pos
        self._buf = pcm
        self._buf_start = buf_start


# ======================================================================
# FLAC: frame-header bisection (frames are independent)
# ======================================================================

def _flac_crc8(buf: bytes) -> int:
    c = 0
    for x in buf:
        c ^= x
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def _flac_parse_header(buf, i, block_nominal):
    """Validated FLAC frame header at buf[i] -> (sample_pos, i) or
    None (CRC-8 gates false syncs)."""
    if i + 16 > len(buf):
        return None
    if not (buf[i] == 0xFF and (buf[i + 1] & 0xFC) == 0xF8):
        return None
    variable = buf[i + 1] & 1
    j = i + 4
    b0 = buf[j]
    if b0 < 0x80:
        nb, num = 1, b0
    else:
        nb, t = 0, b0
        while t & 0x80:
            nb += 1
            t = (t << 1) & 0xFF
        if nb < 2 or nb > 7 or j + nb > len(buf):
            return None
        num = b0 & (0x7F >> nb)
        for k in range(1, nb):
            if (buf[j + k] & 0xC0) != 0x80:
                return None
            num = (num << 6) | (buf[j + k] & 0x3F)
    j += nb
    bs_code = buf[i + 2] >> 4
    if bs_code == 6:
        j += 1
    elif bs_code == 7:
        j += 2
    sr_code = buf[i + 2] & 0xF
    if sr_code == 12:
        j += 1
    elif sr_code in (13, 14):
        j += 2
    if j >= len(buf):
        return None
    if _flac_crc8(buf[i : j]) != buf[j]:
        return None
    sample = num if variable else num * block_nominal
    return sample, i


class FlacSeekReader(_Positioned):
    """Positioned reader over native FLAC: O(log) byte bisection on
    frame headers (each header carries its coded frame/sample number
    and a CRC-8 that validates the probe), then a windowed decode of
    the target frames.  FLAC frames are fully independent, so windows
    are bit-identical to the full decode — no pre-roll needed."""

    _PROBE = 64 * 1024

    def __init__(self, source, device=None):
        self.device = resolve_device(device)
        self.src = _counting(source)
        head = self.src.pread(0, 64 * 1024)
        if head[:4] != b"fLaC":
            raise DecodeError("not native FLAC")
        pos = 4
        info = None
        while pos + 4 <= len(head):
            hdr = head[pos]
            ln = int.from_bytes(head[pos + 1 : pos + 4], "big")
            if (hdr & 0x7F) == 0:
                info = head[pos + 4 : pos + 4 + ln]
            pos += 4 + ln
            if hdr & 0x80:
                break
        if info is None or len(info) < 18:
            raise DecodeError("FLAC STREAMINFO missing")
        self._meta = bytes(head[:pos])
        self.data_off = pos
        self.block_nominal = int.from_bytes(info[2:4], "big")  # max
        self.sample_rate = int.from_bytes(info[10:13], "big") >> 4
        self.channel_count = ((info[12] >> 1) & 0x7) + 1
        self.total = ((info[13] & 0xF) << 32) | int.from_bytes(
            info[14:18], "big")
        self._pos = 0
        self._buf = np.zeros((0, self.channel_count), np.float32)
        self._buf_start = 0

    # -- frame probe ---------------------------------------------------
    def _parse_header(self, buf, i):
        return _flac_parse_header(buf, i, self.block_nominal)

    def _first_frame_after(self, off):
        """(sample_pos, file_off) of the first valid frame header at or
        after byte off."""
        base = max(off, self.data_off)
        while base < self.src.size:
            buf = self.src.pread(base, self._PROBE)
            i = 0
            while True:
                i = buf.find(b"\xff", i)
                if i < 0 or i + 16 > len(buf):
                    break
                got = self._parse_header(buf, i)
                if got is not None:
                    return got[0], base + i
                i += 1
            if base + len(buf) >= self.src.size:
                return None
            base += self._PROBE - 32
        return None

    def pcm_total(self) -> int:
        return self.total

    def _last_frame_start(self, raw: bytes) -> int:
        """Offset of the last valid frame header after the first in raw
        (the end of raw's whole frames), or len(raw) when there is none.
        A header needs 16 bytes to validate: a sync pattern closer to the
        end than that cuts there unvalidated."""
        i = len(raw)
        while True:
            i = raw.rfind(b"\xff", 1, i)
            if i < 1:
                return len(raw)
            if i + 16 > len(raw):
                if i + 1 == len(raw) or (raw[i + 1] & 0xFC) == 0xF8:
                    return i
            elif self._parse_header(raw, i) is not None:
                return i

    def _decode_window(self, pos, n):
        from .formats import flac as F

        # bisect to the last frame starting at/before pos
        lo, hi = self.data_off, self.src.size
        while hi - lo > 2 * self._PROBE:
            mid = (lo + hi) // 2
            got = self._first_frame_after(mid)
            if got is None:
                hi = mid
            elif got[0] <= pos:
                lo = got[1]
                if lo <= mid:           # no forward progress past mid
                    break
            else:
                hi = mid
        got = self._first_frame_after(lo)
        if got is None or got[0] > pos:
            got = self._first_frame_after(self.data_off)
        if got is None:
            raise DecodeError("no FLAC frame found for seek target")
        start_sample, start_off = got
        # decode frames covering [pos, pos+n) via a synthetic
        # container. A read that ends inside a frame is cut back to the
        # last whole frame (the decoder raises on a cut frame); the
        # window grows on a short decode, or on a decode that raises
        # anyway (a false sync where the cut was made)
        need_end = min(pos + n, self.total)
        est = (need_end - start_sample + self.block_nominal) * \
            self.channel_count * 4 + 64 * 1024
        while True:
            raw = self.src.pread(start_off, int(est))
            at_eof = start_off + len(raw) >= self.src.size
            if not at_eof:
                raw = raw[: self._last_frame_start(raw)]
            a = AudioData()
            try:
                F.decode_flac_buffer(self._meta + raw, a, self.device)
            except DecodeError:
                if at_eof:
                    raise
                est *= 2
                continue
            pcm = np.asarray(a.samples, np.float32).reshape(
                -1, a.channel_count)
            if start_sample + pcm.shape[0] >= need_end or at_eof:
                break
            est *= 2
        self._buf = pcm
        self._buf_start = start_sample


class ChainedOggSeekReader(_Positioned):
    """Chained Ogg (multiple sequential links with distinct serials):
    the opusfile surface across links.  Link boundaries are discovered
    by serial bisection (op_bisect_forward_serialno, opusfile.c:1098)
    — O(links * log size) reads, no full scan — then each link gets
    its own OggSeekReader over a byte-range view.  Reads stitch across
    links like op_read_float does; links must share channel count and
    sample rate (ov_read/op_read surface the same way).  Per RFC 3533
    chained links carry DISTINCT serials; a same-serial concatenation
    (spec-invalid) is not separable by bisection — use the
    decode-backed StreamReader for those."""

    def __init__(self, source, device=None):
        self.device = resolve_device(device)
        self.src = _counting(source)
        bounds = self._discover_links()
        self.links = [OggSeekReader(_SubSource(self.src, b0, b1 - b0),
                                    self.device)
                      for b0, b1 in bounds]
        r0 = self.links[0]
        self.channel_count = r0.channel_count
        self.sample_rate = r0.sample_rate
        for r in self.links[1:]:
            if (r.channel_count != r0.channel_count
                    or r.sample_rate != r0.sample_rate):
                raise DecodeError("chained links disagree on format")
        self._starts = []
        total = 0
        for r in self.links:
            self._starts.append(total)
            total += r.pcm_total()
        self._total = total
        self._pos = 0

    def _first_page_any(self, off):
        """(serial, page_start, page_end) of the first page header at
        or after off (any serial; header-only probe)."""
        base = off
        while base < self.src.size:
            buf = self.src.pread(base, 66 * 1024)
            p = _scan_page(buf, base, None, header_only=True)
            if p is not None:
                return p[1], p[2], p[3]
            if len(buf) < 66 * 1024:
                return None
            base += 66 * 1024 - 300
        return None

    def _discover_links(self):
        bounds = []
        start = 0
        while start < self.src.size:
            first = self._first_page_any(start)
            if first is None:
                break
            serial = first[0]
            start = first[1]
            # bisect for the first page with a DIFFERENT serial
            lo, hi = start, self.src.size
            boundary = self.src.size
            while hi - lo > _WIN:
                mid = (lo + hi) // 2
                p = self._first_page_any(mid)
                if p is None:
                    hi = mid
                elif p[0] == serial:
                    lo = p[2]
                else:
                    boundary = min(boundary, p[1])
                    hi = p[1]
            # linear finish inside the last window
            off = lo
            while off < boundary:
                p = self._first_page_any(off)
                if p is None:
                    break
                if p[0] != serial:
                    boundary = p[1]
                    break
                off = p[2]
            bounds.append((start, boundary))
            start = boundary
        if not bounds:
            raise DecodeError("no Ogg links found")
        return bounds

    def pcm_total(self) -> int:
        return self._total

    def read(self, n: int) -> np.ndarray:
        if n < 0:
            raise DecodeError("negative read size")
        out = []
        got = 0
        while got < n and self._pos < self._total:
            li = 0
            for i, s in enumerate(self._starts):
                if self._pos >= s:
                    li = i
            r = self.links[li]
            local = self._pos - self._starts[li]
            r.pcm_seek(min(local, r.pcm_total()))
            chunk = r.read(n - got)
            if chunk.shape[0] == 0:
                break
            out.append(chunk)
            got += chunk.shape[0]
            self._pos += chunk.shape[0]
        if not out:
            return np.zeros((0, self.channel_count), np.float32)
        return np.concatenate(out, axis=0)


class MpcSeekReader(_Positioned):
    """Positioned reader over Musepack SV8/SV7 with real seek-table
    use and decode warm-up (mpc_demux.c:651 mpc_demux_seek_sample).

    SV8: AP blocks start with a key frame, so entropy decode from any
    block boundary is exact.  Seeks jump through the stream's ST seek
    table when present (reached via the SO pointer block,
    mpc_demux.c:324 mpc_demux_SP + :274 mpc_demux_ST: golomb-coded
    second-order offset deltas), then walk block headers to the target
    — the reference's exact flow.  On top of that we warm the
    synthesis filterbank with one extra AP block (>= 1152 samples >
    the 512-tap polyphase memory), so seeked reads equal a linear
    decode; libmpcdec itself re-uses stale filter state and only
    absorbs it in the 481-sample synthesis delay.

    SV7: frames chain scalefactors by DPCM and are not key frames; the
    reference backs up 32 frames and resets the SCF indices to the
    0x01010101 pattern so un-refreshed bands clamp to near-silence
    (mpc_demux.c:664 fwd -= 32, mpc_decoder.c:85 mpc_decoder_reset_scf)
    — mirrored here, including the 20-bit frame-size walk
    (mpc_demux.c:712 fpos += bits_read(20) + 20).  We warm up 64
    frames instead of the reference's 32: 32 still leaves scf drift on
    the SV7 fixture, and the extra 32 entropy-only frames are cheap.

    The entropy decode runs in the native frame reader; the requantize
    and synthesis of a window run on the reader's device in float64, as
    in ``load()``."""

    _WARMUP_SV7 = 64            # frames (2x mpc_demux.c:665)

    def __init__(self, source, device=None):
        from .formats import musepack as M

        self.device = resolve_device(device)
        self._M = M
        self.src = _counting(source)
        magic = self.src.pread(0, 4)
        self._pos = 0
        self._buf = None
        self._buf_start = 0
        if magic == b"MPCK":
            self._sv7 = False
            self._init_sv8()
        elif magic[:3] == b"MP+":
            self._sv7 = True
            self._init_sv7()
        else:
            raise DecodeError("not a musepack stream")

    # -- SV8 container ------------------------------------------------
    def _read_block_header(self, off):
        """(key, total_size, body_off) of the block at byte off."""
        hdr = self.src.pread(off, 11)
        if len(hdr) < 3:
            return None
        key = hdr[:2]
        size = 0
        p = 2
        while True:
            if p >= len(hdr):
                return None
            b = hdr[p]
            size = (size << 7) | (b & 0x7F)
            p += 1
            if not b & 0x80:
                break
        if size < p:
            raise DecodeError("mpc: bad block size")
        return key, size, off + p

    def _init_sv8(self):
        M = self._M
        self.beg_silence = 0
        self._ap = {}               # ap index -> (body_off, body_len)
        self._cursors = [(4, 0)]    # (block offset, AP index there)
        self._st = None             # seek table: list of block offsets
        self._seek_pwr = 0
        st_off = None
        st_body = None
        off = 4
        sh = None
        while True:
            got = self._read_block_header(off)
            if got is None:
                raise DecodeError("no MPC stream header found")
            key, size, body_off = got
            if key == b"AP":
                self._cursors = [(off, 0)]
                break
            body = self.src.pread(body_off, size - (body_off - off))
            if key == b"SH":
                sh = body
            elif key == b"SO":
                ptr, _ = M._read_varint(body, 0)
                st_off = off + ptr
            elif key == b"ST":
                st_body = body           # parsed after SH (needs
                #                          block_pwr)
            elif key == b"SE":
                raise DecodeError("MPC stream ends before audio")
            off += size
        if sh is None:
            raise DecodeError("no MPC stream header found")
        br = M._Bits(sh)
        br.read(32)                          # CRC
        if br.read(8) != 8:
            raise DecodeError("unsupported MPC stream version")
        self.total_samples, p = M._read_varint(sh, br.pos // 8)
        self.beg_silence, p = M._read_varint(sh, p)
        br.pos = p * 8
        self.sample_rate = M._SAMPLE_FREQS[br.read(3)]
        if not self.sample_rate:
            raise DecodeError("mpc: bad sample rate")
        self.max_band = br.read(5) + 1
        if self.max_band > 31:
            raise DecodeError("mpc: max_band out of range")
        self.channel_count = br.read(4) + 1
        if self.channel_count > 2:
            raise DecodeError("mpc: more than two channels")
        self.ms = bool(br.read(1))
        self.block_pwr = br.read(3) * 2
        if st_body is not None:
            self._parse_st(st_body)
        elif st_off is not None:
            got = self._read_block_header(st_off)
            if got is not None and got[0] == b"ST":
                body = self.src.pread(got[2], got[1] - (got[2] - st_off))
                self._parse_st(body)
        if self._st:
            shift = self._seek_pwr - self.block_pwr
            self._cursors += [(o, i << shift)
                              for i, o in enumerate(self._st)]

    def _parse_st(self, body):
        """mpc_demux.c:274 mpc_demux_ST — entries are bit offsets,
        first two varint-coded, the rest golomb(12) second-order
        deltas in 4-bit units.  (We keep the full-resolution table;
        the reference additionally downsamples it past
        MAX_SEEK_TABLE_SIZE entries to bound its malloc.)"""
        br = self._M._Bits(body)

        def bvar():
            v = 0
            while True:
                if br.pos >= br.limit:
                    raise DecodeError("mpc: bad seek table")
                b = br.read(8)
                v = (v << 7) | (b & 0x7F)
                if not b & 0x80:
                    return v

        def golomb12():
            l = 0
            while br.read(1) == 0:
                l += 1
                if l > 64:
                    raise DecodeError("mpc: bad seek table")
            return (l << 12) | br.read(12)

        n = bvar()
        if n > len(body) * 8 or n > 1 << 24:
            raise DecodeError("mpc: bad seek table")
        self._seek_pwr = self.block_pwr + br.read(4)
        if n == 0:
            self._st = []
            return
        last = [bvar() * 8, 0]
        bits = [last[0]]
        if n > 1:
            last[1] = bvar() * 8
            bits.append(last[1])
        for i in range(2, n):
            code = golomb12()
            if code & 1:
                code = -(code & ~1)
            code <<= 2
            last[i & 1] = code + 2 * last[(i - 1) & 1] - last[i & 1]
            bits.append(last[i & 1])
        if any(b % 8 or b < 0 for b in bits):
            raise DecodeError("mpc: bad seek table")
        self._st = [b // 8 for b in bits]

    @property
    def _block_samples(self):
        return self._M.FRAME_LENGTH << self.block_pwr

    def _frames_total(self):
        M = self._M
        return -(-(self.total_samples + M.SYNTH_DELAY) // M.FRAME_LENGTH)

    def _ap_frames(self, idx):
        n_block = 1 << self.block_pwr
        done = idx * n_block
        return max(0, min(n_block, self._frames_total() - done))

    def _ensure_ap(self, idx):
        """Walk block headers (from the best cursor at or before idx)
        until AP block idx is cached."""
        if idx in self._ap:
            return
        off, ap_i = max((c for c in self._cursors if c[1] <= idx),
                        key=lambda c: c[1])
        while ap_i <= idx:
            got = self._read_block_header(off)
            if got is None:
                raise DecodeError("mpc: seek past end of stream")
            key, size, body_off = got
            if key == b"AP":
                self._ap[ap_i] = (body_off, size - (body_off - off))
                ap_i += 1
                self._cursors.append((off + size, ap_i))
            elif key == b"SE":
                raise DecodeError("mpc: seek past end of stream")
            off += size

    # -- SV7 container ------------------------------------------------
    def _init_sv7(self):
        M = self._M
        data = self.src.pread(0, self.src.size)
        if len(data) < 32:
            raise DecodeError("mpc: truncated SV7 header")
        if (data[3] & 15) != 7:
            raise DecodeError(
                f"unsupported MPC SV{data[3] & 15} stream")
        body = data[4:]
        body += b"\x00" * ((-len(body)) % 4)
        arr = np.frombuffer(body, np.uint8).reshape(-1, 4)[:, ::-1]
        self._bits = arr.tobytes()
        br = M._Bits(self._bits)
        frames = (br.read(16) << 16) | br.read(16)
        br.read(1)
        self.ms = bool(br.read(1))
        self.max_band = br.read(6)
        if self.max_band > 31:
            raise DecodeError("mpc: max_band out of range")
        br.read(6)                           # profile + link
        self.sample_rate = M._SAMPLE_FREQS[br.read(2)]
        for _ in range(5):
            br.read(16)
        is_true_gapless = br.read(1)
        last_frame_samples = br.read(11) or M.FRAME_LENGTH
        br.read(20)                          # fast seek + reserved
        br.read(8)                           # encoder version
        self.channel_count = 2
        self.beg_silence = 0
        self.block_pwr = 0
        si = frames * M.FRAME_LENGTH
        if is_true_gapless:
            si -= M.FRAME_LENGTH - last_frame_samples
        else:
            si -= M.SYNTH_DELAY
        # the linear decode can emit at most frames*1152 - 481 samples
        # (synthesis latency); a gapless tail longer than 1152-481
        # truncates there, exactly as the facade's span accounting does
        self.total_samples = min(si,
                                 frames * M.FRAME_LENGTH - M.SYNTH_DELAY)
        self._n_frames7 = frames
        self._fidx = [br.pos]                # bit offset of frame k's
        #                                      20-bit size field

    def _ensure_frame7(self, k):
        br = self._M._Bits(self._bits)
        while len(self._fidx) <= k and len(self._fidx) <= self._n_frames7:
            br.pos = self._fidx[-1]
            size = br.read(20)               # mpc_demux.c:712
            self._fidx.append(self._fidx[-1] + 20 + size)
            if self._fidx[-1] > len(self._bits) * 8:
                raise DecodeError("mpc: seek past end of stream")

    def pcm_total(self) -> int:
        return max(0, self.total_samples - self.beg_silence)

    # -- windowed decode ----------------------------------------------
    def _synth_frames(self, ys):
        """Entropy frames -> pcm [F*1152, ch] float32: the batched
        requantize on the host, the synthesis on the device in float64
        (as ``load()``)."""
        M = self._M
        if not ys:
            raise DecodeError("mpc: empty seek window")
        Y = torch.from_numpy(M._rows(ys, self.max_band,
                                     self.channel_count)).to(self.device)
        return _host(M.synth_rows(Y).T, self.channel_count)

    def _decode_window(self, pos, n):
        M = self._M
        if self._sv7:
            self._decode_window_sv7(pos, n)
            return
        BS = self._block_samples
        dest = pos + self.beg_silence
        fwd = dest // BS                     # mpc_demux.c:662
        first = max(0, fwd - 1)              # warm-up block
        last = min((dest + n + M.SYNTH_DELAY) // BS,
                   -(-self._frames_total() // (1 << self.block_pwr)) - 1)
        dec = M.MusepackDecoder(self.max_band, self.ms,
                                self.channel_count)
        ys = []
        for b in range(first, last + 1):
            self._ensure_ap(b)
            body_off, body_len = self._ap[b]
            br = M._Bits(self.src.pread(body_off, body_len))
            nf = self._ap_frames(b)
            q_s, res_s, scf_s, ms_s = dec.read_block_native(
                br, nf, key_first=True)
            for f in range(nf):
                ys.append((q_s[f], res_s[f], scf_s[f], ms_s[f]))
            if br.pos > br.limit:
                raise DecodeError("MPC bitstream overrun")
        self._buf = self._synth_frames(ys)
        # window sample j = stream sample first*BS + j; output sample o
        # = stream o + SYNTH_DELAY + beg_silence
        self._buf_start = first * BS - M.SYNTH_DELAY - self.beg_silence

    def _decode_window_sv7(self, pos, n):
        M = self._M
        fwd = pos // M.FRAME_LENGTH
        warm = min(fwd, self._WARMUP_SV7)
        first = fwd - warm
        last = min((pos + n + M.SYNTH_DELAY) // M.FRAME_LENGTH,
                   self._n_frames7 - 1)
        self._ensure_frame7(last)
        dec = M.MusepackDecoder(self.max_band, self.ms, 2)
        if first != 0:
            # mpc_decoder_reset_scf(d, fwd != 0): memset to 0x01 bytes;
            # DPCM continuations then blow past 1024 and clamp to
            # 0x8080 -> SCF[0x80], near-silence instead of garbage
            for ch in range(2):
                dec.scf_index[ch][:] = 0x01010101
        br = M._Bits(self._bits)
        br.pos = self._fidx[first]
        ys = []
        for _ in range(first, last + 1):
            br.read(20)                      # frame bit-size field
            dec.read_frame_sv7(br)
            ys.append(dec.requantize())
            if br.pos > br.limit:
                raise DecodeError("MPC SV7 bitstream overrun")
        self._buf = self._synth_frames(ys)
        self._buf_start = first * M.FRAME_LENGTH - M.SYNTH_DELAY


class WavSeekReader(_Positioned):
    """Lazy positioned reader over RIFF WAV PCM/IEEE-float: sample
    positions map linearly onto the data chunk, so every seek is an
    O(1) pread with no decoder state; the raw samples convert on the
    reader's device.  Block-coded WAV (IMA-ADPCM) falls back to the
    decode-backed StreamReader in seek_reader()."""

    def __init__(self, source, device=None):
        from .audio_data import PCMFormat
        from .formats import wav as W

        self.device = resolve_device(device)
        self.src = _counting(source)
        head = self.src.pread(0, 12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise DecodeError("not a RIFF WAV stream")
        # lazy chunk walk: 8-byte headers only
        off = 12
        fmt = None
        self.data_off = self.data_size = 0
        while off + 8 <= self.src.size:
            hdr = self.src.pread(off, 8)
            cid = hdr[:4]
            size = struct.unpack_from("<I", hdr, 4)[0]
            if cid == b"fmt ":
                fmt = self.src.pread(off + 8, min(size, 40))
            elif cid == b"data":
                self.data_off = off + 8
                self.data_size = min(size, self.src.size - off - 8)
                if fmt is not None:
                    break
            off += 8 + size + (size & 1)
        if fmt is None or len(fmt) < 16 or not self.data_off:
            raise DecodeError("WAV fmt/data chunk missing")
        (wformat, ch, rate, _dr, frame_size, bits) = struct.unpack_from(
            "<HHIIHH", fmt, 0)
        if wformat == W.FORMAT_EXT and len(fmt) >= 26:
            wformat = struct.unpack_from("<H", fmt, 24)[0]
        if wformat not in (W.FORMAT_PCM, W.FORMAT_IEEE):
            raise DecodeError("lazy WAV reader handles PCM/float only")
        if ch < 1 or frame_size < 1 or rate < 1:
            raise DecodeError("bad WAV fmt chunk")
        self.channel_count = ch
        self.sample_rate = rate
        self.frame_size = frame_size
        ieee = wformat == W.FORMAT_IEEE
        self.fmt = {
            8: PCMFormat.PCM_U8, 16: PCMFormat.PCM_16,
            24: PCMFormat.PCM_24,
            32: PCMFormat.PCM_FLT if ieee else PCMFormat.PCM_32,
            64: PCMFormat.PCM_DBL if ieee else PCMFormat.PCM_64,
        }.get(bits)
        if self.fmt is None or frame_size != ch * (bits // 8):
            raise DecodeError("unsupported WAV sample layout")
        self._pos = 0

    def pcm_total(self) -> int:
        return self.data_size // self.frame_size

    def read(self, n: int) -> np.ndarray:
        from .ops import pcm as pcm_ops

        if n < 0:
            raise DecodeError("negative read size")
        n = min(n, self.pcm_total() - self._pos)
        if n <= 0:
            return np.zeros((0, self.channel_count), np.float32)
        raw = self.src.pread(self.data_off + self._pos * self.frame_size,
                             n * self.frame_size)
        out = _host(pcm_ops.convert_buffer_to_float32(
            raw, self.fmt, self.device), self.channel_count)
        self._pos += out.shape[0]
        return out


def seek_reader(source, device=None):
    """Factory: the right lazy seek reader for the content (Ogg
    Opus/Vorbis/FLAC bisection incl. chained links, FLAC frame
    bisection, MP3 frame index, Musepack seek-table blocks, WAV O(1)
    preads), decoding on ``device``.  Content without a lazy path
    (IMA-ADPCM WAV, AIFF/CAF, WavPack) falls back to the decode-backed
    StreamReader — same surface, O(file) startup."""
    device = resolve_device(device)
    src = _counting(source)
    head = src.pread(0, 16)
    with _malformed("stream header"):
        if head[:4] == b"OggS":
            r = ChainedOggSeekReader(src, device)
            return r.links[0] if len(r.links) == 1 else r
        if head[:4] == b"fLaC":
            return FlacSeekReader(src, device)
        if head[:4] == b"MPCK" or head[:3] == b"MP+":
            return MpcSeekReader(src, device)
        if head[:4] == b"RIFF":
            try:
                return WavSeekReader(src, device)
            except DecodeError:
                return StreamReader(src.pread(0, src.size), "wav",
                                    device=device)
        if head[:4] in (b"FORM", b"caff") or head[:4] == b"wvpk":
            ext = {b"FORM": "aiff", b"caff": "caf",
                   b"wvpk": "wv"}[head[:4]]
            return StreamReader(src.pread(0, src.size), ext, device=device)
        return Mp3SeekReader(src, device)
