"""The port's positioned readers (libnyquist_torch.streaming) against the
JAX package's, on the CPU, over in-repo content.

Every lazy reader type opens the same bytes in both packages through a
CountingSource: the same reader class, totals, channel count and rate,
the same read calls and bytes after open and after every seek, and the
same samples at every position. Three repairs of the JAX package's
readers (ROADMAP.md section 3, faults 6 to 8) change what a window reads
where they act: native FLAC windows stop at their last whole frame, an
Ogg window that starts on a continued page is placed right, and an Opus
window decodes from 5 s before the read; the tests of those hold the
port against the full decode. Samples agree exactly for FLAC, Ogg FLAC
and WAV; for
Opus 1e-4 (tests/test_torch_io.py's general-path bound), for Vorbis 1e-4
of max(|ref|, 1) (tests/test_torch_vorbis.py:163), for MP3 and Musepack
1e-5 of max(|ref|, 1) (tests/test_torch_mp3.py, test_torch_musepack.py).
Each port reader is also held against the port's own full decode at the
JAX package's seek tolerances (tests/test_seek.py): Opus 2e-4, Vorbis
1e-6, FLAC, Ogg FLAC and WAV exactly; MP3 and Musepack within 1e-6 (the
batched-against-single bound of tests/test_serving.py:49), since the
device synthesis is a product whose rounding follows the window's shape.
The SV8 stream of seeded AP bytes draws states that a linear decode
carries across AP blocks and a window starts fresh, in the JAX reader as
in the port: there the port's gap to its full decode is held against the
JAX reader's gap to the JAX full decode.

Content: the in-repo writers at a few seconds each (tools/opus_stream.py,
vorbis_stream.py, flac_stream.py, l3_stream.py), the fixtures, a Layer
III stream whose frames lean on the bit reservoir, an SV8 stream
assembled with an SO pointer and a Golomb-coded ST seek table, chained
Ogg FLAC re-serialled as tests/test_seek.py:431-447 does, and WAV written
with struct. The builders import NumPy and the writers only; the other
port test files share them.
"""

import functools
import importlib.util
import pathlib
import struct

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"


def tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# content builders
# ---------------------------------------------------------------------------
def reservoir_l3(seed: int, seconds: float, lean: int = 200) -> bytes:
    """A stereo Layer III writer stream whose frames after the first begin
    their main data up to ``lean`` bytes back, in what the frame before
    left unused (main_data_begin > 0): a seek window's first frame then
    has no reservoir and emits nothing."""
    raw = bytearray(tool("l3_stream").make_l3_stream(seed, seconds))
    off = 0
    left = 0                  # bytes the previous frame left unused
    while off + 36 <= len(raw):
        size = 417 + ((raw[off + 2] >> 1) & 1)
        side = int.from_bytes(raw[off + 4 : off + 36], "big")
        # part2_3_length of the four granule-channels (12 bits each, 59
        # bits apart after main_data_begin, private bits and scfsi)
        p23 = sum((side >> (256 - 20 - 59 * k - 12)) & 0xFFF
                  for k in range(4))
        mdb = min(lean, max(0, left - 1))
        side = (side & ~(0x1FF << 247)) | (mdb << 247)
        raw[off + 4 : off + 36] = side.to_bytes(32, "big")
        left = mdb + size - 36 - (p23 + 7) // 8
        off += size
    return bytes(raw)


def _varint(v: int, width: int = 0) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v or len(out) < width:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def _mpc_block(key: bytes, body: bytes) -> bytes:
    """One SV8 block: key, varint size (counting key and size), body."""
    n = len(body) + 3
    while True:
        size = _varint(n)
        if 2 + len(size) + len(body) == n:
            return key + size + body
        n = 2 + len(size) + len(body)


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, v: int, n: int):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def varint(self, v: int):
        for b in _varint(v):
            self.put(b, 8)

    def golomb12(self, code: int):
        self.put(0, code >> 12)
        self.put(1, 1)
        self.put(code & 0xFFF, 12)

    def bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return np.packbits(np.asarray(bits, np.uint8)).tobytes()


def _st_body(offsets, pwr_delta: int = 0) -> bytes:
    """The ST seek table of mpc_demux.c:274: the entry count and the seek
    power as varint and 4 bits, the first two byte offsets as varints,
    the rest as Golomb(12) codes of the second-order difference of their
    bit offsets in units of 4 (odd codes negative)."""
    w = _BitWriter()
    w.varint(len(offsets))
    w.put(pwr_delta, 4)
    w.varint(offsets[0])
    if len(offsets) > 1:
        w.varint(offsets[1])
    bits = [8 * o for o in offsets]
    for i in range(2, len(offsets)):
        d = (bits[i] - 2 * bits[i - 1] + bits[i - 2]) >> 2
        w.golomb12(d if d >= 0 else (-d) | 1)
    return w.bytes()


def sv8_with_seek_table(seed: int, channels: int = 2, block_pwr: int = 0,
                        n_ap: int = 24, max_band: int = 20) -> bytes:
    """An SV8 stream of seeded AP block bytes (44.1 kHz) with an SO block
    pointing at an ST seek table behind the last AP block, as encoders
    write them: MPCK, SH, SO, AP x n_ap, ST, SE."""
    rng = np.random.default_rng(seed)
    total = (n_ap << block_pwr) * 1152 - 700
    sh = bytearray(b"\x00\x00\x00\x00\x08")          # CRC, version 8
    sh += _varint(total) + _varint(0)                # samples, silence
    sh += ((0 << 13) | ((max_band - 1) << 8) | ((channels - 1) << 4)
           | (1 << 3) | (block_pwr // 2)).to_bytes(2, "big")
    head = b"MPCK" + _mpc_block(b"SH", bytes(sh))
    so_len = len(_mpc_block(b"SO", _varint(0, 4)))
    aps, offs = [], []
    off = len(head) + so_len
    for _ in range(n_ap):
        blk = _mpc_block(b"AP", rng.integers(0, 256, 2500 << block_pwr,
                                             np.uint8).tobytes())
        offs.append(off)
        aps.append(blk)
        off += len(blk)
    so = _mpc_block(b"SO", _varint(off - len(head), 4))
    assert len(so) == so_len
    return (head + so + b"".join(aps) + _mpc_block(b"ST", _st_body(offs))
            + _mpc_block(b"SE", b""))


def reserial(data: bytes, serial: int) -> bytes:
    """Every Ogg page of ``data`` under another serial, CRC redone."""
    crc = tool("opus_stream").ogg_crc
    out = bytearray(data)
    pos = 0
    while pos + 27 <= len(out):
        idx = out.find(b"OggS", pos)
        if idx < 0:
            break
        nseg = out[idx + 26]
        end = idx + 27 + nseg + sum(out[idx + 27 : idx + 27 + nseg])
        struct.pack_into("<I", out, idx + 14, serial)
        struct.pack_into("<I", out, idx + 22, 0)
        struct.pack_into("<I", out, idx + 22, crc(bytes(out[idx:end])))
        pos = end
    return bytes(out)


def wav_bytes(seconds: float, bits: int = 16, channels: int = 2,
              rate: int = 44100, seed: int = 0) -> bytes:
    """A PCM WAV file of seeded samples, written with struct."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate) * channels * (bits // 8)
    payload = rng.integers(0, 256, n, np.uint8).tobytes()
    fmt = struct.pack("<HHIIHH", 1, channels, rate,
                      rate * channels * bits // 8, channels * bits // 8,
                      bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt + b"data"
            + struct.pack("<I", len(payload)) + payload)
    return b"RIFF" + struct.pack("<I", len(body)) + body


@functools.lru_cache(maxsize=None)
def content(name: str) -> bytes:
    """The named test input (built once a process)."""
    if name == "opus":
        return tool("opus_stream").make_opus_stream(0, 200)[0]
    if name == "opus chained":
        return tool("opus_stream").make_opus_stream(3, 200)[0]
    if name == "vorbis":
        return tool("vorbis_stream").make_vorbis_stream(3, 4.0)
    if name == "vorbis bisected":
        return tool("vorbis_stream").make_vorbis_stream(4, 12.0)
    if name == "flac":
        return tool("flac_stream").make_flac_stream(1, 4.0)[0]
    if name == "flac variable 24-bit":
        return tool("flac_stream").make_flac_stream(
            2, 3.0, bps=24, blocksize=None)[0]
    if name == "ogg flac":
        return (FIXTURES / "kitty8_dithered.oga").read_bytes()
    if name == "ogg flac chained":
        fl = content("ogg flac")
        return fl + reserial(fl, 0x7777)
    if name == "mp3":
        return tool("l3_stream").make_l3_stream(2, 4.0)
    if name == "mp3 reservoir":
        return reservoir_l3(4, 3.0)
    if name == "mp3 layer II":
        return (FIXTURES / "l2_stereo_44k.mp3").read_bytes()
    if name == "mpc sv7":
        return (FIXTURES / "sv7_stereo.mpc").read_bytes()
    if name == "mpc sv8":
        return sv8_with_seek_table(5)
    if name == "wav s16":
        return wav_bytes(3.0)
    if name == "wav s24 mono":
        return wav_bytes(2.0, bits=24, channels=1, rate=48000, seed=1)
    raise KeyError(name)


# name -> (reader class, tolerance against the JAX package (of max(|ref|,
# 1) where the codec's parity test scales), against the port's full decode)
READERS = {
    "opus": ("OggSeekReader", 1e-4, 2e-4),
    "opus chained": ("ChainedOggSeekReader", 1e-4, 2e-4),
    "vorbis": ("OggSeekReader", 1e-4, 1e-6),
    "vorbis bisected": ("OggSeekReader", 1e-4, 1e-6),
    "flac": ("FlacSeekReader", 0.0, 0.0),
    "flac variable 24-bit": ("FlacSeekReader", 0.0, 0.0),
    "ogg flac": ("OggSeekReader", 0.0, 0.0),
    "ogg flac chained": ("ChainedOggSeekReader", 0.0, 0.0),
    "mp3": ("Mp3SeekReader", 1e-5, 1e-6),
    "mp3 reservoir": ("Mp3SeekReader", 1e-5, 1e-6),
    "mp3 layer II": ("Mp3SeekReader", 1e-5, 1e-6),
    "mpc sv7": ("MpcSeekReader", 1e-5, 1e-6),
    "mpc sv8": ("MpcSeekReader", 1e-5, None),
    "wav s16": ("WavSeekReader", 0.0, 0.0),
    "wav s24 mono": ("WavSeekReader", 0.0, 0.0),
}
EXACT = {"flac", "flac variable 24-bit", "ogg flac", "ogg flac chained",
         "wav s16", "wav s24 mono"}


def close(got, ref, tol, scaled=True):
    """Same shape, and |got - ref| <= tol (times max(|ref|, 1) when
    scaled); tol 0 asks for equal bits."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if tol == 0.0:
        assert np.array_equal(got.view(np.int32), ref.view(np.int32))
        return
    if not got.size:
        return
    scale = max(1.0, float(np.abs(ref).max())) if scaled else 1.0
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, err


def positions(total: int, n: int, seed: int, span: int):
    """Seeded seek targets, with the start and the last span."""
    rng = np.random.default_rng(seed)
    top = max(total - span, 1)
    return [0, max(total - span, 0)] + [int(p) for p in
                                        rng.integers(0, top, n)]


# inputs where the JAX package's lazy reader is at fault (ROADMAP.md
# section 3: its windows keep the tail of a packet continued from before
# the window, and anchor only on pages that end on a packet boundary):
# the port's reads are held against the JAX package's full decode there
JAX_READER_FAULTS = {"vorbis bisected"}
# whether the read counts equal the JAX package's (see _same_reads)
SAME_IO = {name: not (name.startswith(("opus", "flac"))
                      or name in JAX_READER_FAULTS) for name in READERS}


def _pair(name):
    from libnyquist_tpu import streaming as J

    from libnyquist_torch import streaming as P

    data = content(name)
    sj, sp = J.CountingSource(data), P.CountingSource(data)
    return J.seek_reader(sj), sj, P.seek_reader(sp, device="cpu"), sp


@pytest.mark.parametrize("name", list(READERS))
def test_reader_matches_jax(name):
    """Totals, format, read counts after open and after every seek, and
    the samples of 4,800-sample reads at seeded positions, then 20 ms
    sequential reads after one seek."""
    rj, sj, rp, sp = _pair(name)
    cls, tol, _ = READERS[name]
    assert type(rj).__name__ == type(rp).__name__ == cls
    assert (rp.pcm_total(), rp.channel_count, rp.sample_rate) == (
        rj.pcm_total(), rj.channel_count, rj.sample_rate)
    assert (sp.reads, sp.bytes_read) == (sj.reads, sj.bytes_read)
    n = 4800 if name not in ("ogg flac", "mpc sv7") else 1500
    same_io = SAME_IO[name]
    if name in JAX_READER_FAULTS:
        from libnyquist_tpu.streaming import StreamReader

        rj = StreamReader(content(name))
    for pos in positions(rj.pcm_total(), 4, 11, n):
        rj.pcm_seek(pos)
        rp.pcm_seek(pos)
        close(rp.read(n), rj.read(n), tol)
        _same_reads(sp, sj, same_io)
        assert rp.pcm_tell() == rj.pcm_tell()
    step = rp.sample_rate // 50
    pos = rj.pcm_total() // 3
    rj.pcm_seek(pos)
    rp.pcm_seek(pos)
    for _ in range(8):
        close(rp.read(step), rj.read(step), tol)
    _same_reads(sp, sj, same_io)


def _same_reads(sp, sj, same):
    """The port's read count and bytes equal the JAX package's where the
    readers' algorithms are the same. Not for Opus, whose window starts
    SETTLE_OPUS before the read and keeps only its settled samples, and
    whose reads that follow a window continue its decoder; nor for native
    FLAC, whose window stops at its last whole frame where the JAX
    package's grows to the end of the file
    (test_flac_window_stops_at_the_last_whole_frame); nor on the inputs
    the JAX reader is at fault on (ROADMAP.md section 3)."""
    if same:
        assert (sp.reads, sp.bytes_read) == (sj.reads, sj.bytes_read)


def test_flac_window_stops_at_the_last_whole_frame():
    """The JAX package's native FLAC window ends inside a frame, the decode
    raises on the cut frame, and the window doubles until it reaches the
    end of the file: a seek reads and decodes the rest of the stream. The
    port cuts each read at its last whole frame, so a seek reads its
    window and the probes only, with the same samples."""
    from libnyquist_torch import streaming as P
    from libnyquist_tpu import streaming as J

    data = tool("flac_stream").make_flac_stream(1, 20.0)[0]
    sj, sp = J.CountingSource(data), P.CountingSource(data)
    rj, rp = J.FlacSeekReader(sj), P.FlacSeekReader(sp, device="cpu")
    total = rp.pcm_total()
    for pos in (0, total // 2, total - 9000, 300_000):
        bj, bp = sj.bytes_read, sp.bytes_read
        rj.pcm_seek(pos)
        rp.pcm_seek(pos)
        close(rp.read(4800), rj.read(4800), 0.0)
        # a handful of 64 KiB probes and the window, doubled at most once
        assert sp.bytes_read - bp <= 8 * 65536 + 3 * 136704, pos
        if pos == 0:
            assert sj.bytes_read - bj > len(data)     # the rest, and more
    assert sp.bytes_read < len(data)


@pytest.mark.parametrize("name", list(READERS))
def test_reader_matches_port_load(name):
    """Each lazy reader against the decode-backed StreamReader over the
    port's own load() of the same bytes (of the chained Ogg FLAC, whose
    load() decodes the first link as the JAX package's does, against
    the link's decode twice over, as tests/test_seek.py:455-465)."""
    from libnyquist_torch.streaming import StreamReader, seek_reader

    data = content(name)
    _, _, tol = READERS[name]
    if name == "ogg flac chained":
        full = StreamReader(content("ogg flac"), device="cpu")
        full._buf = np.concatenate([full._buf, full._buf])
    else:
        full = StreamReader(data, device="cpu")
    r = seek_reader(data, device="cpu")
    assert r.pcm_total() == full.pcm_total() > 0
    assert (r.channel_count, r.sample_rate) == (full.channel_count,
                                                full.sample_rate)
    if tol is None:
        from libnyquist_tpu import streaming as J

        jr, jfull = J.seek_reader(data), J.StreamReader(data)
    for pos in positions(r.pcm_total(), 3, 12, 2000):
        r.pcm_seek(pos)
        full.pcm_seek(pos)
        if tol is not None:
            close(r.read(2000), full.read(2000), tol, scaled=False)
            continue
        jr.pcm_seek(pos)
        jfull.pcm_seek(pos)
        close(r.read(2000) - full.read(2000),
              jr.read(2000) - jfull.read(2000), 1e-5)


def test_opus_window_is_one_flush_equal_to_per_packet(monkeypatch):
    """An Opus window pushes every packet and flushes once; its samples
    equal decoding the same packets one decode_packet at a time (push +
    flush each) within 1e-6 (tests/test_serving.py:49's batched against
    single bound), and the read is the window's slice at its anchor. A
    read that follows the window continues its decoder: again one flush,
    equal to the full decode."""
    from libnyquist_torch.formats.opus.decoder import OpusDecoder
    from libnyquist_torch.streaming import OggSeekReader, StreamReader

    flushes, windows = [], []
    flush, decode = OpusDecoder.flush, OggSeekReader._opus_decode

    def counted(self):
        flushes.append(self)
        return flush(self)

    def recorded(self, dec, pkts, start, settled, next_off):
        windows.append((pkts, start))
        return decode(self, dec, pkts, start, settled, next_off)

    data = content("opus")
    full = StreamReader(data, device="cpu")
    monkeypatch.setattr(OpusDecoder, "flush", counted)
    monkeypatch.setattr(OggSeekReader, "_opus_decode", recorded)
    r = OggSeekReader(data, device="cpu")
    pos = r.pcm_total() // 2
    r.pcm_seek(pos)
    got = r.read(4800)
    assert len(flushes) == len(windows) == 1
    assert flushes[0].stats["mixes"] == 1
    assert flushes[0].stats["segments"] >= 1
    end = r._buf_start + r._buf.shape[0]
    r.pcm_seek(end + 100)
    got2 = r.read(960)
    assert len(flushes) == 2 and flushes[1] is flushes[0]
    assert windows[1][1] == end
    monkeypatch.undo()
    pkts, start = windows[0]
    one = OpusDecoder(r.channel_count, device="cpu")
    per = np.concatenate([one.decode_packet(p).numpy() for p in pkts if p])
    assert per.shape == (sum(r._opus_durations(pkts)), r.channel_count)
    close(got, per[pos - start : pos - start + 4800], 1e-6, scaled=False)
    full.pcm_seek(pos)
    close(got, full.read(4800), 2e-4, scaled=False)
    full.pcm_seek(end + 100)
    close(got2, full.read(960), 2e-4, scaled=False)


def test_ogg_window_drops_the_tail_of_a_continued_packet():
    """Bisection lands on pages that continue a packet begun on the page
    before, and most pages end inside a packet. The JAX package's window
    keeps the continued packet's tail as a packet of its own (its Vorbis
    window then raises, or decodes the tail as audio) and anchors only on
    a page that ends on a packet boundary; the port's drops the tail,
    anchors on the first page that completes a packet it keeps, and
    starts a probe earlier when its first packet ends past the target,
    so its reads equal the full decode (1e-6, tests/test_seek.py's Vorbis
    bound)."""
    from libnyquist_torch import streaming as P
    from libnyquist_tpu import streaming as J

    data = content("vorbis bisected")
    full = P.StreamReader(data, device="cpu")
    jfull = J.StreamReader(data)
    probe = P.OggSeekReader(data, device="cpu")
    faults = 0
    for pos in positions(full.pcm_total(), 8, 13, 4800):
        rj, rp = J.OggSeekReader(data), P.OggSeekReader(data, device="cpu")
        tail = probe._first_page_after(probe._bisect(pos))[4]   # continued
        rp.pcm_seek(pos)
        full.pcm_seek(pos)
        close(rp.read(4800), full.read(4800), 1e-6, scaled=False)
        rj.pcm_seek(pos)
        jfull.pcm_seek(pos)
        try:
            ok = np.abs(rj.read(4800) - jfull.read(4800)).max() <= 1e-4
        except Exception:       # DecodeError, IndexError
            ok = False
        assert ok or tail, pos  # the JAX reader fails only there
        faults += not ok
    assert faults >= 2


def test_mp3_reservoir_windows_drop_what_jax_drops():
    """Windows whose first frame leans on a reservoir that is not there:
    both packages drop the same frames (the same anchors) and the window
    equals the full decode from the target on."""
    import libnyquist_torch as nqt
    from libnyquist_torch.streaming import Mp3SeekReader
    from libnyquist_tpu.streaming import Mp3SeekReader as JMp3

    data = content("mp3 reservoir")
    rp, rj = Mp3SeekReader(data, device="cpu"), JMp3(data)
    full = nqt.load(data, extension="mp3", device="cpu").samples.reshape(
        -1, 2)
    assert rp.pcm_total() == full.shape[0]
    dropped = 0
    for k in (11, 20, 47, 80, 100):
        pos = k * 1152 + 5
        rp.pcm_seek(pos)
        rj.pcm_seek(pos)
        a, b = rp.read(3000), rj.read(3000)
        assert rp._buf_start == rj._buf_start
        dropped += rp._buf_start // 1152 - (k - Mp3SeekReader.PREROLL)
        close(a, b, 1e-5)
        close(a, full[pos : pos + 3000], 0.0)
    assert dropped >= 3          # the stream does lean on the reservoir


def test_sv8_seek_table_and_io():
    """The ST table parses to the AP block offsets (every entry at an AP
    header, in both packages), and a far seek jumps through it: the
    bytes read stay well under the file's."""
    from libnyquist_torch.streaming import CountingSource, MpcSeekReader
    from libnyquist_tpu.streaming import MpcSeekReader as JMpc

    data = content("mpc sv8")
    src = CountingSource(data)
    r = MpcSeekReader(src, device="cpu")
    assert r._st == JMpc(data)._st and len(r._st) == 24
    for off in r._st:
        assert r._read_block_header(off)[0] == b"AP"
    r.pcm_seek(r.pcm_total() - 700)
    assert r.read(600).shape == (600, 2)
    assert src.bytes_read < 0.25 * src.size, src.bytes_read


def test_sv7_seek_resets_the_scale_factors():
    """A seek past the 64-frame warm-up starts its window at a later frame
    with the scale factor indices reset to 0x01010101 on the port
    decoder's state (mpc_decoder.c:85): an SV7 stream of 160 frames
    written by tools/gen_sv7_stream.py (the fixture's 40 frames never
    reach that branch) reads as the JAX reader's, within 1e-5 of max(|ref|,
    1), with the same read counts."""
    from libnyquist_torch import streaming as P
    from libnyquist_tpu import streaming as J

    gen = tool("gen_sv7_stream")
    gen.N_FRAMES = 160
    data = gen.gen(np.random.default_rng(11))
    sj, sp = J.CountingSource(data), P.CountingSource(data)
    rj, rp = J.MpcSeekReader(sj), P.MpcSeekReader(sp, device="cpu")
    assert rp.pcm_total() == rj.pcm_total() == 160 * 1152 - 481
    for pos in (80 * 1152 + 17, 120 * 1152, rp.pcm_total() - 700):
        rj.pcm_seek(pos)
        rp.pcm_seek(pos)
        close(rp.read(600), rj.read(600), 1e-5)
        assert rp._buf_start == rj._buf_start > 0      # the reset branch
        assert (sp.reads, sp.bytes_read) == (sj.reads, sj.bytes_read)


def test_lazy_dispatch_fallbacks_and_bounds():
    """StreamReader(lazy=True) dispatches by content; IMA-ADPCM WAV,
    AIFF and WavPack take the decode-backed reader, as in the JAX
    package; seeks out of range and negative reads raise."""
    import libnyquist_torch as nqt
    from libnyquist_torch.errors import DecodeError
    from libnyquist_torch.streaming import StreamReader, seek_reader
    from libnyquist_tpu.streaming import seek_reader as jseek

    r = StreamReader(content("mpc sv7"), lazy=True, device="cpu")
    assert type(r).__name__ == "MpcSeekReader"
    chained = StreamReader(content("ogg flac chained"), extension="ogg",
                           lazy=True, device="cpu")
    assert type(chained).__name__ == "ChainedOggSeekReader"
    assert len(chained.links) == 2
    wav = content("wav s16")
    adpcm = bytearray(wav)
    struct.pack_into("<H", adpcm, 20, 0x11)          # IMA-ADPCM tag
    for data in (bytes(adpcm), (FIXTURES / "hybrid_stereo.wv").read_bytes()):
        try:
            ref = jseek(data)
        except Exception:
            ref = None
        try:
            got = seek_reader(data, device="cpu")
        except nqt.NyquistError:
            assert ref is None
            continue
        assert isinstance(got, StreamReader)
        assert type(ref).__name__ == "StreamReader"
        assert got.pcm_total() == ref.pcm_total()
        got.time_seek(0.1)
        ref.time_seek(0.1)
        close(got.read(200), ref.read(200), 0.0)
    r = seek_reader(wav, device="cpu")
    with pytest.raises(DecodeError):
        r.pcm_seek(r.pcm_total() + 1)
    with pytest.raises(DecodeError):
        r.pcm_seek(-1)
    with pytest.raises(DecodeError):
        r.read(-1)
    r.pcm_seek(r.pcm_total())
    assert r.read(100).shape == (0, 2)
    r.time_seek(1.0)
    assert r.pcm_tell() == 44100 and r.time_tell() == 1.0
    assert sum(c.shape[0] for c in r) == r.pcm_total() - 44100


def test_readers_run_on_cuda_unless_told(monkeypatch):
    """Every reader defaults to CUDA and raises without it; nothing falls
    back to the CPU."""
    from libnyquist_torch import streaming as P

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = content("wav s16")
    for make in (lambda: P.seek_reader(data),
                 lambda: P.seek_reader(data, device="cuda"),
                 lambda: P.StreamReader(data, lazy=True),
                 lambda: P.StreamReader(data),
                 lambda: P.WavSeekReader(data),
                 lambda: P.OggSeekReader(content("ogg flac"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
