"""MP3 decoder: MPEG-1/2/2.5 Layer III, plus Layer I/II.

Host half and device half, after minimp3 (reference:
third_party/minimp3/minimp3.h — frame sync :296/:1703, Layer I/II
:317-481, Layer III side info :484 through antialias :1002):

* Layer III: the whole-stream native entropy decode
  (``native/mp3_stream.c``: sync, side info, bit reservoir,
  scalefactors, Huffman, stereo, reorder, antialias) emits
  frequency-domain granule planes and per-band IMDCT kinds;
* the frame decoder below, for the streams the native decode hands
  back (free format, or Layer I/II frames anywhere): Layer III frames
  through the per-frame route (side info, reservoir, scalefactors, the
  native Huffman of ``native/mp3_huff.c``, stereo, reorder, antialias)
  emit frequency-domain granules as the stream decode does; Layer I/II
  frames (bit allocation, scale factors, dequantization) emit
  time-domain band slices;
* the dense synthesis (hybrid IMDCT and QMF polyphase as matmuls,
  ``ops/mp3_synth.py`` ``Mp3Synth``) runs on the device, one call per
  segment that starts from silence.

Normative tables are data (``data/mp3_tables.npz``).
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading

import numpy as np
import torch

from ..audio_data import AudioData, PCMFormat
from ..errors import DecodeError
from ..ops import mp3_synth

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data" / "mp3_tables.npz"

MAX_FREE_FORMAT_FRAME_SIZE = 2304
MAX_FRAME_SYNC_MATCHES = 10
MAX_BITRESERVOIR_BYTES = 511
SHORT_BLOCK_TYPE = 2
MODE_MONO = 3
MODE_JOINT_STEREO = 1
HDR_SIZE = 4
MAX_SCFI = 48  # ((255 - 4 - 210) + 3) & ~3


@functools.lru_cache(maxsize=1)
def T() -> dict:
    return dict(np.load(_DATA))


# --------------------------------------------------------------------------
# Header helpers (reference: minimp3.h HDR_* macros, hdr_* functions)
# --------------------------------------------------------------------------
def hdr_is_mono(h):
    return (h[3] & 0xC0) == 0xC0


def hdr_is_ms_stereo(h):
    return (h[3] & 0xE0) == 0x60


def hdr_is_free_format(h):
    return (h[2] & 0xF0) == 0


def hdr_is_crc(h):
    return not (h[1] & 1)


def hdr_test_padding(h):
    return h[2] & 0x2


def hdr_test_mpeg1(h):
    return h[1] & 0x8


def hdr_test_not_mpeg25(h):
    return h[1] & 0x10


def hdr_test_i_stereo(h):
    return h[3] & 0x10


def hdr_test_ms_stereo(h):
    return h[3] & 0x20


def hdr_get_layer(h):
    return (h[1] >> 1) & 3


def hdr_get_bitrate(h):
    return h[2] >> 4


def hdr_get_sample_rate(h):
    return (h[2] >> 2) & 3


def hdr_get_my_sample_rate(h):
    return hdr_get_sample_rate(h) + (((h[1] >> 3) & 1) + ((h[1] >> 4) & 1)) * 3


def hdr_is_frame_576(h):
    return (h[1] & 14) == 2


def hdr_is_layer_1(h):
    return (h[1] & 6) == 6


def hdr_get_stereo_mode(h):
    return (h[3] >> 6) & 3


def hdr_get_stereo_mode_ext(h):
    return (h[3] >> 4) & 3


_HALFRATE = [
    [
        [0, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 72, 80],
        [0, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 72, 80],
        [0, 16, 24, 28, 32, 40, 48, 56, 64, 72, 80, 88, 96, 112, 128],
    ],
    [
        [0, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160],
        [0, 16, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192],
        [0, 16, 32, 48, 64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224],
    ],
]


def hdr_bitrate_kbps(h):
    return 2 * _HALFRATE[1 if hdr_test_mpeg1(h) else 0][
        hdr_get_layer(h) - 1
    ][hdr_get_bitrate(h)]


def hdr_sample_rate_hz(h):
    hz = [44100, 48000, 32000][hdr_get_sample_rate(h)]
    hz >>= 0 if hdr_test_mpeg1(h) else 1
    hz >>= 0 if hdr_test_not_mpeg25(h) else 1
    return hz


def hdr_frame_samples(h):
    if hdr_is_layer_1(h):
        return 384
    return 1152 >> (1 if hdr_is_frame_576(h) else 0)


def hdr_frame_bytes(h, free_format_size):
    fb = hdr_frame_samples(h) * hdr_bitrate_kbps(h) * 125 // hdr_sample_rate_hz(h)
    if hdr_is_layer_1(h):
        fb &= ~3
    return fb if fb else free_format_size


def hdr_padding(h):
    if hdr_test_padding(h):
        return 4 if hdr_is_layer_1(h) else 1
    return 0


def hdr_valid(h):
    return (
        h[0] == 0xFF
        and ((h[1] & 0xF0) == 0xF0 or (h[1] & 0xFE) == 0xE2)
        and hdr_get_layer(h) != 0
        and hdr_get_bitrate(h) != 15
        and hdr_get_sample_rate(h) != 3
    )


def hdr_compare(h1, h2):
    return (
        hdr_valid(h2)
        and ((h1[1] ^ h2[1]) & 0xFE) == 0
        and ((h1[2] ^ h2[2]) & 0x0C) == 0
        and not (hdr_is_free_format(h1) ^ hdr_is_free_format(h2))
    )


# --------------------------------------------------------------------------
# Bit reader (reference: minimp3.h bs_t/get_bits)
# --------------------------------------------------------------------------
class Bits:
    __slots__ = ("buf", "pos", "limit")

    def __init__(self, buf: bytes, bits: int = None):
        self.buf = buf
        self.pos = 0
        self.limit = len(buf) * 8 if bits is None else bits

    def get(self, n: int) -> int:
        s = self.pos & 7
        shl = n + s
        p = self.pos >> 3
        self.pos += n
        if self.pos > self.limit:
            return 0
        cache = 0
        nxt = self.buf[p] & (255 >> s)
        p += 1
        while shl - 8 > 0:
            shl -= 8
            cache |= nxt << shl
            nxt = self.buf[p] if p < len(self.buf) else 0
            p += 1
        shl -= 8
        return cache | (nxt >> -shl)


# --------------------------------------------------------------------------
# Frame sync (reference: mp3d_find_frame / mp3d_match_frame)
# --------------------------------------------------------------------------
def match_frame(data, off, nbytes, frame_bytes):
    i = 0
    for _ in range(MAX_FRAME_SYNC_MATCHES):
        i += hdr_frame_bytes(data[off + i:], frame_bytes) + hdr_padding(
            data[off + i:]
        )
        if i + HDR_SIZE > nbytes:
            return True
        if not hdr_compare(data[off:], data[off + i:]):
            return False
    return True


def find_frame(data, free_format_bytes):
    n = len(data)
    for i in range(max(0, n - HDR_SIZE)):
        h = data[i:]
        if hdr_valid(h):
            frame_bytes = hdr_frame_bytes(h, free_format_bytes[0])
            frame_and_padding = frame_bytes + hdr_padding(h)
            k = HDR_SIZE
            while (not frame_bytes and k < MAX_FREE_FORMAT_FRAME_SIZE
                   and i + 2 * k < n - HDR_SIZE):
                if hdr_compare(h, data[i + k:]):
                    fb = k - hdr_padding(h)
                    nextfb = fb + hdr_padding(data[i + k:])
                    if (i + k + nextfb + HDR_SIZE <= n
                            and hdr_compare(h, data[i + k + nextfb:])):
                        frame_and_padding = k
                        frame_bytes = fb
                        free_format_bytes[0] = fb
                k += 1
            if (frame_bytes and i + frame_and_padding <= n
                    and match_frame(data, i, n - i, frame_bytes)) or (
                    i == 0 and frame_and_padding == n):
                return i, frame_and_padding
            free_format_bytes[0] = 0
    return n, 0


# --------------------------------------------------------------------------
# Layer III: the native whole-stream entropy decode (native/mp3_stream.c)
# --------------------------------------------------------------------------
class _State(ctypes.Structure):
    """mp3s_state of native/mp3_stream.c, byte for byte."""

    _fields_ = [("header", ctypes.c_uint8 * 4),
                ("reserv", ctypes.c_int32),
                ("free_format_bytes", ctypes.c_int32),
                ("reserv_buf", ctypes.c_uint8 * MAX_BITRESERVOIR_BYTES)]


# mp3s_l3_stream result flags (native/mp3_stream.c MP3S_*)
_EOF, _RESET, _PARAMS, _FULL, _FALLBACK = range(5)
_STREAM_LOCK = threading.Lock()
_STREAM_LIB = None


def _stream_native_lib():
    """The codec host library with its MP3 tables set: mp3s_init_tables
    writes C globals, so it runs once, under a lock, and the table arrays
    stay alive on the library object for its lifetime."""
    global _STREAM_LIB
    with _STREAM_LOCK:
        if _STREAM_LIB is not None:
            return _STREAM_LIB
        from ..runtime import native

        L = native.codec_lib()
        t = T()
        keep = {}
        for k in ("tabs", "tab32", "tab33", "tabindex", "g_linbits",
                  "g_scf_long", "g_scf_short", "g_scf_mixed",
                  "g_scf_partitions", "g_scfc_decode", "g_mod", "g_preamp"):
            keep[k] = np.ascontiguousarray(t[k], np.int32)
        for k in ("g_pow43", "g_expfrac", "g_pan", "g_aa"):
            keep[k] = np.ascontiguousarray(t[k], np.float64)
        p = {k: a.ctypes.data_as(ctypes.c_void_p) for k, a in keep.items()}
        L.mp3s_init_tables(
            p["tabs"], keep["tabs"].size, p["tab32"], p["tab33"],
            p["tabindex"], p["g_linbits"], p["g_pow43"], p["g_scf_long"],
            p["g_scf_short"], p["g_scf_mixed"], p["g_scf_partitions"],
            p["g_scfc_decode"], p["g_mod"], p["g_preamp"], p["g_expfrac"],
            p["g_pan"], p["g_aa"],
        )
        L._mp3s_keepalive = keep
        _STREAM_LIB = L
        return L


class _L3Calls:
    """Successive mp3s_l3_stream calls over one buffer: the C decoder
    state, the position, and the granule buffers a call fills (at most
    ``maxg`` granules a call)."""

    def __init__(self, data: bytes, maxg: int):
        self.L = _stream_native_lib()
        self.data = data
        self.maxg = maxg
        self.grbufs = np.zeros((maxg, 2, 576), np.float32)
        self.kinds = np.zeros((maxg, 2, 32), np.int8)
        self.st = _State()
        self.pos = ctypes.c_int64(0)
        self.info = np.zeros(2, np.int32)          # channels, hz
        self.flag = ctypes.c_int32(0)

    def __call__(self, pending: bool):
        """Decode to the next event. ``pending``: the caller still holds
        granules of the current segment. Returns (X [G, 2, 576],
        kinds [G, 2, 32], flag), copies of this call's granules."""
        G = self.L.mp3s_l3_stream(
            self.data, len(self.data), ctypes.byref(self.pos),
            ctypes.byref(self.st), self.grbufs.ctypes.data,
            self.kinds.ctypes.data, self.info.ctypes.data, self.maxg,
            int(pending), ctypes.byref(self.flag))
        return self.grbufs[:G].copy(), self.kinds[:G].copy(), self.flag.value

    @property
    def channels(self) -> int:
        return int(self.info[0])

    @property
    def hz(self) -> int:
        return int(self.info[1])


def _decode_mp3_buffer_native(data: bytes, device) -> tuple | None:
    """Whole-stream native decode: the host entropy plane runs as chunked
    C calls that emit frequency-domain granule batches; each segment
    (flags 0, 1, 2 end one: end of stream, a decoder reset, a change of
    channels or rate) synthesizes on the device from silence. Returns
    (pcm [n, channels] on ``device``, channels, hz), or None when the
    stream holds Layer I/II or free-format frames (flag 4) or nothing
    decodable: the caller's frame loop takes the whole buffer."""
    calls = _L3Calls(data, 2048)
    segs = []
    cur_g, cur_k = [], []
    cur_ch = 0
    while True:
        X, kinds, flag = calls(bool(cur_g))
        if flag == _FALLBACK:
            return None
        if len(X):
            cur_g.append(X)
            cur_k.append(kinds)
            cur_ch = calls.channels
        if flag in (_EOF, _RESET, _PARAMS) and cur_g:
            segs.append(_synth_segment(np.concatenate(cur_g),
                                       np.concatenate(cur_k), 18, cur_ch,
                                       device))
            cur_g, cur_k = [], []
        if flag == _EOF:
            break
    if not segs:
        return None
    return _join(segs), calls.channels, calls.hz


def l3_stream_entropy(data: bytes):
    """Host-entropy-only decode of a constant-parameter Layer III stream:
    returns (X [G,2,576] float32 frequency planes, kinds [G,2,32] int8,
    channels, hz), the input of the K-stream device synthesis. Raises on
    streams that reset or change parameters mid-way (those go through
    ``decode_mp3_buffer``, which synthesizes each segment from silence)."""
    calls = _L3Calls(data, 4096)
    xs, ks = [], []
    while True:
        X, kinds, flag = calls(bool(xs))
        if len(X):
            xs.append(X)
            ks.append(kinds)
        if flag == _EOF:
            break
        if flag != _FULL:
            raise DecodeError("stream resets/param changes: use "
                              "decode_mp3_buffer")
    if not xs:
        raise DecodeError("no decodable MP3 frames found")
    return np.concatenate(xs), np.concatenate(ks), calls.channels, calls.hz


def _synth_segment(bufs: np.ndarray, kinds, nbands: int, nch: int,
                   device) -> torch.Tensor:
    """One silence-started segment through the device synthesis:
    [G, 2, 576] granule buffers (frequency planes with kinds for Layer
    III, time-domain band slices with kinds None for Layer I/II) ->
    [G * 32 * nbands, nch] PCM on ``device``."""
    synth = mp3_synth.synth_module(nch, nbands, device)
    X = torch.from_numpy(bufs).to(device)[None]
    K = None if kinds is None else torch.from_numpy(kinds).to(device)[None]
    return synth(X, K)[0]


def _join(segs) -> torch.Tensor:
    """The segments' PCM end to end; interleaved output has one channel
    count, so a stream whose channel count changes is refused."""
    if len({s.shape[1] for s in segs}) > 1:
        raise DecodeError("MP3 channel count changes mid-stream")
    return torch.cat(segs)


# --------------------------------------------------------------------------
# Layer III by frame (minimp3.h L3_read_side_info :484 through
# L3_antialias :1002), for the streams the native decode hands back
# --------------------------------------------------------------------------
class GrInfo:
    __slots__ = (
        "sfbtab", "part_23_length", "big_values", "scalefac_compress",
        "global_gain", "block_type", "mixed_block_flag", "n_long_sfb",
        "n_short_sfb", "table_select", "region_count", "subblock_gain",
        "preflag", "scalefac_scale", "count1_table", "scfsi",
    )


def read_side_info(bs: Bits, hdr):
    t = T()
    sr_idx = hdr_get_my_sample_rate(hdr)
    if sr_idx != 0:
        sr_idx -= 1
    gr_count = 1 if hdr_is_mono(hdr) else 2
    scfsi = 0
    if hdr_test_mpeg1(hdr):
        gr_count *= 2
        main_data_begin = bs.get(9)
        scfsi = bs.get(7 + gr_count)
    else:
        main_data_begin = bs.get(8 + gr_count) >> gr_count
    grs = []
    part_23_sum = 0
    remaining = gr_count
    while remaining:
        gr = GrInfo()
        if hdr_is_mono(hdr):
            scfsi <<= 4
        gr.part_23_length = bs.get(12)
        part_23_sum += gr.part_23_length
        gr.big_values = bs.get(9)
        if gr.big_values > 288:
            raise DecodeError("big_values out of range")
        gr.global_gain = bs.get(8)
        gr.scalefac_compress = bs.get(4 if hdr_test_mpeg1(hdr) else 9)
        gr.sfbtab = t["g_scf_long"][sr_idx]
        gr.n_long_sfb = 22
        gr.n_short_sfb = 0
        gr.region_count = [0, 0, 255]
        gr.subblock_gain = [0, 0, 0]
        if bs.get(1):
            gr.block_type = bs.get(2)
            if not gr.block_type:
                raise DecodeError("reserved block type")
            gr.mixed_block_flag = bs.get(1)
            gr.region_count[0] = 7
            gr.region_count[1] = 255
            if gr.block_type == SHORT_BLOCK_TYPE:
                scfsi &= 0x0F0F
                if not gr.mixed_block_flag:
                    gr.region_count[0] = 8
                    gr.sfbtab = t["g_scf_short"][sr_idx]
                    gr.n_long_sfb = 0
                    gr.n_short_sfb = 39
                else:
                    gr.sfbtab = t["g_scf_mixed"][sr_idx]
                    gr.n_long_sfb = 8 if hdr_test_mpeg1(hdr) else 6
                    gr.n_short_sfb = 30
            tables = bs.get(10) << 5
            gr.subblock_gain = [bs.get(3), bs.get(3), bs.get(3)]
        else:
            gr.block_type = 0
            gr.mixed_block_flag = 0
            tables = bs.get(15)
            gr.region_count[0] = bs.get(4)
            gr.region_count[1] = bs.get(3)
            gr.region_count[2] = 255
        gr.table_select = [
            (tables >> 10) & 31, (tables >> 5) & 31, tables & 31
        ]
        gr.preflag = (
            bs.get(1) if hdr_test_mpeg1(hdr)
            else int(gr.scalefac_compress >= 500)
        )
        gr.scalefac_scale = bs.get(1)
        gr.count1_table = bs.get(1)
        gr.scfsi = (scfsi >> 12) & 15
        scfsi = (scfsi << 4) & 0xFFFFFFFF
        grs.append(gr)
        remaining -= 1
    if part_23_sum + bs.pos > bs.limit + main_data_begin * 8:
        raise DecodeError("side info overruns frame")
    return main_data_begin, grs


def ldexp_q2(y, exp_q2):
    g_expfrac = T()["g_expfrac"]
    while True:
        e = min(30 * 4, exp_q2)
        y = y * (g_expfrac[e & 3] * (1 << (30 - (e >> 2))))
        exp_q2 -= e
        if exp_q2 <= 0:
            return y


def l3_read_scalefactors(ist_pos, scf_size, scf_count, bs: Bits, scfsi):
    """L3_read_scalefactors: returns the scalefactors and updates
    ``ist_pos`` in place segment by segment."""
    scf = []
    pos = 0
    for i in range(4):
        cnt = int(scf_count[i])
        if cnt == 0:
            break
        if scfsi & 8:
            scf.extend(ist_pos[pos : pos + cnt])
        else:
            bits = int(scf_size[i])
            if bits == 0:
                for k in range(cnt):
                    ist_pos[pos + k] = 0
                scf.extend([0] * cnt)
            else:
                max_scf = (1 << bits) - 1 if scfsi < 0 else -1
                for k in range(cnt):
                    s = bs.get(bits)
                    ist_pos[pos + k] = 255 if s == max_scf else s  # uint8 -1
                    scf.append(s)
        pos += cnt
        scfsi *= 2
    scf.extend([0, 0, 0])
    return scf


def decode_scalefactors(hdr, ist_pos, bs: Bits, gr: GrInfo, ch):
    t = T()
    scf_partition = t["g_scf_partitions"][
        (1 if gr.n_short_sfb else 0) + (1 if not gr.n_long_sfb else 0)
    ]
    scf_size = [0] * 4
    scf_shift = gr.scalefac_scale + 1
    scfsi = gr.scfsi
    if hdr_test_mpeg1(hdr):
        part = int(t["g_scfc_decode"][gr.scalefac_compress])
        scf_size[0] = scf_size[1] = part >> 2
        scf_size[2] = scf_size[3] = part & 3
        counts = scf_partition
    else:
        g_mod = t["g_mod"]
        ist = 1 if (hdr_test_i_stereo(hdr) and ch) else 0
        sfc = gr.scalefac_compress >> ist
        k = ist * 3 * 4
        while sfc >= 0:
            modprod = 1
            for i in range(3, -1, -1):
                scf_size[i] = (sfc // modprod) % int(g_mod[k + i])
                modprod *= int(g_mod[k + i])
            sfc -= modprod
            k += 4
        counts = scf_partition[k:]
        scfsi = -16
    iscf = l3_read_scalefactors(ist_pos, scf_size, counts, bs, scfsi)
    iscf = list(iscf) + [0] * (40 - len(iscf))
    if gr.n_short_sfb:
        sh = 3 - scf_shift
        for i in range(0, gr.n_short_sfb, 3):
            iscf[gr.n_long_sfb + i + 0] += gr.subblock_gain[0] << sh
            iscf[gr.n_long_sfb + i + 1] += gr.subblock_gain[1] << sh
            iscf[gr.n_long_sfb + i + 2] += gr.subblock_gain[2] << sh
    elif gr.preflag:
        g_preamp = t["g_preamp"]
        for i in range(10):
            iscf[11 + i] += int(g_preamp[i])
    gain_exp = gr.global_gain - 4 - 210 - (2 if hdr_is_ms_stereo(hdr) else 0)
    gain = ldexp_q2(float(1 << (MAX_SCFI // 4)), MAX_SCFI - gain_exp)
    n = gr.n_long_sfb + gr.n_short_sfb
    return np.array(
        [ldexp_q2(gain, iscf[i] << scf_shift) for i in range(n)],
        dtype=np.float32,
    )


@functools.lru_cache(maxsize=1)
def _huffman_tables():
    t = T()
    arrs = {k: np.ascontiguousarray(t[k], np.int32)
            for k in ("tabs", "tab32", "tab33", "tabindex", "g_linbits")}
    arrs["g_pow43"] = np.ascontiguousarray(t["g_pow43"], np.float64)
    return arrs


def l3_huffman(dst, bs: Bits, gr: GrInfo, scf, layer3gr_limit):
    """L3_huffman in C (``native/mp3_huff.c``): dequantized spectrum of
    one granule-channel into ``dst`` [576]; ``bs`` moves to the limit."""
    from ..runtime import native

    L = native.codec_lib()
    nt = _huffman_tables()
    buf = bytes(bs.buf) + b"\x00" * 8
    sfb = np.ascontiguousarray(gr.sfbtab, np.int32)
    scfa = np.ascontiguousarray(scf, np.float64)
    ts = np.ascontiguousarray(gr.table_select, np.int32)
    rc = np.ascontiguousarray(gr.region_count, np.int32)
    L.mp3_l3_huffman(
        dst.ctypes.data, buf, len(bs.buf), bs.pos,
        nt["tabs"].ctypes.data, nt["tab32"].ctypes.data,
        nt["tab33"].ctypes.data, nt["tabindex"].ctypes.data,
        nt["g_linbits"].ctypes.data, nt["g_pow43"].ctypes.data,
        sfb.ctypes.data, scfa.ctypes.data, int(gr.big_values),
        ts.ctypes.data, rc.ctypes.data, int(gr.count1_table),
        int(layer3gr_limit), nt["tabs"].size,
    )
    bs.pos = layer3gr_limit


def midside_stereo(grbuf, n):
    a = grbuf[0][:n].copy()
    b = grbuf[1][:n].copy()
    grbuf[0][:n] = a + b
    grbuf[1][:n] = a - b


def stereo_top_band(right, sfb, nbands):
    max_band = [-1, -1, -1]
    pos = 0
    for i in range(nbands):
        ln = int(sfb[i])
        for k in range(0, ln, 2):
            if right[pos + k] != 0 or right[pos + k + 1] != 0:
                max_band[i % 3] = i
                break
        pos += ln
    return max_band


def stereo_process(grbuf, ist_pos, sfb, hdr, max_band, mpeg2_sh):
    g_pan = T()["g_pan"]
    max_pos = 7 if hdr_test_mpeg1(hdr) else 64
    pos = 0
    i = 0
    while sfb[i]:
        ipos = ist_pos[i]
        ln = int(sfb[i])
        if i > max_band[i % 3] and ipos < max_pos:
            s = np.sqrt(2.0) if hdr_test_ms_stereo(hdr) else 1.0
            if hdr_test_mpeg1(hdr):
                kl = g_pan[2 * ipos]
                kr = g_pan[2 * ipos + 1]
            else:
                kl = 1.0
                kr = ldexp_q2(1.0, ((ipos + 1) >> 1) << mpeg2_sh)
                if ipos & 1:
                    kl, kr = kr, 1.0
            left = grbuf[0][pos : pos + ln].copy()
            grbuf[1][pos : pos + ln] = left * (kr * s)
            grbuf[0][pos : pos + ln] = left * (kl * s)
        elif hdr_test_ms_stereo(hdr):
            a = grbuf[0][pos : pos + ln].copy()
            b = grbuf[1][pos : pos + ln].copy()
            grbuf[0][pos : pos + ln] = a + b
            grbuf[1][pos : pos + ln] = a - b
        pos += ln
        i += 1


def intensity_stereo(grbuf, ist_pos, gr_pair, hdr):
    gr = gr_pair[0]
    n_sfb = gr.n_long_sfb + gr.n_short_sfb
    max_blocks = 3 if gr.n_short_sfb else 1
    max_band = stereo_top_band(grbuf[1], gr.sfbtab, n_sfb)
    if gr.n_long_sfb:
        mb = max(max_band)
        max_band = [mb, mb, mb]
    for i in range(max_blocks):
        default_pos = 3 if hdr_test_mpeg1(hdr) else 0
        itop = n_sfb - max_blocks + i
        prev = itop - max_blocks
        ist_pos[itop] = default_pos if max_band[i] >= prev else ist_pos[prev]
    stereo_process(grbuf, ist_pos, gr.sfbtab, hdr, max_band,
                   gr_pair[1].scalefac_compress & 1)


def reorder(grbuf, offset, sfb):
    dst = []
    src = offset
    i = 0
    while sfb[i]:
        ln = int(sfb[i])
        for k in range(ln):
            dst.append(grbuf[src + k + 0 * ln])
            dst.append(grbuf[src + k + 1 * ln])
            dst.append(grbuf[src + k + 2 * ln])
        src += 3 * ln
        i += 3
    grbuf[offset : offset + len(dst)] = dst


def antialias(grbuf, nbands):
    """The butterflies across each band boundary below ``nbands``."""
    if nbands <= 0:
        return
    g_aa = T()["g_aa"]
    v = grbuf[: 18 * (nbands + 1)].reshape(nbands + 1, 18)
    u = v[1 : nbands + 1, 0:8].copy()
    d = v[0:nbands, 10:18][:, ::-1].copy()
    v[1 : nbands + 1, 0:8] = u * g_aa[0] - d * g_aa[1]
    v[0:nbands, 10:18] = (u * g_aa[1] + d * g_aa[0])[:, ::-1]


def l3_decode_granule(bs: Bits, grs, nch, hdr, grbuf, ist_pos):
    """One granule's channels (L3_decode): scalefactors, Huffman, stereo,
    reorder and antialias into ``grbuf`` [2, 576]; returns its band kinds
    [2, 32]. ``ist_pos`` persists across the frame's granules (scfsi
    sharing copies granule 0's scalefactors into granule 1)."""
    for ch in range(nch):
        layer3gr_limit = bs.pos + grs[ch].part_23_length
        scf = decode_scalefactors(hdr, ist_pos[ch], bs, grs[ch], ch)
        l3_huffman(grbuf[ch], bs, grs[ch], scf, layer3gr_limit)
    if hdr_test_i_stereo(hdr):
        intensity_stereo(grbuf, ist_pos[1], grs, hdr)
    elif hdr_is_ms_stereo(hdr):
        midside_stereo(grbuf, 576)
    kinds = np.zeros((2, 32), np.int8)
    for ch in range(nch):
        gr = grs[ch]
        aa_bands = 31
        n_long_bands = (2 if gr.mixed_block_flag else 0) << (
            1 if hdr_get_my_sample_rate(hdr) == 2 else 0)
        if gr.n_short_sfb:
            aa_bands = n_long_bands - 1
            reorder(grbuf[ch], n_long_bands * 18, gr.sfbtab[gr.n_long_sfb:])
        antialias(grbuf[ch], aa_bands)
        kinds[ch] = mp3_synth.band_kinds(gr.block_type, n_long_bands)
    return kinds


# --------------------------------------------------------------------------
# Layer I/II (minimp3.h:317-481)
# --------------------------------------------------------------------------
_BITALLOC_CODE_TAB = [
    0, 17, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    0, 17, 18, 3, 19, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 16,
    0, 17, 18, 3, 19, 4, 5, 16,
    0, 17, 18, 16,
    0, 17, 18, 19, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    0, 17, 18, 3, 19, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
]

# dequant scale per quantizer: 2^-20-ish / (levels), three per entry
_DEQ_L12 = np.array([
    s / x
    for x in (3, 7, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
              16383, 32767, 65535, 3, 5, 9)
    for s in (9.53674316e-07, 7.56931807e-07, 6.00777173e-07)
], np.float32)


def l12_subband_alloc_table(hdr):
    """-> (alloc [(tab_offset, code_tab_width, band_count)...],
           total_bands, stereo_bands)."""
    mode = hdr_get_stereo_mode(hdr)
    stereo_bands = (0 if mode == MODE_MONO
                    else (hdr_get_stereo_mode_ext(hdr) << 2) + 4
                    if mode == MODE_JOINT_STEREO else 32)
    if hdr_is_layer_1(hdr):
        alloc = [(76, 4, 32)]
        nbands = 32
    elif not hdr_test_mpeg1(hdr):
        alloc = [(60, 4, 4), (44, 3, 7), (44, 2, 19)]
        nbands = 30
    else:
        sample_rate_idx = hdr_get_sample_rate(hdr)
        kbps = hdr_bitrate_kbps(hdr) >> (1 if mode != MODE_MONO else 0)
        if not kbps:
            kbps = 192
        alloc = [(0, 4, 3), (16, 4, 8), (32, 3, 12), (40, 2, 7)]
        nbands = 27
        if kbps < 56:
            alloc = [(44, 4, 2), (44, 3, 10)]
            nbands = 12 if sample_rate_idx == 2 else 8
        elif kbps >= 96 and sample_rate_idx != 1:
            nbands = 30
    return alloc, nbands, min(stereo_bands, nbands)


def l12_read_scale_info(hdr, bs: Bits):
    alloc, total_bands, stereo_bands = l12_subband_alloc_table(hdr)
    bitalloc = np.zeros(64, np.int32)
    scfcod = np.zeros(64, np.int32)
    scf = np.zeros(64 * 3, np.float32)

    ai = 0
    k = 0
    ba_bits = 0
    tab_off = 0
    for i in range(total_bands):
        if i == k:
            tab_off, ba_bits, cnt = alloc[ai]
            k += cnt
            ai += 1
        ba = _BITALLOC_CODE_TAB[tab_off + bs.get(ba_bits)]
        bitalloc[2 * i] = ba
        if i < stereo_bands:
            ba = _BITALLOC_CODE_TAB[tab_off + bs.get(ba_bits)]
        bitalloc[2 * i + 1] = ba if stereo_bands else 0

    for i in range(2 * total_bands):
        scfcod[i] = (
            (2 if hdr_is_layer_1(hdr) else bs.get(2)) if bitalloc[i] else 6
        )

    # L12_read_scalefactors (minimp3.h:362-384)
    si = 0
    for i in range(2 * total_bands):
        s = 0.0
        ba = int(bitalloc[i])
        mask = (4 + ((19 >> int(scfcod[i])) & 3)) if ba else 0
        for m in (4, 2, 1):
            if mask & m:
                b = bs.get(6)
                s = float(_DEQ_L12[ba * 3 - 6 + b % 3]) * float(
                    (1 << 21) >> (b // 3)
                )
            scf[si] = s
            si += 1

    for i in range(stereo_bands, total_bands):
        bitalloc[2 * i + 1] = 0

    return dict(bitalloc=bitalloc, scf=scf, total_bands=total_bands,
                stereo_bands=stereo_bands)


def l12_dequantize_granule(grbuf, bs: Bits, sci, group_size, i_off):
    """minimp3.h:434-467; grbuf [2, 576], writes band*18 + i_off + ..."""
    total = sci["total_bands"]
    bitalloc = sci["bitalloc"]
    for j in range(4):
        base = i_off + group_size * j
        for i in range(2 * total):
            ch = i & 1
            band = i >> 1
            ba = int(bitalloc[i])
            if ba:
                dst = band * 18 + base
                if ba < 17:
                    half = (1 << (ba - 1)) - 1
                    for kk in range(group_size):
                        grbuf[ch][dst + kk] = float(bs.get(ba) - half)
                else:
                    mod = (2 << (ba - 17)) + 1          # 3, 5, 9
                    code = bs.get(mod + 2 - (mod >> 3))  # 5, 7, 10
                    for kk in range(group_size):
                        grbuf[ch][dst + kk] = float(code % mod - mod // 2)
                        code //= mod
    return group_size * 4


def l12_apply_scf_384(sci, igr, grbuf):
    """minimp3.h:469-481."""
    total = sci["total_bands"]
    stereo = sci["stereo_bands"]
    scf = sci["scf"]
    if total > stereo:
        grbuf[1][stereo * 18 : total * 18] = grbuf[0][
            stereo * 18 : total * 18
        ]
    for i in range(total):
        grbuf[0][i * 18 : i * 18 + 12] *= scf[i * 6 + igr]
        grbuf[1][i * 18 : i * 18 + 12] *= scf[i * 6 + 3 + igr]


class Mp3Decoder:
    """Frame decoder state: the last header, the free-format size, the
    Layer III bit reservoir, and an epoch that counts resets (a reset
    sends the synthesis back to silence, so the caller starts a new
    segment)."""

    def __init__(self):
        self.epoch = -1
        self._reset()

    def _reset(self):
        self.header = bytes(4)
        self.free_format_bytes = 0
        self.reserv = 0
        self.reserv_buf = bytearray(MAX_BITRESERVOIR_BYTES)
        self.epoch += 1

    def decode_frame(self, data: bytes):
        """Decode one frame. Returns (granules or None, bytes consumed,
        channels, hz): granules is a list of (buffer [2, 576], nbands,
        kinds) — frequency-domain planes with their band kinds [2, 32]
        for Layer III (nbands 18), time-domain band slices with kinds
        None for Layer I/II (nbands 12) — or None when the frame failed
        or no frame was found."""
        i = 0
        frame_size = 0
        if len(data) > 4 and self.header[0:1] == b"\xff" and hdr_compare(
            self.header, data
        ):
            frame_size = hdr_frame_bytes(data, self.free_format_bytes) + \
                hdr_padding(data)
            if frame_size != len(data) and (
                frame_size + HDR_SIZE > len(data)
                or not hdr_compare(data, data[frame_size:])
            ):
                frame_size = 0
        if not frame_size:
            self._reset()
            ffb = [0]
            i, frame_size = find_frame(data, ffb)
            self.free_format_bytes = ffb[0]
            if not frame_size or i + frame_size > len(data):
                return None, i, 0, 0
        hdr = bytes(data[i : i + HDR_SIZE])
        self.header = hdr
        channels = 1 if hdr_is_mono(hdr) else 2
        hz = hdr_sample_rate_hz(hdr)
        layer = 4 - hdr_get_layer(hdr)
        bs = Bits(bytes(data[i + HDR_SIZE : i + frame_size]))
        if hdr_is_crc(hdr):
            bs.get(16)
        if layer == 3:
            return self._decode_l3(bs, hdr, channels), i + frame_size, \
                channels, hz
        sci = l12_read_scale_info(hdr, bs)
        group_size = layer | 1          # L1 -> 1, L2 -> 3
        grbuf = np.zeros((2, 576), np.float32)
        out = []
        i_off = 0
        for igr in range(3):
            i_off += l12_dequantize_granule(grbuf, bs, sci, group_size,
                                            i_off)
            if i_off == 12:
                i_off = 0
                l12_apply_scf_384(sci, igr, grbuf)
                out.append((grbuf.copy(), 12, None))
                grbuf[:] = 0
            if bs.pos > bs.limit:
                self._reset()
                return None, i + frame_size, channels, hz
        return out, i + frame_size, channels, hz

    def _decode_l3(self, bs: Bits, hdr, channels):
        """A Layer III frame: side info, the main data behind the bit
        reservoir, its granules (None when the reservoir is short of
        main_data_begin or the side info is invalid), then the reservoir
        kept for the next frame."""
        try:
            main_data_begin, grs = read_side_info(bs, hdr)
        except DecodeError:
            self._reset()
            return None
        frame_bytes = (bs.limit - bs.pos) // 8
        bytes_have = min(self.reserv, main_data_begin)
        start = max(0, self.reserv - main_data_begin)
        maindata = (bytes(self.reserv_buf[start : start + bytes_have])
                    + bs.buf[bs.pos // 8 : bs.pos // 8 + frame_bytes])
        mbs = Bits(maindata)
        out = None
        if self.reserv >= main_data_begin:
            out = []
            ist_pos = np.zeros((2, 40), np.int32)
            for igr in range(2 if hdr_test_mpeg1(hdr) else 1):
                grbuf = np.zeros((2, 576), np.float32)
                kinds = l3_decode_granule(mbs, grs[igr * channels:],
                                          channels, hdr, grbuf, ist_pos)
                out.append((grbuf, 18, kinds))
        pos = (mbs.pos + 7) // 8
        remains = mbs.limit // 8 - pos
        if remains > MAX_BITRESERVOIR_BYTES:
            pos += remains - MAX_BITRESERVOIR_BYTES
            remains = MAX_BITRESERVOIR_BYTES
        if remains > 0:
            self.reserv_buf[:remains] = maindata[pos : pos + remains]
        self.reserv = max(0, remains)
        return out


def _decode_mp3_buffer_frames(data: bytes, device):
    """The frame loop for streams the native decode hands back (flag 4):
    free-format Layer III and Layer I/II frames collect their granule
    buffers per segment, and each segment (broken by decoder resets and
    by (nbands, channels) changes) synthesizes on the device from
    silence."""
    dec = Mp3Decoder()
    pos = 0
    segs = []
    cur_g, cur_k = [], []
    cur_nb = cur_ch = channels = hz = 0

    def flush():
        nonlocal cur_g, cur_k
        if cur_g:
            kinds = None if cur_k[0] is None else np.stack(cur_k)
            segs.append(_synth_segment(np.stack(cur_g), kinds, cur_nb,
                                       cur_ch, device))
            cur_g, cur_k = [], []

    view = memoryview(data)
    while pos < len(data):
        epoch = dec.epoch
        grans, consumed, ch, rate = dec.decode_frame(view[pos:])
        if consumed == 0:
            break
        pos += consumed
        if dec.epoch != epoch:
            flush()     # decoder reset: qmf state back to silence
        if grans is None:
            continue    # failed frame: its partial granules are dropped
        channels, hz = ch, rate
        for g, nb, kinds in grans:
            if cur_g and (nb != cur_nb or ch != cur_ch):
                flush()
            cur_nb, cur_ch = nb, ch
            cur_g.append(g)
            cur_k.append(kinds)
    flush()
    if not segs:
        raise DecodeError("no decodable MP3 frames found")
    return _join(segs), channels, hz


def decode_mp3_buffer(data: bytes, audio: AudioData, device) -> None:
    """Whole-buffer decode into ``audio``: Layer III through the native
    stream decode, what it hands back through the frame loop; the synthesis runs
    on ``device`` and the PCM comes back in one copy."""
    out = _decode_mp3_buffer_native(data, device)
    if out is None:
        out = _decode_mp3_buffer_frames(data, device)
    pcm, channels, hz = out
    pcm = pcm.cpu().numpy()
    audio.channel_count = channels
    audio.sample_rate = hz
    audio.source_format = PCMFormat.PCM_FLT
    audio.samples = np.ascontiguousarray(pcm.reshape(-1), np.float32)
    audio.length_seconds = pcm.shape[0] / hz if hz else 0.0
