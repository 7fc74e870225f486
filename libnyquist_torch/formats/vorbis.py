"""Ogg Vorbis decoder (Vorbis I): host entropy decode, device synthesis.

After the libvorbis decode path (reference: third_party/libvorbis/src —
codebook.c/sharedbook.c codebook decode, floor1.c floor curves (:956
floor1_inverse1, :1042 inverse2), floor0.c + lsp.c, res0.c residues
0/1/2, mapping0.c:700 channel coupling, mdct.c:397 IMDCT, block.c
long/short window lapping, vorbisfile.c ov_read_float output semantics).

* Host: the Ogg demux (``native/ogg_opus.c`` ``ogg_collect_packets``,
  or ``formats/ogg.py`` for chained files), the setup parse below, and
  the packet entropy decode in C (``native/vorbis_res.c``): floor 1
  posts and curve, residues, inverse coupling and the floor-curve
  multiply, for a whole stream in one call. Streams with floor 0 or more
  than 8 channels take the per-packet loop, which decodes floor 0 in
  Python and calls the C floor 1 and residue entries per packet.
* Device: the synthesis of the staged spectra
  (``runtime/serving.py`` ``synthesize_vorbis_streams_mixed``): one
  IMDCT product per blocksize, the lap windows and the overlap-add as
  two gathers with indices planned on the host.

There is no Python version of what the C decodes.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import types

import numpy as np
import torch

from ..audio_data import AudioData, PCMFormat
from ..errors import DecodeError
from ..runtime import native
from . import ogg

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data" / (
    "vorbis_tables.npz"
)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=1)
def _floor1_fromdb():
    return np.load(_DATA)["floor1_fromdb"].astype(np.float32)


def ilog(x: int) -> int:
    """Vorbis ilog: bits needed for x (ilog(0)=0, negative -> 0)."""
    if x <= 0:
        return 0
    return x.bit_length()


def float32_unpack(x: int) -> float:
    mantissa = x & 0x1FFFFF
    sign = x & 0x80000000
    exponent = (x & 0x7FE00000) >> 21
    if sign:
        mantissa = -mantissa
    return float(mantissa) * (2.0 ** (exponent - 788))


class LsbBits:
    """LSB-first bit reader (Vorbis convention)."""

    __slots__ = ("data", "pos", "limit", "eop")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.limit = len(data) * 8
        self.eop = False

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.limit:
            self.eop = True
            self.pos = self.limit
            return 0
        byte = self.pos >> 3
        off = self.pos & 7
        nbytes = (off + n + 7) >> 3
        chunk = int.from_bytes(self.data[byte : byte + nbytes], "little")
        self.pos += n
        return (chunk >> off) & ((1 << n) - 1)

    def read1(self) -> int:
        return self.read(1)

    def peek(self, n: int) -> int:
        """Peek n bits without consuming; past-end bits read as zero."""
        byte = self.pos >> 3
        off = self.pos & 7
        nbytes = (off + n + 7) >> 3
        chunk = int.from_bytes(self.data[byte : byte + nbytes], "little")
        return (chunk >> off) & ((1 << n) - 1)


def build_codewords(lengths):
    """Assign codewords per the Vorbis I spec (§3.2.1 decision tree):
    entries in order each take the lowest available leaf at their depth in
    an incrementally-built binary tree. NOT canonical Huffman — the two
    differ when lengths are not sorted."""
    codes = [0] * len(lengths)
    available = [0] * 33        # left-justified 32-bit prefixes
    first = True
    for i, ln in enumerate(lengths):
        if ln <= 0:
            continue
        if first:
            first = False
            codes[i] = 0
            for j in range(1, ln + 1):
                available[j] = 1 << (32 - j)
            continue
        z = ln
        while z > 0 and not available[z]:
            z -= 1
        if z == 0:
            raise DecodeError("over-subscribed codebook")
        res = available[z]
        available[z] = 0
        codes[i] = res >> (32 - ln)
        for y in range(z + 1, ln + 1):
            available[y] = res + (1 << (32 - y))
    return codes


class EndOfPacket(Exception):
    pass


class VorbisCodebook:
    def __init__(self, bits: LsbBits):
        if bits.read(24) != 0x564342:
            raise DecodeError("bad codebook sync")
        self.dimensions = bits.read(16)
        self.entries = bits.read(24)
        # every entry costs >= 1 coded bit, so a valid codebook can never
        # declare more entries than bits remain in the setup packet
        if self.entries > bits.limit - bits.pos:
            raise DecodeError("codebook entries exceed setup packet")
        ordered = bits.read1()
        lengths = [0] * self.entries
        if not ordered:
            sparse = bits.read1()
            for i in range(self.entries):
                if sparse:
                    if bits.read1():
                        lengths[i] = bits.read(5) + 1
                else:
                    lengths[i] = bits.read(5) + 1
        else:
            cur_len = bits.read(5) + 1
            i = 0
            while i < self.entries:
                num = bits.read(ilog(self.entries - i))
                if bits.eop or cur_len > 32:
                    # reads past the end return 0, and codeword lengths
                    # cap at 32: a corrupt ordered codebook would loop
                    raise DecodeError("bad ordered codebook run")
                for _ in range(num):
                    if i >= self.entries:
                        raise DecodeError("ordered codebook overrun")
                    lengths[i] = cur_len
                    i += 1
                cur_len += 1
        self.lengths = lengths

        self.lookup_type = bits.read(4)
        self.vq = None
        if self.lookup_type == 1 or self.lookup_type == 2:
            if self.entries * max(self.dimensions, 1) > (1 << 18):
                raise DecodeError("codebook VQ table too large")
            minimum = float32_unpack(bits.read(32))
            delta = float32_unpack(bits.read(32))
            value_bits = bits.read(4) + 1
            sequence_p = bits.read1()
            if self.lookup_type == 1:
                if self.dimensions == 0:
                    raise DecodeError("VQ codebook with zero dimensions")
                # lookup1_values: largest v with v^dim <= entries
                lv = 0
                while (lv + 1) ** self.dimensions <= self.entries:
                    lv += 1
                quant_count = lv
            else:
                quant_count = self.entries * self.dimensions
            if quant_count > bits.limit - bits.pos:
                raise DecodeError("codebook lookup exceeds setup packet")
            mults = [bits.read(value_bits) for _ in range(quant_count)]
            vq = np.zeros((self.entries, self.dimensions), np.float32)
            for e in range(self.entries):
                last = 0.0
                idx_div = 1
                for d in range(self.dimensions):
                    if self.lookup_type == 1:
                        m = mults[(e // idx_div) % quant_count]
                        idx_div *= quant_count
                    else:
                        m = mults[e * self.dimensions + d]
                    v = m * delta + minimum + last
                    vq[e, d] = v
                    if sequence_p:
                        last = v
            # an overflowing float32_unpack exponent must not turn into
            # inf and NaN the spectrum downstream
            np.nan_to_num(vq, copy=False, posinf=0.0, neginf=0.0)
            self.vq = vq
        elif self.lookup_type != 0:
            raise DecodeError("reserved codebook lookup type")

        codes = build_codewords(self.lengths)
        self.decode_map = {}
        self.min_len = 33
        self.max_len = 0
        for i, ln in enumerate(self.lengths):
            if ln > 0:
                self.decode_map[(ln, codes[i])] = i
                self.min_len = min(self.min_len, ln)
                self.max_len = max(self.max_len, ln)
        # a W-bit LUT over the LSB-first peek window: codeword bits arrive
        # MSB-of-codeword first, so the key is the bit-reversed codeword
        # with every upper-bit suffix filled in
        W = min(self.max_len, 11) if self.max_len > 0 else 0
        self.lut_w = W
        if W > 0:
            lut = np.full(1 << W, -1, np.int32)
            for (ln, code), i in self.decode_map.items():
                if ln <= W:
                    rev = int(format(code, f"0{ln}b")[::-1], 2)
                    lut[rev :: 1 << ln] = (i << 6) | ln
            self.lut = lut
        else:
            self.lut = None

    def decode_scalar(self, bits: LsbBits) -> int:
        """One codeword (the floor 0 LSP words: the only codebook reads
        left on the Python side)."""
        if self.lut is not None:
            v = int(self.lut[bits.peek(self.lut_w)])
            if v >= 0:
                ln = v & 63
                if bits.pos + ln > bits.limit:
                    bits.eop = True
                    bits.pos = bits.limit
                    raise EndOfPacket()
                bits.pos += ln
                return v >> 6
        code = 0
        ln = 0
        while ln < self.max_len:
            b = bits.read1()
            if bits.eop:
                raise EndOfPacket()
            code = (code << 1) | b
            ln += 1
            if ln >= self.min_len:
                e = self.decode_map.get((ln, code))
                if e is not None:
                    return e
        raise EndOfPacket()

    def decode_vq(self, bits) -> np.ndarray:
        return self.vq[self.decode_scalar(bits)]

    def tree_nodes(self) -> np.ndarray:
        """Binary decode tree as flat int32 node pairs for the native
        decoder: child 0 = unset, negative = ~entry leaf (-(entry+1))."""
        tr = getattr(self, "_tree", None)
        if tr is not None:
            return tr
        nodes = [0, 0]
        for (ln, code), e in self.decode_map.items():
            cur = 0
            for depth in range(ln - 1, 0, -1):
                b = (code >> depth) & 1
                nxt = nodes[2 * cur + b]
                if nxt == 0:
                    nodes.extend((0, 0))
                    nxt = (len(nodes) >> 1) - 1
                    nodes[2 * cur + b] = nxt
                cur = nxt
            nodes[2 * cur + (code & 1)] = -(e + 1)
        self._tree = np.array(nodes, np.int32)
        return self._tree


def _cat(chunks, dt):
    return (np.concatenate(chunks).astype(dt, copy=False)
            if chunks else np.zeros(1, dt))


def _book_registry(books):
    """The flat codebook registry (LUTs, trees, VQ tables) the C reads,
    marshalled once per setup and kept on books[0]: the arrays live as
    long as the cached setup, so the pointers in ``ptrs`` stay valid."""
    first = books[0]
    reg = getattr(first, "_native_reg", None)
    if reg is not None:
        return reg
    luts, lut_off, lut_w = [], [], []
    trees, tree_off, maxlen = [], [], []
    vq_chunks, vq_off, dims = [], [], []
    lo = to = vo = 0
    for bk in books:
        lut_off.append(lo)
        if bk.lut is not None:
            luts.append(np.ascontiguousarray(bk.lut, np.int32))
            lo += bk.lut.size
            lut_w.append(bk.lut_w)
        else:
            lut_w.append(0)
        tr = bk.tree_nodes()
        trees.append(tr)
        tree_off.append(to)
        to += tr.size
        maxlen.append(min(bk.max_len, 32))
        dims.append(bk.dimensions)
        if bk.vq is not None:
            v = np.ascontiguousarray(bk.vq, np.float32).reshape(-1)
            vq_chunks.append(v)
            vq_off.append(vo)
            vo += v.size
        else:
            vq_off.append(-1)
    reg = dict(
        luts=_cat(luts, np.int32), trees=_cat(trees, np.int32),
        vqs=_cat(vq_chunks, np.float32),
        lut_off=np.asarray(lut_off, np.int64),
        lut_w=np.asarray(lut_w, np.int32),
        tree_off=np.asarray(tree_off, np.int64),
        maxlen=np.asarray(maxlen, np.int32),
        vq_off=np.asarray(vq_off, np.int64),
        dims=np.asarray(dims, np.int32),
    )
    reg["ptrs"] = (
        reg["luts"].ctypes.data_as(_I32P),
        reg["lut_off"].ctypes.data_as(_I64P),
        reg["lut_w"].ctypes.data_as(_I32P),
        reg["trees"].ctypes.data_as(_I32P),
        reg["tree_off"].ctypes.data_as(_I64P),
        reg["maxlen"].ctypes.data_as(_I32P),
        reg["vqs"].ctypes.data_as(_F32P),
        reg["vq_off"].ctypes.data_as(_I64P),
        reg["dims"].ctypes.data_as(_I32P),
    )
    first._native_reg = reg
    return reg


def _native_packet_ctx(channels, blocksizes, modes, mappings, floors,
                       residues, books):
    """The whole stream config marshalled for native/vorbis_res.c
    vorbis_stream_decode (once per setup), or None for the shapes the
    whole-stream entry does not take: floor 0 and more than 8 channels,
    which go through the per-packet loop."""
    if channels > 8 or any(isinstance(fl, Floor0) for fl in floors):
        return None
    reg = _book_registry(books)
    map_meta, map_mux, map_submap, map_coup = [], [], [], []
    for mp in mappings:
        map_meta.extend([mp.submaps, len(mp.coupling), len(map_mux),
                         len(map_submap), len(map_coup)])
        map_mux.extend(int(x) for x in mp.mux)
        for s in range(mp.submaps):
            map_submap.extend([int(mp.submap_floor[s]),
                               int(mp.submap_residue[s])])
        for mag, ang in mp.coupling:
            map_coup.extend([int(mag), int(ang)])
    fl_cfgs, fl_nbrs, fl_sorts, fl_off = [], [], [], []
    for fl in floors:
        c = fl.native_cfg()
        fl_off.extend([sum(a.size for a in fl_cfgs),
                       sum(a.size for a in fl_nbrs),
                       sum(a.size for a in fl_sorts)])
        fl_cfgs.append(c["cfg"])
        fl_nbrs.append(c["nbrs"])
        fl_sorts.append(c["sort"])
    res_meta, res_books8 = [], []
    for r in residues:
        res_meta.extend([r.type, r.begin, r.end, r.partition_size,
                         r.classifications, r.classbook, len(res_books8)])
        for row in r.books:
            res_books8.extend(int(b) for b in row)
    i32 = np.int32
    ctx = dict(
        reg=reg,
        mode_cfg=np.asarray([[bf, mi] for bf, mi in modes], i32).reshape(-1),
        map_meta=np.asarray(map_meta, i32),
        map_mux=np.asarray(map_mux or [0], i32),
        map_submap=np.asarray(map_submap or [0], i32),
        map_coup=np.asarray(map_coup or [0], i32),
        fl_cfgs=_cat(fl_cfgs, i32), fl_nbrs=_cat(fl_nbrs, i32),
        fl_sorts=_cat(fl_sorts, i32),
        fl_off=np.asarray(fl_off, np.int64),
        fromdb=np.ascontiguousarray(_floor1_fromdb(), np.float32),
        res_meta=np.asarray(res_meta, i32),
        res_books8=np.asarray(res_books8 or [0], i32),
    )
    ctx["args"] = (
        int(channels), int(blocksizes[0]), int(blocksizes[1]),
        ilog(len(modes) - 1),
        ctx["mode_cfg"].ctypes.data_as(_I32P), len(modes),
        ctx["map_meta"].ctypes.data_as(_I32P),
        ctx["map_mux"].ctypes.data_as(_I32P),
        ctx["map_submap"].ctypes.data_as(_I32P),
        ctx["map_coup"].ctypes.data_as(_I32P),
        ctx["fl_cfgs"].ctypes.data_as(_I32P),
        ctx["fl_nbrs"].ctypes.data_as(_I32P),
        ctx["fl_sorts"].ctypes.data_as(_I32P),
        ctx["fl_off"].ctypes.data_as(_I64P),
        ctx["fromdb"].ctypes.data_as(_F32P),
        ctx["res_meta"].ctypes.data_as(_I32P),
        ctx["res_books8"].ctypes.data_as(_I32P),
        *reg["ptrs"],
    )
    return ctx


# --------------------------------------------------------------------------
# Floors
# --------------------------------------------------------------------------
class Floor0:
    """LSP floor (Vorbis I spec §6, reference: libvorbis/src/floor0.c +
    lsp.c vorbis_lsp_to_curve), decoded in Python on the per-packet
    loop."""

    def __init__(self, bits: LsbBits):
        self.order = bits.read(8)
        self.rate = bits.read(16)
        self.barkmap = bits.read(16)
        self.ampbits = bits.read(6)
        self.ampdB = bits.read(8)
        self.numbooks = bits.read(4) + 1
        self.books = [bits.read(8) for _ in range(self.numbooks)]
        if self.order < 1 or self.rate < 1 or self.barkmap < 1:
            raise DecodeError("bad floor0 header")
        self._maps = {}

    def _map(self, n2):
        m = self._maps.get(n2)
        if m is None:
            # floor0.c:126 floor0_map_lazy_init — band-edge bark bins
            def bark(x):
                return (13.1 * np.arctan(0.00074 * x)
                        + 2.24 * np.arctan(x * x * 1.85e-8) + 1e-4 * x)

            scale = self.barkmap / bark(self.rate / 2.0)
            j = np.arange(n2)
            val = np.floor(
                bark((self.rate / 2.0) / n2 * j) * scale).astype(int)
            m = np.minimum(val, self.barkmap - 1)
            self._maps[n2] = m
        return m

    def decode_curve(self, bits, books, n2):
        """Full decode + LSP curve synthesis (floor0_inverse1/2): the
        curve [n2] float64, or None for an unused channel."""
        ampraw = bits.read(self.ampbits)
        if ampraw <= 0:
            return None
        amp = ampraw / ((1 << self.ampbits) - 1) * self.ampdB
        booknum = bits.read(ilog(self.numbooks))
        if booknum >= self.numbooks:
            return None
        book = books[self.books[booknum]]
        lsp = []
        last = 0.0
        while len(lsp) < self.order:
            vec = book.decode_vq(bits)
            lsp.extend(float(v) + last for v in vec)
            last = lsp[-1]
        lsp = np.asarray(lsp[: self.order], np.float64)
        if not np.isfinite(lsp).all():
            raise DecodeError("non-finite floor0 LSP values")
        # vorbis_lsp_to_curve (lsp.c:140): products over 2cos(lsp)
        m = self.order
        lsp2 = 2.0 * np.cos(lsp)
        mapv = self._map(n2)
        ks = np.unique(mapv)
        w = 2.0 * np.cos(np.pi * ks / self.barkmap)
        q = np.full(len(ks), 0.5)
        p = np.full(len(ks), 0.5)
        j = 1
        while j < m:
            q *= w - lsp2[j - 1]
            p *= w - lsp2[j]
            j += 2
        if j == m:  # odd order
            q *= w - lsp2[j - 1]
            p = p * p * (4.0 - w * w)
            q = q * q
        else:       # even order
            p = p * p * (2.0 - w)
            q = q * q * (2.0 + w)
        # degenerate (coincident) LSP roots drive p+q -> 0: keep the
        # curve finite where the reference computes inf
        expo = np.clip(amp / np.sqrt(np.maximum(p + q, 1e-300))
                       - self.ampdB, -400.0, 400.0)
        lut = np.zeros(self.barkmap, np.float64)
        lut[ks] = np.exp(expo * 0.11512925)
        return lut[mapv]


class Floor1:
    RANGES = [256, 128, 86, 64]

    def __init__(self, bits: LsbBits):
        self.partitions = bits.read(5)
        self.partition_class = [bits.read(4) for _ in range(self.partitions)]
        maxclass = max(self.partition_class) if self.partitions else -1
        self.class_dim = []
        self.class_subs = []
        self.class_book = []
        self.subclass_books = []
        for _ in range(maxclass + 1):
            self.class_dim.append(bits.read(3) + 1)
            subs = bits.read(2)
            self.class_subs.append(subs)
            self.class_book.append(bits.read(8) if subs else -1)
            self.subclass_books.append(
                [bits.read(8) - 1 for _ in range(1 << subs)])
        self.mult = bits.read(2) + 1
        rangebits = bits.read(4)
        xs = [0, 1 << rangebits]
        for p in range(self.partitions):
            for _ in range(self.class_dim[self.partition_class[p]]):
                xs.append(bits.read(rangebits))
        self.xlist = xs
        self.posts = len(xs)
        self.sort_idx = sorted(range(self.posts), key=lambda i: xs[i])

    def _neighbors(self, i):
        """low/high neighbor post indices (spec low_neighbor /
        high_neighbor: nearest xs below/above among posts 0..i-1)."""
        xs = self.xlist
        lo = max((j for j in range(i) if xs[j] < xs[i]), key=lambda j: xs[j])
        hi = min((j for j in range(i) if xs[j] > xs[i]), key=lambda j: xs[j])
        return lo, hi

    def native_cfg(self):
        """Packed config for native/vorbis_res.c (layout documented
        there), cached on the floor: the C keeps pointers into it."""
        cfg = getattr(self, "_ncfg", None)
        if cfg is not None:
            return cfg
        rng = self.RANGES[self.mult - 1]
        parts = [self.partitions, self.mult, self.posts, rng,
                 ilog(rng - 1), len(self.class_dim)]
        parts += list(self.partition_class)
        parts += list(self.class_dim)
        parts += list(self.class_subs)
        parts += list(self.class_book)
        for books in self.subclass_books:
            parts += (list(books) + [-1] * 8)[:8]
        parts += list(self.xlist)
        cfg_a = np.asarray(parts, np.int32)
        nbrs = np.asarray([v for i in range(2, self.posts)
                           for v in self._neighbors(i)], np.int32)
        if nbrs.size == 0:
            nbrs = np.zeros(1, np.int32)
        sort_a = np.asarray(self.sort_idx, np.int32)
        fromdb = np.ascontiguousarray(_floor1_fromdb(), np.float32)
        cfg = dict(
            cfg=cfg_a, nbrs=nbrs, sort=sort_a, fromdb=fromdb,
            ptrs=(cfg_a.ctypes.data_as(_I32P), nbrs.ctypes.data_as(_I32P),
                  sort_a.ctypes.data_as(_I32P)),
            fromdb_p=fromdb.ctypes.data_as(_F32P),
        )
        self._ncfg = cfg
        return cfg

    def decode_curve(self, bits, books, n2):
        """Native decode + curve: the float32 curve [n2], or None for an
        unused channel; raises EndOfPacket at the end of the packet."""
        L = native.codec_lib()
        reg = _book_registry(books)
        cfg = self.native_cfg()
        st = np.array([bits.pos, 1 if bits.eop else 0], np.int64)
        curve = np.empty(n2, np.float32)
        rc = L.vorbis_floor1_decode(
            bits.data, len(bits.data), st.ctypes.data_as(_I64P),
            *cfg["ptrs"], *reg["ptrs"][:6], cfg["fromdb_p"], n2,
            curve.ctypes.data_as(_F32P))
        bits.pos = int(st[0])
        bits.eop = bool(st[1])
        if rc == -2:
            raise EndOfPacket()
        return curve if rc else None


# --------------------------------------------------------------------------
# Residues, mappings
# --------------------------------------------------------------------------
class Residue:
    def __init__(self, bits: LsbBits, rtype: int):
        self.type = rtype
        self.begin = bits.read(24)
        self.end = bits.read(24)
        self.partition_size = bits.read(24) + 1
        self.classifications = bits.read(6) + 1
        self.classbook = bits.read(8)
        cascades = []
        for _ in range(self.classifications):
            high = 0
            low = bits.read(3)
            if bits.read1():
                high = bits.read(5)
            cascades.append((high << 3) | low)
        self.books = [[bits.read(8) if cascades[c] & (1 << b) else -1
                       for b in range(8)]
                      for c in range(self.classifications)]
        self._books8 = np.ascontiguousarray(
            np.asarray(self.books, np.int32).reshape(-1))

    def decode(self, bits, books, do_not_decode, ch, n2):
        """[ch, n2] float32 residue vectors through the native decode."""
        out = np.zeros((ch, n2), np.float32)
        total = n2 * ch if self.type == 2 else n2
        begin = min(self.begin, total)
        end = min(self.end, total)
        if end <= begin or (self.type == 2 and all(do_not_decode)):
            return out
        # residue 2 codes ONE channel-interleaved vector of length ch*n2
        work = np.zeros(n2 * ch, np.float32) if self.type == 2 else out
        reg = _book_registry(books)
        st = np.array([bits.pos, 1 if bits.eop else 0], np.int64)
        native.codec_lib().vorbis_residue_decode(
            bits.data, len(bits.data), st.ctypes.data_as(_I64P),
            *reg["ptrs"], int(self.type), int(begin), int(end),
            int(self.partition_size), int(self.classifications),
            int(self.classbook), self._books8.ctypes.data_as(_I32P),
            bytes(1 if x else 0 for x in do_not_decode), int(ch), int(n2),
            work.ctypes.data_as(_F32P))
        bits.pos = int(st[0])
        bits.eop = bool(st[1])
        if self.type == 2:
            out[:] = work.reshape(n2, ch).T
        return out


class Mapping:
    def __init__(self, bits: LsbBits, channels):
        self.submaps = bits.read(4) + 1 if bits.read1() else 1
        self.coupling = []
        if bits.read1():
            for _ in range(bits.read(8) + 1):
                mag = bits.read(ilog(channels - 1))
                ang = bits.read(ilog(channels - 1))
                self.coupling.append((mag, ang))
        if bits.read(2):
            raise DecodeError("reserved mapping bits")
        if self.submaps > 1:
            self.mux = [bits.read(4) for _ in range(channels)]
        else:
            self.mux = [0] * channels
        self.submap_floor = []
        self.submap_residue = []
        for _ in range(self.submaps):
            bits.read(8)  # unused time config
            self.submap_floor.append(bits.read(8))
            self.submap_residue.append(bits.read(8))


# --------------------------------------------------------------------------
# Synthesis tables (reference: libvorbis mdct.c:397, block.c lapping)
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def vorbis_window(n: int) -> np.ndarray:
    x = (np.arange(n) + 0.5) / n * np.pi / 2
    return np.sin(0.5 * np.pi * np.sin(x) ** 2).astype(np.float64)


@functools.lru_cache(maxsize=8)
def imdct_matrix(n: int) -> np.ndarray:
    """The [n, n/2] IMDCT matrix, built in float64."""
    n2 = n // 2
    j = np.arange(n, dtype=np.float64)
    k = np.arange(n2, dtype=np.float64)
    return np.cos((np.pi * 2.0 / n) * np.outer(j + 0.5 + n2 / 2.0, k + 0.5))


def _lap_window(n, blocksizes, blockflag, long_prev, long_next):
    bs0, _ = blocksizes
    w = np.zeros(n, np.float64)
    if not blockflag or (long_prev and long_next):
        full = vorbis_window(n // 2)
        w[: n // 2] = full
        w[n // 2:] = full[::-1]
        return w
    # long block with short neighbors: flat top with short slopes
    ws = vorbis_window(bs0 // 2)
    left_start = n // 4 - bs0 // 4
    if long_prev:
        w[: n // 2] = vorbis_window(n // 2)
    else:
        w[left_start : left_start + bs0 // 2] = ws
        w[left_start + bs0 // 2 : n // 2] = 1.0
    if long_next:
        w[n // 2:] = vorbis_window(n // 2)[::-1]
    else:
        right_start = n - n // 4 - bs0 // 4
        w[n // 2 : right_start] = 1.0
        w[right_start : right_start + bs0 // 2] = ws[::-1]
    return w


# --------------------------------------------------------------------------
# Stream decode
# --------------------------------------------------------------------------
class _CollectedStream:
    """One logical stream from the native Ogg collector: the three header
    packets as bytes, the audio packets left in the contiguous payload
    the whole-stream decode reads."""

    def __init__(self, payload, offs, lens, last_granule):
        self._payload = payload
        self._offs = offs
        self._lens = lens
        self.last_granule = last_granule
        self.packets = [types.SimpleNamespace(data=self._packet(i))
                        for i in range(min(3, len(offs)))]

    def _packet(self, i):
        return bytes(self._payload[self._offs[i] : self._offs[i]
                                   + self._lens[i]])

    def materialize(self):
        """The full packet list, for the per-packet loop."""
        return self.packets + [types.SimpleNamespace(data=self._packet(i))
                               for i in range(3, len(self._offs))]


def _collect_stream_native(data: bytes):
    """One-pass native Ogg demux of the first Vorbis stream, or None when
    the file holds none or is chained (those go through ogg.demux)."""
    n = len(data)
    payload = np.empty(max(n, 1), np.uint8)
    cap = 4096 + n // 8
    offs = np.empty(cap, np.int64)
    lens = np.empty(cap, np.int64)
    info = np.zeros(3, np.int64)
    rc = native.lib().ogg_collect_packets(
        data, n, b"\x01vorbis", 7,
        payload.ctypes.data_as(ctypes.c_char_p), n,
        offs.ctypes.data_as(_I64P), lens.ctypes.data_as(_I64P), cap,
        info.ctypes.data_as(_I64P))
    if rc < 3 or info[1]:       # no stream / too few packets / chained
        return None
    return _CollectedStream(payload, offs[:rc], lens[:rc], int(info[0]))


# Setup-header cache: the parse and the native context are pure functions
# of the setup packet bytes; the cached objects own every array the C
# reads through the context's pointers.
_SETUP_CACHE: dict = {}


def _parse_setup(setup: bytes, channels: int):
    b = LsbBits(setup[7:])
    books = [VorbisCodebook(b) for _ in range(b.read(8) + 1)]
    for _ in range(b.read(6) + 1):
        if b.read(16):
            raise DecodeError("reserved time domain")
    floors = []
    for _ in range(b.read(6) + 1):
        ftype = b.read(16)
        if ftype == 0:
            floors.append(Floor0(b))
        elif ftype == 1:
            floors.append(Floor1(b))
        else:
            raise DecodeError(f"unsupported floor type {ftype}")
    residues = []
    for _ in range(b.read(6) + 1):
        rtype = b.read(16)
        if rtype > 2:
            raise DecodeError("reserved residue type")
        residues.append(Residue(b, rtype))
    mappings = []
    for _ in range(b.read(6) + 1):
        if b.read(16):
            raise DecodeError("reserved mapping type")
        mappings.append(Mapping(b, channels))
    modes = []
    for _ in range(b.read(6) + 1):
        blockflag = b.read1()
        if b.read(16) or b.read(16):
            raise DecodeError("reserved mode bits")
        modes.append((blockflag, b.read(8)))
    # every codebook reference checked once: a corrupt setup would
    # otherwise send the C past the end of the registry
    nb = len(books)

    def bad(refs):
        return any(bk >= nb for bk in refs if bk >= 0)

    for fl in floors:
        if isinstance(fl, Floor0):
            refs = fl.books
        else:
            refs = fl.class_book + [bk for row in fl.subclass_books
                                    for bk in row]
        if bad(refs):
            raise DecodeError("floor references missing codebook")
    for r in residues:
        if r.classbook >= nb or bad(bk for row in r.books for bk in row):
            raise DecodeError("residue references missing codebook")
    for mp in mappings:
        if any(m >= mp.submaps for m in mp.mux):
            raise DecodeError("mapping mux exceeds submap count")
        for s in range(mp.submaps):
            if (mp.submap_floor[s] >= len(floors)
                    or mp.submap_residue[s] >= len(residues)):
                raise DecodeError("mapping references missing config")
    if any(mi >= len(mappings) for _, mi in modes):
        raise DecodeError("mode references missing mapping")
    return books, floors, residues, mappings, modes


def _decode_stream_packets(st):
    """The host half of one logical Vorbis stream: (staged, blocksizes,
    channels, rate, end_granule), staged holding per audio packet
    (specs [ch, n2], n, blockflag, long_prev, long_next, nonzero) — the
    spectra after coupling and the floor multiply."""
    b = LsbBits(st.packets[0].data[7:])
    b.read(32)
    channels = b.read(8)
    rate = b.read(32)
    b.read(96)
    bs0 = 1 << b.read(4)
    bs1 = 1 << b.read(4)
    # info.c:217-219 vorbis_unpack_info bounds: without the 8192 cap a
    # corrupt exponent asks for a multi-GB IMDCT matrix
    if rate < 1 or channels < 1:
        raise DecodeError("vorbis: bad ID header")
    if bs0 < 64 or bs1 < bs0 or bs1 > 8192:
        raise DecodeError("vorbis: invalid blocksizes")
    if len(st.packets) < 3:
        raise DecodeError("vorbis: missing setup header")
    setup = st.packets[2].data
    key = (hash(setup), channels)
    cached = _SETUP_CACHE.get(key)
    if cached is None:
        cached = _parse_setup(setup, channels)
        if len(_SETUP_CACHE) > 16:
            _SETUP_CACHE.clear()
        _SETUP_CACHE[key] = cached
    books, floors, residues, mappings, modes = cached
    blocksizes = (bs0, bs1)
    if (key, "ctx") not in _SETUP_CACHE:
        _SETUP_CACHE[(key, "ctx")] = _native_packet_ctx(
            channels, blocksizes, modes, mappings, floors, residues, books)
    ctx = _SETUP_CACHE[(key, "ctx")]
    staged = None
    if ctx is not None:
        staged = _stream_decode_native(st, ctx, channels, bs1)
    if staged is None:
        packets = (st.materialize() if isinstance(st, _CollectedStream)
                   else st.packets)
        staged = _decode_packets(packets[3:], channels, blocksizes, modes,
                                 mappings, floors, residues, books)
    return staged, blocksizes, channels, rate, st.last_granule


def _stream_decode_native(st, ctx, channels, bs1):
    """Every audio packet in one native call; None when the C asks for
    the per-packet loop."""
    if isinstance(st, _CollectedStream):
        payload = st._payload.ctypes.data_as(ctypes.c_char_p)
        poff = np.ascontiguousarray(st._offs[3:])
        plen = np.ascontiguousarray(st._lens[3:])
    else:
        pkts = [p.data for p in st.packets[3:] if p.data]
        payload = b"".join(pkts)
        plen = np.fromiter((len(p) for p in pkts), np.int64, len(pkts))
        poff = np.concatenate(([0], np.cumsum(plen[:-1]))).astype(np.int64) \
            if len(pkts) else np.zeros(0, np.int64)
    n_pk = len(poff)
    cap = n_pk * channels * (bs1 // 2)
    flat = np.empty(max(cap, 1), np.float32)
    infos = np.zeros((max(n_pk, 1), 12), np.int32)
    rc = native.codec_lib().vorbis_stream_decode(
        payload, poff.ctypes.data_as(_I64P), plen.ctypes.data_as(_I64P),
        n_pk, *ctx["args"], cap, flat.ctypes.data_as(_F32P),
        infos.ctypes.data_as(_I32P))
    if rc < 0:
        return None
    staged = []
    pos = 0
    for info in infos[: int(rc)]:
        n = int(info[0])
        n2 = n // 2
        # views into `flat`, which they keep alive
        specs = flat[pos : pos + channels * n2].reshape(channels, n2)
        pos += channels * n2
        staged.append((specs, n, bool(info[1]), bool(info[2]),
                       bool(info[3]),
                       [bool(info[4 + c]) for c in range(channels)]))
    return staged


def _decode_packets(packets, channels, blocksizes, modes, mappings, floors,
                    residues, books):
    """The per-packet loop (floor 0, more than 8 channels): floors and
    residues per packet, inverse coupling, the floor multiply."""
    mode_bits = ilog(len(modes) - 1)
    staged = []
    for pkt in packets:
        if not pkt.data:
            continue
        bits = LsbBits(pkt.data)
        if bits.read1():
            continue
        mode_idx = bits.read(mode_bits)
        if mode_idx >= len(modes):
            continue
        blockflag, map_idx = modes[mode_idx]
        n = blocksizes[blockflag]
        long_prev = long_next = True
        if blockflag:
            long_prev = bool(bits.read1())
            long_next = bool(bits.read1())
        mapping = mappings[map_idx]
        n2 = n // 2
        curves = [None] * channels
        res_out = np.zeros((channels, n2), np.float32)
        try:
            for c in range(channels):
                fl = floors[mapping.submap_floor[mapping.mux[c]]]
                curves[c] = fl.decode_curve(bits, books, n2)
            nz = [cv is not None for cv in curves]
            for mag, ang in mapping.coupling:
                if nz[mag] or nz[ang]:
                    nz[mag] = nz[ang] = True
            for s in range(mapping.submaps):
                ch_in = [c for c in range(channels) if mapping.mux[c] == s]
                r = residues[mapping.submap_residue[s]]
                dec = r.decode(bits, books, [not nz[c] for c in ch_in],
                               len(ch_in), n2)
                for i, c in enumerate(ch_in):
                    res_out[c] = dec[i]
        except EndOfPacket:
            pass
        for mag, ang in reversed(mapping.coupling):
            m = res_out[mag].copy()
            a = res_out[ang].copy()
            res_out[mag] = np.where(m > 0, np.where(a > 0, m, m + a),
                                    np.where(a > 0, m, m - a))
            res_out[ang] = np.where(m > 0, np.where(a > 0, m - a, m),
                                    np.where(a > 0, m + a, m))
        specs = np.zeros((channels, n2), np.float64)
        for c in range(channels):
            if curves[c] is not None:
                specs[c] = res_out[c] * curves[c]
        staged.append((specs, n, blockflag, long_prev, long_next,
                       [cv is not None for cv in curves]))
    return staged


def staged_specs(staged, channels: int, nmax2: int) -> np.ndarray:
    """The staged spectra as [channels, F, nmax2] float32, zero-padded per
    packet, with the rows of channels whose floor is unused zeroed (a
    coupled channel can carry residue while its floor is unused)."""
    specs = np.zeros((channels, len(staged), nmax2), np.float32)
    for f, (s, n, _bf, _lp, _ln, nz) in enumerate(staged):
        specs[:, f, : n // 2] = s
        for c in range(channels):
            if not nz[c]:
                specs[c, f] = 0.0
    return specs


def synthesize_link(staged, blocksizes, channels, end_granule,
                    device) -> torch.Tensor:
    """One link's PCM [frames, channels] on ``device``: the mixed-block
    synthesis with the link's own lap plan, cut at the end granule and
    clamped to the float32 range as the reference's float32 decode
    saturates."""
    from ..runtime import serving

    if len(staged) < 2:
        raise DecodeError("no Vorbis audio decoded")
    meta = [(n, bf, lp, ln) for (_s, n, bf, lp, ln, _nz) in staged]
    plan = serving.vorbis_lap_plan(meta, blocksizes)
    specs = torch.from_numpy(staged_specs(staged, channels, plan["nmax"] // 2))
    pcm = serving.synthesize_vorbis_streams_mixed(
        specs.to(device), plan, device).T
    if end_granule >= 0:
        pcm = pcm[: int(end_granule)]
    fmax = float(np.finfo(np.float32).max)
    return pcm.clamp(-fmax, fmax)


def decode_vorbis_buffer(data: bytes, audio: AudioData, device) -> None:
    """Whole-buffer decode into ``audio``. Chained files (sequential
    links, each its own serial and ID header) decode link by link and
    concatenate as vorbisfile's ov_read does across links; decoding stops
    at the first later link that fails or changes the channel count or
    rate (this facade returns one fixed AudioData shape)."""
    st_c = _collect_stream_native(data)
    if st_c is not None:
        links = [st_c]
    else:
        links = [s for s in ogg.demux(data).values()
                 if s.packets and s.packets[0].data.startswith(b"\x01vorbis")]
        if not links:
            raise DecodeError("no Vorbis stream in Ogg container")
    staged, bss, channels, rate, end = _decode_stream_packets(links[0])
    chunks = [synthesize_link(staged, bss, channels, end, device)]
    for link in links[1:]:
        try:
            staged, bss, ch_l, rate_l, end = _decode_stream_packets(link)
            if ch_l != channels or rate_l != rate:
                break
            chunks.append(synthesize_link(staged, bss, ch_l, end, device))
        except DecodeError:
            break
    pcm = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
    out = pcm.cpu().numpy()
    audio.channel_count = channels
    audio.sample_rate = rate
    audio.source_format = PCMFormat.PCM_FLT
    audio.samples = np.ascontiguousarray(out.reshape(-1), np.float32)
    audio.length_seconds = out.shape[0] / rate if rate else 0.0
