"""Seeded Ogg Vorbis streams with floor 1 for tests and chip runs (NumPy only).

    from tools.vorbis_stream import make_vorbis_stream
    data = make_vorbis_stream(seed=0, seconds=2.0)

Writes a legal Vorbis I stream (ID, comment and setup headers, audio
packets, Ogg pages each with its CRC) whose setup reaches every construct
the native floor 1 path decodes:

* codebooks: variable-length, sparse, ordered and fixed-length; lookup
  types 1 (with and without ``sequence_p``) and 2;
* floor 1 with three classes, master (class) books and subclass books,
  book -1 among them, multipliers 2 and 3;
* residues of types 0, 1 and 2, square-polar coupling of channel pairs,
  and a mapping of two submaps;
* three modes: short blocks, and two long-block mappings.

The block-size sequence comes from ``block_seed`` (runs of short blocks
between runs of long ones, ``short_share`` of the packets short), so
streams of one ``block_seed`` share one lap plan whatever their content
``seed``. The floor fields are chosen and written explicitly: every Y
value is below the floor's range, which keeps the decoder's step-2
reconstruction in [0, range) (see ``floor_values_legal``). A seeded share
of channels has its floor unused while its coupled partner carries
residue. The residues are random bits behind complete codebooks, so any
bit string decodes; each packet is sized to its mode's worst-case residue
bit count, and a seeded share (``truncate_share``) is cut short on
purpose. The end granule trims a few samples off the last packet. The
audio is noise; the stream exercises the entropy path, the coupling and
every long/short window transition.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MODE_BITS = 2                    # ilog(3 - 1): short, long, long modes
_REV8 = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def ilog(x: int) -> int:
    return int(x).bit_length() if x > 0 else 0


def build_codewords(lengths):
    """Codewords per the Vorbis I spec §3.2.1 (entries in order take the
    lowest free leaf at their depth; length 0 = unused entry)."""
    codes = [0] * len(lengths)
    available = [0] * 33
    first = True
    for i, ln in enumerate(lengths):
        if ln <= 0:
            continue
        if first:
            first = False
            for j in range(1, ln + 1):
                available[j] = 1 << (32 - j)
            continue
        z = ln
        while z > 0 and not available[z]:
            z -= 1
        if z == 0:
            raise ValueError("over-subscribed codebook")
        res = available[z]
        available[z] = 0
        codes[i] = res >> (32 - ln)
        for y in range(z + 1, ln + 1):
            available[y] = res + (1 << (32 - y))
    return codes


def f32_pack(x: float) -> int:
    """Vorbis float32_pack (the inverse of float32_unpack)."""
    if x == 0:
        return 0
    sign = 0x80000000 if x < 0 else 0
    x = abs(x)
    exp = 788
    while x < (1 << 20):
        x *= 2.0
        exp -= 1
    while x >= (1 << 21):
        x /= 2.0
        exp += 1
    return sign | (exp << 21) | (int(round(x)) & 0x1FFFFF)


def ogg_crc(page: bytes) -> int:
    """The Ogg page CRC (polynomial 0x04C11DB7, MSB first, init 0, no
    final xor): zlib's reflected CRC-32 of the bit-reversed bytes, its
    register started at 0, bit-reversed back."""
    raw = zlib.crc32(page.translate(_REV8), 0xFFFFFFFF) ^ 0xFFFFFFFF
    return int(f"{raw:032b}"[::-1], 2)


class _Writer:
    """LSB-first bit writer for the header packets."""

    def __init__(self):
        self.bits = []

    def put(self, v: int, n: int) -> None:
        self.bits.extend((int(v) >> i) & 1 for i in range(n))

    def data(self) -> bytes:
        return np.packbits(np.asarray(self.bits, np.uint8),
                           bitorder="little").tobytes()


class Book:
    """A codebook of the setup: lengths (0 = unused entry), and its VQ
    lookup (type, min, delta, value_bits, sequence_p, multiplicands)."""

    def __init__(self, dims, lengths, lookup=None, ordered=False):
        self.dims = dims
        self.lengths = list(lengths)
        self.lookup = lookup
        self.ordered = ordered
        codes = build_codewords(self.lengths)
        # the stream value of each codeword: written LSB first, read MSB
        # of the codeword first
        self.rev = np.array([int(f"{c:0{ln}b}"[::-1], 2) if ln else 0
                             for c, ln in zip(codes, self.lengths)], np.int64)
        self.len = np.asarray(self.lengths, np.int64)
        self.used = np.nonzero(self.len)[0]
        self.maxlen = int(self.len.max())

    def write(self, w: _Writer) -> None:
        entries = len(self.lengths)
        w.put(0x564342, 24)
        w.put(self.dims, 16)
        w.put(entries, 24)
        w.put(int(self.ordered), 1)
        if self.ordered:
            cur = self.lengths[0]
            w.put(cur - 1, 5)
            i = 0
            while i < entries:
                num = 0
                while i + num < entries and self.lengths[i + num] == cur:
                    num += 1
                w.put(num, ilog(entries - i))
                i += num
                cur += 1
        else:
            sparse = bool((self.len == 0).any())
            w.put(int(sparse), 1)
            for ln in self.lengths:
                if sparse:
                    w.put(int(ln > 0), 1)
                    if ln:
                        w.put(ln - 1, 5)
                else:
                    w.put(ln - 1, 5)
        if self.lookup is None:
            w.put(0, 4)
            return
        ltype, mn, delta, vbits, seq, mults = self.lookup
        w.put(ltype, 4)
        w.put(f32_pack(mn), 32)
        w.put(f32_pack(delta), 32)
        w.put(vbits - 1, 4)
        w.put(seq, 1)
        for m in mults:
            w.put(m, vbits)


def _complete(counts):
    """Lengths of a complete tree: counts[L] entries of length L."""
    return [ln for ln, k in sorted(counts.items()) for _ in range(k)]


def _books():
    b1_lengths = [4 if (e % 4 != 3 and e < 21) else 0 for e in range(64)]
    return [
        Book(1, [1, 2, 3, 3]),                                  # 0 master
        Book(1, b1_lengths),                                    # 1 sparse
        Book(1, _complete({6: 32, 7: 64})),                     # 2 Y book
        Book(1, _complete({3: 4, 4: 8}), ordered=True),         # 3 ordered
        Book(2, _complete({2: 1, 3: 2, 4: 4, 5: 7, 6: 2})),     # 4 classes
        # VQ values of a few sixteenths: the PCM peaks near full scale
        Book(4, _complete({6: 47, 7: 34}),                      # 5 VQ type 1
             (1, -0.0625, 0.0625, 2, 0, [0, 1, 2])),
        Book(2, [4] * 16,                                       # 6 VQ type 2
             (2, -0.125, 0.015625, 4, 0,
              [(5 * i + 3) % 16 for i in range(32)])),
        Book(2, _complete({4: 7, 5: 18}),                       # 7 type 1 seq
             (1, -0.125, 0.0625, 3, 1, [0, 1, 2, 3, 4])),
        Book(4, [4] * 16),                                      # 8 classes
    ]


class Floor:
    """A floor 1 config: partition classes, class dims / subclass bits /
    master books / subclass books, multiplier and X list."""

    RANGES = (256, 128, 86, 64)

    def __init__(self, pclass, classes, mult, rangebits, xs):
        self.pclass = pclass
        self.classes = classes          # (dim, subs, master, books)
        self.mult = mult
        self.rangebits = rangebits
        self.xs = [0, 1 << rangebits] + list(xs)
        assert len(set(self.xs)) == len(self.xs)
        assert len(xs) == sum(classes[c][0] for c in pclass)
        self.rng = self.RANGES[mult - 1]

    def write(self, w: _Writer) -> None:
        w.put(1, 16)
        w.put(len(self.pclass), 5)
        for c in self.pclass:
            w.put(c, 4)
        for dim, subs, master, books in self.classes:
            w.put(dim - 1, 3)
            w.put(subs, 2)
            if subs:
                w.put(master, 8)
            for bk in books:
                w.put(bk + 1, 8)
        w.put(self.mult - 1, 2)
        w.put(self.rangebits, 4)
        for x in self.xs[2:]:
            w.put(x, self.rangebits)


class Residue:
    def __init__(self, rtype, begin, end, psize, cbook, cascade):
        self.type, self.begin, self.end = rtype, begin, end
        self.psize, self.cbook = psize, cbook
        self.cascade = cascade          # per class: {pass: book}

    def write(self, w: _Writer) -> None:
        w.put(self.type, 16)
        w.put(self.begin, 24)
        w.put(self.end, 24)
        w.put(self.psize - 1, 24)
        w.put(len(self.cascade) - 1, 6)
        w.put(self.cbook, 8)
        for passes in self.cascade:
            bits = sum(1 << p for p in passes)
            w.put(bits & 7, 3)
            w.put(int(bits > 7), 1)
            if bits > 7:
                w.put(bits >> 3, 5)
        for passes in self.cascade:
            for p in sorted(passes):
                w.put(passes[p], 8)

    def worst_bits(self, books, n2, nch):
        """The most bits this residue can read for nch channels of an
        n2-bin block: every partition of the busiest class."""
        total = n2 * nch if self.type == 2 else n2
        vecs = 1 if self.type == 2 else nch
        parts = (min(self.end, total) - min(self.begin, total)) // self.psize
        if parts <= 0:
            return 0
        cb = books[self.cbook]
        bits = -(-parts // cb.dims) * cb.maxlen
        for p in range(8):
            bits += parts * max(
                (self.psize // books[c[p]].dims * books[c[p]].maxlen
                 for c in self.cascade if p in c), default=0)
        return bits * vecs


def stream_config(channels: int):
    """The setup every stream of ``channels`` channels shares: books,
    floors, residues, mappings (submaps, coupling, mux, [(floor,
    residue)]) and modes (blockflag, mapping)."""
    books = _books()
    long_x = [int(round(x)) + i                          # distinct
              for i, x in enumerate(np.geomspace(3, 1000, 22))]
    # in no sorted order, as encoders write them: the neighbour search
    # and the sort in the decoder have work to do
    long_x = [long_x[i] for i in np.random.default_rng(1).permutation(22)]
    floors = [
        # short blocks: multiplier 3 (range 86), the ordered Y book
        Floor([0, 0], [(2, 0, -1, [3])], 3, 7, [40, 16, 90, 64]),
        # long blocks: three classes, book -1 in two of them
        Floor([0, 1, 2, 0, 2, 1, 2, 0],
              [(3, 0, -1, [2]), (2, 1, 0, [-1, 2]), (3, 2, 1, [2, 3, -1, 2])],
              2, 10, long_x),
    ]
    rich = [{}, {0: 5}, {0: 5, 1: 7}, {0: 6, 2: 7}]
    residues = [
        Residue(2, 0, 768 * channels, 32, 4, rich),          # long, type 2
        Residue(0, 0, 640, 16, 8, [{}, {0: 5, 1: 6}]),       # long, type 0
        Residue(1, 0, 128, 8, 8, [{}, {0: 7, 1: 5}]),        # short, type 1
        Residue(1, 32, 832, 32, 4, rich),                    # long, type 1
    ]
    coupling = [(2 * k, 2 * k + 1) for k in range(channels // 2)]
    mappings = [
        (1, coupling, [0] * channels, [(0, 2)]),
        (1, coupling, [0] * channels, [(1, 0)]),
        (2, coupling, [c % 2 for c in range(channels)], [(1, 1), (1, 3)]),
    ]
    modes = [(0, 0), (1, 1), (1, 2)]
    return books, floors, residues, mappings, modes


def _setup_packet(channels: int) -> bytes:
    books, floors, residues, mappings, modes = stream_config(channels)
    w = _Writer()
    for ch in b"\x05vorbis":
        w.put(ch, 8)
    w.put(len(books) - 1, 8)
    for bk in books:
        bk.write(w)
    w.put(0, 6)
    w.put(0, 16)                             # one time-domain placeholder
    w.put(len(floors) - 1, 6)
    for fl in floors:
        fl.write(w)
    w.put(len(residues) - 1, 6)
    for r in residues:
        r.write(w)
    w.put(len(mappings) - 1, 6)
    cbits = ilog(channels - 1)
    for submaps, coupling, mux, subs in mappings:
        w.put(0, 16)
        w.put(int(submaps > 1), 1)
        if submaps > 1:
            w.put(submaps - 1, 4)
        w.put(int(bool(coupling)), 1)
        if coupling:
            w.put(len(coupling) - 1, 8)
            for mag, ang in coupling:
                w.put(mag, cbits)
                w.put(ang, cbits)
        w.put(0, 2)
        if submaps > 1:
            for m in mux:
                w.put(m, 4)
        for fl, res in subs:
            w.put(0, 8)
            w.put(fl, 8)
            w.put(res, 8)
    w.put(len(modes) - 1, 6)
    for bf, mp in modes:
        w.put(bf, 1)
        w.put(0, 16)
        w.put(0, 16)
        w.put(mp, 8)
    w.put(1, 1)                              # framing
    return w.data()


def _id_packet(channels, rate, blocksizes) -> bytes:
    w = _Writer()
    for ch in b"\x01vorbis":
        w.put(ch, 8)
    w.put(0, 32)
    w.put(channels, 8)
    w.put(rate, 32)
    w.put(0, 32)
    w.put(128000 * channels // 2, 32)
    w.put(0, 32)
    w.put(ilog(blocksizes[0] - 1), 4)
    w.put(ilog(blocksizes[1] - 1), 4)
    w.put(1, 1)
    return w.data()


def _comment_packet() -> bytes:
    vendor = b"vorbis_stream.py seeded floor-1 writer"
    return (b"\x03vorbis" + struct.pack("<I", len(vendor)) + vendor
            + struct.pack("<I", 0) + b"\x01")


def block_sequence(block_seed: int, seconds: float, rate: int,
                   blocksizes, short_share: float) -> np.ndarray:
    """Per packet 1 (long) or 0 (short): runs of 2..8 short blocks
    between geometric runs of long ones, enough packets for ``seconds``."""
    rng = np.random.default_rng(block_seed)
    target = seconds * rate
    mean_short = 5.0
    mean_long = mean_short * (1.0 - short_share) / max(short_share, 1e-9)
    flags = []
    samples = 0.0
    prev = blocksizes[1]
    long_run = True
    while samples < target or len(flags) < 2:
        if long_run:
            k = int(rng.geometric(1.0 / max(mean_long, 1.0)))
        else:
            k = int(rng.integers(2, 9))
        n = blocksizes[int(long_run)]
        for _ in range(k):
            if flags:
                samples += prev // 4 + n // 4
            flags.append(int(long_run))
            prev = n
            if samples >= target and len(flags) >= 2:
                break
        long_run = not long_run if short_share > 0 else True
    return np.asarray(flags, np.int64)


def _floor_fields(rng, fl: Floor, books, rows: int, unused: np.ndarray):
    """The fields (values [rows, k] written LSB first, widths [rows, k])
    of one channel's floor 1 for ``rows`` packets; ``unused`` rows write
    only the zero flag. Also the chosen posts, for floor_values_legal."""
    used = ~unused
    vals = [used.astype(np.int64)]
    widths = [np.ones(rows, np.int64)]
    bits01 = ilog(fl.rng - 1)
    ys = [rng.integers(0, fl.rng, rows), rng.integers(0, fl.rng, rows)]
    for y in ys:
        vals.append(y)
        widths.append(bits01 * used)
    maxent = max(len(b.lengths) for b in books)
    rev = np.zeros((len(books), maxent), np.int64)
    lens = np.zeros((len(books), maxent), np.int64)
    for i, b in enumerate(books):
        rev[i, : len(b.lengths)] = b.rev
        lens[i, : len(b.lengths)] = b.len
    for c in fl.pclass:
        dim, subs, master, sub_books = fl.classes[c]
        cval = np.zeros(rows, np.int64)
        if subs:
            mb = books[master]
            cval = mb.used[rng.integers(0, len(mb.used), rows)]
            vals.append(rev[master, cval])
            widths.append(lens[master, cval] * used)
        for d in range(dim):
            bk = np.asarray(sub_books)[(cval >> (d * subs)) & ((1 << subs) - 1)]
            # a Y value below the floor's range, from the entries in use
            y = np.zeros(rows, np.int64)
            for b in set(bk.tolist()) - {-1}:
                sel = bk == b
                ok = books[b].used[books[b].used < fl.rng]
                y[sel] = ok[rng.integers(0, len(ok), int(sel.sum()))]
            bsafe = np.maximum(bk, 0)
            has = (bk >= 0) & used
            vals.append(np.where(has, rev[bsafe, y], 0))
            widths.append(np.where(has, lens[bsafe, y], 0))
            ys.append(np.where(bk >= 0, y, 0))
    return vals, widths, np.stack(ys, 1)


def floor_values_legal(fl_xs, rng_: int, posts: np.ndarray) -> bool:
    """Step 2 of the floor 1 decode (spec §7.2.4) on the Y values of one
    floor, [rows, posts]: True when every reconstructed Y lies in
    [0, range)."""
    xs = list(fl_xs)
    final = posts[:, :2].astype(np.int64).copy()
    out = [final[:, 0], final[:, 1]]
    for i in range(2, len(xs)):
        lo = max((j for j in range(i) if xs[j] < xs[i]), key=lambda j: xs[j])
        hi = min((j for j in range(i) if xs[j] > xs[i]), key=lambda j: xs[j])
        y0, y1 = out[lo], out[hi]
        dy = y1 - y0
        off = (np.abs(dy) * (xs[i] - xs[lo])) // (xs[hi] - xs[lo])
        pred = np.where(dy < 0, y0 - off, y0 + off)
        val = posts[:, i]
        hr, lr = rng_ - pred, pred
        room = 2 * np.minimum(hr, lr)
        y = np.where(val >= room, np.where(hr > lr, val - lr + pred,
                                           pred - val + hr - 1),
                     np.where(val & 1, pred - ((val + 1) >> 1),
                              pred + (val >> 1)))
        out.append(np.where(val == 0, pred, y))
    allv = np.stack(out, 1)
    return bool(((allv >= 0) & (allv < rng_)).all())


def _assemble(vals, widths, rng):
    """Rows of LSB-first fields -> ([rows, nbytes] uint8 with random bits
    past each row's fields, bit count per row)."""
    V = np.stack(vals, 1)
    Wd = np.stack(widths, 1)
    pos = np.cumsum(Wd, 1) - Wd
    nbits = Wd.sum(1)
    ncol = int(-(-nbits.max() // 8) * 8)
    bits = rng.integers(0, 2, (V.shape[0], ncol), dtype=np.uint8)
    rows = np.arange(V.shape[0])
    for k in range(V.shape[1]):
        for j in range(int(Wd[:, k].max())):
            m = j < Wd[:, k]
            bits[rows[m], pos[m, k] + j] = (V[m, k] >> j) & 1
    return np.packbits(bits, axis=1, bitorder="little"), nbits


def _audio_packets(rng, flags, channels, blocksizes, unused_share,
                   truncate_share, long_modes=(1, 2)):
    """Every audio packet's bytes, and the floor posts per floor."""
    books, floors, residues, mappings, modes = stream_config(channels)
    n = len(flags)
    nxt = np.append(flags[1:], 1)
    prv = np.concatenate([[flags[0]], flags[:-1]])
    mode = np.where(flags == 1, np.asarray(long_modes)[
        rng.integers(0, len(long_modes), n)], 0)
    worst = []
    for bf, mi in modes:
        submaps, _coup, mux, subs = mappings[mi]
        n2 = blocksizes[bf] // 2
        worst.append(sum(
            residues[res].worst_bits(books, n2, sum(m == s for m in mux))
            for s, (_fl, res) in enumerate(subs)))
    unused = rng.random((n, channels)) < unused_share
    out = [None] * n
    posts = {}
    for bf in (0, 1):
        idx = np.nonzero(flags == bf)[0]
        if not len(idx):
            continue
        rows = len(idx)
        vals = [np.zeros(rows, np.int64), mode[idx]]
        widths = [np.ones(rows, np.int64), np.full(rows, MODE_BITS)]
        if bf:
            vals += [prv[idx], nxt[idx]]
            widths += [np.ones(rows, np.int64)] * 2
        fl = floors[bf]     # both long mappings use the long floor
        ys = []
        for c in range(channels):
            v, w, y = _floor_fields(rng, fl, books, rows, unused[idx, c])
            vals += v
            widths += w
            ys.append(y)
        posts[bf] = np.concatenate(ys)
        head, nbits = _assemble(vals, widths, rng)
        total = -(-(nbits + np.asarray(worst)[mode[idx]]) // 8)
        cut = rng.random(rows) < truncate_share
        total = np.where(cut, rng.integers(1, total + 1), total)
        body = rng.integers(0, 256, int(total.sum()), dtype=np.uint8)
        start = np.concatenate([[0], np.cumsum(total)[:-1]])
        for r, p in enumerate(idx):
            k = min(int(total[r]), head.shape[1])
            pk = body[start[r] : start[r] + total[r]]
            pk[:k] = head[r, :k]
            out[p] = pk.tobytes()
    return out, posts


def _pages(packets, granules, serial, seq, first_flags=0, eos=False,
           target=4096):
    """Ogg pages of these packets: up to 255 segments and about
    ``target`` body bytes a page, packets spanning pages; each page
    carries the granule of the last packet that ends on it (-1 if none)
    and its CRC."""
    lacing, ends = [], []
    for pk, g in zip(packets, granules):
        ln = len(pk)
        segs = [255] * (ln // 255) + [ln % 255]
        lacing += segs
        ends += [None] * (len(segs) - 1) + [g]
    data = b"".join(packets)
    pages = []
    s = off = 0
    continued = False
    while s < len(lacing):
        e = s
        body = 0
        while e < len(lacing) and e - s < 255 and body < target:
            body += lacing[e]
            e += 1
        gran = next((g for g in reversed(ends[s:e]) if g is not None), -1)
        htype = (first_flags if not pages else 0) | (1 if continued else 0)
        if eos and e == len(lacing):
            htype |= 4
        hdr = struct.pack("<4sBBqIIIB", b"OggS", 0, htype, gran, serial,
                          seq, 0, e - s) + bytes(lacing[s:e])
        page = hdr + data[off : off + body]
        crc = ogg_crc(page)
        pages.append(page[:22] + struct.pack("<I", crc) + page[26:])
        continued = ends[e - 1] is None
        off += body
        seq += 1
        s = e
    return pages, seq


def make_vorbis_stream(seed: int, seconds: float, channels: int = 2,
                       rate: int = 44100, blocksizes=(256, 2048),
                       short_share: float = 0.1, block_seed: int = 0,
                       unused_share: float = 0.03,
                       truncate_share: float = 0.02,
                       return_posts: bool = False):
    """An Ogg Vorbis stream of about ``seconds`` seconds (whole packets).
    With ``return_posts``, also the Y values written per floor (index 0
    short, 1 long), [packets x channels, posts]."""
    rng = np.random.default_rng(seed)
    flags = block_sequence(block_seed, seconds, rate, blocksizes,
                           short_share)
    ns = np.asarray(blocksizes)[flags]
    emitted = np.concatenate([[0], ns[:-1] // 4 + ns[1:] // 4])
    granule = np.cumsum(emitted)
    end = int(granule[-1]) - int(rng.integers(0, ns[-1] // 4))
    granule[-1] = end
    packets, posts = _audio_packets(rng, flags, channels, blocksizes,
                                    unused_share, truncate_share)
    serial = int(rng.integers(1, 1 << 31))
    pages, seq = _pages([_id_packet(channels, rate, blocksizes)], [0],
                        serial, 0, first_flags=2)
    more, seq = _pages([_comment_packet(), _setup_packet(channels)],
                       [0, 0], serial, seq)
    audio, _ = _pages(packets, granule.tolist(), serial, seq, eos=True)
    data = b"".join(pages + more + audio)
    return (data, posts) if return_posts else data
