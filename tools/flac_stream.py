"""Seeded native FLAC streams for tests and chip runs (NumPy only).

    from tools.flac_stream import make_flac_stream
    data, samples = make_flac_stream(seed=0, seconds=2.0, bps=16)

Writes a legal FLAC stream and returns it with the int32 samples it
codes ([frames, channels]), the round-trip oracle. The stream has:

* a STREAMINFO block with the true block and frame size bounds, total
  sample count (or 0 for "unknown") and MD5 of the samples, then a
  PADDING block;
* frames with every subframe type, chosen per subframe from the seed:
  constant (on frames the writer makes constant), verbatim, fixed of
  order 0 to 4, and LPC of order 1 to 32 with a precision of 1 to 15
  bits and a shift of 0 to 15;
* Rice residuals with both parameter widths (4- and 5-bit), partition
  orders 0 to 8, escape partitions with their verbatim widths, and
  wasted bits where the samples' low bits are zero;
* the four channel assignments of a stereo frame (independent,
  left/side, right/side, mid/side), and mono or up to 8 independent
  channels;
* 8 to 24-bit samples (32 with verbatim and constant subframes only),
  every blocksize code (the table sizes and the explicit 8- and 16-bit
  ones) when ``blocksize`` is None, with the variable blocking strategy
  and UTF-8 sample numbers, or one fixed size with UTF-8 frame numbers;
  sample rate and sample size codes from the table, the explicit ones
  or "from STREAMINFO";
* a CRC-8 on every frame header and a CRC-16 on every frame.

The signal is a few sines per channel plus seeded noise at about half
of full scale, so prediction has something to find; a seeded share of
frames is constant and another has its low bits zeroed.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

TABLE_BLOCKSIZES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8,
                    512: 9, 1024: 10, 2048: 11, 4096: 12, 8192: 13,
                    16384: 14, 32768: 15}
TABLE_RATES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
               22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
               96000: 11}
TABLE_BPS = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
KINDS = ("constant", "verbatim", "fixed", "lpc")
ASSIGNMENTS = ("independent", "left_side", "right_side", "mid_side")
MAX_LPC_ORDER = 32
_CRC8 = np.zeros(256, np.uint8)
_CRC16 = np.zeros(256, np.uint16)
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = ((_c << 1) ^ 0x07) & 0xFF if _c & 0x80 else (_c << 1) & 0xFF
    _CRC8[_i] = _c
    _c = _i << 8
    for _ in range(8):
        _c = ((_c << 1) ^ 0x8005) & 0xFFFF if _c & 0x8000 else (_c << 1) & 0xFFFF
    _CRC16[_i] = _c


class Fields:
    """MSB-first bit fields gathered as (value, width) arrays. A value
    sits in the low bits of its field and is below 2^32, so a Rice code
    is one field: the unary zeros, the stop bit and the k low bits."""

    def __init__(self):
        self.vals = []
        self.nbits = []
        self.total_bits = 0

    def put(self, val, nbits):
        nb = np.atleast_1d(np.asarray(nbits, np.int64))
        self.vals.append(np.atleast_1d(np.asarray(val, np.int64)))
        self.nbits.append(nb)
        self.total_bits += int(nb.sum())

    def signed(self, x, nbits: int):
        """Two's-complement fields of ``nbits`` (33 splits in two)."""
        u = np.asarray(x, np.int64) & ((1 << nbits) - 1)
        if nbits > 32:
            self.put(np.stack([u >> 32, u & 0xFFFFFFFF], -1).reshape(-1),
                     np.tile([nbits - 32, 32], np.size(u)))
        else:
            self.put(u, np.full(np.size(u), nbits))


def pack(vals: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Bit fields -> bytes (uint8; the last byte zero-padded). Fields
    never share a bit, so the bytes each one touches add as they OR."""
    ends = np.cumsum(nbits) + 32            # 32 bits of front padding
    total = int(ends[-1]) - 32
    start = ends - 32                       # where the value's 32 bits begin
    b = start >> 3
    wide = vals.astype(np.uint64) << (8 - (start & 7)).astype(np.uint64)
    idx = np.concatenate([b + j for j in range(5)])
    w = np.concatenate([((wide >> np.uint64(32 - 8 * j)) & np.uint64(255))
                        .astype(np.float64) for j in range(5)])
    out = np.bincount(idx, weights=w, minlength=int(b.max()) + 5)
    return out.astype(np.uint8)[4 : 4 + (total + 7) // 8]


def _crc_rows(rows: np.ndarray, table: np.ndarray, width: int) -> np.ndarray:
    """CRC (MSB first, init 0) of each row of a left-zero-padded [n, L]
    byte matrix (leading zeros leave such a CRC at 0), all rows at once."""
    crc = np.zeros(rows.shape[0], np.int64)
    mask = (1 << width) - 1
    t = table.astype(np.int64)
    for j in range(rows.shape[1]):
        crc = ((crc << 8) & mask) ^ t[(crc >> (width - 8)) ^ rows[:, j]]
    return crc


def _left_padded(buf: np.ndarray, starts, lengths) -> np.ndarray:
    lengths = np.asarray(lengths, np.int64)
    width = int(lengths.max())
    rows = np.zeros((len(lengths), width), np.uint8)
    r = np.repeat(np.arange(len(lengths)), lengths)
    first = np.repeat(np.cumsum(lengths) - lengths, lengths)
    col = np.arange(int(lengths.sum())) - first
    rows[r, width - np.repeat(lengths, lengths) + col] = buf[
        np.repeat(np.asarray(starts, np.int64), lengths) + col]
    return rows


def _utf8(n: int) -> list:
    """FLAC's UTF-8-like coding of a frame or sample number (< 2^36)."""
    if n < 0x80:
        return [n]
    nbytes = next(k for k, lim in ((2, 1 << 11), (3, 1 << 16), (4, 1 << 21),
                                   (5, 1 << 26), (6, 1 << 31), (7, 1 << 36))
                  if n < lim)
    out = []
    for _ in range(nbytes - 1):
        out.append(0x80 | (n & 0x3F))
        n >>= 6
    lead = (0xFF00 >> nbytes) & 0xFF
    return [lead | n] + out[::-1]


def _signal(rng, n: int, channels: int, bps: int) -> np.ndarray:
    t = np.arange(n) / 44100.0
    full = (1 << (bps - 1)) - 1
    x = np.zeros((channels, n))
    for c in range(channels):
        for _ in range(3):
            f = rng.uniform(60.0, 4000.0)
            x[c] += rng.uniform(0.05, 0.2) * np.sin(
                2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        x[c] += rng.normal(0.0, 0.004, n)
    return np.clip(np.round(x.T * full), -full - 1, full).astype(np.int64)


def _lpc_table(x: np.ndarray, order: int) -> list:
    """Predictors of orders 1..order (Levinson-Durbin on the
    autocorrelation of x): list of float coefficient arrays."""
    x = x.astype(np.float64)
    r = np.array([x[: x.size - k] @ x[k:] for k in range(order + 1)])
    r[0] = r[0] * (1 + 1e-9) + 1e-9
    a = np.zeros(0)
    err = r[0]
    out = []
    for p in range(1, order + 1):
        k = (r[p] - a @ r[p - 1 : 0 : -1]) / err if p > 1 else r[1] / err
        a = np.concatenate([a - k * a[::-1], [k]])
        err *= max(1.0 - k * k, 1e-12)
        out.append(a.copy())
    return out


def _zigzag(r: np.ndarray) -> np.ndarray:
    return (r << 1) ^ (r >> 63)


def _bit_length(m: np.ndarray) -> np.ndarray:
    return np.frexp(m.astype(np.float64))[1].astype(np.int64)


def _residual(f: Fields, rng, r: np.ndarray, blocksize: int, order: int):
    """Rice-partitioned residual of one subframe (spec §9.2.7)."""
    orders = [p for p in range(9)
              if blocksize % (1 << p) == 0 and (blocksize >> p) >= order]
    porder = int(rng.choice(orders))
    nparts = 1 << porder
    part = blocksize >> porder
    u = _zigzag(r)
    # partition p holds u[starts[p]:ends[p]] (the first one loses order)
    ends = np.arange(1, nparts + 1) * part - order
    starts = np.concatenate([[0], ends[:-1]])
    counts = ends - starts
    live = counts > 0
    at = np.minimum(starts, max(u.size - 1, 0))
    if u.size:
        mean = np.where(live, np.add.reduceat(u, at), 0) / np.maximum(counts, 1)
        peak = np.where(live, np.maximum.reduceat(np.abs(r), at), 0)
    else:
        mean = peak = np.zeros(nparts)
    k = np.maximum(_bit_length(np.maximum(mean, 1.0)) - 1
                   + rng.integers(-1, 2, nparts), 0)
    method = int(rng.integers(0, 2)) if k.max() <= 14 else 1
    kmax, escape = (14, 15) if method == 0 else (30, 31)
    esc = (rng.random(nparts) < 0.08) | (k > kmax)
    # an escape partition's width: its largest magnitude plus a sign
    # bit; an all-zero one takes 0 or 1 bits
    width = np.where(peak > 0, _bit_length(peak) + 1,
                     rng.integers(0, 2, nparts))
    f.put([method, porder], [2, 4])
    pid = np.repeat(np.arange(nparts), counts)
    kk, ww, ee = k[pid], width[pid], esc[pid]
    vals = np.where(ee, r & ((1 << ww) - 1), (1 << kk) | (u & ((1 << kk) - 1)))
    nbits = np.where(ee, ww, (u >> kk) + 1 + kk)
    # each partition's parameter (and an escape's width) goes first
    nhead = 1 + esc
    head_at = np.repeat(starts, nhead)
    first = np.cumsum(nhead) - nhead
    hv = np.repeat(np.where(esc, escape, k), nhead)
    hn = np.full(hv.size, method + 4)
    second = first[esc] + 1
    hv[second], hn[second] = width[esc], 5
    f.put(np.insert(vals, head_at, hv), np.insert(nbits, head_at, hn))


def _subframe(f: Fields, rng, x: np.ndarray, bps: int, kinds, lpc: list):
    """One subframe of the channel signal x (int64 [blocksize]) at
    ``bps`` bits (the side channel's one more)."""
    n = x.size
    if np.all(x == x[0]) and "constant" in kinds:
        kind = "constant"
    elif bps > 30:              # keep the decoder's int32 sums exact
        kind = "verbatim"
    else:
        kind = str(rng.choice([k for k in kinds if k != "constant"]
                              or ["verbatim"]))
        if kind == "lpc" and n < 2:
            kind = "fixed"
    tz = 0
    if np.any(x):
        low = np.bitwise_or.reduce(x & ((1 << 31) - 1))
        tz = min((int(low) & -int(low)).bit_length() - 1, bps - 1)
    wasted = int(rng.integers(0, tz + 1)) if tz else 0
    xs = x >> wasted
    b = bps - wasted
    typ = {"constant": 0, "verbatim": 1}.get(kind)
    if kind == "fixed":
        order = int(rng.integers(0, min(4, n - 1) + 1))
        r = xs.copy()
        for _ in range(order):
            r = np.diff(r, prepend=0)
        r = r[order:]
        typ = 8 + order
    elif kind == "lpc":
        order = int(rng.integers(1, min(MAX_LPC_ORDER, n - 1) + 1))
        prec = int(rng.integers(5, 16))
        coef = lpc[order - 1]
        big = float(np.max(np.abs(coef)))
        fit = prec - 1 - (int(np.ceil(np.log2(big))) if big > 0 else 0)
        shift = int(np.clip(fit - int(rng.integers(0, 3)), 0, 15))
        lim = 1 << (prec - 1)
        qc = np.clip(np.round(coef * (1 << shift)), -lim, lim - 1).astype(
            np.int64)
        win = np.lib.stride_tricks.sliding_window_view(xs[:-1], order)
        pred = (win @ qc[::-1]) >> shift
        r = xs[order:] - pred
        if np.max(np.abs(r), initial=0) >= 1 << 30:       # keep int32 safe
            kind, typ = "verbatim", 1
        else:
            typ = 32 + order - 1
    f.put([0, typ, 1 if wasted else 0], [1, 6, 1])
    if wasted:
        f.put(1, wasted)                     # unary wasted-1 then a one
    if kind == "constant":
        f.signed(xs[:1], b)
    elif kind == "verbatim":
        f.signed(xs, b)
    elif kind == "fixed":
        f.signed(xs[:order], b)
        _residual(f, rng, r, n, order)
    else:
        f.signed(xs[:order], b)
        f.put([prec - 1], [4])
        f.signed([shift], 5)
        f.signed(qc, prec)
        _residual(f, rng, r, n, order)


def make_flac_stream(seed: int, seconds: float = 1.0, rate: int = 44100,
                     channels: int = 2, bps: int = 16, blocksize=4096,
                     kinds=KINDS, assignments=ASSIGNMENTS,
                     constant_share: float = 0.05,
                     wasted_share: float = 0.1, total_known: bool = True):
    """(stream bytes, int32 samples [frames, channels]) of about
    ``seconds`` of audio. ``blocksize`` None draws each frame's size
    (variable blocking strategy); an int fixes it (the last frame is
    short)."""
    rng = np.random.default_rng(seed)
    n = max(1, int(round(seconds * rate)))
    x = _signal(rng, n, channels, bps)
    if blocksize is None:
        sizes = []
        while sum(sizes) < n:
            pick = int(rng.integers(0, 4))
            sizes.append(int(rng.choice(list(TABLE_BLOCKSIZES))) if pick < 2
                         else int(rng.integers(17, 257)) if pick == 2
                         else int(rng.integers(257, 6000)))
    else:
        sizes = [blocksize] * (n // blocksize) + (
            [n % blocksize] if n % blocksize else [])
    sizes[-1] -= sum(sizes) - n
    edges = np.concatenate([[0], np.cumsum(sizes)])
    full = (1 << (bps - 1)) - 1
    for i in range(len(sizes)):
        s, e = edges[i], edges[i + 1]
        u = rng.random()
        if u < constant_share:
            x[s:e] = int(rng.integers(-full // 4, full // 4 + 1))
        elif u < constant_share + wasted_share:
            w = int(rng.integers(1, max(2, bps - 4)))
            x[s:e] = (x[s:e] >> w) << w
    lpc = _lpc_table(x[: min(n, 16384), 0], MAX_LPC_ORDER)
    kinds = tuple(kinds)
    if bps > 24:
        kinds = tuple(k for k in kinds if k in ("constant", "verbatim")) \
            or ("verbatim",)

    frames = []                 # (Fields, header length in bits)
    variable = blocksize is None
    for i, bs in enumerate(sizes):
        s = edges[i]
        blk = x[s : s + bs]
        f = Fields()
        bs_code = TABLE_BLOCKSIZES.get(bs)
        if bs_code is None or (variable and rng.random() < 0.1):
            bs_code = 6 if bs <= 256 else 7
        rates = [0] + ([TABLE_RATES[rate]] if rate in TABLE_RATES else [])
        if rate % 1000 == 0 and rate // 1000 < 256:
            rates.append(12)
        if rate < 65536:
            rates.append(13)
        if rate % 10 == 0 and rate // 10 < 65536:
            rates.append(14)
        sr_code = int(rng.choice(rates))
        bps_code = int(rng.choice([0, TABLE_BPS[bps]])) if bps in TABLE_BPS \
            else 0
        assign = "independent"
        if channels == 2:
            assign = str(rng.choice(assignments))
        ch_code = (channels - 1 if assign == "independent"
                   else 8 + ASSIGNMENTS.index(assign) - 1)
        f.put([0x3FFE, 0, 1 if variable else 0, bs_code, sr_code, ch_code,
               bps_code, 0], [14, 1, 1, 4, 4, 4, 3, 1])
        num = _utf8(int(s) if variable else i)
        f.put(num, [8] * len(num))
        if bs_code == 6:
            f.put(bs - 1, 8)
        elif bs_code == 7:
            f.put(bs - 1, 16)
        if sr_code == 12:
            f.put(rate // 1000, 8)
        elif sr_code == 13:
            f.put(rate, 16)
        elif sr_code == 14:
            f.put(rate // 10, 16)
        head_bits = f.total_bits
        f.put(0, 8)                               # CRC-8, patched below
        if assign == "independent":
            planes = [(blk[:, c], bps) for c in range(channels)]
        else:
            left, right = blk[:, 0], blk[:, 1]
            side = left - right
            if assign == "left_side":
                planes = [(left, bps), (side, bps + 1)]
            elif assign == "right_side":
                planes = [(side, bps + 1), (right, bps)]
            else:
                planes = [((left + right) >> 1, bps), (side, bps + 1)]
        for plane, b in planes:
            _subframe(f, rng, plane, b, kinds, lpc)
        pad = -f.total_bits % 8
        f.put([0, 0], [pad, 16])                  # CRC-16, patched below
        frames.append((f, head_bits))

    # pack the frames (byte-aligned, so their bytes concatenate)
    chunks, starts, lengths, heads = [], [], [], []
    pos = 0
    for j in range(0, len(frames), 256):
        group = frames[j : j + 256]
        vals = np.concatenate([v for f, _ in group for v in f.vals])
        nb = np.concatenate([m for f, _ in group for m in f.nbits])
        chunks.append(pack(vals, nb))
        for f, hb in group:
            size = f.total_bits // 8
            starts.append(pos)
            lengths.append(size)
            heads.append(hb // 8)
            pos += size
    audio = np.concatenate(chunks)
    starts = np.asarray(starts)
    audio[starts + heads] = _crc_rows(_left_padded(audio, starts, heads),
                                      _CRC8, 8)
    crc = _crc_rows(_left_padded(audio, starts, np.asarray(lengths) - 2),
                    _CRC16, 16)
    ends = starts + np.asarray(lengths)
    audio[ends - 2] = crc >> 8
    audio[ends - 1] = crc & 0xFF

    samples = x.astype(np.int32)
    nb = (bps + 7) // 8
    flat = x.reshape(-1)
    raw = (flat.astype(f"<i{nb}").tobytes() if nb in (1, 2, 4) else
           flat.astype("<i8").view(np.uint8).reshape(-1, 8)[:, :nb].tobytes())
    info = struct.pack(">HH", min(sizes) if len(sizes) == 1 else
                       min(sizes[:-1]), max(sizes))
    info += int(min(lengths)).to_bytes(3, "big")
    info += int(max(lengths)).to_bytes(3, "big")
    total = n if total_known else 0
    packed = ((rate << 44) | ((channels - 1) << 41) | ((bps - 1) << 36)
              | total)
    info += packed.to_bytes(8, "big") + hashlib.md5(raw).digest()
    pad_len = int(rng.integers(0, 64))
    head = (b"fLaC" + bytes([0]) + len(info).to_bytes(3, "big") + info
            + bytes([0x81]) + pad_len.to_bytes(3, "big") + bytes(pad_len))
    return head + audio.tobytes(), samples
