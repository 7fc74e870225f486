"""Seeded MPEG-1 Layer III streams for tests and chip runs (NumPy only).

    from tools.l3_stream import make_l3_stream
    data = make_l3_stream(seed=0, seconds=2.0)

Writes valid MPEG-1 Layer III frames at 44.1 kHz, 128 kbps (the
padding bit set as a CBR encoder sets it), ``main_data_begin = 0``, no
CRC. The side info is seeded within legal ranges: big_values <= 288,
table selects from the defined tables (4 and 14 are unused), about 10 %
short-block granule-channels plus some mixed blocks and start/stop
windows, random scalefactor selection, preflag and count1 table. The
main data is seeded random bytes that fill each granule-channel's
part2_3_length, with eight spare bytes at the end of the frame so no
granule reads past its frame's main data. ``global_gain`` sits in a
band that keeps the PCM of order one. The audio is noise; the stream
exercises the whole entropy path (scalefactors, every Huffman region,
count1 quads, mid/side stereo, reorder, antialias) and every IMDCT
block kind.

``channels=1`` writes mono frames; ``ms_share`` is the share of stereo
frames coded mid/side (joint stereo, mode extension 2);
``free_format=True`` writes bitrate index 0 with a constant frame size,
which a decoder must measure from the sync pattern.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 44100
KBPS = 128
FRAME_SAMPLES = 1152
# big-value tables: the defined ones without linbits, and four with
TABLES_PLAIN = (0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15)
TABLES_LINBITS = (16, 17, 18, 24)


def _put(bits: np.ndarray, col: int, val: np.ndarray, nb: int) -> int:
    """Write nb-bit fields (MSB first) of val [n] at column col."""
    shifts = np.arange(nb - 1, -1, -1)
    bits[:, col : col + nb] = (np.asarray(val, np.int64)[:, None]
                               >> shifts) & 1
    return col + nb


def make_l3_stream(seed: int, seconds: float, channels: int = 2,
                   ms_share: float = 0.5, free_format: bool = False,
                   gain_range=(150, 168)) -> bytes:
    """A Layer III stream of about ``seconds`` seconds (whole frames)."""
    rng = np.random.default_rng(seed)
    n = max(1, int(round(seconds * SAMPLE_RATE / FRAME_SAMPLES)))
    exact = FRAME_SAMPLES * KBPS * 125 / SAMPLE_RATE      # 417.96 bytes
    if free_format:
        pad = np.zeros(n, np.int64)
        base = int(exact)
    else:
        # CBR padding: a frame is padded when the running size says so
        edges = np.floor(np.arange(n + 1) * exact).astype(np.int64)
        base = int(exact)
        pad = np.diff(edges) - base
    size = base + pad
    side_bytes = 17 if channels == 1 else 32
    main = size - 4 - side_bytes

    hdr = np.empty((n, 4), np.uint8)
    hdr[:, 0] = 0xFF
    hdr[:, 1] = 0xFB                       # MPEG-1, Layer III, no CRC
    bitrate_idx = 0 if free_format else 9  # 128 kbps
    hdr[:, 2] = (bitrate_idx << 4) | (0 << 2) | (pad << 1)
    if channels == 1:
        hdr[:, 3] = 0xC0
    else:
        ms = rng.random(n) < ms_share
        hdr[:, 3] = np.where(ms, 0x60, 0x00)

    nparts = 2 * channels
    bits = np.zeros((n, side_bytes * 8), np.uint8)
    col = _put(bits, 0, np.zeros(n), 9)                 # main_data_begin
    col = _put(bits, col, np.zeros(n), 5 if channels == 1 else 3)
    col = _put(bits, col, rng.integers(0, 1 << (4 * channels), n),
               4 * channels)                            # scfsi
    budget = (main - 8) * 8 // nparts                   # bits per part
    for _gr in range(2):
        for _ch in range(channels):
            p23 = rng.integers(160, budget + 1)
            col = _put(bits, col, p23, 12)
            col = _put(bits, col, rng.integers(0, 289, n), 9)
            col = _put(bits, col, rng.integers(*gain_range, n), 8)
            col = _put(bits, col, rng.integers(0, 16, n), 4)
            u = rng.random(n)
            # block type: 0 long (80 %), 2 short (10 %), 2 mixed (3 %),
            # 1 start (3.5 %), 3 stop (3.5 %)
            bt = np.select([u < 0.80, u < 0.90, u < 0.93, u < 0.965],
                           [0, 2, 2, 1], 3)
            mixed = (u >= 0.90) & (u < 0.93)
            wsf = bt != 0
            plain = np.asarray(TABLES_PLAIN)[
                rng.integers(0, len(TABLES_PLAIN), (n, 3))]
            lin = np.asarray(TABLES_LINBITS)[
                rng.integers(0, len(TABLES_LINBITS), (n, 3))]
            tsel = np.where(rng.random((n, 3)) < 0.1, lin, plain)
            col = _put(bits, col, wsf, 1)
            # the 22 bits that follow depend on the window switch
            long_f = np.zeros((n, 22), np.uint8)
            c = _put(long_f, 0, tsel[:, 0], 5)
            c = _put(long_f, c, tsel[:, 1], 5)
            c = _put(long_f, c, tsel[:, 2], 5)
            c = _put(long_f, c, rng.integers(0, 16, n), 4)   # region0
            _put(long_f, c, rng.integers(0, 8, n), 3)        # region1
            sw_f = np.zeros((n, 22), np.uint8)
            c = _put(sw_f, 0, bt, 2)
            c = _put(sw_f, c, mixed, 1)
            c = _put(sw_f, c, tsel[:, 0], 5)
            c = _put(sw_f, c, tsel[:, 1], 5)
            for _ in range(3):
                c = _put(sw_f, c, rng.integers(0, 8, n), 3)  # subblock gain
            bits[:, col : col + 22] = np.where(wsf[:, None], sw_f, long_f)
            col += 22
            col = _put(bits, col, rng.integers(0, 2, (n,)), 1)  # preflag
            col = _put(bits, col, rng.integers(0, 2, (n,)), 1)  # sf scale
            col = _put(bits, col, rng.integers(0, 2, (n,)), 1)  # count1 tab
    assert col == side_bytes * 8, col
    side = np.packbits(bits, axis=1)

    body = rng.integers(0, 256, int(main.sum()), dtype=np.uint8)
    out = np.empty(int(size.sum()), np.uint8)
    starts = np.concatenate([[0], np.cumsum(size)[:-1]])
    moff = np.concatenate([[0], np.cumsum(main)[:-1]])
    for i in range(n):
        s = starts[i]
        out[s : s + 4] = hdr[i]
        out[s + 4 : s + 4 + side_bytes] = side[i]
        out[s + 4 + side_bytes : s + size[i]] = body[moff[i] : moff[i] + main[i]]
    return out.tobytes()
