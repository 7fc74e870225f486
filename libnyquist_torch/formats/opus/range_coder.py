"""Opus/CELT range (entropy) decoder, RFC 6716 §4.1.

The port's copy of the decoder half (reference: celt/entdec.c,
entcode.c), shared by the per-frame CELT decode and the native SILK
decode of a hybrid frame: the native calls take its ten-word state and
hand it back (``formats/opus/celt_frame.py`` ``ec_pack``). The
byte-serial front half of every Opus frame stays on the host.

Semantics match the reference exactly: 8-bit symbols, 32-bit code
window, 7 extra code bits, raw bits drawn LSB-first from the tail of
the buffer.
"""

from __future__ import annotations

SYM_BITS = 8
CODE_BITS = 32
SYM_MAX = (1 << SYM_BITS) - 1
CODE_TOP = 1 << (CODE_BITS - 1)
CODE_BOT = CODE_TOP >> SYM_BITS
CODE_EXTRA = (CODE_BITS - 2) % SYM_BITS + 1  # 7
UINT_BITS = 8
WINDOW_SIZE = 32
BITRES = 3


def ilog(x: int) -> int:
    """Number of bits needed to represent x (EC_ILOG); ilog(0) == 0."""
    return int(x).bit_length()


class RangeDecoder:
    __slots__ = (
        "buf", "storage", "offs", "end_offs", "end_window", "nend_bits",
        "nbits_total", "rng", "rem", "val", "ext", "error",
    )

    def __init__(self, buf: bytes):
        self.buf = buf
        self.storage = len(buf)
        self.offs = 0
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = CODE_BITS + 1 - (
            (CODE_BITS - CODE_EXTRA) // SYM_BITS
        ) * SYM_BITS
        self.rng = 1 << CODE_EXTRA
        self.rem = self._read_byte()
        self.val = self.rng - 1 - (self.rem >> (SYM_BITS - CODE_EXTRA))
        self.ext = 0
        self.error = 0
        self._normalize()

    # -- byte sources ------------------------------------------------------
    def _read_byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _read_byte_from_end(self) -> int:
        if self.end_offs < self.storage:
            self.end_offs += 1
            return self.buf[self.storage - self.end_offs]
        return 0

    # -- core --------------------------------------------------------------
    def _normalize(self) -> None:
        while self.rng <= CODE_BOT:
            self.nbits_total += SYM_BITS
            self.rng = (self.rng << SYM_BITS) & 0xFFFFFFFF
            sym = self.rem
            self.rem = self._read_byte()
            sym = ((sym << SYM_BITS) | self.rem) >> (SYM_BITS - CODE_EXTRA)
            self.val = (
                (self.val << SYM_BITS) + (SYM_MAX & ~sym)
            ) & (CODE_TOP - 1)

    def decode(self, ft: int) -> int:
        ft = int(ft)
        self.ext = self.rng // ft
        s = self.val // self.ext
        return ft - min(s + 1, ft)

    def decode_bin(self, bits: int) -> int:
        bits = int(bits)
        self.ext = self.rng >> bits
        s = self.val // self.ext
        return (1 << bits) - min(s + 1, 1 << bits)

    def update(self, fl: int, fh: int, ft: int) -> None:
        fl, fh, ft = int(fl), int(fh), int(ft)
        s = self.ext * (ft - fh)
        self.val -= s
        self.rng = self.ext * (fh - fl) if fl > 0 else self.rng - s
        self._normalize()

    def dec_bit_logp(self, logp: int) -> int:
        logp = int(logp)
        r = self.rng
        d = self.val
        s = r >> logp
        ret = int(d < s)
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return ret

    def dec_icdf(self, icdf, ftb: int) -> int:
        """Decode against an inverse CDF table of byte values."""
        ftb = int(ftb)
        s = self.rng
        r = s >> ftb
        ret = -1
        while True:
            ret += 1
            t = s
            s = r * int(icdf[ret])
            if self.val >= s:
                break
        self.val -= s
        self.rng = t - s
        self._normalize()
        return ret

    def dec_uint(self, ft: int) -> int:
        ft = int(ft)
        assert ft > 1
        ft -= 1
        ftb = ilog(ft)
        if ftb > UINT_BITS:
            ftb -= UINT_BITS
            ft_hi = (ft >> ftb) + 1
            s = self.decode(ft_hi)
            self.update(s, s + 1, ft_hi)
            t = (s << ftb) | self.dec_bits(ftb)
            if t <= ft:
                return t
            self.error = 1
            return ft
        ft += 1
        s = self.decode(ft)
        self.update(s, s + 1, ft)
        return s

    def dec_bits(self, bits: int) -> int:
        """Raw bits from the end of the frame, LSB-first window."""
        bits = int(bits)
        window = self.end_window
        available = self.nend_bits
        if available < bits:
            while True:
                window |= self._read_byte_from_end() << available
                available += SYM_BITS
                if available > WINDOW_SIZE - SYM_BITS:
                    break
        ret = window & ((1 << bits) - 1)
        window >>= bits
        available -= bits
        self.end_window = window
        self.nend_bits = available
        self.nbits_total += bits
        return ret

    # -- budget queries ------------------------------------------------------
    def tell(self) -> int:
        return self.nbits_total - ilog(self.rng)

    def tell_frac(self) -> int:
        """Bits used so far in Q3 (1/8 bit), per entcode.c ec_tell_frac."""
        nbits = self.nbits_total << BITRES
        l = ilog(self.rng)
        r = self.rng >> (l - 16)
        for _ in range(BITRES):
            r = (r * r) >> 15
            b = r >> 16
            l = (l << 1) | b
            r >>= b
        return nbits - l
