"""Opus/CELT range (entropy) coder, RFC 6716 §4.1.

The port's copy of the decoder (reference: celt/entdec.c, entcode.c),
shared by the per-frame CELT decode and the native SILK decode of a
hybrid frame: the native calls take its ten-word state and hand it back
(``formats/opus/celt_frame.py`` ``ec_pack``); and of its dual, the
encoder the host Opus encoders write with (celt/entenc.c). The
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


CODE_SHIFT = CODE_BITS - SYM_BITS - 1  # 23


class RangeEncoder:
    """RFC 6716 §4.1 range encoder (reference: celt/entenc.c semantics),
    the exact dual of RangeDecoder — used by the encoder side."""

    __slots__ = (
        "buf", "storage", "offs", "end_offs", "end_window", "nend_bits",
        "nbits_total", "rng", "rem", "val", "ext", "error",
    )

    def __init__(self, size: int):
        self.buf = bytearray(size)
        self.storage = size
        self.offs = 0
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = CODE_BITS + 1
        self.rng = CODE_TOP
        self.rem = -1
        self.val = 0
        self.ext = 0
        self.error = 0

    # -- byte sinks ---------------------------------------------------------
    def _write_byte(self, value: int) -> int:
        if self.offs + self.end_offs >= self.storage:
            return -1
        self.buf[self.offs] = value & 0xFF
        self.offs += 1
        return 0

    def _write_byte_at_end(self, value: int) -> int:
        if self.offs + self.end_offs >= self.storage:
            return -1
        self.end_offs += 1
        self.buf[self.storage - self.end_offs] = value & 0xFF
        return 0

    # -- core ---------------------------------------------------------------
    def _carry_out(self, c: int) -> None:
        if c != SYM_MAX:
            carry = c >> SYM_BITS
            if self.rem >= 0:
                self.error |= self._write_byte(self.rem + carry)
            if self.ext > 0:
                sym = (SYM_MAX + carry) & SYM_MAX
                while self.ext > 0:
                    self.error |= self._write_byte(sym)
                    self.ext -= 1
            self.rem = c & SYM_MAX
        else:
            self.ext += 1

    def _normalize(self) -> None:
        while self.rng <= CODE_BOT:
            self._carry_out(self.val >> CODE_SHIFT)
            self.val = (self.val << SYM_BITS) & (CODE_TOP - 1)
            self.rng = (self.rng << SYM_BITS) & 0xFFFFFFFF
            self.nbits_total += SYM_BITS

    def encode(self, fl: int, fh: int, ft: int) -> None:
        fl, fh, ft = int(fl), int(fh), int(ft)
        r = self.rng // ft
        if fl > 0:
            self.val += self.rng - r * (ft - fl)
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * (ft - fh)
        self._normalize()

    def encode_bin(self, fl: int, fh: int, bits: int) -> None:
        fl, fh, bits = int(fl), int(fh), int(bits)
        r = self.rng >> bits
        if fl > 0:
            self.val += self.rng - r * ((1 << bits) - fl)
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * ((1 << bits) - fh)
        self._normalize()

    def enc_bit_logp(self, val: int, logp: int) -> None:
        r = self.rng
        s = r >> int(logp)
        r -= s
        if val:
            self.val += r
        self.rng = s if val else r
        self._normalize()

    def enc_icdf(self, s: int, icdf, ftb: int) -> None:
        s = int(s)
        r = self.rng >> int(ftb)
        if s > 0:
            self.val += self.rng - r * int(icdf[s - 1])
            self.rng = r * (int(icdf[s - 1]) - int(icdf[s]))
        else:
            self.rng -= r * int(icdf[s])
        self._normalize()

    def enc_uint(self, fl: int, ft: int) -> None:
        fl, ft = int(fl), int(ft)
        assert ft > 1
        ft -= 1
        ftb = ilog(ft)
        if ftb > UINT_BITS:
            ftb -= UINT_BITS
            ft_hi = (ft >> ftb) + 1
            fl_hi = fl >> ftb
            self.encode(fl_hi, fl_hi + 1, ft_hi)
            self.enc_bits(fl & ((1 << ftb) - 1), ftb)
        else:
            self.encode(fl, fl + 1, ft + 1)

    def enc_bits(self, fl: int, bits: int) -> None:
        fl, bits = int(fl), int(bits)
        window = self.end_window
        used = self.nend_bits
        if used + bits > WINDOW_SIZE:
            while used >= SYM_BITS:
                self.error |= self._write_byte_at_end(window & SYM_MAX)
                window >>= SYM_BITS
                used -= SYM_BITS
        window |= fl << used
        used += bits
        self.end_window = window
        self.nend_bits = used
        self.nbits_total += bits

    def enc_shrink(self, size: int) -> None:
        assert self.offs + self.end_offs <= size
        self.buf[size - self.end_offs : size] = self.buf[
            self.storage - self.end_offs : self.storage
        ]
        self.storage = size
        del self.buf[size:]

    def done(self) -> bytes:
        l = CODE_BITS - ilog(self.rng)
        msk = (CODE_TOP - 1) >> l
        end = (self.val + msk) & ~msk
        if (end | msk) >= self.val + self.rng:
            l += 1
            msk >>= 1
            end = (self.val + msk) & ~msk
        while l > 0:
            self._carry_out(end >> CODE_SHIFT)
            end = (end << SYM_BITS) & (CODE_TOP - 1)
            l -= SYM_BITS
        if self.rem >= 0 or self.ext > 0:
            self._carry_out(0)
        window = self.end_window
        used = self.nend_bits
        while used >= SYM_BITS:
            self.error |= self._write_byte_at_end(window & SYM_MAX)
            window >>= SYM_BITS
            used -= SYM_BITS
        if not self.error:
            for i in range(self.offs, self.storage - self.end_offs):
                self.buf[i] = 0
            if used > 0:
                if self.end_offs >= self.storage:
                    self.error = -1
                else:
                    l = -l
                    if (self.offs + self.end_offs >= self.storage
                            and l < used):
                        window &= (1 << l) - 1
                        self.error = -1
                    self.buf[self.storage - self.end_offs - 1] |= window & 0xFF
        return bytes(self.buf)

    def tell(self) -> int:
        return self.nbits_total - ilog(self.rng)

    def tell_frac(self) -> int:
        nbits = self.nbits_total << BITRES
        l = ilog(self.rng)
        r = self.rng >> (l - 16)
        for _ in range(BITRES):
            r = (r * r) >> 15
            b = r >> 16
            l = (l << 1) | b
            r >>= b
        return nbits - l
