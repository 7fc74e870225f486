"""WavPack (.wv) decoder: host block decode, device tail.

After the WavPack 4/5 decode path (reference: third_party/wavpack/src —
block layout wavpack_local.h:134 WavpackHeader, metadata walk
open_utils.c:655 read_metadata_buff/process_metadata, entropy words
read_words.c:327 get_words_lossless, decorrelation unpack.c:506/568
decorr_*_pass, joint-stereo undo and final shift unpack.c:199/680
fixup_samples, float restore unpack_floats.c, int32 info
open_utils.c:412, DSD unpack_dsd.c).

* Host: the block and metadata walk below, then per block the native
  entropy words, decorrelation passes and float restores
  (``native/wv_words.c``), with the passes of blocks that share a term
  sequence run eight at a time in AVX2 lanes (``native/wv_simd.c``; the
  scalar passes where the CPU or a term rules that out), and the DSD
  block decode (``native/wv_dsd.c``). The fixups of the int32 info, the
  hybrid clip and shift and false stereo stay in NumPy.
* Device: the stream's int32 samples, float bit patterns or DSD bytes go
  up in one copy and finish there (``ops/lossless.py``): the int scale
  by ``2^-(bps-1)``, the float exponent normalization, or the 8:1 DSD
  decimation to 24-bit PCM at the byte rate.

Lossless (8 to 32 bits), hybrid (with and without the wvx correction
stream), float, int32-info, false-stereo and DSD streams of one or two
channels decode; more channels raise DecodeError. There is no Python
version of what the C decodes.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from ..audio_data import AudioData, PCMFormat
from ..errors import DecodeError
from ..ops import lossless
from ..ops.pcm import host_to_device
from ..runtime import native

# header flags (wavpack_local.h:176-201)
BYTES_STORED = 3
MONO_FLAG = 4
HYBRID_FLAG = 8
JOINT_STEREO = 0x10
FLOAT_DATA = 0x80
INT32_DATA = 0x100
HYBRID_BITRATE = 0x200
HYBRID_BALANCE = 0x400
INITIAL_BLOCK = 0x800
FINAL_BLOCK = 0x1000
SHIFT_LSB = 13
SRATE_LSB = 23
FALSE_STEREO = 0x40000000
MONO_DATA = MONO_FLAG | FALSE_STEREO
DSD_FLAG = 0x80000000

# metadata ids (wavpack_local.h:228-260)
ID_DECORR_TERMS = 0x2
ID_DECORR_WEIGHTS = 0x3
ID_DECORR_SAMPLES = 0x4
ID_ENTROPY_VARS = 0x5
ID_HYBRID_PROFILE = 0x6
ID_FLOAT_INFO = 0x8
ID_INT32_INFO = 0x9
ID_WV_BITSTREAM = 0xA
ID_WVX_BITSTREAM = 0xC
ID_DSD_BLOCK = 0xE
ID_ODD_SIZE = 0x40
ID_LARGE = 0x80

MAX_TERM = 8
SAMPLE_RATES = [6000, 8000, 9600, 11025, 12000, 16000, 22050, 24000,
                32000, 44100, 48000, 64000, 88200, 96000, 192000]
MAX_BLOCK_SAMPLES = 1 << 20
SIMD_LANES = 8
_SIMD_MIN_LANES = 4    # a partial group of 4 real lanes still beats scalar

_I32P = ctypes.POINTER(ctypes.c_int32)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_VPP = ctypes.POINTER(ctypes.c_void_p)

_EXP2 = [
    0x00, 0x01, 0x01, 0x02, 0x03, 0x03, 0x04, 0x05, 0x06, 0x06, 0x07, 0x08,
    0x08, 0x09, 0x0A, 0x0B, 0x0B, 0x0C, 0x0D, 0x0E, 0x0E, 0x0F, 0x10, 0x10,
    0x11, 0x12, 0x13, 0x13, 0x14, 0x15, 0x16, 0x16, 0x17, 0x18, 0x19, 0x19,
    0x1A, 0x1B, 0x1C, 0x1D, 0x1D, 0x1E, 0x1F, 0x20, 0x20, 0x21, 0x22, 0x23,
    0x24, 0x24, 0x25, 0x26, 0x27, 0x28, 0x28, 0x29, 0x2A, 0x2B, 0x2C, 0x2C,
    0x2D, 0x2E, 0x2F, 0x30, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3A, 0x3A, 0x3B, 0x3C, 0x3D, 0x3E, 0x3F, 0x40, 0x41,
    0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x48, 0x49, 0x4A, 0x4B,
    0x4C, 0x4D, 0x4E, 0x4F, 0x50, 0x51, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5A, 0x5B, 0x5C, 0x5D, 0x5E, 0x5E, 0x5F, 0x60, 0x61,
    0x62, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x6B, 0x6C, 0x6D,
    0x6E, 0x6F, 0x70, 0x71, 0x72, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x7B, 0x7C, 0x7D, 0x7E, 0x7F, 0x80, 0x81, 0x82, 0x83, 0x84, 0x85,
    0x87, 0x88, 0x89, 0x8A, 0x8B, 0x8C, 0x8D, 0x8E, 0x8F, 0x90, 0x91, 0x92,
    0x93, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0x9B, 0x9C, 0x9D, 0x9F, 0xA0,
    0xA1, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA8, 0xA9, 0xAA, 0xAB, 0xAC, 0xAD,
    0xAF, 0xB0, 0xB1, 0xB2, 0xB3, 0xB4, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xBC,
    0xBD, 0xBE, 0xBF, 0xC0, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC8, 0xC9, 0xCA,
    0xCB, 0xCD, 0xCE, 0xCF, 0xD0, 0xD2, 0xD3, 0xD4, 0xD6, 0xD7, 0xD8, 0xD9,
    0xDB, 0xDC, 0xDD, 0xDE, 0xE0, 0xE1, 0xE2, 0xE4, 0xE5, 0xE6, 0xE8, 0xE9,
    0xEA, 0xEC, 0xED, 0xEE, 0xF0, 0xF1, 0xF2, 0xF4, 0xF5, 0xF6, 0xF8, 0xF9,
    0xFA, 0xFC, 0xFD, 0xFF,
]


def exp2s(log: int) -> int:
    """entropy_utils.c wp_exp2s: signed log2 -> 32-bit value."""
    if log < 0:
        return -exp2s(-log)
    value = _EXP2[log & 0xFF] | 0x100
    shift = (log >> 8) - 9
    return value << shift if shift > 0 else value >> -shift


def restore_weight(w: int) -> int:
    """entropy_utils.c restore_weight (signed char -> weight)."""
    if w >= 128:
        w -= 256
    result = w << 3
    if result > 0:
        result += (result + 64) >> 7
    return result


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def _metadata(data: bytes):
    """(id, body) of each metadata sub-block (open_utils.c:655)."""
    pos = 0
    while pos + 2 <= len(data):
        mid = data[pos]
        length = data[pos + 1] << 1
        pos += 2
        if mid & ID_LARGE:
            mid &= ~ID_LARGE
            length += (data[pos] << 9) + (data[pos + 1] << 17)
            pos += 2
        if mid & ID_ODD_SIZE:
            mid &= ~ID_ODD_SIZE
            length -= 1
        yield mid, data[pos : pos + length]
        pos += length + (length & 1)


class Pass:
    """One decorrelation pass: term, delta, weights and history."""

    __slots__ = ("term", "delta", "weight_a", "weight_b",
                 "samples_a", "samples_b")

    def __init__(self, term, delta):
        self.term = term
        self.delta = delta
        self.weight_a = 0
        self.weight_b = 0
        self.samples_a = np.zeros(MAX_TERM, np.int32)
        self.samples_b = np.zeros(MAX_TERM, np.int32)


class Block:
    """One PCM block with its metadata applied."""

    def __init__(self, hdr_flags, block_samples, data):
        self.flags = hdr_flags
        self.block_samples = block_samples
        self.passes: list[Pass] = []
        self.medians = np.zeros(6, np.uint32)
        self.wvbits = None
        self.wvxbits = None
        self.float_flags = 0
        self.float_shift = 0
        self.float_max_exp = 0
        self.float_norm_exp = 0
        self.int32_sent_bits = 0
        self.int32_zeros = 0
        self.int32_ones = 0
        self.int32_dups = 0
        # hybrid state: [slow0, slow1, acc0, acc1, delta0, delta1]
        self.hyb = np.zeros(6, np.int32)
        self._parse_metadata(data)

    @property
    def mono(self) -> bool:
        return bool(self.flags & MONO_DATA)

    @property
    def joint(self) -> bool:
        return not self.mono and bool(self.flags & JOINT_STEREO)

    @property
    def nvalues(self) -> int:
        return self.block_samples * (1 if self.mono else 2)

    def _parse_metadata(self, data: bytes):
        mono = self.mono
        for mid, body in _metadata(data):
            if mid == ID_DECORR_TERMS:
                self.passes = [Pass((b & 0x1F) - 5, (b >> 5) & 0x7)
                               for b in reversed(body)]
            elif mid == ID_DECORR_WEIGHTS:
                # from the last term backwards (decorr_utils.c:61)
                cnt = len(body) // (1 if mono else 2)
                bi = 0
                for p in reversed(self.passes):
                    if cnt == 0:
                        break
                    cnt -= 1
                    p.weight_a = restore_weight(body[bi])
                    bi += 1
                    if not mono:
                        p.weight_b = restore_weight(body[bi])
                        bi += 1
            elif mid == ID_DECORR_SAMPLES:
                self._parse_samples(body, mono)
            elif mid == ID_ENTROPY_VARS:
                vals = struct.unpack_from(f"<{len(body) // 2}H", body, 0)
                for i, v in enumerate(vals[: 3 if mono else 6]):
                    self.medians[i] = exp2s(v) & 0xFFFFFFFF
            elif mid == ID_HYBRID_PROFILE:
                self._parse_hybrid(body, mono)
            elif mid == ID_FLOAT_INFO and len(body) == 4:
                (self.float_flags, self.float_shift, self.float_max_exp,
                 self.float_norm_exp) = body
            elif mid == ID_INT32_INFO and len(body) == 4:
                (self.int32_sent_bits, self.int32_zeros, self.int32_ones,
                 self.int32_dups) = body
            elif mid == ID_WV_BITSTREAM:
                self.wvbits = body
            elif mid == ID_WVX_BITSTREAM:
                # 4-byte crc_x then the side bitstream (open_utils.c:393)
                self.wvxbits = body[4:]

    def _parse_samples(self, body: bytes, mono: bool):
        def word(i):
            return exp2s(struct.unpack_from("<h", body, i)[0])

        bi = 0
        for p in reversed(self.passes):
            if bi >= len(body):
                break
            if p.term > MAX_TERM:
                p.samples_a[0], p.samples_a[1] = word(bi), word(bi + 2)
                bi += 4
                if not mono:
                    p.samples_b[0], p.samples_b[1] = word(bi), word(bi + 2)
                    bi += 4
            elif p.term < 0:
                p.samples_a[0], p.samples_b[0] = word(bi), word(bi + 2)
                bi += 4
            else:
                for m in range(p.term):
                    p.samples_a[m] = word(bi)
                    bi += 2
                    if not mono:
                        p.samples_b[m] = word(bi)
                        bi += 2

    def _parse_hybrid(self, body: bytes, mono: bool):
        """read_hybrid_profile (entropy_utils.c)."""
        bi = 0
        if self.flags & HYBRID_BITRATE:
            self.hyb[0] = exp2s(struct.unpack_from("<h", body, bi)[0])
            bi += 2
            if not mono:
                self.hyb[1] = exp2s(struct.unpack_from("<h", body, bi)[0])
                bi += 2
        self.hyb[2] = _i32(struct.unpack_from("<H", body, bi)[0] << 16)
        bi += 2
        if not mono:
            self.hyb[3] = _i32(struct.unpack_from("<H", body, bi)[0] << 16)
            bi += 2
        if bi < len(body):
            self.hyb[4] = exp2s(struct.unpack_from("<h", body, bi)[0])
            bi += 2
            if not mono:
                self.hyb[5] = exp2s(struct.unpack_from("<h", body, bi)[0])

    def _hybrid_flags(self) -> int:
        flags = self.flags
        return ((1 if flags & HYBRID_BITRATE else 0)
                | (2 if flags & HYBRID_BALANCE else 0)
                | (4 if self.mono else 0))

    def _bits(self):
        if self.wvbits is None:
            raise DecodeError("WavPack block has no audio bitstream")
        return self.wvbits + b"\xff" * 8

    def _pass_arrays(self):
        n = max(len(self.passes), 1)
        terms = np.zeros(n, np.int32)
        deltas = np.zeros(n, np.int32)
        weights = np.zeros((n, 2), np.int32)
        sa = np.zeros((n, MAX_TERM), np.int32)
        sb = np.zeros((n, MAX_TERM), np.int32)
        for i, p in enumerate(self.passes):
            terms[i], deltas[i] = p.term, p.delta
            weights[i] = (p.weight_a, p.weight_b)
            sa[i], sb[i] = p.samples_a, p.samples_b
        return terms, deltas, weights, sa, sb

    def decode(self) -> np.ndarray:
        """Words, passes and joint stereo in one native call, then the
        fixups: int32 [nvalues * (2 if false stereo)]."""
        buf = self._bits()
        out = np.zeros(self.nvalues, np.int32)
        st = np.zeros(4, np.uint32)
        terms, deltas, weights, sa, sb = self._pass_arrays()
        native.codec_lib().wv_decode_block(
            buf, len(self.wvbits) * 8, out.ctypes.data_as(_I32P),
            self.nvalues, self.medians.ctypes.data_as(_U32P),
            st.ctypes.data_as(_U32P), self.hyb.ctypes.data_as(_I32P),
            self._hybrid_flags(), 1 if self.flags & HYBRID_FLAG else 0,
            len(self.passes), terms.ctypes.data_as(_I32P),
            deltas.ctypes.data_as(_I32P), weights.ctypes.data_as(_I32P),
            sa.ctypes.data_as(_I32P), sb.ctypes.data_as(_I32P),
            1 if self.mono else 0, 1 if self.joint else 0,
            self.block_samples)
        if int(st[3]) != self.nvalues:
            raise DecodeError("WavPack entropy decode ran out of data")
        for i, p in enumerate(self.passes):
            p.weight_a, p.weight_b = int(weights[i, 0]), int(weights[i, 1])
            p.samples_a[:], p.samples_b[:] = sa[i], sb[i]
        return self.fixup(out)

    def decode_words(self) -> np.ndarray:
        """The entropy words alone: int32 residuals before the passes."""
        buf = self._bits()
        out = np.zeros(self.nvalues, np.int32)
        st = np.zeros(4, np.uint32)
        L = native.codec_lib()
        med = self.medians.ctypes.data_as(_U32P)
        if self.flags & HYBRID_FLAG:
            L.wv_words_hybrid(buf, len(self.wvbits) * 8, 0,
                              out.ctypes.data_as(_I32P), self.nvalues, med,
                              st.ctypes.data_as(_U32P),
                              self.hyb.ctypes.data_as(_I32P),
                              self._hybrid_flags())
        else:
            L.wv_words_lossless(buf, len(self.wvbits) * 8, 0,
                                out.ctypes.data_as(_I32P), self.nvalues, med,
                                st.ctypes.data_as(_U32P),
                                1 if self.mono else 0)
        if int(st[3]) != self.nvalues:
            raise DecodeError("WavPack entropy decode ran out of data")
        return out

    def apply_decorr(self, out: np.ndarray) -> None:
        """The scalar decorrelation passes and the joint-stereo undo, in
        place."""
        L = native.codec_lib()
        for p in self.passes:
            weights = np.array([p.weight_a, p.weight_b], np.int32)
            if self.mono:
                L.wv_decorr_mono(p.term, p.delta, weights.ctypes.data_as(_I32P),
                                 p.samples_a.ctypes.data_as(_I32P),
                                 out.ctypes.data_as(_I32P), self.block_samples)
            else:
                L.wv_decorr_stereo(p.term, p.delta,
                                   weights.ctypes.data_as(_I32P),
                                   p.samples_a.ctypes.data_as(_I32P),
                                   p.samples_b.ctypes.data_as(_I32P),
                                   out.ctypes.data_as(_I32P),
                                   self.block_samples)
            p.weight_a, p.weight_b = int(weights[0]), int(weights[1])
        if self.joint:
            # unpack.c:199 joint stereo undo (int32 wrap)
            left = out[0::2]
            right = out[1::2]
            right -= left >> 1
            left += right

    def fixup(self, out: np.ndarray) -> np.ndarray:
        """fixup_samples (unpack.c:680): float blocks give their float32
        bit patterns before the exponent normalization (done on the
        device), integer blocks the int32 info, hybrid clip and shift;
        false stereo doubles the channel."""
        flags = self.flags
        shift = (flags >> SHIFT_LSB) & 0x1F
        if flags & FLOAT_DATA:
            out = self._float_bits(out).view(np.int32)
        elif flags & INT32_DATA:
            out, shift = self._int32_info(out, shift)
        if not flags & FLOAT_DATA:
            if flags & HYBRID_FLAG:
                # lossy clip and shift (unpack.c:750-785)
                bits = ((flags & BYTES_STORED) + 1) * 8
                min_v = -(1 << (bits - 1)) >> shift
                max_v = ((1 << (bits - 1)) - 1) >> shift
                out = np.clip(out, min_v, max_v) << shift
            elif shift:
                out <<= shift
        if flags & FALSE_STEREO:
            out = np.repeat(out, 2)
        return out

    def _int32_info(self, out: np.ndarray, shift: int):
        sb, z = self.int32_sent_bits, self.int32_zeros
        o, d = self.int32_ones, self.int32_dups
        if self.wvxbits is None and (sb or not (z or o or d)):
            return out, shift + z + sb + o + d
        if self.wvxbits is not None and sb:
            # literally-sent low bits from the side stream (unpack.c:699),
            # fixed-width LSB-first fields
            bits = np.unpackbits(np.frombuffer(self.wvxbits, np.uint8),
                                 bitorder="little")
            need = len(out) * sb
            if bits.size < need:
                raise DecodeError("WavPack wvx stream too short")
            fields = bits[:need].reshape(len(out), sb).astype(np.int64)
            data = fields @ (1 << np.arange(sb, dtype=np.int64))
            out = (out.astype(np.int64) << sb) | data
            out = out & 0xFFFFFFFF
            out = np.where(out >= 1 << 31, out - (1 << 32),
                           out).astype(np.int32)
        if z:
            out <<= z
        elif o:
            out = ((out + 1) << o) - 1
        elif d:
            out = ((out + (out & 1)) << d) - (out & 1)
        return out, shift

    def _float_bits(self, values: np.ndarray) -> np.ndarray:
        """unpack_floats.c float_values (with the wvx side stream) or
        float_values_nowvx: uint32 bit patterns."""
        L = native.codec_lib()
        n = len(values)
        out = np.empty(n, np.uint32)
        vals = np.ascontiguousarray(values, np.int32)
        if self.wvxbits is not None:
            L.wv_float_values(vals.ctypes.data_as(_I32P), n,
                              self.wvxbits + b"\x00" * 8,
                              len(self.wvxbits) * 8, self.float_flags,
                              self.float_shift, self.float_max_exp,
                              out.ctypes.data_as(_U32P))
        else:
            L.wv_float_nowvx(vals.ctypes.data_as(_I32P), n, self.float_flags,
                             self.float_shift, self.float_max_exp,
                             out.ctypes.data_as(_U32P))
        return out


def decode_dsd_block(flags: int, block_samples: int,
                     body: bytes) -> tuple[np.ndarray, int]:
    """-> (interleaved DSD bytes u8 [block_samples * nch], dsd_power)."""
    dsd = next((b for mid, b in _metadata(body) if mid == ID_DSD_BLOCK),
               None)
    if dsd is None or len(dsd) < 2:
        raise DecodeError("DSD block without DSD metadata")
    power, mode = dsd[0], dsd[1]
    if power > 14:
        raise DecodeError("bad DSD rate multiplier")
    payload = dsd[2:]
    stereo = not (flags & MONO_DATA)
    out = np.zeros(block_samples * (2 if stereo else 1), np.uint8)
    r = native.codec_lib().wv_dsd_decode(
        payload, len(payload), int(mode), int(stereo), block_samples,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if r < 0:
        raise DecodeError("malformed DSD block")
    if flags & FALSE_STEREO:
        out = np.repeat(out, 2)
    return out, power


def _simd_lanes(blocks, res, lanes, terms_t, mono, joint) -> bool:
    """Run the passes of up to eight blocks that share ``terms_t`` in
    lockstep lanes, in place in ``res``; False when the native call
    declines (no AVX2 or a term it does not take) and nothing ran.

    Every block restates its weights and history in its metadata, so no
    state crosses blocks and lanes of different lengths may run to the
    longest: a shorter lane runs on a zero-padded copy whose tail is
    dropped, and unused lanes run on a scratch buffer."""
    nps = len(terms_t)
    n = max(nps, 1)
    terms = np.array(terms_t or [0], np.int32)
    bsamp = max(blocks[i].block_samples for i in lanes)
    nmax = max(res[i].size for i in lanes)
    deltas = np.zeros((n, SIMD_LANES), np.int32)
    weights = np.zeros((n, 2, SIMD_LANES), np.int32)
    sa = np.zeros((n, MAX_TERM, SIMD_LANES), np.int32)
    sb = np.zeros((n, MAX_TERM, SIMD_LANES), np.int32)
    bufs = []
    for ln, i in enumerate(lanes):
        for pi, p in enumerate(blocks[i].passes):
            deltas[pi, ln] = p.delta
            weights[pi, :, ln] = (p.weight_a, p.weight_b)
            sa[pi, :, ln] = p.samples_a
            sb[pi, :, ln] = p.samples_b
        if res[i].size < nmax:
            pad = np.zeros(nmax, np.int32)
            pad[: res[i].size] = res[i]
            bufs.append(pad)
        else:
            bufs.append(res[i])
    scratch = np.zeros(nmax, np.int32)
    bufs += [scratch] * (SIMD_LANES - len(lanes))
    addr = np.array([b.ctypes.data for b in bufs], np.uint64)
    rc = native.codec_lib().wv_decorr_simd8(
        nps, terms.ctypes.data_as(_I32P), deltas.ctypes.data_as(_I32P),
        weights.ctypes.data_as(_I32P), sa.ctypes.data_as(_I32P),
        sb.ctypes.data_as(_I32P), addr.ctypes.data_as(_VPP), bsamp,
        1 if mono else 0, 1 if joint else 0)
    if not rc:
        return False
    for ln, i in enumerate(lanes):
        if bufs[ln] is not res[i]:
            res[i][:] = bufs[ln][: res[i].size]
    return True


def decode_pcm_blocks(blocks: list) -> list:
    """Decode PCM blocks: each fused in one native call when there are
    fewer than four, else the entropy words per block and the passes of
    blocks that share (terms, mono, joint) eight at a time in AVX2 lanes
    (``native/wv_simd.c``), the scalar passes for what is left or what
    the lanes decline. Returns each block's fixed-up int32 values."""
    if len(blocks) < _SIMD_MIN_LANES:
        return [b.decode() for b in blocks]
    res = [b.decode_words() for b in blocks]
    groups: dict = {}
    for i, b in enumerate(blocks):
        key = (tuple(p.term for p in b.passes), b.mono, b.joint)
        groups.setdefault(key, []).append(i)
    for (terms_t, mono, joint), idxs in groups.items():
        k = 0
        while len(idxs) - k >= _SIMD_MIN_LANES:
            lanes = idxs[k : k + SIMD_LANES]
            if not _simd_lanes(blocks, res, lanes, terms_t, mono, joint):
                for i in lanes:
                    blocks[i].apply_decorr(res[i])
            k += len(lanes)
        for i in idxs[k:]:
            blocks[i].apply_decorr(res[i])
    return [b.fixup(res[i]) for i, b in enumerate(blocks)]


def read_blocks(data: bytes):
    """Walk the stream's blocks: (stream info dict, chunks), where a
    chunk is a PCM Block (not yet decoded) or a DSD block's bytes."""
    pos = 0
    n = len(data)
    chunks = []
    info = None
    channels = 0
    is_dsd = False
    while pos + 32 <= n:
        if data[pos : pos + 4] != b"wvpk":
            pos += 1
            continue
        (cksize, version, _index_u8, total_u8, total_lo, _block_index,
         block_samples, flags, _crc) = struct.unpack_from(
            "<IHBBIIIII", data, pos + 4)
        if (cksize < 24 or pos + 8 + cksize > n
                or not 0x402 <= version <= 0x410):
            pos += 1
            continue
        body = data[pos + 32 : pos + 8 + cksize]
        pos += 8 + cksize
        if info is None:
            srate_idx = (flags >> SRATE_LSB) & 0xF
            shift = (flags >> SHIFT_LSB) & 0x1F
            info = {
                # the header's 40-bit total, as the reference package
                # reads it; all ones in the low word means unknown
                "total_samples": (-1 if total_lo == 0xFFFFFFFF else
                                  total_lo + (total_u8 << 32) - total_u8),
                "sample_rate": (44100 if srate_idx == 0xF
                                else SAMPLE_RATES[srate_idx]),
                "is_float": bool(flags & FLOAT_DATA),
                "bps": ((flags & BYTES_STORED) + 1) * 8 - shift,
            }
        if not block_samples:
            continue                    # metadata-only block (tags etc.)
        if block_samples > MAX_BLOCK_SAMPLES:
            # no real encoder writes megasample blocks (PCM blocks are
            # <= ~1 s; DSD64 byte blocks ~350k/s); a corrupt u32 here
            # would drive the DSD bit loop for billions of iterations
            raise DecodeError("implausible WavPack block length")
        if not (flags & INITIAL_BLOCK) or not (flags & FINAL_BLOCK):
            raise DecodeError(
                "multichannel (>2ch) WavPack segments not supported")
        nch = 1 if (flags & MONO_FLAG) and not (flags & FALSE_STEREO) else 2
        if channels == 0:
            channels = nch
            is_dsd = bool(flags & DSD_FLAG)
        elif is_dsd != bool(flags & DSD_FLAG):
            raise DecodeError("mixed DSD and PCM WavPack blocks")
        if flags & DSD_FLAG:
            chunks.append(decode_dsd_block(flags, block_samples, body))
        else:
            chunks.append(Block(flags, block_samples, body))
    if info is None or not chunks:
        raise DecodeError("no WavPack blocks found")
    info["channels"] = channels
    return info, chunks


def _float_norms(blocks, values):
    """The exponents the values normalize from: None when no block is
    float, an int when every block agrees, else (int32 exponent a block,
    int64 values a block), 127 (a pass-through) for integer blocks."""
    if all(not b.flags & FLOAT_DATA for b in blocks):
        return None
    norms = [b.float_norm_exp if b.flags & FLOAT_DATA else 127
             for b in blocks]
    if len(set(norms)) == 1:
        return norms[0]
    return (np.array(norms, np.int32),
            np.array([v.size for v in values], np.int64))


def norm_on(norm, n: int, device):
    """``decode_host``'s norm where the values lie: an int as it is, the
    per-block exponents repeated to one a value on ``device``."""
    if norm is None or isinstance(norm, int):
        return norm
    norms, counts = (torch.from_numpy(a).to(device) for a in norm)
    return torch.repeat_interleave(norms, counts, output_size=n)


def decode_host(data: bytes):
    """The host half of a stream: (info, host array, norm), cut to the
    header's total. A PCM stream gives its fixed-up int32 values [n * ch]
    (float blocks as float32 bit patterns) and the exponent they
    normalize from (None, an int, or exponents and value counts a
    block); a DSD stream gives its decoded bytes [n, ch] and no norm.
    ``info`` holds
    the stream's channels, rate (a DSD stream's at the byte rate: the
    header's times 2^power, as WavpackGetSampleRate), is_float and bps
    (24 for DSD, decimated as with OPEN_DSD_AS_PCM)."""
    info, chunks = read_blocks(data)
    channels, total = info["channels"], info["total_samples"]
    if isinstance(chunks[0], tuple):
        # output frame i of the decimation reads bytes up to i only, so
        # the cut may come first
        raw = np.concatenate([c[0] for c in chunks]).reshape(-1, channels)
        if total >= 0:
            raw = raw[:total]
        info.update(sample_rate=info["sample_rate"] << chunks[0][1],
                    is_float=False, bps=24)
        return info, raw, None
    values = decode_pcm_blocks(chunks)
    raw = np.concatenate(values)
    norm = _float_norms(chunks, values)
    if total >= 0:
        raw = raw[: total * channels]
        if isinstance(norm, tuple):
            ends = np.minimum(np.cumsum(norm[1]), raw.size)
            norm = norm[0], np.diff(ends, prepend=0)
    return info, raw, norm


def device_tail(info: dict, raw: np.ndarray, norm, device) -> torch.Tensor:
    """The host array on ``device`` in one copy, finished there: the DSD
    decimation, or the float exponent normalization and then the view
    as float32 (a float stream) or the int scale. Returns float32
    interleaved samples."""
    x = host_to_device(raw, device)
    if raw.dtype == np.uint8:
        return lossless.dsd_decimate(x).reshape(-1)
    if norm is not None:
        x = lossless.normalize_float_bits(
            x, norm_on(norm, raw.size, device)).view(torch.int32)
    if info["is_float"]:
        return x.view(torch.float32)
    return lossless.scale_int(x, info["bps"])


def decode_wavpack_buffer(data: bytes, audio: AudioData, device) -> None:
    info, raw, norm = decode_host(data)
    channels, rate = info["channels"], info["sample_rate"]
    audio.samples = device_tail(info, raw, norm, device).cpu().numpy()
    audio.channel_count = channels
    audio.sample_rate = rate
    audio.source_format = (
        PCMFormat.PCM_FLT if info["is_float"] else
        {8: PCMFormat.PCM_S8, 16: PCMFormat.PCM_16, 24: PCMFormat.PCM_24,
         32: PCMFormat.PCM_32}.get(info["bps"], PCMFormat.PCM_16))
    audio.length_seconds = (
        audio.samples.size / channels / rate if rate else 0.0)
