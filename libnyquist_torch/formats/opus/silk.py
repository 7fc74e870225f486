"""SILK decoder (host side): the native fixed-point decode to 48 kHz int16.

The SILK half of SILK-only and hybrid Opus frames and its loss
concealment run in C (``native/silk_dec.c``, in ``libcelthost.so``;
reference: silk/ dec_API.c, decode_frame.c, decode_core.c, PLC.c,
CNG.c). SILK is specified in integer arithmetic, so the decode is
bit-exact with the reference. Only the range decoder's state crosses
the boundary (``celt_frame.ec_pack``); the decoder state lives behind an
opaque C handle, which in-band FEC recovery decodes on too. The port
keeps no Python SILK decoder.

The second half of the module is the integer arithmetic the SILK
encoder shares with the decoder's spec (reference: silk/macros.h,
Inlines.h, gain_quant.c, NLSF_*.c, NLSF2A.c, LPC_inv_pred_gain.c,
shell_coder.c): the encoder rebuilds exactly the filters and gains the
decoder will, so these are Python integers with int32 wraps where the
reference's macros wrap.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ...errors import DecodeError
from ...runtime import native
from . import silk_tables as ST
from .celt_frame import ec_pack, ec_unpack

_NATIVE = None          # (lib, keepalive-dict) once initialised
_LOCK = threading.Lock()
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I16P = ctypes.POINTER(ctypes.c_int16)

# Table order contracts with native/silk_dec.c (enum TU8_* / T32_*).
_U8_TABLES = [
    "type_offset_VAD_iCDF", "type_offset_no_VAD_iCDF", "gain_iCDF",
    "delta_gain_iCDF", "uniform3_iCDF", "uniform4_iCDF", "uniform5_iCDF",
    "uniform6_iCDF", "uniform8_iCDF", "NLSF_interp_iCDF", "NLSF_EXT_iCDF",
    "pitch_delta_iCDF", "pitch_lag_iCDF", "pitch_contour_iCDF",
    "pitch_contour_10ms_iCDF", "pitch_contour_NB_iCDF",
    "pitch_contour_10ms_NB_iCDF", "LTP_per_index_iCDF",
    "LTP_gain_iCDF_0", "LTP_gain_iCDF_1", "LTP_gain_iCDF_2",
    "LTPscale_iCDF", "LBRR_flags_2_iCDF", "LBRR_flags_3_iCDF",
    "rate_levels_iCDF", "pulses_per_block_iCDF", "lsb_iCDF", "sign_iCDF",
    "shell_code_table0", "shell_code_table1", "shell_code_table2",
    "shell_code_table3", "stereo_pred_joint_iCDF",
    "stereo_only_code_mid_iCDF",
]
_I32_TABLES = [
    "LTPScales_table_Q14", "LTP_vq_Q7_0", "LTP_vq_Q7_1", "LTP_vq_Q7_2",
    "CB_lags_stage2", "CB_lags_stage2_10ms", "CB_lags_stage3",
    "CB_lags_stage3_10ms", "Quantization_Offsets_Q10",
    "stereo_pred_quant_Q13", "LSFCosTab_FIX_Q12",
]


def _native_silk():
    """The host library with the normative tables handed over once
    (locked: silk_set_tables writes C globals)."""
    global _NATIVE
    with _LOCK:
        if _NATIVE is not None:
            return _NATIVE
        L = native.lib()
        t = ST.tables()
        u8_parts = [np.ascontiguousarray(t[n], np.uint8).ravel()
                    for n in _U8_TABLES]
        cbs = (ST.nlsf_cb_wb(), ST.nlsf_cb_nb_mb())
        for cb in cbs:
            u8_parts.append(np.ascontiguousarray(cb.CB1_iCDF, np.uint8).ravel())
            u8_parts.append(np.ascontiguousarray(cb.ec_iCDF, np.uint8).ravel())
        i32_parts = [np.ascontiguousarray(t[n], np.int32).ravel()
                     for n in _I32_TABLES]
        for cb in cbs:
            i32_parts.append(np.array(
                [cb.nVectors, cb.order, cb.quantStepSize_Q16,
                 cb.invQuantStepSize_Q6], np.int32))
            for a in (cb.CB1_NLSF_Q8, cb.pred_Q8, cb.ec_sel,
                      cb.deltaMin_Q15):
                i32_parts.append(np.ascontiguousarray(a, np.int32).ravel())
        for n in ("shell_code_table_offsets", "resampler_up2_hq_0",
                  "resampler_up2_hq_1", "resampler_frac_FIR_12"):
            i32_parts.append(np.ascontiguousarray(t[n], np.int32).ravel())

        def blob(parts, dtype):
            offs = np.cumsum([0] + [p.size for p in parts[:-1]])
            return (np.concatenate(parts).astype(dtype),
                    np.asarray(offs, np.int64))

        u8_blob, u8_offs = blob(u8_parts, np.uint8)
        i32_blob, i32_offs = blob(i32_parts, np.int32)
        L.silk_set_tables(
            u8_blob.ctypes.data_as(ctypes.c_char_p),
            u8_offs.ctypes.data_as(_I64P), len(u8_parts),
            i32_blob.ctypes.data_as(_I32P),
            i32_offs.ctypes.data_as(_I64P), len(i32_parts),
        )
        # The C side keeps raw pointers: the blobs must outlive the library.
        _NATIVE = (L, dict(u8=u8_blob, i32=i32_blob,
                           u8o=u8_offs, i32o=i32_offs))
        return _NATIVE


class NativeSilkDecoder:
    """One stream's SILK decoder state behind a native handle."""

    def __init__(self, channels: int):
        self._L = _native_silk()[0]
        self.nChannelsAPI = channels
        self._h = self._L.silk_create(channels)
        if not self._h:
            raise MemoryError("silk_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._L.silk_free(h)
            self._h = None

    def decode(self, dec, n_channels_internal, internal_rate, payload_ms):
        """Decode the SILK frames of one Opus frame from the shared range
        decoder ``dec`` (advanced in place). Returns int16-valued float64
        [samples, channels] at 48 kHz."""
        ch = self.nChannelsAPI
        out = np.zeros(payload_ms * 48 * ch, np.int16)
        ec = ec_pack(dec)
        n = self._L.silk_decode(
            self._h, dec.buf, dec.storage, ec.ctypes.data_as(_I64P),
            int(n_channels_internal), int(internal_rate), int(payload_ms),
            out.ctypes.data_as(_I16P),
        )
        if n < 0:
            raise DecodeError("native SILK decode failed")
        ec_unpack(dec, ec)
        return out[: n * ch].reshape(n, ch).astype(np.float64)

    def decode_fec(self, frame: bytes, n_channels_internal, internal_rate,
                   payload_ms):
        """Recover the frame lost before this one from its first LBRR
        frame (reference dec_API.c FLAG_DECODE_LBRR). Returns
        int16-valued float64 [samples, channels] at 48 kHz."""
        ch = self.nChannelsAPI
        out = np.zeros(20 * 48 * ch, np.int16)
        n = self._L.silk_decode_fec(
            self._h, frame, len(frame), int(n_channels_internal),
            int(internal_rate), int(payload_ms), out.ctypes.data_as(_I16P),
        )
        if n == -2:
            raise DecodeError("packet carries no LBRR data")
        if n < 0:
            raise DecodeError("native SILK FEC decode failed")
        return out[: n * ch].reshape(n, ch).astype(np.float64)

    def conceal(self, n_channels_internal, internal_rate, payload_ms):
        """Concealment for one lost packet duration (reference silk/PLC.c
        + CNG.c); the caller passes the last good packet's
        configuration."""
        ch = self.nChannelsAPI
        out = np.zeros(payload_ms * 48 * ch, np.int16)
        n = self._L.silk_decode_lost(
            self._h, int(n_channels_internal), int(internal_rate),
            int(payload_ms), out.ctypes.data_as(_I16P),
        )
        if n < 0:
            raise DecodeError("native SILK conceal failed")
        return out[: n * ch].reshape(n, ch).astype(np.float64)


# --------------------------------------------------------------------------
# Fixed-point helpers (reference: silk/macros.h, SigProc_FIX.h, Inlines.h)
# --------------------------------------------------------------------------
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def i16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x


def sat16(x: int) -> int:
    return -32768 if x < -32768 else (32767 if x > 32767 else x)


def smulwb(a: int, b: int) -> int:
    return (a * i16(b)) >> 16


def smlawb(a: int, b: int, c: int) -> int:
    return a + ((b * i16(c)) >> 16)


def smulbb(a: int, b: int) -> int:
    return i16(a) * i16(b)


def smlabb(a: int, b: int, c: int) -> int:
    return a + i16(b) * i16(c)


def smmul(a: int, b: int) -> int:
    return i32((a * b) >> 32)


def rshift_round(a: int, shift: int) -> int:
    if shift == 1:
        return (a >> 1) + (a & 1)
    return ((a >> (shift - 1)) + 1) >> 1


def smulww(a: int, b: int) -> int:
    # silk_MLA(silk_SMULWB(a, b), a, silk_RSHIFT_ROUND(b, 16))
    return i32(smulwb(a, b) + i32(a * rshift_round(b, 16)))


def smlaww(a: int, b: int, c: int) -> int:
    return i32(smlawb(a, b, c) + i32(b * rshift_round(c, 16)))


def clz32(x: int) -> int:
    x &= 0xFFFFFFFF
    return 32 - x.bit_length()


def cdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def limit(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


def lshift_sat32(a: int, shift: int) -> int:
    v = a << shift
    return limit(v, I32_MIN, I32_MAX)


def inverse32_varq(b32: int, qres: int) -> int:
    b_headrm = clz32(abs(b32)) - 1
    b_nrm = i32(b32 << b_headrm)
    b_inv = cdiv(I32_MAX >> 2, b_nrm >> 16)
    result = i32(b_inv << 16)
    err_q32 = i32(((1 << 29) - smulwb(b_nrm, b_inv)) << 3)
    result = smlaww(result, err_q32, b_inv)
    lshift = 61 - b_headrm - qres
    if lshift <= 0:
        return lshift_sat32(result, -lshift)
    if lshift < 32:
        return result >> lshift
    return 0


def silk_log2lin(in_log_q7: int) -> int:
    if in_log_q7 < 0:
        return 0
    if in_log_q7 >= 3967:
        return I32_MAX
    out = 1 << (in_log_q7 >> 7)
    frac_q7 = in_log_q7 & 0x7F
    adj = smlawb(frac_q7, smulbb(frac_q7, 128 - frac_q7), -174)
    if in_log_q7 < 2048:
        out = out + ((out * adj) >> 7)
    else:
        out = i32(out + (out >> 7) * adj)
    return out


def sqrt_approx(x: int) -> int:
    if x <= 0:
        return 0
    # silk_CLZ_FRAC: lz = CLZ32, frac = 7 middle bits below the leading one
    lz = clz32(x)
    frac_q7 = (x >> max(0, 24 - lz)) & 0x7F
    y = 32768 if (lz & 1) else 46214
    y >>= lz >> 1
    y = smlawb(y, y, smulbb(213, frac_q7))
    return y


def silk_rand(seed: int) -> int:
    return i32(907633515 + i32(seed * 196314165))


# --------------------------------------------------------------------------
# Gains (reference: gain_quant.c silk_gains_dequant)
# --------------------------------------------------------------------------
def gains_dequant(ind, prev_ind: int, conditional: bool, nb_subfr: int):
    gains = [0] * nb_subfr
    for k in range(nb_subfr):
        if k == 0 and not conditional:
            prev_ind = max(ind[k], prev_ind - 16)
        else:
            ind_tmp = ind[k] + ST.MIN_DELTA_GAIN_QUANT
            dsst = 2 * ST.MAX_DELTA_GAIN_QUANT - ST.N_LEVELS_QGAIN + prev_ind
            if ind_tmp > dsst:
                prev_ind += (ind_tmp << 1) - dsst
            else:
                prev_ind += ind_tmp
        prev_ind = limit(prev_ind, 0, ST.N_LEVELS_QGAIN - 1)
        gains[k] = silk_log2lin(
            min(smulwb(ST.GAIN_INV_SCALE_Q16, prev_ind) + ST.GAIN_OFFSET,
                3967)
        )
    return gains, prev_ind


# --------------------------------------------------------------------------
# NLSF (reference: NLSF_unpack.c, NLSF_decode.c, NLSF_stabilize.c,
# NLSF_VQ_weights_laroia.c, NLSF2A.c, bwexpander_32.c, LPC_inv_pred_gain.c)
# --------------------------------------------------------------------------
def nlsf_unpack(cb, cb1_index: int):
    ec_ix = [0] * cb.order
    pred_q8 = [0] * cb.order
    row = cb.ec_sel[cb1_index]
    for i in range(0, cb.order, 2):
        entry = int(row[i // 2])
        ec_ix[i] = ((entry >> 1) & 7) * (2 * ST.NLSF_QUANT_MAX_AMPLITUDE + 1)
        pred_q8[i] = int(cb.pred_Q8[i + (entry & 1) * (cb.order - 1)])
        ec_ix[i + 1] = ((entry >> 5) & 7) * (
            2 * ST.NLSF_QUANT_MAX_AMPLITUDE + 1
        )
        pred_q8[i + 1] = int(
            cb.pred_Q8[i + ((entry >> 4) & 1) * (cb.order - 1) + 1]
        )
    return ec_ix, pred_q8


def nlsf_residual_dequant(indices, pred_q8, quant_step_q16, order):
    x_q10 = [0] * order
    out_q10 = 0
    for i in range(order - 1, -1, -1):
        pred_q10 = (out_q10 * i16(pred_q8[i])) >> 8
        out_q10 = indices[i] << 10
        if out_q10 > 0:
            out_q10 = i16(out_q10 - ST.NLSF_QUANT_LEVEL_ADJ_Q10)
        elif out_q10 < 0:
            out_q10 = i16(out_q10 + ST.NLSF_QUANT_LEVEL_ADJ_Q10)
        out_q10 = smlawb(pred_q10, out_q10, quant_step_q16)
        x_q10[i] = out_q10
    return x_q10


def nlsf_vq_weights_laroia(nlsf_q15, order):
    w = [0] * order
    tmp1 = max(nlsf_q15[0], 1)
    tmp1 = cdiv(1 << (15 + ST.NLSF_W_Q), tmp1)
    tmp2 = max(nlsf_q15[1] - nlsf_q15[0], 1)
    tmp2 = cdiv(1 << (15 + ST.NLSF_W_Q), tmp2)
    w[0] = min(tmp1 + tmp2, 32767)
    for k in range(1, order - 1, 2):
        tmp1 = max(nlsf_q15[k + 1] - nlsf_q15[k], 1)
        tmp1 = cdiv(1 << (15 + ST.NLSF_W_Q), tmp1)
        w[k] = min(tmp1 + tmp2, 32767)
        tmp2 = max(nlsf_q15[k + 2] - nlsf_q15[k + 1], 1)
        tmp2 = cdiv(1 << (15 + ST.NLSF_W_Q), tmp2)
        w[k + 1] = min(tmp1 + tmp2, 32767)
    tmp1 = max((1 << 15) - nlsf_q15[order - 1], 1)
    tmp1 = cdiv(1 << (15 + ST.NLSF_W_Q), tmp1)
    w[order - 1] = min(tmp1 + tmp2, 32767)
    return w


def nlsf_stabilize(nlsf, delta_min, L):
    for _ in range(20):  # MAX_LOOPS
        min_diff = nlsf[0] - int(delta_min[0])
        I = 0
        for i in range(1, L):
            diff = nlsf[i] - (nlsf[i - 1] + int(delta_min[i]))
            if diff < min_diff:
                min_diff = diff
                I = i
        diff = (1 << 15) - (nlsf[L - 1] + int(delta_min[L]))
        if diff < min_diff:
            min_diff = diff
            I = L
        if min_diff >= 0:
            return
        if I == 0:
            nlsf[0] = int(delta_min[0])
        elif I == L:
            nlsf[L - 1] = (1 << 15) - int(delta_min[L])
        else:
            min_center = 0
            for k in range(I):
                min_center += int(delta_min[k])
            min_center += int(delta_min[I]) >> 1
            max_center = 1 << 15
            for k in range(L, I, -1):
                max_center -= int(delta_min[k])
            max_center -= int(delta_min[I]) >> 1
            center = limit(
                rshift_round(nlsf[I - 1] + nlsf[I], 1), min_center, max_center
            )
            nlsf[I - 1] = center - (int(delta_min[I]) >> 1)
            nlsf[I] = nlsf[I - 1] + int(delta_min[I])
    # Fallback: sort and force deltas
    nlsf[:L] = sorted(nlsf[:L])
    for i in range(1, L):
        nlsf[i] = max(nlsf[i], nlsf[i - 1] + int(delta_min[i]))
    for i in range(L - 1, -1, -1):
        hi = ((1 << 15) - int(delta_min[L])) if i == L - 1 else (
            nlsf[i + 1] - int(delta_min[i + 1])
        )
        nlsf[i] = min(nlsf[i], hi)


def nlsf_decode(indices, cb):
    order = cb.order
    nlsf = [int(cb.CB1_NLSF_Q8[indices[0]][i]) << 7 for i in range(order)]
    ec_ix, pred_q8 = nlsf_unpack(cb, indices[0])
    res_q10 = nlsf_residual_dequant(
        indices[1:], pred_q8, cb.quantStepSize_Q16, order
    )
    w = nlsf_vq_weights_laroia(nlsf, order)
    for i in range(order):
        w_q9 = sqrt_approx(w[i] << (18 - ST.NLSF_W_Q))
        v = nlsf[i] + cdiv(res_q10[i] << 14, w_q9)
        nlsf[i] = limit(v, 0, 32767)
    nlsf_stabilize(nlsf, cb.deltaMin_Q15, order)
    return nlsf


_ORDERING16 = [0, 15, 8, 7, 4, 11, 12, 3, 2, 13, 10, 5, 6, 9, 14, 1]
_ORDERING10 = [0, 9, 6, 3, 4, 5, 8, 1, 2, 7]
QA_NLSF2A = 16
QA_INVPRED = 24
A_LIMIT_Q24 = int(0.99975 * (1 << 24) + 0.5)


def _nlsf2a_find_poly(clsf, dd):
    out = [0] * (dd + 1)
    out[0] = 1 << QA_NLSF2A
    out[1] = -clsf[0]
    # Caller passes the de-interleaved even/odd cos-LSF sequence, so the
    # reference's cLSF[2*k] stride-2 access becomes clsf[k].
    for k in range(1, dd):
        ftmp = clsf[k]
        out[k + 1] = i32(
            i32(out[k - 1] << 1)
            - int(_rshift_round64(ftmp * out[k], QA_NLSF2A))
        )
        for n in range(k, 1, -1):
            out[n] = i32(
                out[n] + out[n - 2]
                - int(_rshift_round64(ftmp * out[n - 1], QA_NLSF2A))
            )
        out[1] -= ftmp
    return out


def _rshift_round64(a: int, shift: int) -> int:
    if shift == 1:
        return (a >> 1) + (a & 1)
    return ((a >> (shift - 1)) + 1) >> 1


def bwexpander_32(ar, d, chirp_q16):
    chirp_minus_one = chirp_q16 - 65536
    for i in range(d - 1):
        ar[i] = smulww(chirp_q16, ar[i])
        chirp_q16 += rshift_round(i32(chirp_q16 * chirp_minus_one), 16)
    ar[d - 1] = smulww(chirp_q16, ar[d - 1])


def lpc_inverse_pred_gain(a_q12, order):
    dc_resp = sum(a_q12[:order])
    if dc_resp >= 4096:
        return 0
    anew = [a << (QA_INVPRED - 12) for a in a_q12[:order]]
    inv_gain_q30 = 1 << 30
    for k in range(order - 1, 0, -1):
        if anew[k] > A_LIMIT_Q24 or anew[k] < -A_LIMIT_Q24:
            return 0
        rc_q31 = i32(-(anew[k] << (31 - QA_INVPRED)))
        rc_mult1_q30 = (1 << 30) - smmul(rc_q31, rc_q31)
        mult2q = 32 - clz32(abs(rc_mult1_q30))
        rc_mult2 = inverse32_varq(rc_mult1_q30, mult2q + 30)
        inv_gain_q30 = i32(smmul(inv_gain_q30, rc_mult1_q30) << 2)
        aold = anew[:]
        for n in range(k):
            tmp = i32(
                aold[n] - _mul32_frac_q(aold[k - n - 1], rc_q31, 31)
            )
            anew[n] = _mul32_frac_q(tmp, rc_mult2, mult2q)
    if anew[0] > A_LIMIT_Q24 or anew[0] < -A_LIMIT_Q24:
        return 0
    rc_q31 = i32(-(anew[0] << (31 - QA_INVPRED)))
    rc_mult1_q30 = (1 << 30) - smmul(rc_q31, rc_q31)
    inv_gain_q30 = i32(smmul(inv_gain_q30, rc_mult1_q30) << 2)
    return inv_gain_q30


def _mul32_frac_q(a: int, b: int, q: int) -> int:
    return i32(_rshift_round64(a * b, q))


def nlsf2a(nlsf_q15, d):
    t = ST.tables()
    cos_tab = t["LSFCosTab_FIX_Q12"]
    ordering = _ORDERING16 if d == 16 else _ORDERING10
    clsf = [0] * d
    for k in range(d):
        f_int = nlsf_q15[k] >> 8
        f_frac = nlsf_q15[k] - (f_int << 8)
        cos_val = int(cos_tab[f_int])
        delta = int(cos_tab[f_int + 1]) - cos_val
        clsf[ordering[k]] = rshift_round(
            (cos_val << 8) + delta * f_frac, 20 - QA_NLSF2A
        )
    dd = d >> 1
    P = _nlsf2a_find_poly(clsf[0::2], dd)
    Q = _nlsf2a_find_poly(clsf[1::2], dd)
    a32_qa1 = [0] * d
    for k in range(dd):
        ptmp = P[k + 1] + P[k]
        qtmp = Q[k + 1] - Q[k]
        a32_qa1[k] = i32(-qtmp - ptmp)
        a32_qa1[d - k - 1] = i32(qtmp - ptmp)
    for i in range(10):
        maxabs = 0
        idx = 0
        for k in range(d):
            absval = abs(a32_qa1[k])
            if absval > maxabs:
                maxabs = absval
                idx = k
        maxabs = rshift_round(maxabs, QA_NLSF2A + 1 - 12)
        if maxabs > 32767:
            maxabs = min(maxabs, 163838)
            sc_q16 = int(0.999 * 65536 + 0.5) - cdiv(
                (maxabs - 32767) << 14, (i32(maxabs * (idx + 1))) >> 2
            )
            bwexpander_32(a32_qa1, d, sc_q16)
        else:
            break
    if i == 9 and maxabs > 32767:
        a_q12 = [
            sat16(rshift_round(a, QA_NLSF2A + 1 - 12)) for a in a32_qa1
        ]
        a32_qa1 = [a << (QA_NLSF2A + 1 - 12) for a in a_q12]
    else:
        a_q12 = [rshift_round(a, QA_NLSF2A + 1 - 12) for a in a32_qa1]
    for it in range(16):  # MAX_LPC_STABILIZE_ITERATIONS
        if lpc_inverse_pred_gain(a_q12, d) < int((1 << 30) / 1e4):
            bwexpander_32(a32_qa1, d, 65536 - (2 << it))
            a_q12 = [rshift_round(a, QA_NLSF2A + 1 - 12) for a in a32_qa1]
        else:
            break
    return a_q12


def _shell_tables():
    t = ST.tables()
    return (
        t["shell_code_table0"], t["shell_code_table1"],
        t["shell_code_table2"], t["shell_code_table3"],
        t["shell_code_table_offsets"],
    )
