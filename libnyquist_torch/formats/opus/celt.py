"""CELT, the encode half (host side): allocation, band quantization and
the prefilter the CELT encoder writes with.

The port keeps no Python CELT decoder (the decode runs in
``native/celt_bands.c``); this module holds what the encoders share with
the decoder's spec, in the encode direction only: the allocation
(reference: celt/rate.c clt_compute_allocation, coding the skip,
intensity and dual-stereo choices), the PVQ combinatorics and search
(cwrs.c icwrs, vq.c alg_quant and exp_rotation), the Laplace coder
(laplace.c ec_laplace_encode), the band recursion (bands.c quant_band,
quant_partition, quant_band_stereo, quant_all_bands), which resynthesizes
each band as the decoder does so both fold from the same buffers, and the
comb filter the pitch prefilter runs (celt.c comb_filter). Host float64
NumPy and Python integers; bit allocation is integer arithmetic and
matches the reference exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .celt_tables import COMB_GAINS, ORDERY_TABLE
from .range_coder import BITRES, RangeEncoder, ilog

# Constants (reference: celt/celt.h, celt/rate.h, celt/bands.h)
COMBFILTER_MINPERIOD = 15
MAX_FINE_BITS = 8
FINE_OFFSET = 21
QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16
LOG_MAX_PSEUDO = 6
SPREAD_NONE, SPREAD_LIGHT, SPREAD_NORMAL, SPREAD_AGGRESSIVE = 0, 1, 2, 3
ALLOC_STEPS = 6
EPSILON = 1e-15

SMALL_ENERGY_ICDF = [2, 1, 0]

# Inline iCDFs (reference: celt/celt_decoder.c, celt/celt.c), RFC 6716 §4.3.
TAPSET_ICDF = [2, 1, 0]
SPREAD_ICDF = [25, 23, 2, 0]
TRIM_ICDF = [126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0]

# Q3 log2 of 1..24 (reference: celt/rate.c LOG2_FRAC_TABLE).
LOG2_FRAC_TABLE = [
    0, 8, 13, 16, 19, 21, 23, 24, 26, 27, 28, 29, 30, 31, 32, 32,
    33, 34, 34, 35, 36, 36, 37, 37,
]

TF_SELECT_TABLE = [
    [0, -1, 0, -1, 0, -1, 0, -1],
    [0, -1, 0, -2, 1, 0, 1, -1],
    [0, -2, 0, -3, 2, 0, 1, -1],
    [0, -2, 0, -3, 3, 0, 1, -1],
]
BIT_INTERLEAVE_TABLE = [0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3]
BIT_DEINTERLEAVE_TABLE = [
    0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
    0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF,
]


def cdiv(a: int, b: int) -> int:
    """C-style integer division (truncation toward zero). Python's //
    floors, which differs for negative operands — and the reference's
    allocation math divides negative ints in several places."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def celt_lcg_rand(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def _frac_mul16(a: int, b: int) -> int:
    return (16384 + _i16(a) * _i16(b)) >> 15


def _i16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x


def bitexact_cos(x: int) -> int:
    """Bit-exact cos approximation (reference: bands.c:68-78)."""
    tmp = (4096 + x * x) >> 13
    x2 = tmp
    x2 = (32767 - x2) + _frac_mul16(
        x2, -7651 + _frac_mul16(x2, 8277 + _frac_mul16(-626, x2))
    )
    return 1 + x2


def bitexact_log2tan(isin: int, icos: int) -> int:
    lc = ilog(icos)
    ls = ilog(isin)
    icos <<= 15 - lc
    isin <<= 15 - ls
    return (
        (ls - lc) * (1 << 11)
        + _frac_mul16(isin, _frac_mul16(isin, -2597) + 7932)
        - _frac_mul16(icos, _frac_mul16(icos, -2597) + 7932)
    )


LAPLACE_LOG_MINP = 0
LAPLACE_MINP = 1 << LAPLACE_LOG_MINP
LAPLACE_NMIN = 16


def _laplace_get_freq1(fs0: int, decay: int) -> int:
    ft = 32768 - LAPLACE_MINP * (2 * LAPLACE_NMIN) - fs0
    return (ft * (16384 - decay)) >> 15


PRED_COEF = [29440 / 32768.0, 26112 / 32768.0, 21248 / 32768.0, 16384 / 32768.0]
BETA_COEF = [30147 / 32768.0, 22282 / 32768.0, 12124 / 32768.0, 6554 / 32768.0]
BETA_INTRA = 4915 / 32768.0


def get_pulses(i: int) -> int:
    return i if i < 8 else (8 + (i & 7)) << ((i >> 3) - 1)


def _band_cache(mode, band, LM):
    idx = mode.cache_index[(LM + 1) * mode.nbEBands + band]
    return mode.cache_bits[idx:]


def bits2pulses(mode, band, LM, bits):
    cache = _band_cache(mode, band, LM)
    lo, hi = 0, int(cache[0])
    bits -= 1
    for _ in range(LOG_MAX_PSEUDO):
        mid = (lo + hi + 1) >> 1
        if int(cache[mid]) >= bits:
            hi = mid
        else:
            lo = mid
    if bits - (-1 if lo == 0 else int(cache[lo])) <= int(cache[hi]) - bits:
        return lo
    return hi


def pulses2bits(mode, band, LM, pulses):
    cache = _band_cache(mode, band, LM)
    return 0 if pulses == 0 else int(cache[pulses]) + 1


_CAPS_CACHE = {}


def init_caps(mode, LM, C):
    """Per-band allocation caps; deterministic in (mode, LM, C), so cached
    (callers treat the result as read-only)."""
    key = (id(mode), LM, C)
    cap = _CAPS_CACHE.get(key)
    if cap is not None:
        return cap
    cap = [0] * mode.nbEBands
    for i in range(mode.nbEBands):
        N = (mode.eBands[i + 1] - mode.eBands[i]) << LM
        cap[i] = (
            int(mode.cache_caps[mode.nbEBands * (2 * LM + C - 1) + i]) + 64
        ) * C * N >> 2
    _CAPS_CACHE[key] = cap
    return cap


def _interp_bits2pulses(
    mode, start, end, skip_start, bits1, bits2, thresh, cap, total, skip_rsv,
    intensity_rsv, dual_stereo_rsv, C, LM, enc, chosen_intensity,
    chosen_dual,
):
    eBands = mode.eBands
    alloc_floor = C << BITRES
    stereo = 1 if C > 1 else 0
    logM = LM << BITRES
    bits = [0] * mode.nbEBands
    ebits = [0] * mode.nbEBands
    fine_priority = [0] * mode.nbEBands

    lo, hi = 0, 1 << ALLOC_STEPS
    for _ in range(ALLOC_STEPS):
        mid = (lo + hi) >> 1
        psum, done = 0, False
        for j in range(end - 1, start - 1, -1):
            tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS)
            if tmp >= thresh[j] or done:
                done = True
                psum += min(tmp, cap[j])
            elif tmp >= alloc_floor:
                psum += alloc_floor
        if psum > total:
            hi = mid
        else:
            lo = mid
    psum, done = 0, False
    for j in range(end - 1, start - 1, -1):
        tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS)
        if tmp < thresh[j] and not done:
            tmp = alloc_floor if tmp >= alloc_floor else 0
        else:
            done = True
        tmp = min(tmp, cap[j])
        bits[j] = tmp
        psum += tmp

    codedBands = end
    while True:
        j = codedBands - 1
        if j <= skip_start:
            total += skip_rsv
            break
        left = total - psum
        percoeff = cdiv(left, int(eBands[codedBands] - eBands[start]))
        left -= (eBands[codedBands] - eBands[start]) * percoeff
        rem = max(left - (eBands[j] - eBands[start]), 0)
        band_width = int(eBands[codedBands] - eBands[j])
        band_bits = bits[j] + percoeff * band_width + rem
        if band_bits >= max(thresh[j], alloc_floor + (1 << BITRES)):
            # encoder choice: never skip bands (spec-valid)
            enc.enc_bit_logp(1, 1)
            break
        psum -= bits[j] + intensity_rsv
        if intensity_rsv > 0:
            intensity_rsv = LOG2_FRAC_TABLE[j - start]
        psum += intensity_rsv
        if band_bits >= alloc_floor:
            psum += alloc_floor
            bits[j] = alloc_floor
        else:
            bits[j] = 0
        codedBands -= 1

    if intensity_rsv > 0:
        intensity = min(chosen_intensity, codedBands)
        enc.enc_uint(intensity - start, codedBands + 1 - start)
    else:
        intensity = 0
    if intensity <= start:
        total += dual_stereo_rsv
        dual_stereo_rsv = 0
    if dual_stereo_rsv > 0:
        dual_stereo = chosen_dual
        enc.enc_bit_logp(dual_stereo, 1)
    else:
        dual_stereo = 0

    left = total - psum
    percoeff = cdiv(left, int(eBands[codedBands] - eBands[start]))
    left -= (eBands[codedBands] - eBands[start]) * percoeff
    for j in range(start, codedBands):
        bits[j] += percoeff * (eBands[j + 1] - eBands[j])
    for j in range(start, codedBands):
        tmp = min(left, int(eBands[j + 1] - eBands[j]))
        bits[j] += tmp
        left -= tmp

    balance = 0
    j = start
    for j in range(start, codedBands):
        N0 = int(eBands[j + 1] - eBands[j])
        N = N0 << LM
        bit = bits[j] + balance
        if N > 1:
            excess = max(bit - cap[j], 0)
            bits[j] = bit - excess
            den = C * N + (
                1 if (C == 2 and N > 2 and not dual_stereo and j < intensity)
                else 0
            )
            NClogN = den * (int(mode.logN[j]) + logM)
            offset = (NClogN >> 1) - den * FINE_OFFSET
            if N == 2:
                offset += den << BITRES >> 2
            if bits[j] + offset < (den * 2) << BITRES:
                offset += NClogN >> 2
            elif bits[j] + offset < (den * 3) << BITRES:
                offset += NClogN >> 3
            ebits[j] = max(
                0, cdiv(bits[j] + offset + (den << (BITRES - 1)),
                        den << BITRES)
            )
            if C * ebits[j] > (bits[j] >> BITRES):
                ebits[j] = bits[j] >> stereo >> BITRES
            ebits[j] = min(ebits[j], MAX_FINE_BITS)
            fine_priority[j] = int(
                ebits[j] * (den << BITRES) >= bits[j] + offset
            )
            bits[j] -= C * ebits[j] << BITRES
        else:
            excess = max(0, bit - (C << BITRES))
            bits[j] = bit - excess
            ebits[j] = 0
            fine_priority[j] = 1
        if excess > 0:
            extra_fine = min(excess >> (stereo + BITRES),
                             MAX_FINE_BITS - ebits[j])
            ebits[j] += extra_fine
            extra_bits = extra_fine * C << BITRES
            fine_priority[j] = int(extra_bits >= excess - balance)
            excess -= extra_bits
        balance = excess

    for j in range(codedBands, end):
        ebits[j] = bits[j] >> stereo >> BITRES
        bits[j] = 0
        fine_priority[j] = int(ebits[j] < 1)
    return codedBands, balance, bits, ebits, fine_priority, intensity, dual_stereo


def compute_allocation(
    mode, start, end, offsets, cap, alloc_trim, total, C, LM, enc,
    chosen_intensity=0, chosen_dual=0,
):
    """rate.c clt_compute_allocation in the encode direction: the band
    skip, intensity and dual-stereo choices are coded into ``enc``."""
    eBands = mode.eBands
    total = max(total, 0)
    length = mode.nbEBands
    skip_start = start
    skip_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
    total -= skip_rsv
    intensity_rsv = dual_stereo_rsv = 0
    if C == 2:
        intensity_rsv = LOG2_FRAC_TABLE[end - start]
        if intensity_rsv > total:
            intensity_rsv = 0
        else:
            total -= intensity_rsv
            dual_stereo_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
            total -= dual_stereo_rsv

    thresh = [0] * length
    trim_offset = [0] * length
    bits1 = [0] * length
    bits2 = [0] * length
    for j in range(start, end):
        thresh[j] = max(
            C << BITRES,
            (3 * (eBands[j + 1] - eBands[j]) << LM << BITRES) >> 4,
        )
        trim_offset[j] = (
            C * (eBands[j + 1] - eBands[j])
            * (alloc_trim - 5 - LM) * (end - j - 1)
            * (1 << (LM + BITRES))
        ) >> 6
        if (eBands[j + 1] - eBands[j]) << LM == 1:
            trim_offset[j] -= C << BITRES

    lo, hi = 1, mode.nbAllocVectors - 1
    while lo <= hi:
        done = False
        psum = 0
        mid = (lo + hi) >> 1
        for j in range(end - 1, start - 1, -1):
            N = int(eBands[j + 1] - eBands[j])
            bitsj = C * N * int(mode.allocVectors[mid, j]) << LM >> 2
            if bitsj > 0:
                bitsj = max(0, bitsj + trim_offset[j])
            bitsj += offsets[j]
            if bitsj >= thresh[j] or done:
                done = True
                psum += min(bitsj, cap[j])
            elif bitsj >= C << BITRES:
                psum += C << BITRES
        if psum > total:
            hi = mid - 1
        else:
            lo = mid + 1
    hi = lo
    lo -= 1
    for j in range(start, end):
        N = int(eBands[j + 1] - eBands[j])
        bits1j = C * N * int(mode.allocVectors[lo, j]) << LM >> 2
        bits2j = (
            cap[j] if hi >= mode.nbAllocVectors
            else C * N * int(mode.allocVectors[hi, j]) << LM >> 2
        )
        if bits1j > 0:
            bits1j = max(0, bits1j + trim_offset[j])
        if bits2j > 0:
            bits2j = max(0, bits2j + trim_offset[j])
        if lo > 0:
            bits1j += offsets[j]
        bits2j += offsets[j]
        if offsets[j] > 0:
            skip_start = j
        bits2j = max(0, bits2j - bits1j)
        bits1[j] = bits1j
        bits2[j] = bits2j
    return _interp_bits2pulses(
        mode, start, end, skip_start, bits1, bits2, thresh, cap, total,
        skip_rsv, intensity_rsv, dual_stereo_rsv, C, LM, enc,
        chosen_intensity, chosen_dual,
    )


_U_CACHE: dict = {}


def pvq_u(n: int, k: int) -> int:
    """U(N,K): PVQ codewords of size N, K pulses, first pulse positive-ish."""
    if n < 0 or k < 0:
        return 0
    a, b = (n, k) if n <= k else (k, n)
    key = (a, b)
    v = _U_CACHE.get(key)
    if v is not None:
        return v
    # Base cases per the reference table (cwrs.c CELT_PVQ_U_DATA rows
    # N=0: 1,0,0,...  N=1: 1,1,1,...): U(0,0)=1, U(0,K>0)=0, U(N>0,0)=0.
    if n == 0 and k == 0:
        v = 1
    elif n == 0 or k == 0:
        v = 0
    else:
        v = pvq_u(n - 1, k) + pvq_u(n, k - 1) + pvq_u(n - 1, k - 1)
    _U_CACHE[key] = v
    return v


def pvq_v(n: int, k: int) -> int:
    return pvq_u(n, k) + pvq_u(n, k + 1)


SPREAD_FACTOR = [15, 10, 5]


def _exp_rotation1(X, length, stride, c, s):
    for i in range(length - stride):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = c * x2 + s * x1
        X[i] = c * x1 - s * x2
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = c * x2 + s * x1
        X[i] = c * x1 - s * x2


def exp_rotation(X, length, direction, stride, K, spread):
    if 2 * K >= length or spread == SPREAD_NONE:
        return
    factor = SPREAD_FACTOR[spread - 1]
    gain = 1.0 * length / (length + factor * K)
    theta = 0.5 * gain * gain
    c = math.cos(0.5 * math.pi * theta)
    s = math.cos(0.5 * math.pi * (1.0 - theta))
    stride2 = 0
    if length >= 8 * stride:
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride + (stride >> 2) < length:
            stride2 += 1
    length //= stride
    for i in range(stride):
        seg = X[i * length : (i + 1) * length]
        if direction < 0:
            if stride2:
                _exp_rotation1(seg, length, stride2, s, c)
            _exp_rotation1(seg, length, 1, c, s)
        else:
            _exp_rotation1(seg, length, 1, c, -s)
            if stride2:
                _exp_rotation1(seg, length, stride2, s, -c)


def extract_collapse_mask(iy, N, B):
    if B <= 1:
        return 1
    N0 = N // B
    mask = 0
    for i in range(B):
        sub = 0
        for j in range(N0):
            sub |= iy[i * N0 + j]
        mask |= (1 if sub != 0 else 0) << i
    return mask


def icwrs(n: int, y) -> int:
    """Pulse vector -> index (reference: cwrs.c icwrs)."""
    j = n - 1
    i = 1 if y[j] < 0 else 0
    k = abs(int(y[j]))
    while j > 0:
        j -= 1
        i += pvq_u(n - j, k)
        k += abs(int(y[j]))
        if y[j] < 0:
            i += pvq_u(n - j, k + 1)
    return i


def encode_pulses(iy, n: int, k: int, enc) -> None:
    enc.enc_uint(icwrs(n, iy), pvq_v(n, k))


def op_pvq_search(X, K: int, N: int):
    """Greedy K-pulse PVQ search (reference: vq.c op_pvq_search).

    Returns (iy, yy). Any |y|_1 = K vector is decodable; the search only
    affects quality."""
    signs = [1 if X[j] >= 0 else -1 for j in range(N)]
    ax = [abs(float(X[j])) for j in range(N)]
    total = sum(ax)
    iy = [0] * N
    if total <= 1e-15:
        iy = [K] + [0] * (N - 1)
        return iy, float(K * K)
    # projection first pass
    pulses_left = K
    if K > (N >> 1):
        rcp = (K - 1) / total
        for j in range(N):
            iy[j] = int(ax[j] * rcp)
        pulses_left = K - sum(iy)
    xy = sum(ax[j] * iy[j] for j in range(N))
    yy = float(sum(v * v for v in iy))
    while pulses_left > 0:
        best = -1
        best_num = -1.0
        best_den = 0.0
        for j in range(N):
            num = (xy + ax[j]) * (xy + ax[j])
            den = yy + 2.0 * iy[j] + 1.0
            if best < 0 or num * best_den > best_num * den:
                best = j
                best_num = num
                best_den = den
        xy += ax[best]
        yy += 2.0 * iy[best] + 1.0
        iy[best] += 1
        pulses_left -= 1
    out = [signs[j] * iy[j] for j in range(N)]
    return out, float(sum(v * v for v in out))


def alg_quant(X, N, K, spread, B, enc, gain):
    """PVQ quantize + encode + resynthesize (reference: vq.c alg_quant)."""
    exp_rotation(X, N, 1, B, K, spread)
    iy, yy = op_pvq_search(X, K, N)
    encode_pulses(iy, N, K, enc)
    g = gain / math.sqrt(yy)
    for j in range(N):
        X[j] = g * iy[j]
    exp_rotation(X, N, -1, B, K, spread)
    return extract_collapse_mask(iy, N, B)


def laplace_encode(enc, value: int, fs: int, decay: int) -> int:
    """Dual of laplace_decode (reference: laplace.c ec_laplace_encode).
    Returns the (possibly saturated) value actually encoded."""
    fl = 0
    val = int(value)
    if val:
        s = -1 if val < 0 else 0
        val = (val + s) ^ s
        fl = fs
        fs = _laplace_get_freq1(fs, decay)
        i = 1
        while fs > 0 and i < val:
            fs *= 2
            fl += fs + 2 * LAPLACE_MINP
            fs = (fs * decay) >> 15
            i += 1
        if not fs:
            ndi_max = (32768 - fl + LAPLACE_MINP - 1) >> LAPLACE_LOG_MINP
            ndi_max = (ndi_max - s) >> 1
            di = min(val - i, ndi_max - 1)
            fl += (2 * di + 1 + s) * LAPLACE_MINP
            fs = min(LAPLACE_MINP, 32768 - fl)
            value = (i + di + s) ^ s
        else:
            fs += LAPLACE_MINP
            fl += fs & ~s
    enc.encode_bin(fl, fl + fs, 15)
    return int(value)


def renormalise_vector(X, N, gain):
    E = EPSILON + float(np.sum(X[:N] * X[:N]))
    g = gain / math.sqrt(E)
    X[:N] *= g


def _haar1(X, n0, stride):
    n0 >>= 1
    s = math.sqrt(0.5)
    for i in range(stride):
        for j in range(n0):
            a = stride * 2 * j + i
            b = stride * (2 * j + 1) + i
            t1 = s * X[a]
            t2 = s * X[b]
            X[a] = t1 + t2
            X[b] = t1 - t2


def _deinterleave_hadamard(X, N0, stride, hadamard):
    N = N0 * stride
    tmp = np.empty(N, dtype=X.dtype)
    if hadamard:
        ordery = ORDERY_TABLE[stride]
        for i in range(stride):
            for j in range(N0):
                tmp[ordery[i] * N0 + j] = X[j * stride + i]
    else:
        for i in range(stride):
            for j in range(N0):
                tmp[i * N0 + j] = X[j * stride + i]
    X[:N] = tmp


def _interleave_hadamard(X, N0, stride, hadamard):
    N = N0 * stride
    tmp = np.empty(N, dtype=X.dtype)
    if hadamard:
        ordery = ORDERY_TABLE[stride]
        for i in range(stride):
            for j in range(N0):
                tmp[j * stride + i] = X[ordery[i] * N0 + j]
    else:
        for i in range(stride):
            for j in range(N0):
                tmp[j * stride + i] = X[i * N0 + j]
    X[:N] = tmp


def compute_qn(N, b, offset, pulse_cap, stereo):
    exp2_table8 = [16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048]
    N2 = 2 * N - 1
    if stereo and N == 2:
        N2 -= 1
    qb = min(b - pulse_cap - (4 << BITRES), cdiv(b + N2 * offset, N2))
    qb = min(8 << BITRES, qb)
    if qb < (1 << BITRES >> 1):
        qn = 1
    else:
        qn = exp2_table8[qb & 0x7] >> (14 - (qb >> BITRES))
        qn = ((qn + 1) >> 1) << 1
    return qn


@dataclass
class BandCtx:
    mode: object
    i: int = 0
    intensity: int = 0
    spread: int = 0
    tf_change: int = 0
    enc: RangeEncoder = None
    remaining_bits: int = 0
    seed: int = 0
    bandE: object = None        # [C, nbEBands] band energies
    disable_inv: int = 1


@dataclass
class SplitCtx:
    inv: int = 0
    imid: int = 0
    iside: int = 0
    delta: int = 0
    itheta: int = 0
    qalloc: int = 0


def _stereo_split(X, Y, N):
    s = math.sqrt(0.5)
    for j in range(N):
        l = s * X[j]
        r = s * Y[j]
        X[j] = l + r
        Y[j] = r - l


def _intensity_stereo(mode, X, Y, bandE, bandID, N):
    left = float(bandE[0][bandID])
    right = float(bandE[1][bandID])
    norm = EPSILON + math.sqrt(EPSILON + left * left + right * right)
    a1 = left / norm
    a2 = right / norm
    for j in range(N):
        X[j] = a1 * X[j] + a2 * Y[j]


def compute_theta(ctx: BandCtx, X, Y, N, b, B, B0, LM, stereo, fill):
    """Returns (sctx, b, fill)."""
    enc = ctx.enc
    mode = ctx.mode
    i = ctx.i
    sctx = SplitCtx()
    pulse_cap = int(mode.logN[i]) + LM * (1 << BITRES)
    offset = (pulse_cap >> 1) - (
        QTHETA_OFFSET_TWOPHASE if (stereo and N == 2) else QTHETA_OFFSET
    )
    qn = compute_qn(N, b, offset, pulse_cap, stereo)
    if stereo and i >= ctx.intensity:
        qn = 1
    inv = 0
    # stereo_itheta (vq.c): mid/side angle for stereo, half/half for a
    # mono split
    if stereo:
        m = 0.5 * (X[:N] + Y[:N])
        sd = 0.5 * (X[:N] - Y[:N])
        emid = 1e-15 + float(np.dot(m, m))
        eside = 1e-15 + float(np.dot(sd, sd))
    else:
        emid = 1e-15 + float(np.dot(X[:N], X[:N]))
        eside = 1e-15 + float(np.dot(Y[:N], Y[:N]))
    itheta = int(math.floor(0.5 + 16384 * 0.63662 * math.atan2(
        math.sqrt(eside), math.sqrt(emid))))
    tell = enc.tell_frac()
    if qn != 1:
        itheta = (itheta * qn + 8192) >> 14
        if stereo and N > 2:
            p0 = 3
            x0 = qn // 2
            ft = p0 * (x0 + 1) + x0
            x = itheta
            enc.encode(
                p0 * x if x <= x0 else (x - 1 - x0) + (x0 + 1) * p0,
                p0 * (x + 1) if x <= x0 else (x - x0) + (x0 + 1) * p0,
                ft,
            )
        elif B0 > 1 or stereo:
            enc.enc_uint(itheta, qn + 1)
        else:
            ft = ((qn >> 1) + 1) * ((qn >> 1) + 1)
            if itheta <= (qn >> 1):
                fs = itheta + 1
                fl = itheta * (itheta + 1) >> 1
            else:
                fs = qn + 1 - itheta
                fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1)
            enc.encode(fl, fl + fs, ft)
        itheta = itheta * 16384 // qn
        if stereo:
            if itheta == 0:
                _intensity_stereo(ctx.mode, X, Y, ctx.bandE, i, N)
            else:
                _stereo_split(X, Y, N)
    elif stereo:
        inv = 1 if (itheta > 8192 and not ctx.disable_inv) else 0
        if inv:
            Y[:N] = -Y[:N]
        _intensity_stereo(ctx.mode, X, Y, ctx.bandE, i, N)
        if b > 2 << BITRES and ctx.remaining_bits > 2 << BITRES:
            enc.enc_bit_logp(inv, 2)
        else:
            inv = 0
        itheta = 0
    qalloc = enc.tell_frac() - tell
    b -= qalloc

    if itheta == 0:
        imid, iside = 32767, 0
        fill &= (1 << B) - 1
        delta = -16384
    elif itheta == 16384:
        imid, iside = 0, 32767
        fill &= ((1 << B) - 1) << B
        delta = 16384
    else:
        imid = bitexact_cos(itheta)
        iside = bitexact_cos(16384 - itheta)
        delta = _frac_mul16((N - 1) << 7, bitexact_log2tan(iside, imid))

    sctx.inv = inv
    sctx.imid = imid
    sctx.iside = iside
    sctx.delta = delta
    sctx.itheta = itheta
    sctx.qalloc = qalloc
    return sctx, b, fill


def quant_band_n1(ctx: BandCtx, X, Y, b, lowband_out):
    enc = ctx.enc
    stereo = Y is not None
    for x in ([X, Y] if stereo else [X]):
        sign = 0
        if ctx.remaining_bits >= 1 << BITRES:
            sign = 1 if x[0] < 0 else 0
            enc.enc_bits(sign, 1)
            ctx.remaining_bits -= 1 << BITRES
            b -= 1 << BITRES
        x[0] = -1.0 if sign else 1.0
    if lowband_out is not None:
        lowband_out[0] = X[0]
    return 1


def quant_partition(ctx: BandCtx, X, N, b, B, lowband, LM, gain, fill):
    mode = ctx.mode
    i = ctx.i
    B0 = B
    cache = _band_cache(mode, i, LM)
    if LM != -1 and b > int(cache[int(cache[0])]) + 12 and N > 2:
        N >>= 1
        Y = X[N:]
        LM -= 1
        if B == 1:
            fill = (fill & 1) | (fill << 1)
        B = (B + 1) >> 1
        sctx, b, fill = compute_theta(ctx, X, Y, N, b, B, B0, LM, 0, fill)
        imid, iside = sctx.imid, sctx.iside
        delta, itheta, qalloc = sctx.delta, sctx.itheta, sctx.qalloc
        mid = imid / 32768.0
        side = iside / 32768.0
        if B0 > 1 and (itheta & 0x3FFF):
            if itheta > 8192:
                delta -= delta >> (4 - LM)
            else:
                delta = min(0, delta + (N << BITRES >> (5 - LM)))
        mbits = max(0, min(b, cdiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        next_lowband2 = lowband[N:] if lowband is not None else None
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_partition(
                ctx, X, N, mbits, B, lowband, LM, gain * mid, fill
            )
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_partition(
                ctx, Y, N, sbits, B, next_lowband2, LM, gain * side,
                fill >> B,
            ) << (B0 >> 1)
        else:
            cm = quant_partition(
                ctx, Y, N, sbits, B, next_lowband2, LM, gain * side,
                fill >> B,
            ) << (B0 >> 1)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_partition(
                ctx, X, N, mbits, B, lowband, LM, gain * mid, fill
            )
    else:
        q = bits2pulses(mode, i, LM, b)
        curr_bits = pulses2bits(mode, i, LM, q)
        ctx.remaining_bits -= curr_bits
        while ctx.remaining_bits < 0 and q > 0:
            ctx.remaining_bits += curr_bits
            q -= 1
            curr_bits = pulses2bits(mode, i, LM, q)
            ctx.remaining_bits -= curr_bits
        if q != 0:
            K = get_pulses(q)
            cm = alg_quant(X, N, K, ctx.spread, B, ctx.enc, gain)
        else:
            cm_mask = (1 << B) - 1
            fill &= cm_mask
            if not fill:
                X[:N] = 0.0
                cm = 0
            else:
                if lowband is None:
                    for j in range(N):
                        ctx.seed = celt_lcg_rand(ctx.seed)
                        v = ctx.seed
                        X[j] = float(
                            np.int32(np.uint32(v)).item() >> 20
                        )
                    cm = cm_mask
                else:
                    for j in range(N):
                        ctx.seed = celt_lcg_rand(ctx.seed)
                        tmp = 1.0 / 256
                        tmp = tmp if (ctx.seed & 0x8000) else -tmp
                        X[j] = lowband[j] + tmp
                    cm = fill
                renormalise_vector(X, N, gain)
    return cm


def quant_band(
    ctx: BandCtx, X, N, b, B, lowband, LM, lowband_out, gain,
    lowband_scratch, fill,
):
    N0 = N
    N_B = N
    B0 = B
    time_divide = 0
    recombine = 0
    longBlocks = B0 == 1
    tf_change = ctx.tf_change

    N_B //= B

    if N == 1:
        return quant_band_n1(ctx, X, None, b, lowband_out)

    if tf_change > 0:
        recombine = tf_change
    if lowband_scratch is not None and lowband is not None and (
        recombine or ((N_B & 1) == 0 and tf_change < 0) or B0 > 1
    ):
        lowband_scratch[:N] = lowband[:N]
        lowband = lowband_scratch

    fill = int(fill)
    for k in range(recombine):
        _haar1(X, N >> k, 1 << k)
        if lowband is not None:
            _haar1(lowband, N >> k, 1 << k)
        fill = (
            BIT_INTERLEAVE_TABLE[fill & 0xF]
            | BIT_INTERLEAVE_TABLE[fill >> 4] << 2
        )
    B >>= recombine
    N_B <<= recombine

    while (N_B & 1) == 0 and tf_change < 0:
        _haar1(X, N_B, B)
        if lowband is not None:
            _haar1(lowband, N_B, B)
        fill |= fill << B
        B <<= 1
        N_B >>= 1
        time_divide += 1
        tf_change += 1
    B0 = B
    N_B0 = N_B

    if B0 > 1 and lowband is not None:
        _deinterleave_hadamard(
            lowband, N_B >> recombine, B0 << recombine, longBlocks
        )
    if B0 > 1:
        _deinterleave_hadamard(
            X, N_B >> recombine, B0 << recombine, longBlocks
        )

    cm = quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill)

    # Resynthesis: the encoder resynthesizes as the decoder does, so the
    # norm folding buffers match the decoder's.
    if B0 > 1:
        _interleave_hadamard(X, N_B >> recombine, B0 << recombine, longBlocks)
    N_B = N_B0
    B = B0
    for _ in range(time_divide):
        B >>= 1
        N_B <<= 1
        cm |= cm >> B
        _haar1(X, N_B, B)
    for k in range(recombine):
        cm = BIT_DEINTERLEAVE_TABLE[cm]
        _haar1(X, N0 >> k, 1 << k)
    B <<= recombine

    if lowband_out is not None:
        n = math.sqrt(N0)
        for j in range(N0):
            lowband_out[j] = n * X[j]
    cm &= (1 << B) - 1
    return cm


def quant_band_stereo(
    ctx: BandCtx, X, Y, N, b, B, lowband, LM, lowband_out,
    lowband_scratch, fill,
):
    if N == 1:
        return quant_band_n1(ctx, X, Y, b, lowband_out)
    orig_fill = fill
    sctx, b, fill = compute_theta(ctx, X, Y, N, b, B, B, LM, 1, fill)
    inv = sctx.inv
    imid, iside = sctx.imid, sctx.iside
    delta, itheta, qalloc = sctx.delta, sctx.itheta, sctx.qalloc
    mid = imid / 32768.0
    side = iside / 32768.0

    if N == 2:
        mbits = b
        sbits = 0
        if itheta != 0 and itheta != 16384:
            sbits = 1 << BITRES
        mbits -= sbits
        c = 1 if itheta > 8192 else 0
        ctx.remaining_bits -= qalloc + sbits
        x2 = Y if c else X
        y2 = X if c else Y
        sign = 0
        if sbits:
            sign = 1 if (x2[0] * y2[1] - x2[1] * y2[0]) < 0 else 0
            ctx.enc.enc_bits(sign, 1)
        sign = 1 - 2 * sign
        cm = quant_band(
            ctx, x2, N, mbits, B, lowband, LM, lowband_out, 1.0,
            lowband_scratch, orig_fill,
        )
        y2[0] = -sign * x2[1]
        y2[1] = sign * x2[0]
        X[0] *= mid
        X[1] *= mid
        Y[0] *= side
        Y[1] *= side
        tmp = X[0]
        X[0] = tmp - Y[0]
        Y[0] = tmp + Y[0]
        tmp = X[1]
        X[1] = tmp - Y[1]
        Y[1] = tmp + Y[1]
    else:
        mbits = max(0, min(b, cdiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_band(
                ctx, X, N, mbits, B, lowband, LM, lowband_out, 1.0,
                lowband_scratch, fill,
            )
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_band(
                ctx, Y, N, sbits, B, None, LM, None, side, None, fill >> B
            )
        else:
            cm = quant_band(
                ctx, Y, N, sbits, B, None, LM, None, side, None, fill >> B
            )
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_band(
                ctx, X, N, mbits, B, lowband, LM, lowband_out, 1.0,
                lowband_scratch, fill,
            )

    if N != 2:
        _stereo_merge(X, Y, mid, N)
    if inv:
        Y[:N] = -Y[:N]
    return cm


def _stereo_merge(X, Y, mid, N):
    xp = float(np.dot(Y[:N], X[:N]))
    side = float(np.dot(Y[:N], Y[:N]))
    xp *= mid
    mid2 = mid
    El = mid2 * mid2 + side - 2 * xp
    Er = mid2 * mid2 + side + 2 * xp
    if Er < 6e-4 or El < 6e-4:
        Y[:N] = X[:N]
        return
    lgain = 1.0 / math.sqrt(El)
    rgain = 1.0 / math.sqrt(Er)
    for j in range(N):
        l = mid * X[j]
        r = Y[j]
        X[j] = lgain * (l - r)
        Y[j] = rgain * (l + r)


def quant_all_bands(
    mode, start, end, X_, Y_, collapse_masks, pulses, shortBlocks, spread,
    dual_stereo, intensity, tf_res, total_bits, balance, enc, LM,
    codedBands, seed, bandE,
):
    """bands.c quant_all_bands in the encode direction: each band's shape
    is quantized, coded into ``enc`` and resynthesized in place. Returns
    the folding seed."""
    eBands = mode.eBands
    M = 1 << LM
    B = M if shortBlocks else 1
    C = 2 if Y_ is not None else 1
    norm_offset = M * int(eBands[start])
    norm_len = M * int(eBands[mode.nbEBands - 1]) - norm_offset
    norm = np.zeros(norm_len, dtype=np.float64)
    norm2 = np.zeros(norm_len, dtype=np.float64) if C == 2 else norm
    scratch = np.zeros(M * int(eBands[mode.nbEBands]), dtype=np.float64)

    lowband_offset = 0
    update_lowband = True
    ctx = BandCtx(mode=mode, intensity=intensity, spread=spread, enc=enc,
                  seed=seed, bandE=bandE)

    for i in range(start, end):
        ctx.i = i
        last = i == end - 1
        X = X_[M * int(eBands[i]):]
        Y = Y_[M * int(eBands[i]):] if Y_ is not None else None
        N = M * int(eBands[i + 1]) - M * int(eBands[i])
        tell = enc.tell_frac()

        if i != start:
            balance -= tell
        remaining_bits = total_bits - tell - 1
        ctx.remaining_bits = remaining_bits
        if i <= codedBands - 1:
            curr_balance = cdiv(balance, min(3, codedBands - i))
            b = max(0, min(16383, min(remaining_bits + 1,
                                      pulses[i] + curr_balance)))
        else:
            b = 0

        if (M * int(eBands[i]) - N >= M * int(eBands[start])
                and (update_lowband or lowband_offset == 0)):
            lowband_offset = i

        tf_change = tf_res[i]
        ctx.tf_change = tf_change
        lowband_scratch = scratch
        if i == end - 1:
            lowband_scratch = None

        effective_lowband = -1
        if lowband_offset != 0 and (
            spread != SPREAD_AGGRESSIVE or B > 1 or tf_change < 0
        ):
            effective_lowband = max(
                0, M * int(eBands[lowband_offset]) - norm_offset - N
            )
            fold_start = lowband_offset
            while M * int(eBands[fold_start - 1]) > (
                effective_lowband + norm_offset
            ):
                fold_start -= 1
            fold_start -= 1
            fold_end = lowband_offset - 1
            while True:
                fold_end += 1
                if M * int(eBands[fold_end]) >= (
                    effective_lowband + norm_offset + N
                ):
                    break
            x_cm = y_cm = 0
            for fold_i in range(fold_start, fold_end):
                x_cm |= collapse_masks[fold_i * C + 0]
                y_cm |= collapse_masks[fold_i * C + C - 1]
        else:
            x_cm = y_cm = (1 << B) - 1

        if dual_stereo and i == intensity:
            dual_stereo = 0
            for j in range(M * int(eBands[i]) - norm_offset):
                norm[j] = 0.5 * (norm[j] + norm2[j])

        if dual_stereo:
            x_cm = quant_band(
                ctx, X, N, b // 2, B,
                norm[effective_lowband:] if effective_lowband != -1 else None,
                LM,
                None if last else norm[M * int(eBands[i]) - norm_offset:],
                1.0, lowband_scratch, x_cm,
            )
            y_cm = quant_band(
                ctx, Y, N, b // 2, B,
                norm2[effective_lowband:] if effective_lowband != -1 else None,
                LM,
                None if last else norm2[M * int(eBands[i]) - norm_offset:],
                1.0, lowband_scratch, y_cm,
            )
        else:
            if Y is not None:
                x_cm = quant_band_stereo(
                    ctx, X, Y, N, b, B,
                    norm[effective_lowband:]
                    if effective_lowband != -1 else None,
                    LM,
                    None if last else norm[M * int(eBands[i]) - norm_offset:],
                    lowband_scratch, x_cm | y_cm,
                )
            else:
                x_cm = quant_band(
                    ctx, X, N, b, B,
                    norm[effective_lowband:]
                    if effective_lowband != -1 else None,
                    LM,
                    None if last else norm[M * int(eBands[i]) - norm_offset:],
                    1.0, lowband_scratch, x_cm | y_cm,
                )
            y_cm = x_cm
        collapse_masks[i * C + 0] = x_cm & 0xFF
        collapse_masks[i * C + C - 1] = y_cm & 0xFF
        balance += pulses[i] + tell
        update_lowband = b > (N << BITRES)

    return ctx.seed


def comb_filter(y, x, off, T0, T1, N, g0, g1, tapset0, tapset1, window,
                overlap):
    """In-place pitch postfilter (reference: celt/celt.c:114-172).

    x/y are the same decode-history array; `off` is the start index of the
    N-sample region being filtered (reads reach back off - T - 2).
    Vectorized in chunks of min(T0, T1) - 2 samples: the lag keeps every
    read strictly before the chunk, so chunks are data-parallel.
    """
    if g0 == 0.0 and g1 == 0.0:
        return
    g00 = g0 * COMB_GAINS[tapset0][0]
    g01 = g0 * COMB_GAINS[tapset0][1]
    g02 = g0 * COMB_GAINS[tapset0][2]
    g10 = g1 * COMB_GAINS[tapset1][0]
    g11 = g1 * COMB_GAINS[tapset1][1]
    g12 = g1 * COMB_GAINS[tapset1][2]

    w2 = window * window
    i = 0
    if not (g0 == g1 and T0 == T1 and tapset0 == tapset1):
        ov = min(overlap, N)
        step = max(1, min(T0, T1) - 2)
        while i < ov:
            n = min(step, ov - i)
            j = off + i
            f = w2[i : i + n]
            a0 = x[j - T0 : j - T0 + n]
            a1 = x[j - T0 + 1 : j - T0 + 1 + n] + x[j - T0 - 1 : j - T0 - 1 + n]
            a2 = x[j - T0 + 2 : j - T0 + 2 + n] + x[j - T0 - 2 : j - T0 - 2 + n]
            b0 = x[j - T1 : j - T1 + n]
            b1 = x[j - T1 + 1 : j - T1 + 1 + n] + x[j - T1 - 1 : j - T1 - 1 + n]
            b2 = x[j - T1 + 2 : j - T1 + 2 + n] + x[j - T1 - 2 : j - T1 - 2 + n]
            y[j : j + n] = (
                x[j : j + n]
                + (1 - f) * (g00 * a0 + g01 * a1 + g02 * a2)
                + f * (g10 * b0 + g11 * b1 + g12 * b2)
            )
            i += n
        if g1 == 0.0:
            return
    # Constant-parameter tail (comb_filter_const)
    step = max(1, T1 - 2)
    while i < N:
        n = min(step, N - i)
        j = off + i
        b0 = x[j - T1 : j - T1 + n]
        b1 = x[j - T1 + 1 : j - T1 + 1 + n] + x[j - T1 - 1 : j - T1 - 1 + n]
        b2 = x[j - T1 + 2 : j - T1 + 2 + n] + x[j - T1 - 2 : j - T1 - 2 + n]
        y[j : j + n] = x[j : j + n] + g10 * b0 + g11 * b1 + g12 * b2
        i += n
