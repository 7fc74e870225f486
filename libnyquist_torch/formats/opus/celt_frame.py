"""CELT host half, one frame at a time: entropy decode to spectra.

The general Opus path (SILK, hybrid, mode transitions, redundancy
frames) decodes CELT frame by frame: a hybrid frame shares one range
decoder between its SILK half and its CELT half, which starts at band 17.
``celt_decode_frame_to_freq`` mirrors celt_decode_with_ec up to the
synthesis (reference: celt_decoder_clean.c:353-724): the energy, tf,
allocation and band stages run in C (``native/celt_bands.c``, the same
entries the whole-stream decode is built from), each taking the Python
range decoder's ten-word state and handing it back (``ec_pack`` /
``ec_unpack``). The output is one frame's denormalised spectra and
postfilter parameters; the synthesis runs on the card
(``runtime/opus_pipeline.py`` ``CeltLane``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from ...errors import DecodeError
from ...runtime import native
from .celt_host import CeltDecoderState, _mode_ptrs
from .celt_tables import mode48000
from .range_coder import BITRES, RangeDecoder

EPSILON = 1e-15
SPREAD_NORMAL = 2
TAPSET_ICDF = [2, 1, 0]
SPREAD_ICDF = [25, 23, 2, 0]

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


def ec_pack(dec: RangeDecoder) -> np.ndarray:
    """The range decoder's state as the native calls' ten int64s."""
    return np.array(
        [dec.offs, dec.end_offs, dec.end_window, dec.nend_bits,
         dec.nbits_total, dec.rng, dec.rem, dec.val, dec.ext, dec.error],
        np.int64,
    )


def ec_unpack(dec: RangeDecoder, ec: np.ndarray) -> None:
    (dec.offs, dec.end_offs, dec.end_window, dec.nend_bits,
     dec.nbits_total, dec.rng, dec.rem, dec.val, dec.ext,
     dec.error) = ec.tolist()


def celt_lcg_rand(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


_CAPS = {}
_PROB = {}


def _caps(mode, LM, C) -> np.ndarray:
    """Per-band allocation caps (reference: celt.c init_caps)."""
    cap = _CAPS.get((LM, C))
    if cap is None:
        nb = mode.nbEBands
        n = (np.diff(mode.eBands[: nb + 1]).astype(np.int64)) << LM
        cc = mode.cache_caps[nb * (2 * LM + C - 1):][:nb].astype(np.int64)
        cap = np.ascontiguousarray((cc + 64) * C * n >> 2, np.int32)
        _CAPS[(LM, C)] = cap
    return cap


def _prob_model(mode, LM, intra) -> np.ndarray:
    p = _PROB.get((LM, intra))
    if p is None:
        p = np.ascontiguousarray(mode.e_prob_model[LM][intra], np.int32)
        _PROB[(LM, intra)] = p
    return p


def anti_collapse(mode, X_, collapse_masks, LM, C, size, start, end, logE,
                  prev1logE, prev2logE, pulses, seed):
    """Fill collapsed short blocks with signed noise and renormalise
    (reference: bands.c:258-351)."""
    for i in range(start, end):
        N0 = int(mode.eBands[i + 1] - mode.eBands[i])
        depth = (1 + pulses[i]) // (N0 << LM)
        thresh = 0.5 * math.pow(2.0, -0.125 * depth)
        sqrt_1 = 1.0 / math.sqrt(N0 << LM)
        for c in range(C):
            prev1 = prev1logE[c * mode.nbEBands + i]
            prev2 = prev2logE[c * mode.nbEBands + i]
            if C == 1:
                prev1 = max(prev1, prev1logE[mode.nbEBands + i])
                prev2 = max(prev2, prev2logE[mode.nbEBands + i])
            Ediff = max(0.0, logE[c * mode.nbEBands + i] - min(prev1, prev2))
            r = 2.0 * math.pow(2.0, -Ediff)
            if LM == 3:
                r *= 1.41421356
            r = min(thresh, r) * sqrt_1
            X = X_[c * size + (int(mode.eBands[i]) << LM):]
            renormalize = False
            for k in range(1 << LM):
                if not (collapse_masks[i * C + c] & (1 << k)):
                    for j in range(N0):
                        seed = celt_lcg_rand(seed)
                        X[(j << LM) + k] = r if (seed & 0x8000) else -r
                    renormalize = True
            if renormalize:
                n = N0 << LM
                X[:n] *= 1.0 / math.sqrt(EPSILON + float(np.sum(X[:n] ** 2)))
    return seed


def denormalise_bands(mode, X, freq, bandLogE_row, start, end, M):
    """One channel: X [N] unit bands -> freq [N] scaled spectra
    (reference: bands.c:192-256)."""
    N = M * mode.shortMdctSize
    eb = np.asarray(mode.eBands[start: end + 1], np.int64) * M
    lg = (np.asarray(bandLogE_row[start:end], np.float64)
          + np.asarray(mode.eMeans[start:end], np.float64))
    g = np.exp(0.6931471805599453094 * lg)
    freq[: eb[0]] = 0.0
    freq[eb[0]: eb[-1]] = X[eb[0]: eb[-1]] * np.repeat(g, np.diff(eb))
    freq[eb[-1]: N] = 0.0


def frame_lm(frame_size: int) -> int:
    """LM of a CELT frame size (120 << LM); DecodeError for any other."""
    mode = mode48000()
    for lm in range(mode.maxLM + 1):
        if mode.shortMdctSize << lm == frame_size:
            return lm
    raise DecodeError(f"bad CELT frame size {frame_size}")


def celt_decode_frame_to_freq(st: CeltDecoderState, data: bytes,
                              frame_size: int, dec: RangeDecoder = None):
    """Entropy-decode one frame to denormalised spectra + synthesis params.

    ``dec`` is the caller's range decoder when the frame shares one with
    a SILK half (hybrid). Updates the energy memories and the seed of
    ``st`` in place. Returns the frame's info dict (the synthesis input:
    ``freq`` [max(CC, C), N] float64, N, LM, C, CC, shortBlocks, the
    three postfilter parameters and ``silence``).
    """
    mode = mode48000()
    nb = mode.nbEBands
    eBands = mode.eBands
    CC = st.channels
    C = st.stream_channels
    LM = frame_lm(frame_size)
    M = 1 << LM
    N = M * mode.shortMdctSize
    if dec is None:
        dec = RangeDecoder(data)
    length = len(data)
    L = native.lib()
    mp = _mode_ptrs(mode)
    buf, storage = dec.buf, dec.storage

    effEnd = min(st.end, mode.effEBands)
    oldBandE = st.oldEBands
    if C == 1:
        oldBandE[0, :] = np.maximum(oldBandE[0, :], oldBandE[1, :])

    total_bits = length * 8
    tell = dec.tell()
    if tell >= total_bits:
        silence = 1
    elif tell == 1:
        silence = dec.dec_bit_logp(15)
    else:
        silence = 0
    if silence:
        tell = length * 8
        dec.nbits_total += tell - dec.tell()

    postfilter_gain = 0.0
    postfilter_pitch = 0
    postfilter_tapset = 0
    if st.start == 0 and tell + 16 <= total_bits:
        if dec.dec_bit_logp(1):
            octave = dec.dec_uint(6)
            postfilter_pitch = (16 << octave) + dec.dec_bits(4 + octave) - 1
            qg = dec.dec_bits(3)
            if dec.tell() + 2 <= total_bits:
                postfilter_tapset = dec.dec_icdf(TAPSET_ICDF, 2)
            postfilter_gain = 0.09375 * (qg + 1)
        tell = dec.tell()

    if LM > 0 and tell + 3 <= total_bits:
        isTransient = dec.dec_bit_logp(3)
        tell = dec.tell()
    else:
        isTransient = 0
    shortBlocks = M if isTransient else 0

    intra = dec.dec_bit_logp(3) if tell + 3 <= total_bits else 0
    ec = ec_pack(dec)
    ecp = ec.ctypes.data_as(_I64P)
    eb = np.ascontiguousarray(oldBandE, np.float64)
    L.celt_coarse_energy(
        buf, storage, ecp, _prob_model(mode, LM, 1 if intra else 0)
        .ctypes.data_as(_I32P), st.start, st.end,
        eb.ctypes.data_as(_F64P), nb, int(bool(intra)), int(C), int(LM))
    tf = np.zeros(nb, np.int32)
    L.celt_tf_decode(buf, storage, ecp, st.start, st.end, int(isTransient),
                     tf.ctypes.data_as(_I32P), int(LM))
    ec_unpack(dec, ec)

    tell = dec.tell()
    spread_decision = SPREAD_NORMAL
    if tell + 4 <= total_bits:
        spread_decision = dec.dec_icdf(SPREAD_ICDF, 5)

    cap = _caps(mode, LM, C)
    offsets = np.zeros(nb, np.int32)
    trim = np.zeros(1, np.int32)
    ec = ec_pack(dec)
    ecp = ec.ctypes.data_as(_I64P)
    L.celt_dynalloc(
        buf, storage, ecp, mp["eb_p"], st.start, st.end, int(C), int(LM),
        cap.ctypes.data_as(_I32P), int(total_bits << BITRES),
        offsets.ctypes.data_as(_I32P), trim.ctypes.data_as(_I32P))
    ec_unpack(dec, ec)

    bits = (length * 8 << BITRES) - dec.tell_frac() - 1
    anti_collapse_rsv = (
        (1 << BITRES)
        if (isTransient and LM >= 2 and bits >= ((LM + 2) << BITRES))
        else 0
    )
    bits -= anti_collapse_rsv

    pulses = np.zeros(nb, np.int32)
    fine_quant = np.zeros(nb, np.int32)
    fine_priority = np.zeros(nb, np.int32)
    res = np.zeros(4, np.int32)
    ec = ec_pack(dec)
    ecp = ec.ctypes.data_as(_I64P)
    L.celt_compute_allocation(
        buf, storage, ecp, mp["eb_p"], nb, mp["ln_p"], mp["av"],
        int(mode.nbAllocVectors), cap.ctypes.data_as(_I32P),
        offsets.ctypes.data_as(_I32P), st.start, st.end, int(trim[0]),
        int(bits), int(C), int(LM), pulses.ctypes.data_as(_I32P),
        fine_quant.ctypes.data_as(_I32P),
        fine_priority.ctypes.data_as(_I32P), res.ctypes.data_as(_I32P))
    codedBands, intensity, dual_stereo, balance = (int(v) for v in res)

    L.celt_fine_energy(buf, storage, ecp, fine_quant.ctypes.data_as(_I32P),
                       eb.ctypes.data_as(_F64P), nb, st.start, st.end, int(C))

    N_full = M * int(eBands[nb])          # the band loop's channel stride
    Xb = np.zeros(C * N_full, np.float64)
    masks = np.zeros(C * nb, np.uint8)
    st.rng = int(L.celt_bands_decode(
        buf, storage, ecp, mp["eb_p"], nb, mp["ln_p"], mp["ci_p"], mp["cb"],
        st.start, st.end, int(shortBlocks), int(spread_decision),
        int(dual_stereo), int(intensity), tf.ctypes.data_as(_I32P),
        int(length * (8 << BITRES) - anti_collapse_rsv), int(balance),
        pulses.ctypes.data_as(_I32P), int(LM), int(codedBands),
        int(st.rng) & 0xFFFFFFFF, int(C), Xb.ctypes.data_as(_F64P),
        masks.ctypes.data_as(ctypes.c_char_p))) & 0xFFFFFFFF
    ec_unpack(dec, ec)
    X = np.zeros(C * N, np.float64)         # channel stride N from here
    for c in range(C):
        X[c * N: c * N + N_full] = Xb[c * N_full: (c + 1) * N_full]

    anti_collapse_on = dec.dec_bits(1) if anti_collapse_rsv > 0 else 0

    ec = ec_pack(dec)
    L.celt_energy_finalise(
        buf, storage, ec.ctypes.data_as(_I64P),
        fine_quant.ctypes.data_as(_I32P),
        fine_priority.ctypes.data_as(_I32P), int(length * 8 - dec.tell()),
        eb.ctypes.data_as(_F64P), nb, st.start, st.end, int(C))
    ec_unpack(dec, ec)
    oldBandE[:, :] = eb

    if anti_collapse_on:
        st.rng = anti_collapse(
            mode, X, masks, LM, C, N, st.start, st.end,
            oldBandE.reshape(-1), st.oldLogE, st.oldLogE2, pulses, st.rng)

    freq = np.zeros((max(CC, C), N), np.float64)
    if silence:
        oldBandE[:, :] = -28.0
    else:
        for c in range(C):
            denormalise_bands(mode, X[c * N:(c + 1) * N], freq[c],
                              oldBandE[c], st.start, effEnd, M)
    bound = M * int(eBands[effEnd])
    if st.downsample != 1:
        bound = min(bound, N // st.downsample)
    freq[:C, bound:] = 0.0
    if CC == 2 and C == 1:
        freq[1, :] = freq[0, :]
    if CC == 1 and C == 2:
        freq[0, :] = 0.5 * (freq[0, :] + freq[1, :])

    # Energy-memory rollover (reference: celt_decoder_clean.c:685-720)
    if C == 1:
        oldBandE[1, :] = oldBandE[0, :]
    flatE = oldBandE.reshape(-1)
    if not isTransient:
        st.oldLogE2[:] = st.oldLogE
        st.oldLogE[:] = flatE
        st.backgroundLogE[:] = np.minimum(st.backgroundLogE + M * 0.001,
                                          flatE)
    else:
        st.oldLogE[:] = np.minimum(st.oldLogE, flatE)
    for c in range(2):
        oldBandE[c, : st.start] = 0.0
        oldBandE[c, st.end:] = 0.0
        st.oldLogE[c * nb: c * nb + st.start] = -28.0
        st.oldLogE2[c * nb: c * nb + st.start] = -28.0
        st.oldLogE[c * nb + st.end: (c + 1) * nb] = -28.0
        st.oldLogE2[c * nb + st.end: (c + 1) * nb] = -28.0
    st.rng = dec.rng

    return {
        "freq": freq,
        "N": N,
        "LM": LM,
        "C": C,
        "CC": CC,
        "shortBlocks": shortBlocks,
        "postfilter_pitch": postfilter_pitch,
        "postfilter_gain": postfilter_gain,
        "postfilter_tapset": postfilter_tapset,
        "silence": silence,
    }
