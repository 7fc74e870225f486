"""SILK encoder: speech -> SILK-only Opus packets (host side).

An encoder built against the SILK decoder's spec (RFC 6716 §4.2; the
reference encoder is silk/enc_API.c and its float pipeline): the
bitstream contract is the decoder's symbol sequence (decode_indices,
decode_pulses); the parameter search is original:

  * LPC analysis: Hann-windowed autocorrelation and Levinson-Durbin per
    frame, bandwidth-expanded; A(z) -> NLSF by root-finding on the P/Q
    polynomials (only the dequantized filter must match the decoder,
    and it is rebuilt with the decoder's own nlsf_decode / nlsf2a of
    ``formats/opus/silk.py``).
  * NLSF quantization: exact search over every stage-1 vector with the
    decoder's backward-recursive residual dequantizer, scored by
    Laroia-weighted error.
  * Gains: a closed search over the decoder's gains_dequant recursion.
  * Pitch and LTP: a lag search with contour fitting and LTP codebook
    selection; voiced frames code the decoder's exact LTP synthesis.
  * Excitation: closed-loop predictive quantization against the
    decoder's reconstruction, with its dither/sign LCG chain, offsets,
    level adjust and the per-shell-block pulse budget.
  * Entropy coding: the range encoder of ``range_coder.py`` over the
    iCDF tables the decoder reads.

Mono and stereo (mid/side with the decoder's exact predictor), nb/mb/wb,
10/20/40/60 ms packets, DTX and in-band FEC (LBRR). Serial host NumPy and
Python integers; the front end's resample to the internal rate runs on
the device (``ops/src.py``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import silk as S
from . import silk_tables as ST
from .range_coder import RangeEncoder

SUBFR = 4
LTP_ORDER = 5

# Decoder-side latency of the SILK path in 48 kHz samples: the
# bit-exact libopus-mirror decoder resampler (silk/resampler.c 1 ms
# delay buffering + IIR/FIR group delay) plus a small codec lag,
# measured end-to-end per internal rate (best-lag scan on speech-like
# content).  The standalone Ogg writers absorb it in the
# OpusHead preskip field exactly as opusenc does with the encoder's
# OPUS_GET_LOOKAHEAD (reference: libopus/src/opus_encoder.c
# delay_compensation); the mixed-mode auto encoder instead advances
# each SILK/hybrid segment's input window (analysis.py) so segments
# stay aligned with zero-latency CELT segments under one global
# preskip.
DELAY_COMP_48K = {"nb": 33, "mb": 38, "wb": 38}
MAX_LPC_ORDER = 16              # sLPC carry width (decoder.h MAX_LPC_ORDER)
TYPE_UNVOICED = 1
TYPE_VOICED = 2


def resample_on(x: np.ndarray, sr_in: int, sr_out: int, device) -> np.ndarray:
    """One channel of host float32 samples through the polyphase
    resampler on ``device``, back on the host as float64."""
    from ...ops.src import resample

    y = resample(torch.from_numpy(np.ascontiguousarray(x)), sr_in, sr_out,
                 device=device)
    return y.cpu().numpy().astype(np.float64)


class _Bw:
    """Per-bandwidth + frame-duration constants (decoder side:
    silk.py set_fs)."""

    def __init__(self, fs_khz: int, toc_config: int, nb_subfr: int = 4):
        self.fs_khz = fs_khz
        self.toc = toc_config            # RFC 6716 TOC config
        self.nb_subfr = nb_subfr         # 4 = 20 ms, 2 = 10 ms
        self.subfr_len = 5 * fs_khz      # SUB_FRAME_LENGTH_MS
        self.frame_len = nb_subfr * self.subfr_len
        self.ltp_mem = 20 * fs_khz       # LTP_MEM_LENGTH_MS
        self.min_lag = 2 * fs_khz        # PITCH_EST_MIN_LAG_MS
        self.max_lag = 18 * fs_khz       # PITCH_EST_MAX_LAG_MS
        self.lag_scale = fs_khz >> 1     # lagIndex = hi*scale + lo
        self.lpc_order = 16 if fs_khz == 16 else 10
        self.lag_low_key = {16: "uniform8_iCDF", 12: "uniform6_iCDF",
                            8: "uniform4_iCDF"}[fs_khz]
        if nb_subfr == 4:
            self.contour_key = ("pitch_contour_NB_iCDF" if fs_khz == 8
                                else "pitch_contour_iCDF")
        else:
            self.contour_key = ("pitch_contour_10ms_NB_iCDF"
                                if fs_khz == 8
                                else "pitch_contour_10ms_iCDF")

    @property
    def nlsf_cb(self):
        return (ST.nlsf_cb_wb() if self.fs_khz == 16
                else ST.nlsf_cb_nb_mb())

    @property
    def contour_cb(self):
        t = ST.tables()
        if self.nb_subfr == 4:
            return (np.asarray(t["CB_lags_stage2"]).reshape(4, 11)
                    if self.fs_khz == 8
                    else np.asarray(t["CB_lags_stage3"]).reshape(4, 34))
        return (np.asarray(t["CB_lags_stage2_10ms"]).reshape(2, 3)
                if self.fs_khz == 8
                else np.asarray(t["CB_lags_stage3_10ms"]).reshape(2, 12))


BANDWIDTHS = {"nb": _Bw(8, 1), "mb": _Bw(12, 5), "wb": _Bw(16, 9)}
BANDWIDTHS_10MS = {"nb": _Bw(8, 0, 2), "mb": _Bw(12, 4, 2),
                   "wb": _Bw(16, 8, 2)}


# ----------------------------------------------------------------------
# LPC analysis
# ----------------------------------------------------------------------

def _levinson(r):
    """Levinson-Durbin: autocorrelation -> predictor coeffs p with
    x[n] ~= sum_j p[j] x[n-1-j].

    Guards are RELATIVE to r[0]: with near-singular autocorrelations
    (pure tones) the prediction error e underflows in r[0]-scale units
    long before any absolute epsilon, and clipped reflection
    coefficients then compound into garbage predictors (the round-3
    bug that capped SILK quality).  When a reflection saturates the
    recursion stops at the current order instead."""
    d = len(r) - 1
    a = np.zeros(d)
    e = float(r[0])
    floor = float(r[0]) * 1e-9 + 1e-12
    for i in range(d):
        acc = r[i + 1] - np.dot(a[:i], r[i:0:-1][:i])
        if e <= floor:
            break
        k = float(acc / e)
        if abs(k) >= 0.999:
            break
        a[:i], a[i] = a[:i] - k * a[:i][::-1], k
        e *= (1.0 - k * k)
    return a


def _a2nlsf_q15(a):
    """Predictor -> line spectral frequencies (Q15 of w/pi).

    P(z) = A(z) + z^-(d+1) A(1/z), Q(z) = A(z) - z^-(d+1) A(1/z) with
    A(z) = 1 - sum p_j z^-j; their roots interleave on the unit circle
    (reference: silk/A2NLSF.c — implemented here with numpy roots)."""
    d = len(a)
    A = np.concatenate([[1.0], -a])             # A(z) coeffs, z^0..z^-d
    P = np.concatenate([A, [0.0]]) + np.concatenate([[0.0], A[::-1]])
    Q = np.concatenate([A, [0.0]]) - np.concatenate([[0.0], A[::-1]])
    ws = []
    for poly in (P, Q):
        r = np.roots(poly)
        ang = np.angle(r[np.abs(np.abs(r) - 1.0) < 0.1])
        ang = ang[(ang > 1e-4) & (ang < np.pi - 1e-4)]
        ws.append(np.sort(np.unique(np.round(ang, 9))))
    lsf = np.sort(np.concatenate(ws))[:d]
    if len(lsf) < d:        # degenerate frame: spread evenly
        lsf = (np.arange(1, d + 1) / (d + 1)) * np.pi
    q15 = np.clip((lsf / np.pi) * 32768.0, 1, 32766).astype(np.int64)
    return q15.tolist()


# ----------------------------------------------------------------------
# Quantizer searches (exact inverses of the decoder recursions)
# ----------------------------------------------------------------------

def _gain_table_q16():
    t = []
    for pi in range(ST.N_LEVELS_QGAIN):
        t.append(S.silk_log2lin(
            min(S.smulwb(ST.GAIN_INV_SCALE_Q16, pi) + ST.GAIN_OFFSET,
                3967)))
    return np.asarray(t, np.int64)


_GAINS_Q16 = None


def _quant_gains(targets_q16, prev_ind, conditional, nb_subfr=SUBFR):
    """Choose GainsIndices so the decoder's gains_dequant lands nearest
    each per-subframe target gain (log-domain distance)."""
    global _GAINS_Q16
    if _GAINS_Q16 is None:
        _GAINS_Q16 = _gain_table_q16()
    tbl = _GAINS_Q16
    inds = []
    pi = prev_ind
    lt = np.log2(np.maximum(tbl, 1))
    n_delta = len(ST.tables()["delta_gain_iCDF"]) - 1
    for k, tgt in enumerate(targets_q16):
        want = float(np.log2(max(tgt, 1)))
        if k == 0 and not conditional:
            d = int(np.argmin(np.abs(lt - want)))
            ind = d
            pi = max(ind, pi - 16)
        else:
            best, ind = None, 0
            for cand in range(n_delta + 1):
                ind_tmp = cand + ST.MIN_DELTA_GAIN_QUANT
                dsst = (2 * ST.MAX_DELTA_GAIN_QUANT
                        - ST.N_LEVELS_QGAIN + pi)
                npi = pi + ((ind_tmp << 1) - dsst
                            if ind_tmp > dsst else ind_tmp)
                npi = S.limit(npi, 0, ST.N_LEVELS_QGAIN - 1)
                err = abs(float(lt[npi]) - want)
                # bias toward small deltas (cheaper symbols)
                err += 0.01 * abs(cand - 4)
                if best is None or err < best:
                    best, ind, keep = err, cand, npi
            pi = keep
        pi = S.limit(pi, 0, ST.N_LEVELS_QGAIN - 1)
        inds.append(ind)
    gains, last = S.gains_dequant(inds, prev_ind, conditional,
                                  nb_subfr)
    return inds, gains, last


def _quant_nlsf(nlsf_q15, cb, signal_type):
    """Stage-1 + residual NLSF quantization, mirrored on the decoder's
    nlsf_residual_dequant recursion; returns (indices, dequantized
    nlsf)."""
    order = cb.order
    target = np.asarray(nlsf_q15, np.int64)
    w_t = np.asarray(S.nlsf_vq_weights_laroia(target.tolist(), order),
                     np.float64)
    step_q16 = cb.quantStepSize_Q16
    best = None
    cb1_nlsf = np.asarray(cb.CB1_NLSF_Q8, np.int64)
    # rank stage-1 candidates by weighted base distance, search top 8
    base_all = cb1_nlsf.astype(np.int64) << 7
    d = ((base_all - target[None, :]) ** 2 * w_t[None, :]).sum(axis=1)
    for cb1 in np.argsort(d)[:8]:
        cb1 = int(cb1)
        base = base_all[cb1]
        ec_ix, pred_q8 = S.nlsf_unpack(cb, cb1)
        w = S.nlsf_vq_weights_laroia(base.tolist(), order)
        wq9 = [S.sqrt_approx(w[i] << (18 - ST.NLSF_W_Q))
               for i in range(order)]
        res_des = [
            int(round((int(target[i] - base[i]) * wq9[i]) / (1 << 14)))
            for i in range(order)
        ]
        idxs = [0] * order
        out_next = 0
        for i in range(order - 1, -1, -1):
            pred_q10 = (out_next * S.i16(pred_q8[i])) >> 8
            lvl = ((res_des[i] - pred_q10) << 16) // max(step_q16, 1)
            cand0 = int(round(lvl / 1024.0))
            cbest, obest, ebest = 0, pred_q10, abs(res_des[i] - pred_q10)
            for c in {cand0 - 1, cand0, cand0 + 1, 0}:
                c = S.limit(c, -ST.NLSF_QUANT_MAX_AMPLITUDE - 4,
                            ST.NLSF_QUANT_MAX_AMPLITUDE + 4)
                o = c << 10
                if o > 0:
                    o = S.i16(o - ST.NLSF_QUANT_LEVEL_ADJ_Q10)
                elif o < 0:
                    o = S.i16(o + ST.NLSF_QUANT_LEVEL_ADJ_Q10)
                o = S.smlawb(pred_q10, o, step_q16)
                e = abs(res_des[i] - o)
                if e < ebest:
                    cbest, obest, ebest = c, o, e
            idxs[i] = cbest
            out_next = obest
        indices = [cb1] + idxs
        deq = S.nlsf_decode(indices, cb)
        err = float((((np.asarray(deq) - target) ** 2) * w_t).sum())
        if best is None or err < best[0]:
            best = (err, indices, deq)
    return best[1], best[2]


# ----------------------------------------------------------------------
# Entropy coding (mirror of silk.py decode_indices / decode_pulses)
# ----------------------------------------------------------------------

def _enc_split(enc, c1, p, table, offsets):
    if p > 0:
        enc.enc_icdf(c1, table[int(offsets[p]):], 8)


def _shell_encoder(enc, q):
    t0, t1, t2, t3, offs = S._shell_tables()

    def s(lo, n):
        return int(np.sum(np.abs(q[lo:lo + n])))

    _enc_split(enc, s(0, 8), s(0, 16), t3, offs)
    _enc_split(enc, s(0, 4), s(0, 8), t2, offs)
    _enc_split(enc, s(0, 2), s(0, 4), t1, offs)
    _enc_split(enc, s(0, 1), s(0, 2), t0, offs)
    _enc_split(enc, s(2, 1), s(2, 2), t0, offs)
    _enc_split(enc, s(4, 2), s(4, 4), t1, offs)
    _enc_split(enc, s(4, 1), s(4, 2), t0, offs)
    _enc_split(enc, s(6, 1), s(6, 2), t0, offs)
    _enc_split(enc, s(8, 4), s(8, 8), t2, offs)
    _enc_split(enc, s(8, 2), s(8, 4), t1, offs)
    _enc_split(enc, s(8, 1), s(8, 2), t0, offs)
    _enc_split(enc, s(10, 1), s(10, 2), t0, offs)
    _enc_split(enc, s(12, 2), s(12, 4), t1, offs)
    _enc_split(enc, s(12, 1), s(12, 2), t0, offs)
    _enc_split(enc, s(14, 1), s(14, 2), t0, offs)


def _icdf_bits(icdf, sym):
    hi = 256 if sym == 0 else int(icdf[sym - 1])
    lo = int(icdf[sym])
    p = max(hi - lo, 1)
    return -np.log2(p / 256.0)


def _encode_pulses(enc, pulses, signal_type, quant_offset_type):
    t = ST.tables()
    q = np.asarray(pulses, np.int64)
    nblk = len(q) // ST.SHELL_FRAME
    sums = [int(np.abs(q[i * 16:(i + 1) * 16]).sum())
            for i in range(nblk)]
    assert max(sums) <= ST.MAX_PULSES, "pulse budget exceeded"
    # rate level: cheapest total symbol cost (enc_API RATE_LEVEL search)
    costs = []
    for rl in range(ST.N_RATE_LEVELS - 1):
        cdf = t["pulses_per_block_iCDF"][rl]
        costs.append(sum(_icdf_bits(cdf, sp) for sp in sums))
    rl = int(np.argmin(costs))
    enc.enc_icdf(rl, t["rate_levels_iCDF"][signal_type >> 1], 8)
    cdf = t["pulses_per_block_iCDF"][rl]
    for sp in sums:
        enc.enc_icdf(sp, cdf, 8)
    for i in range(nblk):
        if sums[i] > 0:
            _shell_encoder(enc, q[i * 16:(i + 1) * 16])
    # signs
    sign_base = t["sign_iCDF"]
    i0 = 7 * (quant_offset_type + (signal_type << 1))
    for i in range(nblk):
        if sums[i] > 0:
            icdf0 = int(sign_base[i0 + min(sums[i] & 0x1F, 6)])
            icdf = np.asarray([icdf0, 0], np.uint8)
            for j in range(16):
                v = int(q[i * 16 + j])
                if v != 0:
                    enc.enc_icdf(1 if v > 0 else 0, icdf, 8)


# ----------------------------------------------------------------------
# Frame encoder
# ----------------------------------------------------------------------

class SilkEncoderState:
    def __init__(self, bw: _Bw):
        self.bw = bw
        self.last_gain_index = 10
        self.prev_signal_type = 0        # ec_prevSignalType mirror
        self.x_hist = np.zeros(bw.lpc_order)    # input history (int16 dom)
        self.xq_hist = np.zeros(bw.lpc_order)   # reconstruction history
        self.res_hist = np.zeros(bw.ltp_mem)    # input LPC residual hist
        self.out_buf = np.zeros(bw.ltp_mem)     # reconstruction (int16 dom)
        self.slpc = np.zeros(MAX_LPC_ORDER)     # Q14 gain-normalized carry
        self.prev_gain_q16 = 1 << 16
        self.first = True


def _pitch_analysis(res_ext, bw: _Bw):
    """Normalized-autocorrelation pitch estimate on the input LPC
    residual (res_ext = [ltp_mem history | current frame]).  Returns
    (voiced, per-subframe lags) — the encoder-side analysis half the
    decoder never sees (reference idea: silk/float/pitch_analysis_core
    — ours is a plain argmax, not a port)."""
    cur = res_ext[bw.ltp_mem:]
    e1 = float(np.dot(cur, cur))
    if e1 < 1e3:
        return False, None
    best_lag, best_c = 0, 0.0
    for lag in range(bw.min_lag, bw.max_lag + 1):
        past = res_ext[bw.ltp_mem - lag : bw.ltp_mem - lag + bw.frame_len]
        c = float(np.dot(cur, past))
        if c <= 0:
            continue
        e2 = float(np.dot(past, past)) + 1e-9
        score = c * c / e2
        if score > best_c:
            best_c, best_lag = score, lag
    if not best_lag:
        return False, None
    corr = np.sqrt(best_c / e1)
    # loose gate: the LPC whitens most periodicity out of the
    # residual, so frame-level corr is low even for clearly voiced
    # input; the caller's LTP energy-reduction test makes the final
    # voiced/unvoiced call
    if corr < 0.25:
        return False, None
    # per-subframe refinement around the global lag
    lags = []
    for k in range(bw.nb_subfr):
        seg = res_ext[bw.ltp_mem + k * bw.subfr_len : bw.ltp_mem
                      + (k + 1) * bw.subfr_len]
        bl, bc = best_lag, -1.0
        for lag in range(max(bw.min_lag, best_lag - 4),
                         min(bw.max_lag, best_lag + 4) + 1):
            base = bw.ltp_mem + k * bw.subfr_len - lag
            past = res_ext[base : base + bw.subfr_len]
            c = float(np.dot(seg, past))
            e2 = float(np.dot(past, past)) + 1e-9
            s = c * abs(c) / e2
            if s > bc:
                bc, bl = s, lag
        lags.append(bl)
    return True, lags


def _fit_contour(lags, bw: _Bw):
    """(lagIndex, contourIndex, per-subframe coded lags): the 20 ms
    contour codebook entry (CB_lags_stage3, or stage2 for NB) + base
    lag best matching the measured per-subframe lags (decode side:
    silk.decode_pitch)."""
    cbl = bw.contour_cb
    lags = np.asarray(lags, np.float64)
    best = None
    for idx in range(cbl.shape[1]):
        off = cbl[:, idx].astype(np.float64)
        base = int(np.clip(round(float(np.mean(lags - off))),
                           bw.min_lag, bw.max_lag))
        cost = float(np.sum((base + off - lags) ** 2))
        if best is None or cost < best[0]:
            best = (cost, base, idx)
    _, base, idx = best
    # lagIndex is coded hi*scale + lo with hi < 32 (pitch_lag_iCDF)
    lag_index = int(np.clip(base - bw.min_lag, 0, 32 * bw.lag_scale - 1))
    coded = [int(np.clip(bw.min_lag + lag_index + int(cbl[k, idx]),
                         bw.min_lag, bw.max_lag))
             for k in range(bw.nb_subfr)]
    return lag_index, idx, coded


def _select_ltp(res_ext, lags, bw: _Bw):
    """Open-loop LTP codebook search on the input residual: for each
    subframe pick the 5-tap vector (across the three periodicity
    tables) minimizing the residual after prediction from lags
    L-2..L+2.  Returns (per_index, ltp_index[4], b_q14[4][5],
    reduced residual [frame_len])."""
    t = ST.tables()
    tables = [np.asarray(t[f"LTP_vq_Q7_{p}"], np.float64).reshape(-1, 5)
              for p in range(3)]
    red = np.empty(bw.frame_len)
    # PERIndex is shared across subframes: pick the table whose best
    # vectors minimize the total error, then re-pick vectors within it
    totals = []
    for p, tab in enumerate(tables):
        tot = 0.0
        for k in range(bw.nb_subfr):
            s0 = bw.ltp_mem + k * bw.subfr_len
            r = res_ext[s0 : s0 + bw.subfr_len]
            L = lags[k]
            P = np.stack([res_ext[s0 - L + 2 - j : s0 - L + 2 - j
                                  + bw.subfr_len]
                          for j in range(LTP_ORDER)], 1)
            pred = P @ (tab.T / 128.0)
            tot += float(((r[:, None] - pred) ** 2).sum(axis=0).min())
        totals.append(tot)
    per = int(np.argmin(totals))
    tab = tables[per]
    ltp_index = []
    b_q14 = []
    for k in range(bw.nb_subfr):
        s0 = bw.ltp_mem + k * bw.subfr_len
        r = res_ext[s0 : s0 + bw.subfr_len]
        L = lags[k]
        P = np.stack([res_ext[s0 - L + 2 - j : s0 - L + 2 - j
                              + bw.subfr_len] for j in range(LTP_ORDER)], 1)
        pred = P @ (tab.T / 128.0)
        errs = ((r[:, None] - pred) ** 2).sum(axis=0)
        j = int(np.argmin(errs))
        ltp_index.append(j)
        b_q14.append(tab[j] * 128.0)            # vq_Q7 << 7 -> Q14
        red[k * bw.subfr_len : (k + 1) * bw.subfr_len] = r - pred[:, j]
    return per, ltp_index, b_q14, red


def _encode_frame(enc: RangeEncoder, st: SilkEncoderState, x,
                  conditional=False, gain_boost=1.0):
    """One mono frame (int16 domain floats; NB/MB/WB via st.bw).
    conditional=True codes the decoder's CODE_CONDITIONALLY form
    (frames after the first in 40/60 ms packets): delta first gain,
    optional pitch-lag delta, no LTP-scale symbol.

    Voiced frames (pitch detected in the input LPC residual) carry the
    full LTP layer — lag/contour, 5-tap codebook gains, LTP scale —
    and the closed-loop excitation quantizer mirrors the decoder's
    reconstruction (silk.decode_core) in float: whitened pitch history
    (lpc_analysis_filter), inverse-gain/LTP-scale scaling, gain-adjust
    of carried state, the decoder's rounding biases.  Unvoiced frames
    use the same mirror with the LTP term zero."""
    t = ST.tables()
    bw = st.bw
    order = bw.lpc_order
    cb = bw.nlsf_cb

    # ---- LPC analysis on the windowed frame ----
    xw = x * np.hanning(bw.frame_len)
    r = np.correlate(xw, xw, "full")[bw.frame_len - 1:
                                     bw.frame_len + order]
    r = r * (1.0 + 1e-4 * np.arange(order + 1) ** 2)  # lag window
    r[0] *= 1.0 + 1e-3
    r[0] += 1e-2
    a = _levinson(r)
    a *= 0.994 ** (np.arange(order) + 1)        # bandwidth expansion

    # ---- input residual + prediction-gain limiting ----
    # The closed-loop quantizer feeds its error back through 1/A(z);
    # unbounded prediction gain (pure tones: poles at the expansion
    # radius) amplifies the +-half-step quantization noise past int32
    # and the loop wraps.  SILK's own encoder bandwidth-expands until
    # the gain is bounded (silk/float/find_LPC.c limit) — same idea.
    hist = np.concatenate([st.x_hist, x])
    ex = float(np.dot(x, x)) + 1.0
    for _chirp in range(16):
        aq_probe = np.asarray(a)
        e = np.empty(bw.frame_len)
        for n in range(bw.frame_len):
            e[n] = x[n] - np.dot(aq_probe,
                                 hist[n + order - 1::-1][:order])
        if ex / (float(np.dot(e, e)) + 1.0) < 1e3:
            break
        a *= 0.97 ** (np.arange(order) + 1)
    nlsf_tgt = _a2nlsf_q15(a)

    # ---- voicing / pitch / LTP analysis ----
    res_ext = np.concatenate([st.res_hist, e])
    voiced, subf_lags = _pitch_analysis(res_ext, bw)
    if voiced:
        lag_index, contour_index, lags = _fit_contour(subf_lags, bw)
        per_index, ltp_index, b_q14, e_red = _select_ltp(res_ext, lags,
                                                         bw)
        # voiced only when LTP genuinely pays (the corr gate alone
        # passes glides the 5-tap filter can't track)
        if (float(np.dot(e_red, e_red))
                > 0.75 * float(np.dot(e, e)) + 1.0):
            voiced = False
    if voiced:
        signal_type = TYPE_VOICED
    else:
        lags = None
        e_red = e
        signal_type = TYPE_UNVOICED
    quant_offset_type = 0        # low offset first; RD trial below

    # ---- NLSF quantization (needed by the trial loop; coded later) --
    nlsf_idx, nlsf_deq = _quant_nlsf(nlsf_tgt, cb, signal_type)
    aq = np.asarray(S.nlsf2a(list(nlsf_deq), order), np.float64)
    aqf = aq / 4096.0

    # CODE_CONDITIONALLY carries no LTP-scale symbol; the decoder
    # uses index 0 there, the same value we pick independently
    scale_index = 0
    ltp_scale_q14 = (int(t["LTPScales_table_Q14"][scale_index])
                     if voiced else 0)

    # ---- gains with escalation: the closed loop feeds quantization
    # error back through 1/A(z); when the pulse budget can't track the
    # target (tonal content: poles near the unit circle) the loop
    # rings to saturation.  Double the gains until the quantizer fits
    # — the decoder-side cost is coarser excitation, not instability.
    rms0 = [float(np.sqrt(np.mean(
        e_red[k * bw.subfr_len:(k + 1) * bw.subfr_len] ** 2)) + 1.0)
        for k in range(bw.nb_subfr)]
    boost = float(gain_boost)
    for attempt in range(6):
        tg = [int(min(r_ * 1.7 * boost * 65536.0, 2.0 ** 38))
              for r_ in rms0]
        g_inds, gains_q16, lgi = _quant_gains(
            tg, st.last_gain_index, conditional=conditional,
            nb_subfr=bw.nb_subfr)
        pulses, xq, slpc_out, prev_gain_out, miss = _quantize_frame(
            st, x, aq, aqf, gains_q16, signal_type, quant_offset_type,
            voiced, lags, b_q14 if voiced else None, ltp_scale_q14)
        if miss <= bw.frame_len // 32 or attempt == 5:
            break
        boost *= 2.0

    # quantOffsetType: one closed-loop trial of the high offset at the
    # chosen gains — the offset shifts every reconstruction level
    # (Quantization_Offsets_Q10), which suits dense excitation;
    # keep whichever tracks the input better (reference idea:
    # silk/float/noise_shape_analysis find of quantOffsetType)
    err0 = float(np.dot(xq - x, xq - x))
    trial = _quantize_frame(
        st, x, aq, aqf, gains_q16, signal_type, 1,
        voiced, lags, b_q14 if voiced else None, ltp_scale_q14)
    err1 = float(np.dot(trial[1] - x, trial[1] - x))
    if err1 < err0:
        quant_offset_type = 1
        pulses, xq, slpc_out, prev_gain_out, miss = trial
    st.last_gain_index = lgi

    # ---- emission (decoder read order: silk.decode_indices) ----
    ix = (signal_type << 1) + quant_offset_type
    enc.enc_icdf(ix - 2, t["type_offset_VAD_iCDF"], 8)
    if conditional:
        enc.enc_icdf(g_inds[0], t["delta_gain_iCDF"], 8)
    else:
        enc.enc_icdf(g_inds[0] >> 3, t["gain_iCDF"][signal_type], 8)
        enc.enc_icdf(g_inds[0] & 7, t["uniform8_iCDF"], 8)
    for k in range(1, bw.nb_subfr):
        enc.enc_icdf(g_inds[k], t["delta_gain_iCDF"], 8)

    enc.enc_icdf(nlsf_idx[0], cb.CB1_iCDF[signal_type >> 1], 8)
    ec_ix, _pred = S.nlsf_unpack(cb, nlsf_idx[0])
    for i in range(cb.order):
        c = nlsf_idx[i + 1]
        sym = c + ST.NLSF_QUANT_MAX_AMPLITUDE
        tbl = cb.ec_iCDF.reshape(-1)[ec_ix[i]:]
        if c <= -ST.NLSF_QUANT_MAX_AMPLITUDE:
            enc.enc_icdf(0, tbl, 8)
            enc.enc_icdf(-ST.NLSF_QUANT_MAX_AMPLITUDE - c,
                         t["NLSF_EXT_iCDF"], 8)
        elif c >= ST.NLSF_QUANT_MAX_AMPLITUDE:
            enc.enc_icdf(2 * ST.NLSF_QUANT_MAX_AMPLITUDE, tbl, 8)
            enc.enc_icdf(c - ST.NLSF_QUANT_MAX_AMPLITUDE,
                         t["NLSF_EXT_iCDF"], 8)
        else:
            enc.enc_icdf(sym, tbl, 8)
    if bw.nb_subfr == 4:
        # 20 ms frame: NLSF interpolation coef (4 = no interpolation)
        enc.enc_icdf(4, t["NLSF_interp_iCDF"], 8)

    if voiced:
        if conditional and st.prev_signal_type == TYPE_VOICED:
            # delta symbol 0 = "absolute lag follows"
            enc.enc_icdf(0, t["pitch_delta_iCDF"], 8)
        # absolute lag: hi * (fs_khz/2) + low bits
        enc.enc_icdf(lag_index // bw.lag_scale, t["pitch_lag_iCDF"], 8)
        enc.enc_icdf(lag_index % bw.lag_scale, t[bw.lag_low_key], 8)
        enc.enc_icdf(contour_index, t[bw.contour_key], 8)
        enc.enc_icdf(per_index, t["LTP_per_index_iCDF"], 8)
        for k in range(bw.nb_subfr):
            enc.enc_icdf(ltp_index[k],
                         t[f"LTP_gain_iCDF_{per_index}"], 8)
        if not conditional:
            enc.enc_icdf(scale_index, t["LTPscale_iCDF"], 8)

    enc.enc_icdf(0, t["uniform4_iCDF"], 8)      # seed

    _encode_pulses(enc, pulses, signal_type, quant_offset_type)

    st.x_hist = x[-order:].copy()
    st.xq_hist = xq[-order:].copy()
    st.res_hist = np.concatenate([st.res_hist, e])[-bw.ltp_mem:]
    st.out_buf = np.concatenate([st.out_buf, xq])[-bw.ltp_mem:]
    st.slpc = slpc_out
    st.prev_gain_q16 = prev_gain_out
    st.last_xq = xq          # mirror output (tests compare vs decoder)
    st.prev_signal_type = signal_type
    st.first = False


def _quantize_frame(st, x, aq, aqf, gains_q16, signal_type,
                    quant_offset_type, voiced, lags, b_q14,
                    ltp_scale_q14):
    """Closed-loop excitation quantization against a float mirror of
    silk.decode_core (whitened LTP history, inverse-gain scaling,
    gain-adjusted carried state, the decoder's rounding biases).
    Pure trial function: reads st, never mutates it.  Returns
    (pulses, xq, slpc_carry, prev_gain, miss) where miss counts
    samples the pulse grid could not track (escalation signal)."""
    t = ST.tables()
    bw = st.bw
    order = bw.lpc_order
    offset_q10 = int(t["Quantization_Offsets_Q10"][signal_type >> 1][
        quant_offset_type])
    adj16 = ST.QUANT_LEVEL_ADJUST_Q10 << 4
    off16 = offset_q10 << 4
    pulses = np.zeros(bw.frame_len, np.int64)
    xq = np.empty(bw.frame_len)
    rand_seed = 0
    miss = 0

    slpc = np.concatenate([st.slpc, np.zeros(bw.subfr_len)])
    sltp = np.zeros(bw.ltp_mem + bw.frame_len)  # sLTP_Q15 mirror
    buf_idx = bw.ltp_mem
    prev_gain = st.prev_gain_q16
    budget = 0
    n = 0
    lag = 0
    for k in range(bw.nb_subfr):
        gq16 = gains_q16[k]
        gain_q10 = gq16 >> 6
        inv_gain_q31 = (1 << 47) / max(gq16, 1)
        if gq16 != prev_gain:
            gain_adj = prev_gain / gq16
            slpc[:16] *= gain_adj
        else:
            gain_adj = 1.0
        prev_gain = gq16

        if voiced:
            lag = lags[k]
            if k == 0:
                # whiten the reconstruction history with the frame's
                # quantized LPC (decode_core k==0 branch)
                start = bw.ltp_mem - lag - order - LTP_ORDER // 2
                seg = st.out_buf[start:]
                filt = np.zeros(len(seg))
                for i2 in range(order, len(seg)):
                    filt[i2] = np.clip(
                        seg[i2] - np.dot(
                            aqf, seg[i2 - order : i2][::-1]),
                        -32768.0, 32767.0)
                inv = inv_gain_q31 * ltp_scale_q14 / (1 << 16) * 4
                for i2 in range(lag + LTP_ORDER // 2):
                    sltp[buf_idx - i2 - 1] = (
                        inv * filt[len(filt) - i2 - 1] / (1 << 16))
            elif gain_adj != 1.0:
                for i2 in range(lag + LTP_ORDER // 2):
                    sltp[buf_idx - i2 - 1] *= gain_adj

        for i in range(bw.subfr_len):
            if n % ST.SHELL_FRAME == 0:
                budget = ST.MAX_PULSES
            c_ltp = 0.0
            if voiced:
                p_ = buf_idx - lag + LTP_ORDER // 2
                ltp_pred = 2.0
                for j in range(LTP_ORDER):
                    ltp_pred += sltp[p_ - j] * b_q14[k][j] / 65536.0
                c_ltp = 2.0 * ltp_pred
            pos = MAX_LPC_ORDER + i
            lpc_pred = order / 2.0
            for j in range(order):
                lpc_pred += slpc[pos - 1 - j] * aq[j] / 65536.0
            # v = exc + c_ltp + 16*lpc_pred; xq = v*gain_q10/2^24
            v_target = x[n] * (1 << 24) / max(gain_q10, 1)
            vt = v_target - c_ltp - 16.0 * lpc_pred   # desired exc_Q14
            rand_seed = S.silk_rand(rand_seed)
            flip = rand_seed < 0
            want = -vt if flip else vt
            p0 = int(round((want - off16) / 16384.0))
            best_p, best_err, best_v = 0, None, 0.0
            for p in {p0 - 1, p0, p0 + 1, 0}:
                p = int(np.clip(p, -budget, budget))
                vq = p << 14
                if vq > 0:
                    vq -= adj16
                elif vq < 0:
                    vq += adj16
                vq += off16
                if flip:
                    vq = -vq
                err = abs(vq - vt)
                if best_err is None or err < best_err:
                    best_p, best_err, best_v = p, err, vq
            if best_err > 1.5 * 16384.0:
                miss += 1
            pulses[n] = best_p
            budget -= abs(best_p)
            rand_seed = S.i32(rand_seed + best_p)
            res = best_v + c_ltp
            if voiced:
                sltp[buf_idx] = 2.0 * res
                buf_idx += 1
            v = res + 16.0 * lpc_pred
            slpc[pos] = v
            xq[n] = float(np.clip(round(v * gain_q10 / (1 << 24)),
                                  -32768, 32767))
            n += 1
        slpc = np.concatenate(
            [slpc[bw.subfr_len : bw.subfr_len + MAX_LPC_ORDER],
             np.zeros(bw.subfr_len)])

    return pulses, xq, slpc[:MAX_LPC_ORDER].copy(), prev_gain, miss


# ----------------------------------------------------------------------
# Stereo (mid/side) layer — decode side: silk.stereo_decode_pred /
# stereo_ms_to_lr (reference: stereo_LR_to_MS.c, stereo_encode_pred.c)
# ----------------------------------------------------------------------

def _stereo_quant_pred(target_q13):
    """Nearest point on the decoder's stereo predictor grid
    (stereo_pred_quant_Q13 anchors x 5 sub-steps, silk.py
    stereo_decode_pred dequant math).  Returns ((ix0, ix1, ix2),
    dequantized_q13)."""
    t = ST.tables()
    quant = t["stereo_pred_quant_Q13"]
    best = None
    for i in range(15):
        low = int(quant[i])
        step = S.smulwb(int(quant[i + 1]) - low, 6554)  # 0.5/5 Q16
        for sub in range(5):
            val = S.smlabb(low, step, 2 * sub + 1)
            err = abs(val - target_q13)
            if best is None or err < best[0]:
                best = (err, i, sub, val)
    _, i, sub, val = best
    return (i % 3, sub, i // 3), val


class _StereoState:
    def __init__(self):
        self.pred_prev_q13 = [0, 0]
        self.mid_carry = np.zeros(2)     # last 2 decoded mid samples
        self.side_carry = 0.0            # last coded side sample target


def _stereo_fit_preds(mid, side, mid_prev2):
    """Least-squares (w0, w1) for the decoder's side prediction
    side2[j] = side[j] + lp_sum(j)*p0/2**15 + mid[j]*p1/2**13 with
    lp_sum(j) = mid[j-1] + 2 mid[j] + mid[j+1]."""
    m_ext = np.concatenate([mid_prev2, mid])
    lp = m_ext[:-2] + 2.0 * m_ext[1:-1] + np.concatenate(
        [m_ext[2:], mid[-1:]])[:len(mid)]
    c0 = lp[:len(mid)] / 4.0
    c1 = mid
    A = np.stack([c0, c1], 1)
    try:
        w, *_ = np.linalg.lstsq(A, -side, rcond=None)
    except np.linalg.LinAlgError:
        w = np.zeros(2)
    # w is in units of Q13/8192 with the /4 folded into c0
    return float(np.clip(-w[0], -1.6, 1.6)), \
        float(np.clip(-w[1], -1.6, 1.6))


def encode_ogg_opus_silk_stereo(samples: np.ndarray, sample_rate: int,
                                bandwidth: str = "wb",
                                frame_ms: int = 20,
                                lbrr: bool = False,
                                preskip: int | None = None,
                                return_packets: bool = False,
                                device=None):
    """Encode interleaved stereo float32 [-1, 1] PCM as SILK-only Ogg
    Opus (10/20/40/60 ms packets, stereo TOC).  Mid/side coding
    with per-frame stereo prediction: the side channel codes the
    residual after the decoder's exact 3-tap + direct mid prediction
    (silk.stereo_ms_to_lr mirror, including the 8 ms predictor
    interpolation ramp), so both internal channels ride the mono frame
    encoder unchanged."""
    from .celt_encoder import PRESKIP, ogg_opus_wrap

    t = ST.tables()
    if frame_ms not in (10, 20, 40, 60):
        raise ValueError("SILK packets are 10/20/40/60 ms")
    if lbrr and frame_ms != 20:
        raise ValueError("LBRR is implemented for 20 ms packets")
    bw = (BANDWIDTHS_10MS if frame_ms == 10 else BANDWIDTHS)[bandwidth]
    fpp = max(1, frame_ms // 20)    # 20 ms SILK frames per packet
    toc_cfg = ({"nb": 0, "mb": 4, "wb": 8}[bandwidth]
               + {10: 0, 20: 1, 40: 2, 60: 3}[frame_ms])
    fs_hz = bw.fs_khz * 1000
    x = np.asarray(samples, np.float64).reshape(-1, 2)
    S48 = (len(x) if sample_rate == 48000
           else int(round(len(x) * 48000 / sample_rate)))
    if sample_rate != fs_hz:
        x = np.stack([
            resample_on(x[:, c].astype(np.float32), sample_rate, fs_hz,
                        device) for c in range(2)], 1)
    if preskip is None:
        preskip = PRESKIP
    lead = np.zeros((preskip * bw.fs_khz // 48, 2))
    x = np.concatenate([lead, x]) * 32767.0
    # +delay-comp tail coverage, standalone wrap only (see the mono
    # path's comment on DELAY_COMP_48K)
    d_fs = (0 if return_packets
            else -(-DELAY_COMP_48K[bandwidth] * bw.fs_khz // 48))
    F = -(-(len(x) + d_fs) // bw.frame_len)
    x = np.concatenate([x, np.zeros((F * bw.frame_len - len(x), 2))])

    # LR -> MS in the decoder's int domain (stereo_ms_to_lr inverse:
    # L = mid + side2, R = mid - side2)
    mid_all = np.round((x[:, 0] + x[:, 1]) / 2.0)
    side_all = np.round((x[:, 0] - x[:, 1]) / 2.0)

    st_mid = SilkEncoderState(bw)
    st_side = SilkEncoderState(bw)
    ss = _StereoState()
    interp_len = ST.STEREO_INTERP_LEN_MS * bw.fs_khz
    denom_q16 = (1 << 16) // interp_len
    P = -(-F // fpp)
    pad = P * fpp * bw.frame_len - len(mid_all)
    mid_all = np.concatenate([mid_all, np.zeros(pad)])
    side_all = np.concatenate([side_all, np.zeros(pad)])
    packets = []
    toc = (toc_cfg << 3) | (1 << 2)   # SILK-only, stereo, code 0
    prev_state = None
    for k in range(P):
        enc = RangeEncoder(1275)
        has_lbrr = lbrr and prev_state is not None
        for ch in range(2):
            for _ in range(fpp):
                enc.enc_bit_logp(1, 1)  # VAD per frame (side coded)
            enc.enc_bit_logp(1 if has_lbrr else 0, 1)   # LBRR
        if has_lbrr:
            # LBRR slot: stereo pred + mid + side of the PREVIOUS
            # frame at coarser gains, from its original state copy
            lb_m, lb_s, lb_ss, lb_mid, lb_side = prev_state
            silk_stereo_frame(enc, lb_m, lb_s, lb_ss, lb_mid, lb_side,
                              gain_boost=2.0)
        if lbrr:
            lo = k * bw.frame_len
            prev_state = (copy.deepcopy(st_mid),
                          copy.deepcopy(st_side), copy.deepcopy(ss),
                          mid_all[lo:lo + bw.frame_len],
                          side_all[lo:lo + bw.frame_len])
        for i in range(fpp):
            lo = (k * fpp + i) * bw.frame_len
            silk_stereo_frame(
                enc, st_mid, st_side, ss,
                mid_all[lo:lo + bw.frame_len],
                side_all[lo:lo + bw.frame_len],
                conditional=(i > 0))
        nbytes = ((enc.tell() + 7) >> 3) + 1
        enc.enc_shrink(max(nbytes, enc.offs + enc.end_offs, 2))
        packets.append(bytes([toc]) + enc.done())
    if return_packets:
        return packets, S48
    return ogg_opus_wrap(packets, 2, S48, frame_ms * 48,
                         preskip + DELAY_COMP_48K[bandwidth])


def silk_stereo_frame(enc, st_mid: SilkEncoderState,
                      st_side: SilkEncoderState, ss: _StereoState,
                      mid, side, conditional=False,
                      gain_boost=1.0) -> None:
    """One stereo SILK frame onto a (possibly shared) range coder:
    stereo predictors, mid frame, prediction-compensated side frame.
    Used by the SILK-only stereo packetizer above and the stereo
    hybrid encoder (the caller emits VAD/LBRR header flags first)."""
    t = ST.tables()
    bw = st_mid.bw
    interp_len = ST.STEREO_INTERP_LEN_MS * bw.fs_khz
    denom_q16 = (1 << 16) // interp_len

    # fit + quantize the two predictors (decoder applies
    # pred[0] -= pred[1] after dequant: q0 targets w0 + q1)
    w0, w1 = _stereo_fit_preds(mid, side, ss.mid_carry)
    ix1, q1 = _stereo_quant_pred(int(round(w1 * 8192.0)))
    ix0, q0 = _stereo_quant_pred(int(round(w0 * 8192.0)) + q1)
    p0_eff, p1_eff = q0 - q1, q1

    n_joint = ix0[2] * 5 + ix1[2]
    enc.enc_icdf(n_joint, t["stereo_pred_joint_iCDF"], 8)
    for ix in (ix0, ix1):
        enc.enc_icdf(ix[0], t["uniform3_iCDF"], 8)
        enc.enc_icdf(ix[1], t["uniform5_iCDF"], 8)
    # VAD ch1 set -> the decoder reads no only-mid symbol

    _encode_frame(enc, st_mid, mid, conditional=conditional,
                  gain_boost=gain_boost)
    xq_mid = st_mid.last_xq

    # side target: subtract the decoder's exact per-sample
    # prediction from the DECODED mid, with the 8 ms ramp from
    # the previous predictors (silk.stereo_ms_to_lr); side
    # sample j is applied at decoder step n = j+1
    m_ext = np.concatenate([ss.mid_carry, xq_mid, xq_mid[-1:]])
    pv0, pv1 = ss.pred_prev_q13
    d0 = S.rshift_round(S.smulbb(p0_eff - pv0, denom_q16), 16)
    d1 = S.rshift_round(S.smulbb(p1_eff - pv1, denom_q16), 16)
    side_tgt = np.empty(bw.frame_len)
    for j in range(bw.frame_len):
        nstep = j + 1
        if nstep < interp_len:
            c0 = pv0 + d0 * (nstep + 1)
            c1 = pv1 + d1 * (nstep + 1)
        else:
            c0, c1 = p0_eff, p1_eff
        lp = m_ext[j] + 2.0 * m_ext[j + 1] + m_ext[j + 2]
        pred = lp * c0 / 32768.0 + m_ext[j + 1] * c1 / 8192.0
        side_tgt[j] = np.clip(np.round(side[j] - pred),
                              -32768, 32767)
    # the decoder increments the mid channel's frame counter before
    # reading the side frame, so the side conditional boundary is the
    # same as mid's (verified bit-exact against libopus)
    _encode_frame(enc, st_side, side_tgt, conditional=conditional,
                  gain_boost=gain_boost)

    ss.pred_prev_q13 = [p0_eff, p1_eff]
    ss.mid_carry = xq_mid[-2:].copy()


DTX_REFRESH = 20          # packets; ~400 ms at 20 ms (opus_encoder.c)
DTX_RMS_THRESH = 40.0     # int16 domain, ~-58 dBFS


def encode_ogg_opus_silk(samples: np.ndarray, sample_rate: int,
                         bandwidth: str = "wb",
                         frame_ms: int = 20,
                         dtx: bool = False,
                         lbrr: bool = False,
                         preskip: int | None = None,
                         return_packets: bool = False,
                         device=None):
    """Encode mono float32 [-1, 1] PCM as SILK-only Ogg Opus.
    bandwidth picks the SILK internal rate: "nb" (8 kHz), "mb"
    (12 kHz) or "wb" (16 kHz); frame_ms 20 (TOC configs 1/5/9), 10
    (2 subframes, the 10 ms pitch contour codebooks — configs 0/4/8),
    or 40/60 (multi-frame packets, frames after the first coded
    CODE_CONDITIONALLY — configs 2-3/6-7/10-11).

    dtx=True replaces packets whose input falls below ~-58 dBFS with
    TOC-only (1 byte) packets after a one-packet hangover, refreshing
    with a real packet every ~400 ms (OPUS_SET_DTX semantics; the
    decoder treats the empty frames as DTX comfort-noise holds).
    Like libopus, encoder and decoder state drift across a DTX gap;
    the first packets after reactivation are coded independently and
    re-converge.

    lbrr=True (20 ms packets) adds in-band FEC: each packet carries a
    low-bitrate re-encode of the PREVIOUS frame (coarser gains) in
    the LBRR slot (OPUS_SET_INBAND_FEC; decode side: our
    decode_packet(fec=True) or libopus opus_decode(..., decode_fec=1)
    recovers a lost frame from the next packet). The resample to the
    internal rate runs on ``device``."""
    from .celt_encoder import PRESKIP, ogg_opus_wrap

    if frame_ms not in (10, 20, 40, 60):
        raise ValueError("SILK packets are 10/20/40/60 ms")
    if lbrr and frame_ms != 20:
        raise ValueError("LBRR is implemented for 20 ms packets")
    bw = (BANDWIDTHS_10MS if frame_ms == 10 else BANDWIDTHS)[bandwidth]
    fpp = max(1, frame_ms // 20)    # 20 ms SILK frames per packet
    toc_cfg = ({"nb": 0, "mb": 4, "wb": 8}[bandwidth]
               + {10: 0, 20: 1, 40: 2, 60: 3}[frame_ms])
    fs_hz = bw.fs_khz * 1000
    x = np.asarray(samples, np.float64).reshape(-1)
    S48 = (len(x) if sample_rate == 48000
           else int(round(len(x) * 48000 / sample_rate)))
    if sample_rate != fs_hz:
        x = resample_on(x.astype(np.float32), sample_rate, fs_hz, device)
    # preskip priming (preskip is in 48 kHz samples; 0 = mid-stream
    # segment of a mixed-mode auto encode)
    if preskip is None:
        preskip = PRESKIP
    lead = np.zeros(preskip * bw.fs_khz // 48)
    x = np.concatenate([lead, x]) * 32767.0
    # Standalone wrap only: +delay-comp tail coverage — the decoder
    # emits the audio DELAY_COMP_48K late, so the frame grid must
    # extend past the nominal end for the granule budget
    # preskip+delay+S48 to exist.  In packet mode (return_packets, the
    # auto-mode mixer) the frame count must stay exactly the segment's
    # frame count — the caller compensates the delay instead.
    d_fs = (0 if return_packets
            else -(-DELAY_COMP_48K[bandwidth] * bw.fs_khz // 48))
    F = -(-(len(x) + d_fs) // bw.frame_len)
    x = np.concatenate([x, np.zeros(F * bw.frame_len - len(x))])

    # pad to whole packets
    P = -(-F // fpp)
    x = np.concatenate([x, np.zeros(P * fpp * bw.frame_len - len(x))])

    st = SilkEncoderState(bw)
    packets = []
    toc = (toc_cfg << 3) | 0   # SILK-only, mono, code 0
    silent_run = 0
    prev_state = None          # (state before frame k-1, its input)
    for k in range(P):
        if dtx:
            seg = x[k * fpp * bw.frame_len:(k + 1) * fpp * bw.frame_len]
            if np.sqrt(np.mean(seg * seg)) < DTX_RMS_THRESH:
                silent_run += 1
                if silent_run > 1 and silent_run % DTX_REFRESH:
                    packets.append(bytes([toc]))   # TOC-only: DTX
                    prev_state = None
                    continue
            else:
                silent_run = 0
        enc = RangeEncoder(1275)
        for _ in range(fpp):
            enc.enc_bit_logp(1, 1)      # VAD flag per frame: active
        has_lbrr = lbrr and prev_state is not None
        enc.enc_bit_logp(1 if has_lbrr else 0, 1)   # LBRR flag
        if has_lbrr:
            # one frame/packet: LBRR_flags[0]=1 is implicit; the LBRR
            # slot re-encodes the PREVIOUS frame independently against
            # the state it was originally coded from, at coarser gains
            lb_st, lb_x = prev_state
            _encode_frame(enc, lb_st, lb_x, gain_boost=2.0)
        if lbrr:
            prev_state = (copy.deepcopy(st),
                          x[k * bw.frame_len:(k + 1) * bw.frame_len])
        for i in range(fpp):
            lo = (k * fpp + i) * bw.frame_len
            _encode_frame(enc, st, x[lo:lo + bw.frame_len],
                          conditional=(i > 0))
        nbytes = ((enc.tell() + 7) >> 3) + 1   # VBR: shrink to used
        enc.enc_shrink(max(nbytes, enc.offs + enc.end_offs, 2))
        packets.append(bytes([toc]) + enc.done())
    if return_packets:
        return packets, S48
    return ogg_opus_wrap(packets, 1, S48, frame_ms * 48,
                         preskip + DELAY_COMP_48K[bandwidth])
