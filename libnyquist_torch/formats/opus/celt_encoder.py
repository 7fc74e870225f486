"""CELT encoder (mono/stereo, long and short blocks) and the Ogg Opus
writer of every encoder of the package.

A CELT-only encoder built from the decoder's spec (the decoder is the
normative half of CELT): forward MDCT (reference: celt/mdct.c:116-217
clt_mdct_forward), band energies with intra/inter coarse and fine energy
coding (the duals of quant_bands.c's unquant_*), the PVQ search and CWRS
index coding (vq.c alg_quant, cwrs.c icwrs), and the allocation and band
recursion of ``formats/opus/celt.py`` in the encode direction.

Rate-distortion machinery: valley-follower dynalloc with the reference's
perceptual noise floor, slope-driven trim, per-band tf analysis with
viterbi smoothing over the flip grammar, per-frame intra/inter
energy-prediction choice, transient detection with 8-short-MDCT coding,
the pitch prefilter (the decoder's postfilter re-adds the harmonics) and
constrained-VBR rate control; spread stays NORMAL.

Everything here is serial host NumPy: the prefilter is the per-frame
host comb filter, not the card's postfilter kernel. Input is 48 kHz
(the entry points in ``encoders.py`` resample on the device first).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .celt import (
    BETA_COEF,
    BETA_INTRA,
    BITRES,
    COMBFILTER_MINPERIOD,
    LOG2_FRAC_TABLE,
    MAX_FINE_BITS,
    PRED_COEF,
    SMALL_ENERGY_ICDF,
    SPREAD_AGGRESSIVE,
    SPREAD_ICDF,
    SPREAD_LIGHT,
    SPREAD_NONE,
    SPREAD_NORMAL,
    TAPSET_ICDF,
    TF_SELECT_TABLE,
    TRIM_ICDF,
    bits2pulses,
    cdiv,
    comb_filter,
    compute_allocation,
    exp_rotation,
    init_caps,
    laplace_encode,
    pvq_u,
    pvq_v,
    quant_all_bands,
)
from .celt_tables import mode48000
from .range_coder import RangeEncoder, ilog

def celt_window(overlap: int) -> np.ndarray:
    i = np.arange(overlap, dtype=np.float64)
    return np.sin(0.5 * np.pi * np.sin(0.5 * np.pi * (i + 0.5) / overlap) ** 2)


def mdct_forward(x: np.ndarray, N: int, overlap: int) -> np.ndarray:
    """NumPy port of clt_mdct_forward (mdct.c:116-217), B=1, stride 1.

    Args:
      x: [..., N2 + overlap] input window (frame advance is N2).
      N: transform size (l->n >> shift); N2 = N//2 output bins.
    Returns [..., N2] spectrum.
    """
    N2, N4 = N // 2, N // 4
    w = celt_window(overlap)
    t = np.cos(2 * np.pi * np.arange(N4 + 1, dtype=np.float64) / N)
    sine = 2 * np.pi * 0.125 / N
    x = x.astype(np.float64)
    batch = x.shape[:-1]
    half = overlap // 2
    q = (overlap + 3) >> 2

    f_re = np.zeros(batch + (N4,), np.float64)
    f_im = np.zeros(batch + (N4,), np.float64)
    i1 = np.arange(q)
    # region 1: windowed fold of the tail into the head
    xp1 = half + 2 * i1
    xp2 = N2 - 1 + half - 2 * i1
    f_re[..., :q] = (w[half - 1 - 2 * i1] * x[..., xp1 + N2]
                     + w[half + 2 * i1] * x[..., xp2])
    f_im[..., :q] = (w[half + 2 * i1] * x[..., xp1]
                     - w[half - 1 - 2 * i1] * x[..., xp2 - N2])
    # region 2: pass-through
    i2 = np.arange(q, N4 - q)
    f_re[..., q : N4 - q] = x[..., N2 - 1 + half - 2 * i2]
    f_im[..., q : N4 - q] = x[..., half + 2 * i2]
    # region 3: windowed fold of the head
    i3 = np.arange(N4 - q, N4)
    j3 = i3 - (N4 - q)
    xp1 = half + 2 * i3
    xp2 = N2 - 1 + half - 2 * i3
    f_re[..., N4 - q :] = (-w[2 * j3] * x[..., xp1 - N2]
                           + w[overlap - 1 - 2 * j3] * x[..., xp2])
    f_im[..., N4 - q :] = (w[overlap - 1 - 2 * j3] * x[..., xp1]
                           + w[2 * j3] * x[..., xp2 + N2])

    # pre-rotation
    ti = t[:N4]
    tn = t[N4:0:-1]
    yr = -f_re * ti - f_im * tn
    yi = -f_im * ti + f_re * tn
    fr = yr + yi * sine
    fi = yi - yr * sine

    # forward N/4 complex FFT, downscaled by 4/N (kiss convention)
    z = np.fft.fft(fr + 1j * fi, axis=-1) / N4
    zr, zi = z.real, z.imag

    # post-rotation
    yr = zi * tn + zr * ti
    yi = zr * tn - zi * ti
    out = np.zeros(batch + (N2,), np.float64)
    out[..., 0::2] = yr - yi * sine
    out[..., 1::2] = (yi + yr * sine)[..., ::-1]
    return out


# ---------------------------------------------------------------------------
# Energy envelope encoding (duals of celt.py unquant_* / quant_bands.c)
# ---------------------------------------------------------------------------

def quant_coarse_energy(mode, start, end, bandLogE, oldEBands, enc, C, LM,
                        budget, intra=True):
    """Coarse energy encode (quant_bands.c quant_coarse_energy); the
    caller picks intra (self-contained, ~6 bits/band) or inter
    (predicted from the previous frame's energies, ~2-3 bits/band on
    stationary content) and codes the flag itself."""
    prob_model = mode.e_prob_model[LM][1 if intra else 0]
    if intra:
        coef, beta = 0.0, BETA_INTRA
    else:
        coef, beta = PRED_COEF[LM], BETA_COEF[LM]
    prev = [0.0, 0.0]
    error = np.zeros((C, mode.nbEBands))
    for i in range(start, end):
        for c in range(C):
            x = float(bandLogE[c][i])
            old = max(-9.0, float(oldEBands[c, i]))
            f = x - coef * old - prev[c]
            qi = int(math.floor(0.5 + f))
            tell = enc.tell()
            bits_left = budget - tell - 3 * C * (end - i)
            if i != start and bits_left < 30:
                qi = min(qi, 1)
                qi = max(qi, -1)
            if budget - tell >= 15:
                pi = 2 * min(i, 20)
                qi = laplace_encode(
                    enc, qi,
                    int(prob_model[pi]) << 7, int(prob_model[pi + 1]) << 6,
                )
            elif budget - tell >= 2:
                qi = max(-1, min(qi, 1))
                enc.enc_icdf(2 * qi ^ -(1 if qi < 0 else 0),
                             SMALL_ENERGY_ICDF, 2)
            elif budget - tell >= 1:
                qi = min(0, qi)
                enc.enc_bit_logp(-qi, 1)
            else:
                qi = -1
            error[c][i] = f - qi
            q = float(qi)
            tmp = coef * old + prev[c] + q
            oldEBands[c, i] = tmp
            prev[c] = prev[c] + q - beta * q
    return error


def quant_fine_energy(mode, start, end, oldEBands, error, fine_quant, enc, C):
    for i in range(start, end):
        if fine_quant[i] <= 0:
            continue
        frac = 1 << fine_quant[i]
        for c in range(C):
            q2 = int(math.floor((float(error[c][i]) + 0.5) * frac))
            q2 = max(0, min(frac - 1, q2))
            enc.enc_bits(q2, fine_quant[i])
            offset = (q2 + 0.5) * (1 << (14 - fine_quant[i])) / 16384.0 - 0.5
            oldEBands[c, i] += offset
            error[c][i] -= offset


def quant_energy_finalise(mode, start, end, oldEBands, error, fine_quant,
                          fine_priority, bits_left, enc, C):
    for prio in range(2):
        i = start
        while i < end and bits_left >= C:
            if fine_quant[i] >= MAX_FINE_BITS or fine_priority[i] != prio:
                i += 1
                continue
            for c in range(C):
                q2 = 0 if error[c][i] < 0 else 1
                enc.enc_bits(q2, 1)
                offset = (q2 - 0.5) * (1 << (14 - fine_quant[i] - 1)) / 16384.0
                oldEBands[c, i] += offset
                bits_left -= 1
            i += 1


COMB_MINPERIOD = 15
COMB_MAXPERIOD = 1024


def _prefilter_pitch(xm, base, N):
    """Pitch lag + normalized correlation for the frame xm[base:base+N]
    (mono raw preemph stream with >= COMB_MAXPERIOD+2 history).
    Coarse search at 1/2 rate, refine at full rate (the idea of
    celt/pitch.c pitch_search + remove_doubling, not a port)."""
    ds = xm[base - COMB_MAXPERIOD : base + N][::2]
    cur = ds[COMB_MAXPERIOD // 2 :]
    e1 = float(np.dot(cur, cur)) + 1e-9
    best_l, best_s = 0, 0.0
    # skip the shortest 1.5 octaves: short-term correlation of any
    # smooth signal is high there (run_prefilter's own guard — it
    # searches down to 3*COMBFILTER_MINPERIOD only, sub-periods below
    # come from the doubling check)
    for lag in range(3 * COMB_MINPERIOD // 2, COMB_MAXPERIOD // 2 - 2):
        past = ds[COMB_MAXPERIOD // 2 - lag : COMB_MAXPERIOD // 2 - lag
                  + len(cur)]
        c = float(np.dot(cur, past))
        if c <= 0:
            continue
        s = c * c / (float(np.dot(past, past)) + 1e-9)
        if s > best_s:
            best_s, best_l = s, lag
    if not best_l:
        return COMB_MINPERIOD, 0.0
    # prefer the shortest consistent sub-period (remove doubling)
    for div in (4, 3, 2):
        lag2 = best_l // div
        if lag2 <= COMB_MINPERIOD // 2:
            continue
        past = ds[COMB_MAXPERIOD // 2 - lag2 : COMB_MAXPERIOD // 2 - lag2
                  + len(cur)]
        c = float(np.dot(cur, past))
        if c <= 0:
            continue
        s = c * c / (float(np.dot(past, past)) + 1e-9)
        if s > 0.81 * best_s:
            best_s, best_l = s, lag2
            break
    # full-rate refinement around 2*lag
    best_T, best_c = 2 * best_l, -1.0
    curf = xm[base : base + N]
    e1f = float(np.dot(curf, curf)) + 1e-9
    for T in range(max(COMB_MINPERIOD, 2 * best_l - 2),
                   min(COMB_MAXPERIOD - 2, 2 * best_l + 2) + 1):
        past = xm[base - T : base - T + N]
        c = float(np.dot(curf, past))
        e2 = float(np.dot(past, past)) + 1e-9
        s = c / np.sqrt(e1f * e2) if c > 0 else 0.0
        if s > best_c:
            best_c, best_T = s, T
    return best_T, max(0.0, best_c)


def run_prefilter(pre, F, N, overlap, window, short_mdct):
    """Stream prefilter (reference celt_encoder.c:1007 run_prefilter):
    per frame, pitch-search the raw pre-emphasized input and SUBTRACT
    the comb prediction (negated postfilter gains) so the decoder's
    pitch postfilter re-adds the harmonics — quantization noise
    between the harmonics gets shaped away.  Feed-forward on the raw
    stream (the decoder's postfilter is the recursive inverse on its
    own output), params crossfaded at frame starts exactly like the
    decoder applies them.

    pre: [C, total] raw pre-emphasized input (frame-padded + overlap
    tail).  Returns (filtered [C, total], per-frame params
    [(pf_on, pitch_index, qg, tapset)])."""
    C, total = pre.shape
    pad = COMB_MAXPERIOD + 2
    raw = np.concatenate([np.zeros((C, pad)), pre], axis=1)
    out = raw.copy()
    xm = raw.mean(axis=0) if C == 2 else raw[0]
    prev_T, prev_g, prev_tap = COMB_MINPERIOD, 0.0, 0
    params = []
    for k in range(F):
        base = pad + k * N
        T, corr = _prefilter_pitch(xm, base, N)
        gain1 = 0.7 * corr
        thr = 0.2
        if abs(T - prev_T) * 10 > T:
            thr += 0.2
        if prev_g > 0.4:
            thr -= 0.1
        if prev_g > 0.55:
            thr -= 0.1
        thr = max(thr, 0.2)
        if gain1 < thr:
            pf_on, qg, g1, T = 0, 0, 0.0, COMB_MINPERIOD
        else:
            if abs(gain1 - prev_g) < 0.1:
                gain1 = prev_g
            qg = int(np.clip(np.floor(0.5 + gain1 * 32.0 / 3.0) - 1,
                             0, 7))
            g1 = 0.09375 * (qg + 1)
            pf_on = 1
        # Application timing: the decoder switches to frame k's params
        # only at output sample k*N + shortMdctSize (its first
        # shortMdctSize samples still run the previous params,
        # celt.py:2702-2717), and our framing has zero net latency
        # (PRESKIP absorbs it) — so the removal must shift by the same
        # shortMdctSize or every param change mis-cancels for 240
        # samples (measured: -5 dB on music before this shift).
        for c in range(C):
            comb_filter(out[c], raw[c], base + short_mdct, prev_T, T,
                        N, -prev_g, -g1, prev_tap, 0, window, overlap)
        params.append((pf_on, T, qg, 0))
        prev_T, prev_g, prev_tap = T, g1, 0
    # lookahead tail past the last shifted region (read by the final
    # MDCT window): constant last params
    tpos = pad + F * N + short_mdct
    tail = total + pad - tpos
    if tail > 0 and prev_g != 0.0:
        for c in range(C):
            comb_filter(out[c], raw[c], tpos, prev_T, prev_T,
                        tail, -prev_g, -prev_g, prev_tap, prev_tap,
                        window, 0)
    return out[:, pad:], params


def _haar_time(x, rounds):
    """The decoder's extra-time-resolution transform for long frames
    with tf_change < 0 (bands.c haar1(X, N>>k, 1<<k) iterated)."""
    x = np.asarray(x, np.float64).copy()
    n = len(x)
    s = np.sqrt(0.5)
    for k in range(rounds):
        n0 = n >> k
        stride = 1 << k
        pairs = n0 >> 1
        if pairs == 0:
            break
        v = x[: pairs * 2 * stride].reshape(pairs, 2, stride)
        a = s * (v[:, 0] + v[:, 1])
        b = s * (v[:, 0] - v[:, 1])
        x[: pairs * 2 * stride] = np.stack(
            [a, b], axis=1).reshape(-1)
    return x


def tf_analysis(X, start, end, eBands, LM):
    """Per-band time/frequency resolution decisions for LONG frames:
    raw tf bit 1 maps (via TF_SELECT_TABLE) to extra time splits — the
    right choice for bands whose coefficients become SPARSER under the
    time haar (sweeping tones, isolated clicks).  L1-compaction metric
    with a bias covering the flip's bit cost (the idea of the
    reference's tf_analysis, celt_encoder.c:589, without its viterbi
    smoothing)."""
    depth = {0: 1, 1: 2, 2: 2, 3: 2}[LM]
    M = 1 << LM
    # per-band coding-gain estimate in bits: a unit-L2 band whose L1
    # compacts from l1_0 to l1_1 under the time haar saves roughly
    # N*log2(l1_0/l1_1) bits of shape entropy
    benefit = np.zeros(end)
    for i in range(start, end):
        x = X[M * int(eBands[i]) : M * int(eBands[i + 1])]
        if len(x) < 4:
            continue
        l1 = float(np.abs(x).sum()) + 1e-9
        l1t = float(np.abs(_haar_time(x, depth)).sum()) + 1e-9
        benefit[i] = len(x) * np.log2(l1 / l1t)
    # two-state viterbi over the tf grammar's transition costs (first
    # flip costs ~4 bits, later flips 5, staying ~0.1) — smooths out
    # isolated flips the per-band threshold version paid for dearly
    NEG = -1e18
    dp = {0: 0.0, 1: NEG}
    bp = {0: [], 1: []}
    first = True
    for i in range(start, end):
        logp = 4.0 if first else 5.0
        first = False
        ndp, nbp = {}, {}
        for s in (0, 1):
            best, arg = NEG, 0
            for sp in (0, 1):
                c = logp if (s ^ sp) else 0.1
                v = dp[sp] - c + (benefit[i] if s else 0.0)
                if v > best:
                    best, arg = v, sp
            ndp[s] = best
            nbp[s] = bp[arg] + [s]
        dp, bp = ndp, nbp
    path = bp[0] if dp[0] >= dp[1] else bp[1]
    wants = [0] * end
    for j, i in enumerate(range(start, end)):
        wants[i] = path[j]
    return wants


def tf_encode(start, end, isTransient, LM, enc, wants):
    """Per-band tf_encode mirroring tf_decode's grammar exactly."""
    budget = enc.storage * 8
    tell = enc.tell()
    logp = 2 if isTransient else 4
    tf_select_rsv = 1 if (LM > 0 and tell + logp + 1 <= budget) else 0
    budget -= tf_select_rsv
    curr = 0
    tf_changed = 0
    raw = [0] * end
    for i in range(start, end):
        if tell + logp <= budget:
            enc.enc_bit_logp(wants[i] ^ curr, logp)
            tell = enc.tell()
            curr = wants[i]
            tf_changed |= curr
        raw[i] = curr
        logp = 4 if isTransient else 5
    base = 4 * (1 if isTransient else 0)
    tf_select = 0
    if tf_select_rsv and (
        TF_SELECT_TABLE[LM][base + 0 + tf_changed]
        != TF_SELECT_TABLE[LM][base + 2 + tf_changed]
    ):
        enc.enc_bit_logp(0, 1)
    return [TF_SELECT_TABLE[LM][base + 2 * tf_select + raw[i]]
            for i in range(end)]


def tf_encode_uniform(start, end, isTransient, LM, enc, want):
    """tf_encode with a uniform tf_res (celt_encoder.c tf_encode).

    want=0 for long frames; want=1 for transient frames, which keeps the
    short blocks' time resolution (the all-zero mapping would recombine
    them via TF_SELECT_TABLE and defeat the transient switch).
    Returns the per-band MAPPED tf_change values exactly as the
    decoder's tf_decode will derive them from these bits."""
    budget = enc.storage * 8
    tell = enc.tell()
    logp = 2 if isTransient else 4
    tf_select_rsv = 1 if (LM > 0 and tell + logp + 1 <= budget) else 0
    budget -= tf_select_rsv
    curr = 0
    tf_changed = 0
    raw = [0] * end
    for i in range(start, end):
        if tell + logp <= budget:
            enc.enc_bit_logp(want ^ curr, logp)
            tell = enc.tell()
            curr = want
            tf_changed |= curr
        raw[i] = curr
        logp = 4 if isTransient else 5
    base = 4 * (1 if isTransient else 0)
    tf_select = 0
    if tf_select_rsv and (
        TF_SELECT_TABLE[LM][base + 0 + tf_changed]
        != TF_SELECT_TABLE[LM][base + 2 + tf_changed]
    ):
        enc.enc_bit_logp(0, 1)
    return [TF_SELECT_TABLE[LM][base + 2 * tf_select + raw[i]]
            for i in range(end)]


def compute_band_energies(mode, freq, C, M):
    """bands.c compute_band_energies: bandE[c][i] = ||freq band||."""
    eBands = mode.eBands
    bandE = np.zeros((C, mode.nbEBands))
    for c in range(C):
        for i in range(mode.nbEBands):
            j0, j1 = M * int(eBands[i]), M * int(eBands[i + 1])
            bandE[c][i] = math.sqrt(
                1e-27 + float(np.dot(freq[c][j0:j1], freq[c][j0:j1]))
            )
    return bandE


def normalise_bands(mode, freq, bandE, C, M):
    eBands = mode.eBands
    X = np.zeros((C, M * int(eBands[mode.nbEBands])))
    for c in range(C):
        for i in range(mode.nbEBands):
            j0, j1 = M * int(eBands[i]), M * int(eBands[i + 1])
            g = 1.0 / (1e-27 + bandE[c][i])
            X[c][j0:j1] = freq[c][j0:j1] * g
    return X


class CeltEncoderState:
    def __init__(self, channels: int):
        mode = mode48000()
        self.channels = channels
        self.start = 0
        self.end = mode.effEBands
        self.oldEBands = np.zeros((2, mode.nbEBands))
        self.rng = 0
        self.overlap_mem = np.zeros((channels, mode.overlap))
        # decision smoothing state (spreading_decision /
        # intensity_decision / dual_stereo_decision below)
        self.spread_avg = 3.0          # IPR EMA; 3 = Gaussian noise
        self.intensity_avg = float(mode.effEBands)
        self.dual_avg = 0.0            # EMA of the L/R-vs-M/S margin


def spreading_decision(X, mode, M, start, end, C, st):
    """Per-frame PVQ spreading (rotation strength) decision — the
    surface of the reference's spreading_decision
    (celt_encoder.c:400), ORIGINAL formulation.

    Statistic: per-band inverse participation ratio of the normalized
    shape, r = N * sum(x^4) for unit-norm x — ~3 for Gaussian noise,
    ~N for a lone tone, 1 for a flat shape.  The frame statistic is
    the median over coded bands with N >= 8 and non-negligible energy
    (tonal content concentrates in few bands; the median over the
    *live* bands tracks it).  An EMA across frames adds hysteresis so
    the signaled class doesn't thrash at threshold boundaries.

    Mapping: strongly tonal -> SPREAD_NONE (rotation would smear the
    quantization error across the peak's neighborhood), noise-like ->
    SPREAD_AGGRESSIVE (strongest decorrelation of the pulse grid),
    Gaussian-ish -> NORMAL.  Thresholds chosen by RD sweep
    (tools/opus_rd_compare.py): no cell may regress vs always-NORMAL.
    """
    eBands = mode.eBands
    vals = []
    for c in range(C):
        base = c * M * int(eBands[mode.nbEBands])
        for b in range(start, end):
            lo = M * int(eBands[b])
            hi = M * int(eBands[b + 1])
            N = hi - lo
            if N < 8:
                continue
            x = X[lo + base : hi + base] if X.ndim == 1 else X[c, lo:hi]
            e = float(np.dot(x, x))
            if e < 1e-10:
                continue
            vals.append(N * float(np.sum((x * x) ** 2)) / (e * e))
    if not vals:
        return SPREAD_NORMAL
    st.spread_avg = 0.7 * st.spread_avg + 0.3 * float(np.median(vals))
    a = st.spread_avg
    if a > 30.0:
        return SPREAD_NONE
    if a > 10.0:
        return SPREAD_LIGHT
    if a > 2.2:
        return SPREAD_NORMAL
    return SPREAD_AGGRESSIVE


def intensity_decision(X, mode, M, start, end, st, kbps):
    """Stereo intensity threshold — the surface of the reference
    encoder's intensity machinery (celt_encoder.c stereo analysis +
    rate thresholds), ORIGINAL formulation.

    Above the returned band, only the mid shape is coded and both
    channels reconstruct from it with their own energies; the loss is
    the inter-channel shape difference, the gain is ~half the PVQ bits
    of those bands.  Worth it when (a) the rate is too low to code two
    shapes well, or (b) the shapes are near-identical anyway.

    Decision: a rate prior maps the stereo-pair rate to a base band
    (off at >= 88 kbps, down to band 6 toward 24 kbps), then the
    measured per-band |corr(L, R)| of the normalized shapes shifts it
    by up to +-2 bands (collapsing uncorrelated shapes hurts; highly
    correlated ones are free).  An EMA keeps the signaled value
    stable; the allocator clamps to codedBands (celt.py:521).
    """
    nb = mode.nbEBands
    eBands = mode.eBands
    if kbps >= 88.0:
        target = float(end)
    else:
        base = float(np.interp(kbps, [24.0, 88.0], [6.0, end]))
        b0 = int(max(start + 1, min(end - 1, round(base))))
        num = den = 0.0
        W = M * int(eBands[nb])
        for b in range(b0, end):
            lo = M * int(eBands[b])
            hi = M * int(eBands[b + 1])
            l = X[lo:hi] if X.ndim == 1 else X[0, lo:hi]
            r = (X[W + lo : W + hi] if X.ndim == 1 else X[1, lo:hi])
            el = float(np.dot(l, l))
            er = float(np.dot(r, r))
            if el < 1e-10 or er < 1e-10:
                continue
            w = hi - lo
            num += w * abs(float(np.dot(l, r))) / np.sqrt(el * er)
            den += w
        corr = num / den if den else 1.0
        target = base + (-2.0 if corr > 0.85 else
                         2.0 if corr < 0.3 else 0.0)
    st.intensity_avg = 0.7 * st.intensity_avg + 0.3 * target
    return int(max(start + 1, min(end, round(st.intensity_avg))))


def dual_stereo_decision(freq, mode, M, start, end, st):
    """Dual-stereo (code L/R shapes separately) vs the default
    theta-split M/S — the surface of the reference encoder's
    stereo_analysis (celt_encoder.c), ORIGINAL criterion.

    The coder spends bits proportional to how spread the per-band log
    energies are across the two coded shapes: identical channels make
    the side collapse (M/S wins), hard-panned channels make one L/R
    channel collapse (dual wins).  Compare the width-weighted sums of
    clamped log2 band energies in both domains and flip to dual only
    when L/R is decisively more compact (EMA + margin so the signaled
    bit doesn't thrash; M/S is the tie default)."""
    eBands = mode.eBands
    L, R = freq[0], freq[1]
    mid = 0.5 * (L + R)
    side = 0.5 * (L - R)
    cost_lr = cost_ms = 0.0
    for b in range(start, end):
        lo = M * int(eBands[b])
        hi = M * int(eBands[b + 1])
        w = hi - lo
        def le(x):
            return max(np.log2(float(np.dot(x[lo:hi], x[lo:hi]))
                               + 1e-15), -20.0)
        cost_lr += w * (le(L) + le(R))
        cost_ms += w * (le(mid) + le(side))
    width = M * int(eBands[end])
    margin = (cost_ms - cost_lr) / max(width, 1)   # >0: L/R more compact
    st.dual_avg = 0.7 * st.dual_avg + 0.3 * margin
    return 1 if st.dual_avg > 1.0 else 0


def dynalloc_analysis(bandLogE, start, end, C, eBands, LM, cap):
    """Tonality-driven boost analysis (the idea of the reference
    encoder's dynalloc_analysis, celt_encoder.c:889, in our own
    formulation): a slow-attack VALLEY follower rides the band
    spectrum from both sides (rise limited to 1.5 dB/band forward,
    2 dB/band backward), so isolated tonal peaks poke far above it;
    the excess buys extra allocation for exactly those bands.  A
    ridge/max follower cannot work here — it contains each band's own
    energy, so a lone peak never exceeds it (the round-3 bug that
    left pure tones 12 dB behind libopus at matched rates).

    Returns per-band desired boost in eighth-bits (the encode loop
    buys whole decoder-grammar quanta up to these)."""
    nb = bandLogE.shape[1] if bandLogE.ndim == 2 else len(bandLogE)
    e2 = np.atleast_2d(bandLogE)
    Cn = e2.shape[0]
    # perceptual noise floor (celt_encoder.c:908): band width, depth,
    # eMeans and a bark-ish (i+5)^2 preemphasis term — boosts below it
    # would spend bits on content the ear can't use
    mode = mode48000()
    idx = np.arange(nb)
    noise_floor = (0.0625 * np.asarray(mode.logN[:nb], np.float64)
                   + 0.5 - 15.0 + 0.0062 * (idx + 5) ** 2
                   - np.asarray(mode.eMeans[:nb], np.float64))
    followers = np.empty_like(e2)
    for c in range(Cn):
        e = e2[c]
        fol = np.empty(nb)
        fol[0] = e[0]
        last = 0
        for i in range(1, end):
            # the last clearly-rising band bounds the backward pass
            # (bandlimited signals would otherwise boost the cutoff)
            if e[i] > e[i - 1] + 0.5:
                last = i
            fol[i] = min(fol[i - 1] + 1.5, e[i])
        fol[end:] = e[end:] if end < nb else fol[end:]
        for i in range(last - 1, -1, -1):
            fol[i] = min(fol[i], fol[i + 1] + 2.0, e[i])
        followers[c] = np.maximum(fol, noise_floor)
    if Cn == 2:
        # cross-talk: a tone in one channel raises the other channel's
        # floor (limits boosting content the ear localizes anyway)
        fL = followers[0, start:end].copy()
        fR = followers[1, start:end].copy()
        followers[0, start:end] = np.maximum(fL, fR - 4.0)
        followers[1, start:end] = np.maximum(fR, fL - 4.0)
    excess = np.maximum(0.0, e2 - followers).mean(axis=0)
    # perceptual shaping: low bands matter double, high bands half;
    # bound any single band's boost at 4 dB worth
    excess[:8] *= 2.0
    excess[12:] *= 0.5
    excess = np.minimum(excess, 4.0)
    boosts = np.zeros(nb, np.int64)
    for i in range(start, end):
        width = C * (int(eBands[i + 1]) - int(eBands[i])) << LM
        # ~one extra bit per coefficient per dB of tonal excess
        want = int(excess[i] * width * 8)          # eighth-bits
        boosts[i] = min(want, int(cap[i]))
    return boosts


def alloc_trim_analysis(bandLogE, start, end):
    """Tilt-driven trim (reference alloc_trim_analysis'
    spectral-slope term, celt_encoder.c:1217): the energy-weighted
    tilt diff = mean_i e[i]*(2+2i-end) is positive for bright spectra
    (trim down: more bits high) and negative for bass-heavy ones
    (trim up: more bits low).  Index range 0..10, neutral 5.  The
    stereo-correlation and MLP-tonality terms of the reference need
    inputs this analysis pass doesn't carry; the slope term is what
    moves music (bass-heavy content earns trim 6-7, worth >1 dB at
    matched rates on sb-reverie)."""
    if end - start < 4:
        return 5
    i = np.arange(0, end - 1)
    diff = float(
        (np.mean(bandLogE[:, : end - 1], axis=0)
         * (2 + 2 * i - end)).sum()) / (end - 1)
    trim = 5.0 - np.clip((diff + 1.0) / 6.0, -2.0, 2.0)
    return int(np.clip(np.floor(0.5 + trim), 0, 10))


def transient_detect(pcm_win: np.ndarray, N: int, n_short: int) -> int:
    """Attack detector (simplified from celt_encoder.c transient_analysis):
    a sub-block whose energy jumps far above everything before it within
    the frame marks a transient, which switches to 8 short MDCTs so the
    attack does not pre-echo across the whole 20 ms window."""
    x = pcm_win[:, :N]
    e = (x.reshape(x.shape[0], N // n_short, n_short) ** 2).sum(
        axis=(0, 2)) + 1e-9
    prev = e[0]
    for b in range(1, len(e)):
        if e[b] > 24.0 * prev and e[b] > 1e3:
            return 1
        prev = max(prev, e[b])
    return 0


def celt_encode_frame(st: CeltEncoderState, pcm_win: np.ndarray,
                      nbytes: int, LM: int = 3, enc=None,
                      pf=None) -> bytes:
    """Encode one CELT frame (intra energy; frame length 120 << LM).

    Args:
      pcm_win: [C, N + overlap] input windows (frame advance N), scaled
        to the CELT signal domain (+-32768 * gain handled by caller).
      nbytes: target packet payload size (CBR, excluding the TOC byte).
      LM: 0..3 -> 2.5/5/10/20 ms frames.
      enc: optional shared RangeEncoder (hybrid mode: SILK bits already
        written; nbytes is then the WHOLE payload size and the caller
        finalizes the coder — celt_encode_with_ec's contract).
    Returns the compressed frame payload (b"" when enc is shared).
    """
    mode = mode48000()
    C = st.channels
    M = 1 << LM
    N = M * mode.shortMdctSize
    eBands = mode.eBands
    nbEBands = mode.nbEBands

    external = enc is not None
    if not external:
        enc = RangeEncoder(nbytes)
    total_bits = nbytes * 8

    n_short = mode.shortMdctSize
    isTransient = transient_detect(pcm_win, N, n_short) if LM > 0 else 0
    if isTransient:
        # B=8 short MDCTs, spectra interleaved like the decoder reads
        # them (celt_synthesize_host: freq[c, b::B][:n_short])
        freq = np.zeros((C, N))
        for c in range(C):
            for b in range(M):
                sub = mdct_forward(
                    pcm_win[c, n_short * b : n_short * b + 2 * n_short],
                    2 * n_short, mode.overlap)
                freq[c, b::M] = sub
    else:
        freq = np.stack([
            mdct_forward(pcm_win[c], 2 * N, mode.overlap) for c in range(C)
        ])
    effEnd = min(st.end, mode.effEBands)
    freq[:, M * int(eBands[effEnd]):] = 0.0

    bandE = compute_band_energies(mode, freq, C, M)
    X = normalise_bands(mode, freq, bandE, C, M)
    bandLogE = np.log2(np.maximum(bandE, 1e-27)) - np.asarray(
        mode.eMeans[:nbEBands]
    )

    tell = enc.tell()
    # silence flag: only a FRESH CELT frame codes it — the decoder
    # (celt_decoder.c and ours) reads it iff tell == 1, so a hybrid
    # frame (SILK bits already in the coder) must NOT write it
    if tell == 1:
        enc.enc_bit_logp(0, 15)
    tell = enc.tell()
    # postfilter signaling (start == 0 frames only; pf from the
    # prefilter pass: (pf_on, pitch_index, qg, tapset))
    if st.start == 0 and tell + 16 <= total_bits:
        if pf is not None and pf[0]:
            enc.enc_bit_logp(1, 1)
            t1 = pf[1] + 1
            octave = t1.bit_length() - 5   # EC_ILOG
            enc.enc_uint(octave, 6)
            enc.enc_bits(t1 - (16 << octave), 4 + octave)
            enc.enc_bits(pf[2], 3)
            if enc.tell() + 2 <= total_bits:
                enc.enc_icdf(pf[3], TAPSET_ICDF, 2)
        else:
            enc.enc_bit_logp(0, 1)
        tell = enc.tell()
    if LM > 0 and tell + 3 <= total_bits:
        enc.enc_bit_logp(isTransient, 3)
        tell = enc.tell()
    else:
        isTransient = 0
    shortBlocks = M if isTransient else 0
    # intra/inter energy: trial-code both on scratch coders (range
    # cost depends only on the symbols, not prior coder state) and
    # keep the cheaper, including the flag's own cost.  The decoder
    # assumes INTER when the flag doesn't fit (celt.py:2235).
    if C == 1:
        # the decoder merges rows at frame start (celt.py:2202)
        st.oldEBands[0, :] = np.maximum(st.oldEBands[0],
                                        st.oldEBands[1])
    if tell + 3 <= total_bits:
        if getattr(st, "force_intra", False):
            # first coded frame after a DTX gap: the decoder's energy
            # memory drifted through its comfort-noise hold, so inter
            # prediction would desync — intra is self-contained
            intra = True
            st.force_intra = False
        else:
            cost = {}
            for trial_intra in (True, False):
                sc = RangeEncoder(nbytes)
                quant_coarse_energy(
                    mode, st.start, st.end, bandLogE,
                    st.oldEBands.copy(), sc, C, LM, total_bits,
                    intra=trial_intra)
                cost[trial_intra] = sc.tell_frac()
            intra = cost[True] + (3 << 3) <= cost[False] + 2
        enc.enc_bit_logp(1 if intra else 0, 3)
    else:
        intra = False
    error = quant_coarse_energy(
        mode, st.start, st.end, bandLogE, st.oldEBands, enc, C, LM,
        total_bits, intra=intra,
    )
    if isTransient:
        # keep the short blocks' time resolution everywhere
        tf_vals = tf_encode_uniform(st.start, st.end, 1, LM, enc, 1)
    elif LM >= 2:
        # mono analysis on the mid channel (stereo bands share tf)
        Xa = X[0] if C == 1 else (X[0] + X[1]) * 0.5
        wants = tf_analysis(Xa, st.start, st.end, eBands, LM)
        tf_vals = tf_encode(st.start, st.end, 0, LM, enc, wants)
    else:
        # 2.5/5 ms frames already have fine time resolution
        tf_vals = tf_encode_uniform(st.start, st.end, 0, LM, enc, 0)

    tell = enc.tell()
    spread_val = SPREAD_NORMAL     # the decoder's unsignaled default
    if tell + 4 <= total_bits:
        spread_val = spreading_decision(X, mode, M, st.start, effEnd,
                                        C, st)
        enc.enc_icdf(spread_val, SPREAD_ICDF, 5)

    cap = init_caps(mode, LM, C)
    offsets = [0] * nbEBands
    desired = dynalloc_analysis(bandLogE, st.start, st.end, C, eBands,
                                LM, cap)
    dynalloc_logp = 6
    total_bits_q3 = total_bits << BITRES
    tell_q3 = enc.tell_frac()
    for i in range(st.start, st.end):
        width = C * (int(eBands[i + 1]) - int(eBands[i])) << LM
        quanta = min(width << BITRES, max(6 << BITRES, width))
        dynalloc_loop_logp = dynalloc_logp
        boost = 0
        # mirror of the decoder's dynalloc grammar: a 1 flag buys one
        # quanta (first flag costs dynalloc_logp bits, the rest 1 bit),
        # a 0 flag terminates; hitting cap terminates implicitly
        while (tell_q3 + (dynalloc_loop_logp << BITRES) < total_bits_q3
                and boost < cap[i]):
            flag = 1 if boost + quanta <= desired[i] else 0
            enc.enc_bit_logp(flag, dynalloc_loop_logp)
            tell_q3 = enc.tell_frac()
            if not flag:
                break
            boost += quanta
            total_bits_q3 -= quanta
            dynalloc_loop_logp = 1
        offsets[i] = boost
        if boost > 0:
            dynalloc_logp = max(2, dynalloc_logp - 1)

    alloc_trim = alloc_trim_analysis(bandLogE, st.start, st.end)
    if tell_q3 + (6 << BITRES) <= total_bits_q3:
        enc.enc_icdf(alloc_trim, TRIM_ICDF, 7)
        tell_q3 = enc.tell_frac()

    bits = (nbytes * 8 << BITRES) - enc.tell_frac() - 1
    anti_collapse_rsv = (
        1 << BITRES
        if isTransient and LM >= 2 and bits >= ((LM + 2) << BITRES)
        else 0
    )
    bits -= anti_collapse_rsv
    if C == 2:
        # stereo-pair payload rate in kbps (frame is (120 << LM)/48 ms)
        kbps = nbytes * 8.0 * 48.0 / (120 << LM)
        chosen_int = intensity_decision(X, mode, M, st.start, effEnd,
                                        st, kbps)
        chosen_dual = dual_stereo_decision(freq, mode, M, st.start,
                                           effEnd, st)
    else:
        chosen_int = st.end
        chosen_dual = 0
    (codedBands, balance, pulses, fine_quant, fine_priority,
     intensity, dual_stereo) = compute_allocation(
        mode, st.start, st.end, offsets, cap, alloc_trim, bits, C, LM, enc,
        chosen_intensity=chosen_int, chosen_dual=chosen_dual,
    )

    quant_fine_energy(
        mode, st.start, st.end, st.oldEBands, error, fine_quant, enc, C
    )

    collapse_masks = [0] * (C * nbEBands)
    Xflat = np.concatenate([X[c] for c in range(C)])
    Xv = Xflat[: M * int(eBands[nbEBands])]
    Yv = Xflat[M * int(eBands[nbEBands]):] if C == 2 else None
    st.rng = quant_all_bands(
        mode, st.start, st.end, Xv, Yv, collapse_masks, pulses,
        shortBlocks, spread_val, dual_stereo, intensity,
        list(tf_vals) + [0] * (nbEBands - len(tf_vals)),
        nbytes * (8 << BITRES) - anti_collapse_rsv, balance, enc, LM,
        codedBands, st.rng, bandE,
    )

    if anti_collapse_rsv:
        # enable noise filling when any coded band actually collapsed in
        # some sub-block (celt_encoder.c sets this from the collapse
        # masks); the decoder then runs anti_collapse and avoids
        # sputtering silence in short blocks
        full = (1 << M) - 1
        collapsed = any(
            (collapse_masks[i * C + c] & full) != full
            for c in range(C)
            for i in range(st.start, codedBands)
        )
        enc.enc_bits(1 if collapsed else 0, 1)

    quant_energy_finalise(
        mode, st.start, st.end, st.oldEBands, error, fine_quant,
        fine_priority, nbytes * 8 - enc.tell(), enc, C,
    )

    # mirror the decoder's end-of-frame energy state so inter-coded
    # frames predict from the SAME values the decoder holds
    # (celt.py:2360-2366: mono row copy, out-of-range bands zeroed)
    if C == 1:
        st.oldEBands[1, :] = st.oldEBands[0, :]
    st.oldEBands[:, : st.start] = 0.0
    st.oldEBands[:, st.end:] = 0.0

    if external:
        if enc.error:
            raise RuntimeError("range encoder overflow")
        return b""
    data = enc.done()
    if enc.error:
        raise RuntimeError("range encoder overflow")
    return data


# ---------------------------------------------------------------------------
# Ogg Opus file encoding (RFC 7845 mux around the CELT frames)
# ---------------------------------------------------------------------------

PREEMPH_COEF = 0.85000610351562500
FRAME = 960            # 20 ms at 48 kHz
PRESKIP = 312
VENDOR = b"libnyquist_torch"   # OpusTags vendor string


def encode_ogg_opus(samples: np.ndarray, channels: int, sample_rate: int,
                    bitrate_kbps: int = 96, vbr: bool = True,
                    frame_ms: float = 20, dtx: bool = False) -> bytes:
    """Encode interleaved float32 [-1, 1] PCM to an Ogg Opus byte string.

    CELT-only fullband frames of 2.5/5/10/20 ms (TOC configs 28-31,
    RFC 6716 table 2). Input must be 48 kHz (callers resample first,
    ops/src.py); mono or stereo.

    vbr=True runs constrained VBR: each frame's size follows its
    dynalloc demand (tonal peaks) and loudness, banking bytes from quiet
    frames into a bounded reservoir so the average rate stays at or
    under the target (the reference encoder's constrained-VBR contract;
    our rate control is an original loudness+boost heuristic, not a
    port).  vbr=False keeps the old CBR behavior.
    """
    packets, S = celt_encode_packets(samples, channels, sample_rate,
                                     bitrate_kbps, vbr, frame_ms,
                                     dtx=dtx)
    frame = 120 << {2.5: 0, 5: 1, 10: 2, 20: 3}[frame_ms]
    return ogg_opus_wrap(packets, channels, S, frame, PRESKIP)


def celt_encode_packets(samples: np.ndarray, channels: int,
                        sample_rate: int, bitrate_kbps: int = 96,
                        vbr: bool = True,
                        frame_ms: float = 20,
                        dtx: bool = False,
                        preskip: int | None = None) -> tuple[list, int]:
    """Encode PCM to a list of finished Opus packets (TOC included).
    Returns (packets, input_samples).  The container-free form both
    the single-stream Ogg writer and the multistream combiner build
    on (reference: opus_encoder.c produces packets the same way for
    opus_multistream_encoder.c to frame)."""
    if sample_rate != 48000:
        raise ValueError("opus encoding requires 48 kHz input (resample)")
    if channels not in (1, 2):
        raise ValueError("opus encoding supports mono or stereo")
    lm_by_ms = {2.5: 0, 5: 1, 10: 2, 20: 3}
    if frame_ms not in lm_by_ms:
        raise ValueError("frame_ms must be one of 2.5, 5, 10, 20")
    LM = lm_by_ms[frame_ms]
    frame = 120 << LM

    pcm = np.asarray(samples, np.float64).reshape(-1, channels).T  # [C, S]
    S = pcm.shape[1]
    # preskip priming + frame padding (preskip=0: mid-stream segment
    # of a mixed-mode auto encode — no lead, fresh state)
    if preskip is None:
        preskip = PRESKIP
    lead = np.zeros((channels, preskip), np.float64)
    pcm = np.concatenate([lead, pcm], axis=1)
    F = -(-pcm.shape[1] // frame)
    pad = F * frame + mode48000().overlap - pcm.shape[1]
    pcm = np.concatenate([pcm, np.zeros((channels, pad))], axis=1)

    # celt_preemphasis (celt.c): x'[n] = SIG_SCALE*(x[n] - c*x[n-1])
    pre = np.empty_like(pcm)
    pre[:, 0] = 32768.0 * pcm[:, 0]
    pre[:, 1:] = 32768.0 * (pcm[:, 1:] - PREEMPH_COEF * pcm[:, :-1])

    base = max(12, int(bitrate_kbps * 1000 * (frame / 48000.0) / 8))
    st = CeltEncoderState(channels)
    mode = mode48000()

    # pitch prefilter (the decoder's postfilter re-adds the harmonics)
    if LM >= 2:
        pre, pf_params = run_prefilter(pre, F, frame, mode.overlap,
                                       np.asarray(mode.window),
                                       mode.shortMdctSize)
    else:
        pf_params = [None] * F
    # CELT fullband configs 28..31 = 2.5/5/10/20 ms (RFC 6716 §3.1)
    toc = ((28 + LM) << 3) | ((1 if channels == 2 else 0) << 2)
    packets = []
    overlap = mode.overlap
    M = 1 << LM
    cap = init_caps(mode, LM, channels)
    reservoir = 2.0 * base          # banked bytes (bounded credit)
    loud_avg = None
    silent_run = 0
    for k in range(F):
        if dtx:
            seg = pcm[:, k * frame : (k + 1) * frame]
            if np.sqrt(np.mean(seg * seg)) * 32768.0 < 40.0:
                silent_run += 1
                if silent_run > 1 and silent_run % 20:
                    # TOC-only DTX hold; the next coded frame is
                    # forced intra (self-contained energies) since the
                    # decoder's energy memory decays through its PLC
                    packets.append(bytes([toc]))
                    st.force_intra = True
                    reservoir = min(reservoir + base - 1, 8.0 * base)
                    continue
            else:
                silent_run = 0
        win = pre[:, k * frame : k * frame + frame + overlap]
        nbytes = base
        if vbr:
            freq_a = np.stack([
                mdct_forward(win[c], 2 * frame, overlap)
                for c in range(channels)
            ])
            bandE_a = compute_band_energies(mode, freq_a, channels, M)
            bandLogE_a = np.log2(np.maximum(bandE_a, 1e-27)) - np.asarray(
                mode.eMeans[: mode.nbEBands])
            boosts = dynalloc_analysis(
                bandLogE_a, st.start, st.end, channels,
                mode.eBands, LM, cap)
            demand = int(boosts.sum()) // 64        # eighth-bits -> bytes
            loud = float(np.mean(
                np.maximum(bandLogE_a, -10.0)[:, st.start : st.end]))
            if loud_avg is None:
                loud_avg = loud
            relief = int(np.clip((loud_avg - loud) * 1.5, 0, base * 0.4))
            loud_avg = 0.95 * loud_avg + 0.05 * loud
            want = base + min(demand, base) - relief
            nbytes = int(np.clip(
                want, 12, base + max(0.0, min(reservoir, base))))
            reservoir = min(reservoir + base - nbytes, 8.0 * base)
        packets.append(bytes([toc])
                       + celt_encode_frame(st, win, nbytes, LM,
                                           pf=pf_params[k]))

    return packets, S


# RFC 7845 §5.1.1.2 channel mapping family 1 (Vorbis order), mirrored
# from the layouts the reference encoder uses
# (opus_multistream_encoder.c:52 vorbis_mappings): channels ->
# (streams, coupled_streams, mapping).
VORBIS_LAYOUTS = {
    1: (1, 0, (0,)),
    2: (1, 1, (0, 1)),
    3: (2, 1, (0, 2, 1)),
    4: (2, 2, (0, 1, 2, 3)),
    5: (3, 2, (0, 4, 1, 2, 3)),
    6: (4, 2, (0, 4, 1, 2, 3, 5)),
    7: (4, 3, (0, 4, 1, 2, 3, 5, 6)),
    8: (5, 3, (0, 6, 1, 2, 3, 4, 5, 7)),
}


def self_delimit(pkt: bytes) -> bytes:
    """Code-0/1/2/3 packet -> RFC 6716 Appendix B self-delimited form
    (multistream packets carry every stream but the last this way)."""
    code = pkt[0] & 3
    if code == 0:
        frame = pkt[1:]
        n = len(frame)
    elif code in (1, 2):
        raise ValueError("multistream combiner emits code-0 packets")
    else:
        raise ValueError("multistream combiner emits code-0 packets")
    if n < 252:
        size = bytes([n])
    else:
        b1 = 252 + ((n - 252) % 4)
        size = bytes([b1, (n - b1) // 4])
    return bytes([pkt[0]]) + size + frame


def encode_ogg_opus_multistream(samples: np.ndarray, channels: int,
                                sample_rate: int,
                                bitrate_kbps: int | None = None,
                                vbr: bool = True,
                                frame_ms: float = 20) -> bytes:
    """Encode 1-8 channel interleaved PCM to Ogg Opus with channel
    mapping family 1 (RFC 7845 §5.1.1.2; the reference's surround
    encoder surface, opus_multistream_encoder.c).

    Channels follow Vorbis surround order (L C R ... LFE).  Coupled
    streams carry channel pairs, mono streams the rest; per the
    decoder mapping out[i] = stream_channels[mapping[i]].
    bitrate_kbps is the TOTAL target; it splits 2:1 between coupled
    and mono streams (default 48 kbps per channel)."""
    if channels not in VORBIS_LAYOUTS:
        raise ValueError("multistream encoding supports 1-8 channels")
    if channels <= 2:
        return encode_ogg_opus(samples, channels, sample_rate,
                               bitrate_kbps or 48 * channels, vbr,
                               frame_ms)
    streams, coupled, mapping = VORBIS_LAYOUTS[channels]
    total_kbps = bitrate_kbps or 48 * channels
    shares = 2 * coupled + (streams - coupled)
    kbps_coupled = max(16, int(total_kbps * 2 / shares))
    kbps_mono = max(12, int(total_kbps / shares))

    pcm = np.asarray(samples, np.float64).reshape(-1, channels)
    # stream channel j <- input channel i where mapping[i] == j
    inv = {j: i for i, j in enumerate(mapping)}
    all_pkts = []
    S = None
    for s in range(streams):
        if s < coupled:
            ch_idx = [inv[2 * s], inv[2 * s + 1]]
            nch, kbps = 2, kbps_coupled
        else:
            ch_idx = [inv[coupled + s]]
            nch, kbps = 1, kbps_mono
        sub = np.ascontiguousarray(pcm[:, ch_idx]).reshape(-1)
        pkts, S = celt_encode_packets(sub, nch, sample_rate, kbps, vbr,
                                      frame_ms)
        all_pkts.append(pkts)

    combined = []
    for frame_pkts in zip(*all_pkts):
        ms = b"".join(self_delimit(p) for p in frame_pkts[:-1])
        combined.append(ms + frame_pkts[-1])
    frame = 120 << {2.5: 0, 5: 1, 10: 2, 20: 3}[frame_ms]
    return ogg_opus_wrap(combined, channels, S, frame, PRESKIP,
                         layout=(streams, coupled, mapping))


def ogg_opus_wrap(packets, channels, input_samples, frame_48k,
                  preskip, layout=None) -> bytes:
    """Wrap finished Opus packets (TOC included) in an Ogg stream:
    OpusHead/OpusTags + ~1 s data pages with correct granule positions
    and end trimming (RFC 7845).  layout=(streams, coupled, mapping)
    selects channel mapping family 1 (multistream)."""
    from ..ogg import write_page, write_page_multi

    if layout is None:
        family = bytes([0])
    else:
        streams, coupled, mapping = layout
        family = bytes([1, streams, coupled]) + bytes(mapping)
    head = (b"OpusHead" + bytes([1, channels])
            + struct.pack("<HIh", preskip, 48000, 0) + family)
    tags = (b"OpusTags" + struct.pack("<I", len(VENDOR)) + VENDOR
            + struct.pack("<I", 0))
    serial = 0x4C4E5154
    pages = [write_page(head, 0, serial, 0, bos=True),
             write_page(tags, 0, serial, 1)]
    total = preskip + input_samples
    seq = 2
    PER_PAGE = max(1, 48000 // frame_48k)  # ~1 s pages, like opusenc
    idx = 0
    while idx < len(packets):
        # fill a page: at most PER_PAGE packets and 255 lacing segments
        take, segs = 0, 0
        while (idx + take < len(packets) and take < PER_PAGE):
            need = len(packets[idx + take]) // 255 + 1
            if segs + need > 255:
                break
            segs += need
            take += 1
        sub = packets[idx : idx + take]
        idx += take
        granule = min(frame_48k * idx, total)
        pages.append(write_page_multi(sub, granule, serial, seq,
                                      eos=(idx >= len(packets))))
        seq += 1
    return b"".join(pages)
