"""CELT packet-loss concealment (host side).

Upstream libopus conceals a lost CELT frame in one of two ways
(celt_decoder.c:351 celt_decode_lost; the reference fork's clean decoder
stripped it):

* noise (five losses in a row, or a hybrid frame's CELT half, which
  starts at band 17): the bands are refilled with unit-norm noise scaled
  by the last energies decayed toward the background floor.
  ``celt_noise_frame`` returns that frame's spectra; the frame then
  queues for the card's synthesis like a decoded one.
* pitch (otherwise): serial float work over the synthesis history, so
  ``celt_decode_lost_pitch`` runs on the host over the history the card
  hands back (``runtime/opus_pipeline.py`` ``CeltLane.history``), and
  the lane takes the updated state back.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from .celt_frame import celt_lcg_rand, denormalise_bands, frame_lm
from .celt_host import COMBFILTER_MINPERIOD, CeltDecoderState
from .celt_tables import COMB_GAINS, mode48000

DECODE_BUFFER_SIZE = 2048
VERY_SMALL = 1e-30
CELT_SIG_SCALE = 32768.0
PLC_PITCH_LAG_MAX = 720           # celt_decoder.c:346
PLC_PITCH_LAG_MIN = 100           # celt_decoder.c:349
LPC_ORDER = 24
MAX_PERIOD = 1024


def uses_pitch(st: CeltDecoderState, loss_count: int) -> bool:
    """Whether a loss conceals by pitch (else by noise)."""
    return loss_count < 5 and st.start == 0


def celt_noise_frame(st: CeltDecoderState, frame_size: int,
                     loss_count: int) -> dict:
    """Noise-mode concealment of one lost frame: decays the energies
    toward the background floor (celt_decoder.c:447-456), refills the
    bands with seeded noise and returns the frame's info dict (the
    synthesis input, as ``celt_decode_frame_to_freq`` returns it), with
    the postfilter parameters left as they were."""
    mode = mode48000()
    LM = frame_lm(frame_size)
    M = 1 << LM
    N = M * mode.shortMdctSize
    CC = st.channels
    eBands = mode.eBands
    effEnd = min(st.end, mode.effEBands)

    decay = 1.5 if loss_count == 0 else 0.5
    bg = st.backgroundLogE.reshape(2, -1)
    for c in range(2):
        st.oldEBands[c, st.start:st.end] = np.maximum(
            bg[c, st.start:st.end],
            st.oldEBands[c, st.start:st.end] - decay,
        )

    seed = st.rng
    freq = np.zeros((CC, N))
    X = np.zeros(N)
    for c in range(CC):
        for i in range(st.start, effEnd):
            lo, hi = M * int(eBands[i]), M * int(eBands[i + 1])
            blen = hi - lo
            vals = np.empty(blen)
            for j in range(blen):
                seed = celt_lcg_rand(seed)
                s32 = seed - 0x100000000 if seed >= 0x80000000 else seed
                vals[j] = float(s32 >> 20)
            nrm = np.sqrt(np.sum(vals * vals))
            X[lo:hi] = vals / nrm if nrm > 0 else 0.0
        denormalise_bands(mode, X, freq[c], st.oldEBands[c],
                          st.start, effEnd, M)
    st.rng = seed
    return dict(
        N=N, CC=CC, C=CC, LM=LM, shortBlocks=0, freq=freq, silence=0,
        postfilter_pitch=st.postfilter_period,
        postfilter_gain=st.postfilter_gain,
        postfilter_tapset=st.postfilter_tapset,
    )


# --- pitch analysis (float semantics of upstream celt/pitch.c and
# celt/celt_lpc.c) ------------------------------------------------------

def _plc_autocorr(x: np.ndarray, window, overlap: int,
                  lag: int) -> np.ndarray:
    """_celt_autocorr (celt_lpc.c): edge-windowed autocorrelation."""
    xx = x.astype(np.float64, copy=True)
    n = len(xx)
    if overlap:
        xx[:overlap] *= window[:overlap]
        xx[n - overlap:] *= window[:overlap][::-1]
    return np.array([np.dot(xx[k:], xx[: n - k]) for k in range(lag + 1)])


def _plc_lpc(ac: np.ndarray, p: int) -> np.ndarray:
    """_celt_lpc (celt_lpc.c): Levinson-Durbin with 30 dB early exit."""
    lpc = np.zeros(p)
    error = ac[0]
    if ac[0] != 0:
        for i in range(p):
            rr = float(np.dot(lpc[:i], ac[i:0:-1])) + ac[i + 1]
            r = -rr / error
            lpc[i] = r
            jj = np.arange((i + 1) >> 1)
            tmp1 = lpc[jj].copy()
            tmp2 = lpc[i - 1 - jj].copy()
            lpc[jj] = tmp1 + r * tmp2
            lpc[i - 1 - jj] = tmp2 + r * tmp1
            error -= r * r * error
            if error < 0.001 * ac[0]:
                break
    return lpc


def _plc_fir(x: np.ndarray, num: np.ndarray, mem: np.ndarray) -> np.ndarray:
    """celt_fir (celt_lpc.c): y[i] = x[i] + sum_j num[j]*x[i-1-j]."""
    full = np.concatenate([mem[::-1], x])
    ord_ = len(num)
    conv = np.convolve(full, num)
    return x + conv[ord_ - 1 : ord_ - 1 + len(x)]


def _plc_iir(x: np.ndarray, den: np.ndarray, mem: np.ndarray) -> np.ndarray:
    """celt_iir (celt_lpc.c): y[i] = x[i] - sum_j den[j]*y[i-1-j]."""
    ord_ = len(den)
    y = np.empty(len(x) + ord_)
    y[:ord_] = mem[::-1]
    rden = den[::-1]
    for i in range(len(x)):
        y[ord_ + i] = x[i] - np.dot(rden, y[i : i + ord_])
    return y[ord_:]


def _plc_pitch_downsample(chans: np.ndarray) -> np.ndarray:
    """pitch_downsample (pitch.c:147): 2x low-pass decimation summed
    over channels, then 4th-order LPC whitening via a 5-tap FIR."""
    n = chans.shape[1]
    lp = np.zeros(n >> 1)
    for x in chans:
        lp[1:] += 0.25 * (x[1 : n - 1 : 2] + x[3:n:2]) + 0.5 * x[2:n:2]
        lp[0] += 0.25 * x[1] + 0.5 * x[0]
    ac = _plc_autocorr(lp, None, 0, 4)
    ac[0] *= 1.0001
    for i in range(1, 5):
        ac[i] -= ac[i] * (0.008 * i) * (0.008 * i)
    lpc = _plc_lpc(ac, 4)
    tmp = 1.0
    for i in range(4):
        tmp *= 0.9
        lpc[i] *= tmp
    c1 = 0.8
    lpc2 = np.array([lpc[0] + 0.8, lpc[1] + c1 * lpc[0],
                     lpc[2] + c1 * lpc[1], lpc[3] + c1 * lpc[2],
                     c1 * lpc[3]])
    return _plc_fir(lp, lpc2, np.zeros(5))


def _plc_find_best_pitch(xcorr, y, len_, max_pitch):
    """find_best_pitch (pitch.c:45), float normalization."""
    best_num = [-1.0, -1.0]
    best_den = [0.0, 0.0]
    best_pitch = [0, 1]
    Syy = 1.0 + float(np.dot(y[:len_], y[:len_]))
    for i in range(max_pitch):
        if xcorr[i] > 0:
            x16 = xcorr[i] * 1e-12
            num = x16 * x16
            if num * best_den[1] > best_num[1] * Syy:
                if num * best_den[0] > best_num[0] * Syy:
                    best_num[1], best_den[1] = best_num[0], best_den[0]
                    best_pitch[1] = best_pitch[0]
                    best_num[0], best_den[0] = num, Syy
                    best_pitch[0] = i
                else:
                    best_num[1], best_den[1] = num, Syy
                    best_pitch[1] = i
        Syy += y[i + len_] * y[i + len_] - y[i] * y[i]
        Syy = max(1.0, Syy)
    return best_pitch


def _plc_pitch_search(x_lp: np.ndarray, y: np.ndarray, len_: int,
                      max_pitch: int) -> int:
    """pitch_search (pitch.c:296): 4x coarse, 2x refine, pseudo-interp."""
    lag = len_ + max_pitch
    x4 = x_lp[: (len_ >> 1) : 2][: len_ >> 2]
    y4 = y[: (lag >> 1) : 2][: lag >> 2]
    # coarse: xcorr[i] = sum_j x4[j] * y4[i+j]
    xc = np.correlate(y4, x4, "full")[len(x4) - 1 :][: max_pitch >> 2]
    best = _plc_find_best_pitch(xc, y4, len_ >> 2, max_pitch >> 2)
    xcorr = np.zeros(max_pitch >> 1)
    for i in range(max_pitch >> 1):
        if abs(i - 2 * best[0]) > 2 and abs(i - 2 * best[1]) > 2:
            continue
        xcorr[i] = max(-1.0, float(
            np.dot(x_lp[: len_ >> 1], y[i : i + (len_ >> 1)])))
    best = _plc_find_best_pitch(xcorr, y, len_ >> 1, max_pitch >> 1)
    offset = 0
    b0 = best[0]
    if 0 < b0 < (max_pitch >> 1) - 1:
        a, b, c = xcorr[b0 - 1], xcorr[b0], xcorr[b0 + 1]
        if (c - a) > 0.7 * (b - a):
            offset = 1
        elif (a - c) > 0.7 * (b - c):
            offset = -1
    return 2 * b0 - offset


def _comb_filter_np(y, x, off, T0, T1, N, g0, g1, tapset0, tapset1, window,
                    overlap):
    """In-place pitch postfilter in float64 (reference:
    celt/celt.c:114-172), here for the pre-filter of a concealed overlap.

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


@functools.lru_cache(maxsize=8)
def _deemph_toeplitz(coef: float, n: int):
    i = np.arange(n)
    d = i[:, None] - i[None, :]
    L = np.where(d >= 0, np.power(coef, np.maximum(d, 0.0)), 0.0)
    # the carried m is already coef*y_prev, so it enters y[0]
    # with unit weight: m-term coefficient for y[j] is coef^j
    powers = np.power(coef, i.astype(np.float64))
    # coef^d underflows to float32 DENORMALS past d ~ 540 (0.85^540 ~
    # 1e-38), and denormal operands run the GEMM ~10x slower; those
    # entries are far below float32 resolution of any partial sum, so
    # flush them to exact zeros.
    L[L < 1e-30] = 0.0
    powers = np.where(powers < 1e-30, 0.0, powers)
    return L, powers


def celt_decode_lost_pitch(st: CeltDecoderState, frame_size: int,
                           loss_count: int, decode_mem: np.ndarray,
                           preemph_memD: np.ndarray) -> np.ndarray:
    """Pitch-based concealment of one lost frame (upstream
    celt_decoder.c:465-678): LPC analysis over the decode history,
    periodic extrapolation of the excitation at the detected pitch with
    energy-decay tracking, re-synthesis through 1/A(z), an energy
    explosion clamp, and a simulated TDAC fold so the splice into the
    next real frame stays clickless.

    ``decode_mem`` [CC, DECODE_BUFFER_SIZE + overlap] (the postfiltered
    history, then the raw overlap tail) and ``preemph_memD`` [CC] (the
    deemphasis carry, coef times the last output) are the synthesis
    state brought to the host (``CeltLane.history``); both are updated in
    place. Returns pcm [frame_size, CC] float64."""
    mode = mode48000()
    N = frame_size
    CC = st.channels
    overlap = mode.overlap
    window = mode.window
    DB = DECODE_BUFFER_SIZE

    if loss_count == 0:
        lp = _plc_pitch_downsample(decode_mem[:, :DB])
        pitch = _plc_pitch_search(
            lp[PLC_PITCH_LAG_MAX >> 1 :], lp, DB - PLC_PITCH_LAG_MAX,
            PLC_PITCH_LAG_MAX - PLC_PITCH_LAG_MIN,
        )
        pitch_index = PLC_PITCH_LAG_MAX - pitch
        st.last_pitch_index = pitch_index
        fade = 1.0
    else:
        pitch_index = st.last_pitch_index
        fade = 0.8
    pitch_index = max(1, pitch_index)

    if st.plc_lpc is None:
        st.plc_lpc = np.zeros((CC, LPC_ORDER))
    for c in range(CC):
        buf = decode_mem[c]
        exc = buf[DB - MAX_PERIOD : DB].copy()

        if loss_count == 0:
            ac = _plc_autocorr(exc, window, overlap, LPC_ORDER)
            ac[0] *= 1.0001                       # -40 dB noise floor
            for i in range(1, LPC_ORDER + 1):
                ac[i] -= ac[i] * (0.008 * i) * (0.008 * i)  # lag window
            st.plc_lpc[c] = _plc_lpc(ac, LPC_ORDER)
        lpc = st.plc_lpc[c]

        exc_length = min(2 * pitch_index, MAX_PERIOD)
        lpc_mem = buf[DB - exc_length - 1 - np.arange(LPC_ORDER)].copy()
        exc[MAX_PERIOD - exc_length :] = _plc_fir(
            exc[MAX_PERIOD - exc_length :], lpc, lpc_mem)

        # Decay estimate over the last two half-periods of excitation.
        dl = exc_length >> 1
        e_new = exc[MAX_PERIOD - dl :]
        e_old = exc[MAX_PERIOD - 2 * dl : MAX_PERIOD - dl]
        E1 = 1.0 + float(np.dot(e_new, e_new))
        E2 = 1.0 + float(np.dot(e_old, e_old))
        E1 = min(E1, E2)
        decay = math.sqrt(E1 / E2)  # float build: SHR32 is a no-op

        # Slide history left one frame (OPUS_MOVE, celt_decoder.c:580).
        buf[: DB - N] = buf[N:DB]

        # Periodic extrapolation with per-period decay.
        eoff = MAX_PERIOD - pitch_index
        elen = N + overlap
        idx = np.arange(elen)
        j = idx % pitch_index
        att = fade * decay ** (1.0 + idx // pitch_index)
        buf[DB - N : DB - N + elen] = att * exc[eoff + j]
        src = buf[DB - MAX_PERIOD - N + eoff + j]
        S1 = float(np.dot(src, src))

        # Re-synthesize through 1/A(z) for signal-domain continuity.
        lpc_mem2 = buf[DB - N - 1 - np.arange(LPC_ORDER)].copy()
        seg = _plc_iir(buf[DB - N : DB - N + elen], lpc, lpc_mem2)
        buf[DB - N : DB - N + elen] = seg

        # Energy explosion clamp (celt_decoder.c:630-659).
        S2 = float(np.dot(seg, seg))
        if not (S1 > 0.2 * S2):
            buf[DB - N : DB - N + elen] = 0.0
        elif S1 < S2:
            ratio = math.sqrt((S1 + 1.0) / (S2 + 1.0))
            g = 1.0 - window * (1.0 - ratio)
            buf[DB - N : DB - N + overlap] *= g
            buf[DB - N + overlap : DB - N + elen] *= ratio

        # Pre-filter the overlap so the decoder's post-filter re-apply
        # on the next real frame cancels (celt_decoder.c:663-668).
        T = max(st.postfilter_period, COMBFILTER_MINPERIOD)
        g0 = st.postfilter_gain
        hist = T + 2
        scratch = buf[DB - hist : DB + overlap].copy()
        if g0 != 0.0:
            _comb_filter_np(scratch, scratch, hist, T, T, overlap,
                        -g0, -g0, st.postfilter_tapset,
                        st.postfilter_tapset, window, 0)
        etmp = scratch[hist : hist + overlap]

        # Simulated TDAC fold over the first half of the overlap.
        half = overlap // 2
        i = np.arange(half)
        buf[DB : DB + half] = (window[i] * etmp[overlap - 1 - i]
                               + window[overlap - 1 - i] * etmp[i])

    # Deemphasis of the concealed frame (same tail as the decode path).
    coef0 = mode.preemph[0]
    L, powers = _deemph_toeplitz(coef0, N)
    pcm = np.zeros((N, CC))
    for c in range(CC):
        m = preemph_memD[c]
        y = L @ (decode_mem[c, DB - N : DB] + VERY_SMALL) + powers * m
        preemph_memD[c] = coef0 * y[N - 1]
        pcm[:, c] = y * (1.0 / CELT_SIG_SCALE)
    return pcm
