"""Automatic Opus encode-mode selection (speech/music analysis).

The reference compiles libopus's analysis machinery — a tonality
tracker plus a small trained MLP that drives the encoder's per-frame
celt/silk/hybrid decision (reference:
third_party/opus/libopus/src/analysis.c, opus_encoder.c mode
plumbing; built via src/OpusDependencies.c:246-256).  The MLP weights
are trained data we must not copy, so this module is an ORIGINAL
detector: hand-designed spectral/temporal features feeding a tiny
logistic model that was fit on synthetic labelled audio generated by
tools/train_mode_classifier.py in this repo (run it to reproduce the
weights below — no external data, no reference data).

Feature design rationale (all computed per 20 ms frame, then
aggregated over a ~1 s sliding context):
  * syllabic modulation — speech alternates voiced bursts and gaps at
    2-8 Hz; the std of log-energy over the context window is high for
    speech, low for sustained music;
  * spectral flux burstiness — consonant onsets make speech flux
    spiky; steady music (pads, chords) is smooth, and even rhythmic
    music is *periodic* rather than bursty;
  * pitch glide — speech f0 slides continuously inside a voiced
    segment; music holds stable note pitches (or has no single f0);
  * harmonicity / flatness — separates tonal content from noise so
    the glide/modulation cues are only trusted where they mean
    something.

The decision layer maps smoothed speech probability to a mode with a
hysteresis band and a minimum dwell so the mode never thrashes
(opus_encoder.c keeps analogous hysteresis on its mode state).

Mode policy (mirrors the reference's coarse rate logic, not its
code): music or high rates -> CELT fullband; speech at low rates ->
SILK WB; speech at mid rates (or speech with significant energy above
8 kHz) -> hybrid FB.
"""

from __future__ import annotations

import numpy as np

FRAME = 960                    # 20 ms @ 48 kHz, the analysis grain
_EPS = 1e-12

# Pitch-lag search range for the harmonicity cue: 70..400 Hz @ 48 kHz.
_LAG_LO = 48000 // 400
_LAG_HI = 48000 // 70

# Logistic weights fit by tools/train_mode_classifier.py (synthetic
# corpus, seed 0; see that script for the generator zoo and the fit
# loop).  Feature order must match context_features() below.
_FEATURE_NAMES = (
    "mod_depth",      # std of log10 frame RMS over the context
    "flux_mean",      # mean normalized spectral flux
    "flux_std",       # flux burstiness
    "flat_mean",      # mean log spectral flatness (0..8 kHz)
    "voiced_frac",    # fraction of frames with clear pitch
    "pitch_glide",    # mean |d log f0| between voiced neighbours
    "harm_mean",      # mean pitch-autocorrelation peak height
    "pause_rate",     # fraction of frames >=10 dB under context peak
)
_WEIGHTS = np.array([
    8.36854, 11.87923, -7.18849, 0.88578,
    6.94946, -0.03791, 3.61917, 5.47751,
])
_BIAS = -7.02049


def frame_features(x: np.ndarray) -> dict:
    """Per-20 ms-frame raw features of a mono 48 kHz signal.

    Vectorized over all frames at once: one rfft batch gives the
    spectra, one irfft batch gives the pitch autocorrelations."""
    x = np.asarray(x, np.float64).reshape(-1)
    F = max(1, -(-len(x) // FRAME))
    x = np.concatenate([x, np.zeros(F * FRAME - len(x))])
    frames = x.reshape(F, FRAME)

    rms = np.sqrt(np.mean(frames * frames, axis=1))
    loge = np.log10(rms + 1e-9)

    win = np.hanning(FRAME)
    spec = np.abs(np.fft.rfft(frames * win, axis=1))       # [F, 481]
    power = spec * spec
    freqs = np.fft.rfftfreq(FRAME, 1.0 / 48000.0)

    # normalized flux (L1 of normalized magnitude deltas)
    m_norm = spec / (spec.sum(axis=1, keepdims=True) + _EPS)
    flux = np.zeros(F)
    if F > 1:
        flux[1:] = 0.5 * np.abs(np.diff(m_norm, axis=0)).sum(axis=1)

    # log spectral flatness over 100 Hz .. 8 kHz
    band = (freqs >= 100) & (freqs < 8000)
    pb = power[:, band] + _EPS
    flat = np.exp(np.mean(np.log(pb), axis=1)) / np.mean(pb, axis=1)
    log_flat = np.log10(flat + _EPS)

    hf = power[:, freqs >= 8000].sum(axis=1) / (power.sum(axis=1) + _EPS)

    # pitch via FFT autocorrelation on zero-padded frames (linear, not
    # circular): acf = irfft(|rfft(x, 2N)|^2)
    spec2 = np.abs(np.fft.rfft(frames, n=2 * FRAME, axis=1))
    acf = np.fft.irfft(spec2 * spec2, axis=1)[:, : FRAME]
    acf0 = acf[:, 0] + _EPS
    lag_slice = acf[:, _LAG_LO:_LAG_HI]
    peak_lag = lag_slice.argmax(axis=1) + _LAG_LO
    harm = lag_slice.max(axis=1) / acf0
    f0 = 48000.0 / peak_lag

    return {"loge": loge, "flux": flux, "flat": log_flat, "hf": hf,
            "harm": harm, "f0": f0}


def context_features(raw: dict, half_window: int = 25) -> np.ndarray:
    """Aggregate raw per-frame features over a sliding +-half_window
    frame context (~1 s) into the classifier's feature matrix
    [F, len(_FEATURE_NAMES)]."""
    loge, flux = raw["loge"], raw["flux"]
    flat, harm, f0 = raw["flat"], raw["harm"], raw["f0"]
    F = len(loge)
    W = half_window

    voiced = harm > 0.45
    glide = np.zeros(F)
    if F > 1:
        dlog = np.abs(np.diff(np.log(f0)))
        pair_v = voiced[1:] & voiced[:-1]
        glide[1:] = np.where(pair_v, dlog, 0.0)

    # sliding-window stats via cumulative sums (O(F))
    def win_stats(v):
        c = np.concatenate([[0.0], np.cumsum(v)])
        c2 = np.concatenate([[0.0], np.cumsum(v * v)])
        lo = np.maximum(np.arange(F) - W, 0)
        hi = np.minimum(np.arange(F) + W + 1, F)
        n = (hi - lo).astype(np.float64)
        mean = (c[hi] - c[lo]) / n
        var = np.maximum((c2[hi] - c2[lo]) / n - mean * mean, 0.0)
        return mean, np.sqrt(var)

    def win_max(v):
        # per-frame max over the window (small W: strided max is fine)
        pad = np.full(W, -np.inf)
        vp = np.concatenate([pad, v, pad])
        return np.max(np.lib.stride_tricks.sliding_window_view(
            vp, 2 * W + 1), axis=1)

    loge_mean, mod_depth = win_stats(loge)
    flux_mean, flux_std = win_stats(flux)
    flat_mean, _ = win_stats(flat)
    voiced_frac, _ = win_stats(voiced.astype(np.float64))
    harm_mean, _ = win_stats(harm)
    gsum, _ = win_stats(glide)
    vsum, _ = win_stats(voiced[:].astype(np.float64))
    pitch_glide = gsum / (vsum + 1e-6)
    pause = (loge < win_max(loge) - 0.5).astype(np.float64)  # -10 dB
    pause_rate, _ = win_stats(pause)

    return np.stack([mod_depth, flux_mean, flux_std, flat_mean,
                     voiced_frac, pitch_glide, harm_mean,
                     pause_rate], axis=1)


def speech_probability(x_mono_48k: np.ndarray) -> np.ndarray:
    """Per-20 ms-frame probability that the signal is speech-like
    (the analysis.c music_prob analog, inverted)."""
    raw = frame_features(x_mono_48k)
    feats = context_features(raw)
    z = feats @ _WEIGHTS + _BIAS
    return 1.0 / (1.0 + np.exp(-np.clip(z, -40, 40)))


def decide_modes(p_speech: np.ndarray, hf_frac: np.ndarray,
                 bitrate_kbps: int, channels: int,
                 min_dwell_frames: int = 50) -> list[str]:
    """Per-frame mode decision with hysteresis + minimum dwell.

    Hysteresis: entering speech mode needs p > 0.7, leaving needs
    p < 0.3 (between, the current mode holds — opus_encoder.c keeps
    analogous stickiness on its mode state).  A mode then holds for at
    least min_dwell_frames (~1 s) so boundary jitter can't thrash the
    decoder's transition machinery.
    """
    F = len(p_speech)
    # Rate gate: past this rate CELT wins on everything.  Thresholds
    # are fit to THIS package's encoders' measured RD (speechish
    # corpus: celt@48k 13.2 dB > silk 12.7 dB > hybrid@48k 12.7 dB at
    # equal-or-higher rate), not copied from the reference's tables —
    # its encoders have different strengths.
    if bitrate_kbps >= (48 if channels == 1 else 96):
        return ["celt"] * F
    # Below the gate SILK has the best measured RD (12.7 dB at a
    # ~18 kbps closed-loop VBR rate); hybrid only pays when the signal
    # has real energy above SILK's 8 kHz ceiling AND the budget covers
    # hybrid's uncontrolled SILK half (~32 kbps floor).
    speech_mode = "silk"
    # >8 kHz energy judged over the speech-classified frames only —
    # the music segments (which CELT takes anyway) must not dilute it
    sp_frames = np.asarray(p_speech) > 0.5
    hf = np.asarray(hf_frac)
    hf_avg = float(np.mean(hf[sp_frames]) if sp_frames.any()
                   else (np.mean(hf) if F else 0.0))
    if hf_avg > 0.08 and bitrate_kbps >= 32:
        speech_mode = "hybrid"

    modes: list[str] = []
    cur = speech_mode if (F and p_speech[0] > 0.5) else "celt"
    dwell = 0
    for k in range(F):
        want = cur
        if cur == "celt" and p_speech[k] > 0.7:
            want = speech_mode
        elif cur != "celt" and p_speech[k] < 0.3:
            want = "celt"
        if want != cur and dwell >= min_dwell_frames:
            cur, dwell = want, 0
        else:
            dwell += 1
        modes.append(cur)
    return modes


def encode_ogg_opus_auto(samples: np.ndarray, channels: int,
                         bitrate_kbps: int = 64,
                         dtx: bool = False,
                         fec: bool = False,
                         device=None) -> bytes:
    """Encode 48 kHz PCM to Ogg Opus with automatic per-segment
    celt/silk/hybrid selection (the analysis.c + opus_encoder.c mode
    machinery, original design).  All frames are 20 ms; segments are
    runs of equal mode, each encoded with the matching encoder
    (preskip priming only on the first), concatenated into one packet
    sequence — the decoder's transition machinery (decoder.py
    mode-switch crossfades) handles the boundaries. The SILK and hybrid
    segments' resamples run on ``device``.
    """
    from .celt_encoder import PRESKIP, celt_encode_packets, ogg_opus_wrap
    from .hybrid_encoder import encode_ogg_opus_hybrid
    from .silk_encoder import (DELAY_COMP_48K, encode_ogg_opus_silk,
                               encode_ogg_opus_silk_stereo)

    x = np.asarray(samples, np.float32).reshape(-1, channels)
    S = len(x)
    # Global preskip lead BEFORE segmentation: every segment then sits
    # on the 960-sample frame grid, so no segment except the last needs
    # tail padding (per-segment preskip would push segment 0 off-grid
    # and splice 960-PRESKIP samples of silence into the stream).
    x = np.concatenate([np.zeros((PRESKIP, channels), np.float32), x])
    # SILK/hybrid segments decode DELAY_COMP_48K samples late (decoder
    # resampler latency; the standalone writers absorb it in OpusHead
    # preskip, impossible here under one global preskip shared with
    # zero-latency CELT segments) — advance their input windows instead
    # so every segment lands aligned.  Tail pad keeps the last advanced
    # window in range.
    d48 = DELAY_COMP_48K["wb"]
    x_adv = np.concatenate([x, np.zeros((d48, channels), np.float32)])
    mono = x.mean(axis=1)
    raw = frame_features(mono)
    p = speech_probability(mono)
    modes = decide_modes(p, raw["hf"], bitrate_kbps, channels)

    # run-length segments on the 20 ms frame grid
    segs: list[tuple[str, int, int]] = []
    for k, m in enumerate(modes):
        if segs and segs[-1][0] == m:
            segs[-1] = (m, segs[-1][1], k + 1)
        else:
            segs.append((m, k, k + 1))
    if not segs:
        segs = [("celt", 0, 1)]

    packets: list[bytes] = []
    for m, f0, f1 in segs:
        if m == "celt":
            seg = x[f0 * FRAME : min(f1 * FRAME, len(x))].reshape(-1)
        else:
            seg = x_adv[f0 * FRAME + d48 :
                        min(f1 * FRAME, len(x)) + d48].reshape(-1)
        ps = 0
        if m == "celt":
            pk, _ = celt_encode_packets(seg, channels, 48000,
                                        bitrate_kbps, frame_ms=20,
                                        dtx=dtx, preskip=ps)
        elif m == "silk":
            if channels == 2:
                pk, _ = encode_ogg_opus_silk_stereo(
                    seg, 48000, bandwidth="wb", frame_ms=20, lbrr=fec,
                    preskip=ps, return_packets=True, device=device)
            else:
                pk, _ = encode_ogg_opus_silk(
                    seg, 48000, bandwidth="wb", frame_ms=20, dtx=dtx,
                    lbrr=fec, preskip=ps, return_packets=True,
                    device=device)
        else:
            pk, _ = encode_ogg_opus_hybrid(
                seg, 48000, bitrate_kbps, channels=channels,
                frame_ms=20, bandwidth="fb", preskip=ps,
                return_packets=True, device=device)
        packets.extend(pk)

    return ogg_opus_wrap(packets, channels, S, FRAME, PRESKIP)
