"""Batched sample-rate conversion on the device.

The reference ships only linear and 4-point Hermite resamplers
(reference: include/libnyquist/Common.h:220-261 linear_resample /
hermite_resample, kept for API parity); the polyphase resampler below
is the package's own:

A rational ratio L/M (48k->44.1k = 147/160) is one windowed-sinc lowpass
at the upsampled rate, decomposed into L phases. Every cycle of L output
samples reads one contiguous span of M + K - 1 input samples, so the
whole resampler is one dense [L, M + K - 1] weight matrix applied as a
strided convolution (``torch.nn.functional.conv1d`` with L output
channels and stride M) over [batch, cycles], in float32 without TF32.
The weights are designed in float64 on the host, cached per
(L, M, taps, beta), and go to the device once.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


@functools.lru_cache(maxsize=32)
def polyphase_weights(L: int, M: int, taps_per_phase: int = 24,
                      beta: float = 8.6):
    """Design the per-cycle weight matrix W [L, M + K - 1].

    y[c*L + p] = sum_j W[p, j] * x[c*M - K + 1 + j]   (K = taps per phase)

    Returns (W float32, K, delay_out). The prototype length scales with
    max(L, M): an anti-alias filter for decimation needs taps
    proportional to M regardless of the phase count.
    """
    N = -(-taps_per_phase * max(L, M) // L) * L
    K = N // L
    # prototype lowpass at the upsampled rate fs*L, cut off at the
    # narrower of the two Nyquists, centred on a whole number of output
    # periods (a multiple of M in upsampled units) so that trimming whole
    # output samples removes the group delay exactly
    cutoff = min(1.0 / L, 1.0 / M)
    delay_out = int(round((N - 1) / 2.0 / M))
    c0 = delay_out * M
    n = np.arange(N, dtype=np.float64) - c0
    T = (N - 1) / 2.0
    wx = np.clip(1.0 - (n / T) ** 2, 0.0, None)
    win = np.i0(beta * np.sqrt(wx)) / np.i0(beta)
    win[np.abs(n) > T] = 0.0
    h = L * cutoff * np.sinc(cutoff * n) * win

    W = np.zeros((L, M + K - 1), np.float64)
    for p in range(L):
        r = (p * M) % L
        d = (p * M) // L
        hp = h[r::L]                       # phase-r subfilter, K taps
        for q in range(len(hp)):
            W[p, d - q + K - 1] = hp[q]
    return W.astype(np.float32), K, delay_out


_WEIGHTS = {}


def _weights(L: int, M: int, taps_per_phase: int, beta: float,
             device: torch.device) -> torch.Tensor:
    """W as conv1d weights [L, 1, M + K - 1] on ``device``, once."""
    key = (L, M, taps_per_phase, beta, str(device))
    w = _WEIGHTS.get(key)
    if w is None:
        W, _, _ = polyphase_weights(L, M, taps_per_phase, beta)
        w = _WEIGHTS[key] = torch.from_numpy(W)[:, None, :].to(device)
    return w


def _resample_poly(x: torch.Tensor, L: int, M: int, taps_per_phase: int,
                   beta: float) -> torch.Tensor:
    """[B, S] -> [B, (ceil(S / M) + 1) * L], the delay not yet trimmed."""
    _, K, _ = polyphase_weights(L, M, taps_per_phase, beta)
    B, S = x.shape
    n_cycles = -(-S // M)                  # ceil: cover the whole input
    # the window of cycle c runs over [c*M - K + 1, c*M + M - 1]
    pad_l = K - 1
    pad_r = n_cycles * M + (M - 1) - (S - 1)
    xp = F.pad(x, (pad_l, pad_r))
    out = F.conv1d(xp[:, None, :], _weights(L, M, taps_per_phase, beta,
                                            x.device), stride=M)
    return out.transpose(1, 2).reshape(B, -1)     # [B, L, nc] -> phases


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def resample(x, sr_in: int, sr_out: int, taps_per_phase: int = 24,
             beta: float = 8.6, device=None) -> torch.Tensor:
    """Batched polyphase resample of [B, S] (or [S]) from sr_in to
    sr_out on ``device`` (CUDA unless the caller names another).

    Returns round(S * sr_out / sr_in) samples per stream, group-delay
    compensated: the filter's delay is a whole number of output samples
    by construction and is trimmed from the front. When the filtered
    output runs out before that count (decimation ends with fewer
    cycles than the rounded length asks for), the tail is filled with
    zeros. Equal rates pass the input through unchanged.
    """
    x = _as_tensor(x, resolve_device(device))
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    if sr_in == sr_out:
        return x[0] if squeeze else x
    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    S = x.shape[1]
    y = _resample_poly(x, L, M, taps_per_phase, beta)
    _, _, delay_out = polyphase_weights(L, M, taps_per_phase, beta)
    n_out = int(round(S * L / M))
    y = y[:, delay_out : delay_out + n_out]
    if y.shape[1] < n_out:
        y = F.pad(y, (0, n_out - y.shape[1]))
    return y[0] if squeeze else y


# --- the reference's resamplers (Common.h:220-261) ---

def _positions(n_in: int, n_out: int, device):
    """Output positions in input samples, float32 as the reference
    package computes them, and their integer parts."""
    pos = torch.arange(n_out, dtype=torch.float32, device=device) * (
        n_in / n_out)
    return pos, torch.clamp(pos.to(torch.int64), 0, n_in - 1)


def linear_resample(x, n_out: int, device=None) -> torch.Tensor:
    """Linear interpolation resample to n_out samples (Common.h:220-235)."""
    x = _as_tensor(x, resolve_device(device))
    n_in = x.shape[-1]
    pos, i0 = _positions(n_in, n_out, x.device)
    i1 = torch.clamp(i0 + 1, 0, n_in - 1)
    frac = pos - i0
    return x[..., i0] * (1.0 - frac) + x[..., i1] * frac


def hermite_resample(x, n_out: int, device=None) -> torch.Tensor:
    """4-point cubic Hermite resample (Common.h:247-261)."""
    x = _as_tensor(x, resolve_device(device))
    n_in = x.shape[-1]
    pos, i1 = _positions(n_in, n_out, x.device)
    t = pos - i1
    i0 = torch.clamp(i1 - 1, 0, n_in - 1)
    i2 = torch.clamp(i1 + 1, 0, n_in - 1)
    i3 = torch.clamp(i1 + 2, 0, n_in - 1)
    xm1, x0, x1, x2 = x[..., i0], x[..., i1], x[..., i2], x[..., i3]
    c = (x1 - xm1) * 0.5
    v = x0 - x1
    w = c + v
    a = w + v + (x2 - x0) * 0.5
    b_neg = w + a
    return (((a * t) - b_neg) * t + c) * t + x0
