"""CELT pitch postfilter over 12-sample chunks: plain version + CUDA kernel.

The reference applies the comb filter in place over the decode buffer
(reference: celt/celt.c:114-172): y[i] = x[i] + taps(y[i-T-2 .. i-T+2])
with per-frame pitch lag T in [15, 1024], a true IIR across the stream.
Since T >= COMBFILTER_MINPERIOD (15), any 12-sample chunk reads only
samples strictly before the chunk, so a stream filters chunk by chunk,
vectorized over the [stream * channel] batch axis.

``comb_filter`` dispatches on the tensor's device: a CPU tensor goes to
the plain PyTorch version ``comb_filter_stream_ref``; a CUDA tensor goes
to the hand-written kernel (``csrc/comb.cu``) through
``comb_filter_cuda``, or the call raises.

The kernel does not advance one chunk at a time: the only ordering rule
is that a step may not read a sample it writes, so a step of m chunks is
legal when every chunk in it that filters at all (its six gains are not
all zero) has min(T0, T1) >= 12 m + 2. ``comb_step_widths`` and
``comb_step_plan`` state the steps the kernel takes, and
``comb_filter_planned_ref`` is the plain filter that follows such a plan
step by step: the executable statement of the kernel's algorithm.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

CHUNK = 12
MAXPERIOD = 1024
HIST = MAXPERIOD + 2  # history needed before the first sample
MAX_STEP = 10         # widest step the kernel takes, in chunks (120 samples)
TILE = 256            # chunks per staged input tile; no step crosses one


def build_chunk_params(frame_params, frame_size: int, window: np.ndarray,
                       short_mdct_size: int = 120):
    """Host-side: per-frame postfilter params -> per-chunk tap arrays.

    Args:
      frame_params: list over frames of dicts with keys
        T0a, T1a, g0a[3], g1a[3]  (segment A: first shortMdctSize samples:
          old->current params crossfade)
        T0b, T1b, g0b[3], g1b[3]  (segment B: rest of frame: current->new)
        — matching the two comb_filter calls in celt_decoder_clean.c:652-668.
      window: CELT window (length = overlap).
    Returns dict of np arrays, each [n_chunks_total, ...]:
      T0, T1 (int32), gains0 [.,3], gains1 [.,3], fade [., CHUNK] in [0,1].
    """
    overlap = len(window)
    w2 = (window * window).astype(np.float32)
    n_frames = len(frame_params)
    chunks_per_frame = frame_size // CHUNK
    total = n_frames * chunks_per_frame
    T0 = np.zeros(total, np.int32)
    T1 = np.zeros(total, np.int32)
    g0 = np.zeros((total, 3), np.float32)
    g1 = np.zeros((total, 3), np.float32)
    fade = np.zeros((total, CHUNK), np.float32)
    for f, p in enumerate(frame_params):
        for k in range(chunks_per_frame):
            pos = k * CHUNK  # within frame
            idx = f * chunks_per_frame + k
            if pos < short_mdct_size:
                seg_start = 0
                T0[idx], T1[idx] = p["T0a"], p["T1a"]
                g0[idx], g1[idx] = p["g0a"], p["g1a"]
            else:
                seg_start = short_mdct_size
                T0[idx], T1[idx] = p["T0b"], p["T1b"]
                g0[idx], g1[idx] = p["g0b"], p["g1b"]
            rel = pos - seg_start
            # crossfade factor per sample: w2 within the first `overlap`
            # samples of the segment, then 1.0 (new params only).
            f_vals = np.ones(CHUNK, np.float32)
            for j in range(CHUNK):
                r = rel + j
                if r < overlap:
                    f_vals[j] = w2[r]
            fade[idx] = f_vals
    return dict(T0=T0, T1=T1, gains0=g0, gains1=g1, fade=fade)


def comb_filter_stream_ref(x, hist, T0, T1, gains0, gains1, fade):
    """Plain PyTorch postfilter over a segment of frames.

    Args:
      x: [B, S] unfiltered synthesis (S = n_chunks * CHUNK).
      hist: [B, H] previous *filtered* output, H >= HIST.
      T0, T1: [B, n_chunks] integer lags in [15, 1024].
      gains0, gains1: [B, n_chunks, 3] tap gains (old / new params).
      fade: [B, n_chunks, CHUNK] crossfade weight of the new params.
    Returns (y [B, S], new_hist [B, H]): new_hist is the last H samples
    of [hist, y].
    """
    B, S = x.shape
    n = S // CHUNK
    H = hist.shape[1]
    dev = x.device
    # One buffer holds the history then the filtered output; chunk k's
    # two 16-wide lag windows start at H + k*CHUNK - T - 2. torch.gather
    # takes int64 indices.
    buf = torch.cat([hist.float(), torch.zeros_like(x)], dim=1)
    start = H + CHUNK * torch.arange(n, device=dev)             # [n]
    win = torch.arange(CHUNK + 4, device=dev)
    idx = torch.stack([
        (start - T0.long() - 2)[..., None] + win,
        (start - T1.long() - 2)[..., None] + win,
    ], dim=2).reshape(B, n, 2 * (CHUNK + 4))                   # [B, n, 32]
    g = torch.stack([gains0, gains1], dim=2)[..., None]        # [B,n,2,3,1]
    # Per-chunk views, split once: the loop body is the arithmetic only.
    per_chunk = zip(idx.unbind(1), g[:, :, :, 0].unbind(1),
                    g[:, :, :, 1].unbind(1), g[:, :, :, 2].unbind(1),
                    x.reshape(B, n, CHUNK).unbind(1), (1.0 - fade).unbind(1),
                    fade.unbind(1), buf[:, H:].view(B, n, CHUNK).unbind(1))
    for ik, g0k, g1k, g2k, xk, keepk, fk, yk in per_chunk:
        w = torch.gather(buf, 1, ik).view(B, 2, CHUNK + 4)
        mix = (g0k * w[:, :, 2 : 2 + CHUNK]
               + g1k * (w[:, :, 1 : 1 + CHUNK] + w[:, :, 3 : 3 + CHUNK])
               + g2k * (w[:, :, 0:CHUNK] + w[:, :, 4 : 4 + CHUNK]))
        old, new = mix.unbind(1)
        yk.copy_(xk + keepk * old + fk * new)
    return buf[:, H:].contiguous(), buf[:, S:].contiguous()


def comb_step_limits(T0, T1, gains0, gains1):
    """[B, n] int: the widest step (in chunks, 1..MAX_STEP) each chunk
    allows to a step that contains it. A chunk whose six gains are zero
    reads no history (y = x) and allows MAX_STEP; any other allows
    (min(T0, T1) - 2) // 12: a step of m chunks starting at sample s
    writes s .. s + 12 m - 1 and the chunk's newest read is at most
    s + 12 m - 1 - T + 2, which must stay below s."""
    active = (gains0 != 0).any(dim=-1) | (gains1 != 0).any(dim=-1)
    lim = torch.div(torch.minimum(T0, T1).long() - 2, CHUNK,
                    rounding_mode="floor").clamp(1, MAX_STEP)
    return torch.where(active, lim, torch.full_like(lim, MAX_STEP))


def comb_step_widths(T0, T1, gains0, gains1):
    """[B, n] int: the longest legal step that starts at each chunk, as
    the kernel computes it per staged tile: the largest m <= MAX_STEP,
    not past the end of the chunk's TILE nor of the row, such that every
    chunk of the step allows m (comb_step_limits)."""
    lim = comb_step_limits(T0, T1, gains0, gains1)
    n = lim.shape[-1]
    pos = torch.arange(n, device=lim.device)
    room = torch.minimum(TILE - pos % TILE, n - pos)
    padded = torch.nn.functional.pad(lim, (0, MAX_STEP), value=MAX_STEP)
    run = lim
    ok = torch.ones_like(lim, dtype=torch.bool)
    width = torch.ones_like(lim)
    for m in range(1, MAX_STEP + 1):
        if m > 1:
            run = torch.minimum(run, padded[..., m - 1 : m - 1 + n])
        ok = ok & (run >= m) & (room >= m)
        width = torch.where(ok, torch.full_like(width, m), width)
    return width


def comb_step_plan(T0, T1, gains0, gains1):
    """The steps the kernel follows: per row a list of (first chunk, m),
    walking the row by comb_step_widths."""
    widths = comb_step_widths(T0, T1, gains0, gains1)
    plans = []
    for w in widths.tolist():
        k, steps = 0, []
        while k < len(w):
            steps.append((k, w[k]))
            k += w[k]
        plans.append(steps)
    return plans


def comb_filter_planned_ref(x, hist, T0, T1, gains0, gains1, fade,
                            plans=None):
    """Plain PyTorch postfilter that follows a step plan (by default
    comb_step_plan's): each step computes all its 12 m samples from the
    buffer as it stood before the step, as the kernel's lanes do. A chunk
    whose gains are all zero copies x. Same arguments and returns as
    comb_filter_stream_ref; row by row, for small sizes."""
    B, S = x.shape
    H = hist.shape[1]
    if plans is None:
        plans = comb_step_plan(T0, T1, gains0, gains1)
    active = (gains0 != 0).any(dim=-1) | (gains1 != 0).any(dim=-1)
    buf = torch.cat([hist.float(), torch.zeros_like(x)], dim=1)
    fade_s = fade.reshape(B, S)
    for r, steps in enumerate(plans):
        row = buf[r]
        for k, m in steps:
            j = torch.arange(CHUNK * k, CHUNK * (k + m), device=x.device)
            c = j // CHUNK                               # chunk per sample
            before = row.clone()

            def taps(T, g):
                p = H + j - T[r, c].long()
                return (g[r, c, 0] * before[p]
                        + g[r, c, 1] * (before[p - 1] + before[p + 1])
                        + g[r, c, 2] * (before[p - 2] + before[p + 2]))

            f = fade_s[r, j]
            y = x[r, j] + (1.0 - f) * taps(T0, gains0) + f * taps(T1, gains1)
            row[H + j] = torch.where(active[r, c], y, x[r, j])
    return buf[:, H:].contiguous(), buf[:, S:].contiguous()


_BOUND = False


def _comb_lib() -> ctypes.CDLL:
    global _BOUND
    L = kernels.load("comb")
    if not _BOUND:
        vp = ctypes.c_void_p
        L.comb_filter_launch.restype = ctypes.c_int
        L.comb_filter_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp,        # x hist T0 T1 g0 g1 fade y
            ctypes.c_int, ctypes.c_longlong,       # B, n_chunks
            ctypes.c_int, vp, vp,                  # vec, steps, stream
        ]
        _BOUND = True
    return L


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"comb_filter_cuda: {name} on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"comb_filter_cuda: {name} is {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"comb_filter_cuda: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"comb_filter_cuda: {name} is not contiguous")


def comb_filter_cuda(x, hist, T0, T1, gains0, gains1, fade, *,
                     step_counts=None):
    """The postfilter on the card through the hand-written kernel.

    Same arguments as comb_filter_stream_ref, with hist exactly
    [B, HIST], lags int32 and every tensor contiguous on one CUDA
    device. ``step_counts``, when given, is an int64 [B] tensor on the
    device that receives the steps each row's chain took. Counts its
    launches in ``comb_filter_cuda.launches``.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"comb_filter_cuda: x is on {dev}, not CUDA")
    if x.dim() != 2 or x.shape[1] % CHUNK:
        raise ValueError(f"comb_filter_cuda: x must be [B, 12*n], got "
                         f"{tuple(x.shape)}")
    B, S = x.shape
    n = S // CHUNK
    f32 = torch.float32
    _check("x", x, f32, (B, S), dev)
    _check("hist", hist, f32, (B, HIST), dev)
    _check("T0", T0, torch.int32, (B, n), dev)
    _check("T1", T1, torch.int32, (B, n), dev)
    _check("gains0", gains0, f32, (B, n, 3), dev)
    _check("gains1", gains1, f32, (B, n, 3), dev)
    _check("fade", fade, f32, (B, n, CHUNK), dev)
    if step_counts is not None:
        _check("step_counts", step_counts, torch.int64, (B,), dev)
    y = torch.empty_like(x)
    if B and n:
        if x.data_ptr() % 16 or fade.data_ptr() % 16:
            raise ValueError("comb_filter_cuda: x and fade must be 16-byte "
                             "aligned")
        # 16-byte staging of the lag and gain rows needs them aligned
        vec = n % 4 == 0 and not any(
            t.data_ptr() % 16 for t in (T0, T1, gains0, gains1))
        L = _comb_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = L.comb_filter_launch(
                x.data_ptr(), hist.data_ptr(), T0.data_ptr(), T1.data_ptr(),
                gains0.data_ptr(), gains1.data_ptr(), fade.data_ptr(),
                y.data_ptr(), B, n, int(vec),
                None if step_counts is None else step_counts.data_ptr(),
                stream)
        if rc != 0:
            raise RuntimeError(f"comb kernel launch failed: CUDA error {rc}")
        comb_filter_cuda.launches += 1
    elif step_counts is not None:
        step_counts.zero_()
    # the last HIST samples of [hist, y]
    if S >= HIST:
        new_hist = y[:, S - HIST:].contiguous()
    else:
        new_hist = torch.cat([hist[:, S:], y], dim=1)
    return y, new_hist


comb_filter_cuda.launches = 0


def comb_filter(x, hist, T0, T1, gains0, gains1, fade):
    """Device dispatch: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (never the plain version on a card)."""
    if x.device.type == "cuda":
        return comb_filter_cuda(x, hist, T0, T1, gains0, gains1, fade)
    if x.device.type == "cpu":
        return comb_filter_stream_ref(x, hist, T0, T1, gains0, gains1, fade)
    raise ValueError(f"comb_filter: no implementation for {x.device}")
