"""CELT-layout inverse MDCT as matrix products over frame batches.

The reference computes the backward MDCT in four serial stages — twiddle
pre-rotation, N/4 complex IFFT, post-rotation/deshuffle, TDAC window
mirror (reference: third_party/opus/celt/mdct.c:269-379). All four are
linear in the spectrum, and the TDAC mirror is also linear in the
previous frame's tail, so the whole pipeline folds into one precomputed
synthesis matrix per (N, shift) mode:

    T : spectrum[N2]  ->  contribution[N2 + overlap]

Decoding a stream is then a batched product [frames, N2] @ T plus a
shifted add, with no sequential carry: superposition removes the
overlap-add recurrence. Transient frames (B interleaved short MDCTs)
fold their intra-frame overlap-add into the matrix as well.

The matrices are built in float64 with NumPy (the same builders as the
reference package) and cast to float32. The products are plain float32
``torch.matmul``: on CUDA the device module pins full-precision float32
(no TF32), as the reference pins its products for the 1e-4 contract.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resident


def celt_window(overlap: int) -> np.ndarray:
    """CELT's power-of-sine window."""
    i = np.arange(overlap, dtype=np.float64)
    return np.sin(0.5 * np.pi * np.sin(0.5 * np.pi * (i + 0.5) / overlap) ** 2)


def celt_imdct_reference(
    x: np.ndarray, N: int, overlap: int, prev_tail: np.ndarray | None = None
) -> np.ndarray:
    """NumPy port of clt_mdct_backward (reference mdct.c:269-379).

    Args:
      x: [..., N2] de-strided spectrum.
      N: transform size (l->n >> shift).
      overlap: window overlap length.
      prev_tail: optional [..., overlap//2] previous raw tail.
    Returns out: [..., N2 + overlap] (float64; entries beyond
    N2 + overlap//2 are zero).
    """
    N2, N4 = N // 2, N // 4
    batch = x.shape[:-1]
    t = np.cos(2 * np.pi * np.arange(N4 + 1, dtype=np.float64) / N)
    sine = 2 * np.pi * 0.125 / N  # small-angle sin substitute (mdct.c:292)

    # Pre-rotation (mdct.c:295-313).
    x = x.astype(np.float64)
    xe = x[..., 0::2]                       # x[2i]
    xo = x[..., ::-1][..., 0::2]            # x[N2-1-2i]
    ti = t[:N4]
    tn = t[N4:0:-1]                         # t[N4 - i]
    yr = -xo * ti + xe * tn
    yi = -xo * tn - xe * ti
    fr = yr - yi * sine
    fi = yi + yr * sine

    # Unnormalized inverse N/4 complex FFT (kiss_fft convention: no 1/N).
    z = np.fft.ifft(fr + 1j * fi, axis=-1) * N4
    zr, zi = z.real, z.imag

    # Post-rotation + deshuffle (mdct.c:320-359).
    u = zr * ti - zi * tn
    v = zi * ti + zr * tn
    even = -(u - v * sine)
    odd = (v + u * sine)[..., ::-1]
    buf = np.zeros(batch + (N2,), dtype=np.float64)
    buf[..., 0::2] = even
    buf[..., 1::2] = odd

    # TDAC window mirror (mdct.c:361-377), linear in (prev_tail, buf).
    w = celt_window(overlap)
    half = overlap // 2
    out = np.zeros(batch + (N2 + overlap,), dtype=np.float64)
    out[..., half : half + N2] = buf
    fresh_head = buf[..., :half]
    pre = (
        prev_tail.astype(np.float64)
        if prev_tail is not None
        else np.zeros(batch + (half,), dtype=np.float64)
    )
    wi = w[:half]
    wr = w[overlap - 1 : half - 1 : -1]     # w[ov-1-i]
    fresh_rev = fresh_head[..., ::-1]
    out[..., :half] = wr * pre - wi * fresh_rev
    out[..., half:overlap] = (wi * pre + wr * fresh_rev)[..., ::-1]
    return out


@functools.lru_cache(maxsize=None)
def celt_synthesis_matrix(N: int, overlap: int, B: int = 1) -> np.ndarray:
    """Build the fused synthesis matrix T [B*N2, B*N2 + overlap] (float32).

    Column block [:N2] is the frame's own finished output; [N2:] is the
    windowed tail it donates to the next frame's head (the next frame's
    TDAC mirror weights are folded in). For B > 1 the B interleaved
    sub-blocks (spectrum X[b + B*k], output offset b*N2) and their
    intra-frame overlap-adds fold into one matrix.
    """
    N2 = N // 2
    half = overlap // 2
    eye = np.eye(N2, dtype=np.float64)
    base = celt_imdct_reference(eye, N, overlap)          # [N2, N2+ov]
    w = celt_window(overlap)
    T = np.zeros((N2, N2 + overlap), dtype=np.float64)
    T[:, :N2] = base[:, :N2]
    raw_tail = base[:, N2 : N2 + half]
    wi = w[:half]
    wr = w[overlap - 1 : half - 1 : -1]
    T[:, N2 : N2 + half] = raw_tail * wr
    T[:, N2 + half : N2 + overlap] = (raw_tail * wi)[:, ::-1]
    if B == 1:
        return T.astype(np.float32)
    total = B * N2
    TB = np.zeros((total, total + overlap), dtype=np.float64)
    for b in range(B):
        TB[b::B, b * N2 : b * N2 + N2 + overlap] += T
    return TB.astype(np.float32)


@functools.lru_cache(maxsize=None)
def celt_synthesis_matrices_paired(N: int, overlap: int, B: int = 1):
    """Split the fused synthesis matrix for layout-free overlap-add.

    Returns (T_main [N2, N2], T_tailpad [N2, N2], T_tail [N2, overlap])
    such that a frame's finished output over its own region is

        out[f] = spec[f] @ T_main + spec[f-1] @ T_tailpad

    The carry for a following batch is spec[last] @ T_tail.
    """
    n2 = B * (N // 2)
    T = celt_synthesis_matrix(N, overlap, B)
    T_main = np.ascontiguousarray(T[:, :n2])
    T_tail = np.ascontiguousarray(T[:, n2:])
    T_tailpad = np.zeros((n2, n2), np.float32)
    T_tailpad[:, :overlap] = T_tail
    return T_main, T_tailpad, T_tail


def _synthesize(spectra, matrix, init_tail, n2: int, overlap: int):
    """[F, n2] spectra @ [n2, n2+ov] -> (pcm [F*n2], tails [F+1, ov])."""
    c = spectra @ matrix                                  # [F, n2 + ov]
    main = c[:, :n2]
    tails = torch.cat([init_tail[None, :], c[:, n2:]], dim=0)
    # Frame f's tail adds to the head of frame f+1's region. All
    # per-frame carry-out tails are returned so callers running padded
    # (bucketed) batches can pick the tail after the last REAL frame.
    shifted = torch.nn.functional.pad(tails[:-1], (0, n2 - overlap))
    return (main + shifted).reshape(-1), tails


def celt_imdct_batch_padded(
    spectra: torch.Tensor,
    n_real: int,
    N: int,
    overlap: int,
    B: int = 1,
    init_tail: torch.Tensor | None = None,
):
    """Batched fused IMDCT + TDAC overlap-add for one (N, B) bucket of
    zero-padded frames.

    Args:
      spectra: [F, B * N//2] frame spectra (interleaved layout for B>1).
      n_real: frames before the padding; the carry is taken after it.
      init_tail: [overlap] carry from the previous batch (zeros at start).
    Returns (pcm [F * B * N//2], next_tail [overlap]).
    """
    n2 = B * (N // 2)
    dev = spectra.device
    M = resident(("imdct_T", N, overlap, B),
                   lambda: celt_synthesis_matrix(N, overlap, B), dev)
    if init_tail is None:
        init_tail = torch.zeros(overlap, dtype=torch.float32, device=dev)
    out, tails = _synthesize(spectra.float(), M, init_tail, n2, overlap)
    return out, tails[n_real]


def _synthesize_rows(spectra, Tm, Tp, tails, overlap: int):
    """[R, F, n2] spectra + per-row carry tails -> [R, F*n2] PCM + all
    per-frame tails [R, F, overlap]."""
    R, F, n2 = spectra.shape
    flat = spectra.reshape(-1, n2)
    main = flat @ Tm
    prev = torch.cat(
        [spectra.new_zeros(R, 1, n2), spectra[:, :-1]], dim=1
    ).reshape(-1, n2)
    out = (main + prev @ Tp).reshape(R, F, n2)
    out[:, 0, :overlap] += tails
    all_tails = spectra @ Tp[:, :overlap]                 # [R, F, ov]
    return out.reshape(R, F * n2), all_tails


def celt_imdct_rows(
    spectra: torch.Tensor,
    N: int,
    overlap: int,
    B: int = 1,
    tails: torch.Tensor | None = None,
):
    """Rows-batched fused IMDCT + TDAC overlap-add for one (N, B) bucket.

    Args:
      spectra: [R, F, B*N//2], R = streams x channels (the serving axis).
      tails: [R, overlap] carry from the previous segment (zeros at start).
    Returns (pcm [R, F * B*N//2], per-frame tails [R, F, overlap]).
    """
    dev = spectra.device
    Tm = resident(("imdct_Tm", N, overlap, B),
                    lambda: celt_synthesis_matrices_paired(N, overlap, B)[0],
                    dev)
    Tp = resident(("imdct_Tp", N, overlap, B),
                    lambda: celt_synthesis_matrices_paired(N, overlap, B)[1],
                    dev)
    if tails is None:
        tails = torch.zeros(spectra.shape[0], overlap, dtype=torch.float32,
                            device=dev)
    return _synthesize_rows(spectra.float(), Tm, Tp, tails, overlap)
