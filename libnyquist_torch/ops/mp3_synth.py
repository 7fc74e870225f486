"""MP3 synthesis filterbank as linear maps: IMDCT + QMF as matmuls.

The reference decodes MP3 with serial per-granule butterflies
(reference: third_party/minimp3/minimp3.h — L3_imdct_gr :1184 hybrid
IMDCT-36/12 with overlap state, mp3d_DCT_II :1264 + mp3d_synth :1466
windowed polyphase with qmf_state carry). Every one of those stages is
linear in its inputs, so they ship as matrices (``data/mp3_maps.npz``)
and a whole stream synthesizes as a handful of matmuls over its granule
axis:

* hybrid IMDCT: per band kind k in {long, long/stop, short}
  ``out18 = A1_k @ x18 + B1_k @ ov9_prev`` and ``ov9 = A2_k @ x18``; the
  overlap depends on the current granule only, so there is no
  recurrence: two batched products plus a shifted add;
* polyphase QMF: ``out_slice[s] = sum_{i<16} Q_i @ band_slice[s-i]``,
  assembled into three granule maps (A, BC, BDC), a 3-tap matmul FIR
  over granules.

Two forms:

* ``imdct_granules_stream`` / ``synth_granules_stream``: the plain NumPy
  versions (float32 as the reference decodes, float64 for an exact
  reference);
* ``Mp3Synth``: the device module, batched over streams, that ``load()``
  and the K-stream serving path both run. Its products are
  ``torch.matmul`` in float32 (TF32 off, ``device.resolve_device``); the
  kind masks and the shifted adds are plain PyTorch.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

_MAPS = pathlib.Path(__file__).resolve().parents[1] / "data" / "mp3_maps.npz"

# band kinds for the hybrid IMDCT
KIND_LONG = 0       # long block, normal window
KIND_LONG_W1 = 1    # long block, block_type == 3 window
KIND_SHORT = 2      # three short IMDCT-12 lanes


@functools.lru_cache(maxsize=1)
def M() -> dict:
    """Probed linear maps: imdct A1 [3,18,18], B1 [3,18,9], A2 [3,9,18];
    qmf Q [16,32,32]."""
    return dict(np.load(_MAPS))


@functools.lru_cache(maxsize=1)
def _sign_mask() -> np.ndarray:
    """(-1)^(b*t parity) applied post-IMDCT: odd time samples of odd
    bands flip (the reference's L3_change_sign, minimp3.h:1655)."""
    b = np.arange(32)[:, None]
    t = np.arange(18)[None, :]
    return np.where((b & 1) & (t & 1), -1.0, 1.0).astype(np.float32)


def band_kinds(block_type: int, n_long_bands: int) -> np.ndarray:
    """Per-band IMDCT kind row [32] for one granule-channel
    (reference: L3_imdct_gr dispatch, minimp3.h:1184-1200)."""
    kinds = np.empty(32, np.int8)
    if block_type == 2:
        kinds[:] = KIND_SHORT
    else:
        kinds[:] = KIND_LONG_W1 if block_type == 3 else KIND_LONG
    kinds[:n_long_bands] = KIND_LONG
    return kinds


def imdct_granules_stream(X: np.ndarray, kinds: np.ndarray,
                          dtype=np.float32) -> np.ndarray:
    """Hybrid IMDCT over a whole stream of granules, zero overlap start.

    Args:
      X: [G, C, 576] frequency-domain granule planes (post antialias).
      kinds: [G, C, 32] int8 band kinds (band_kinds rows).
      dtype: float32 (as the reference decodes) or float64.
    Returns [G, C, 576] time-domain band slices (synth input layout).
    """
    m = M()
    A1, B1, A2 = (m[k].astype(dtype) for k in ("A1", "B1", "A2"))
    G, C = X.shape[:2]
    Xr = X.reshape(G, C, 32, 18).astype(dtype)
    out = np.zeros((G, C, 32, 18), dtype)
    ov = np.zeros((G, C, 32, 9), dtype)
    for k in range(3):
        mask = (kinds == k)[..., None]
        if not mask.any():
            continue
        out += np.where(mask, Xr @ A1[k].T, 0.0)
        ov += np.where(mask, Xr @ A2[k].T, 0.0)
    ovprev = np.empty_like(ov)
    ovprev[0] = 0.0
    ovprev[1:] = ov[:-1]
    for k in range(3):
        mask = (kinds == k)[..., None]
        if mask.any():
            out += np.where(mask, ovprev @ B1[k].T, 0.0)
    out *= _sign_mask().astype(dtype)
    return out.reshape(G, C, 576)


@functools.lru_cache(maxsize=8)
def granule_maps(nbands: int, nch: int):
    """Assemble (A, BC, BDC) granule-FIR synthesis maps from the probed
    per-slice QMF maps Q (pure block placement), float32 [n_out, d_in].

    out[(s*32+j)*nch+c] = sum_{i=0..15} Q_i[j,:] @ slice_{s-i} of ch c,
    where slice t of channel c lives at input index c*576 + b*18 + t.
    Slices with s-i < 0 come from the previous granule (BC) or the one
    before it (BDC).
    """
    Q = M()["Q"]  # [16, 32, 32] maps band-slice -> pcm-slice
    d_in = 576 * nch
    n_out = 32 * nbands * nch
    A = np.zeros((n_out, d_in), np.float32)
    BC = np.zeros((n_out, d_in), np.float32)
    BDC = np.zeros((n_out, d_in), np.float32)
    for s in range(nbands):
        for i in range(16):
            t = s - i
            if t >= 0:
                dst = A
            elif t + nbands >= 0:
                dst, t = BC, t + nbands
            else:
                dst, t = BDC, t + 2 * nbands
            if t >= nbands:
                continue
            for c in range(nch):
                rows = (np.arange(32) * nch + c) + s * 32 * nch
                cols = c * 576 + np.arange(32) * 18 + t
                dst[np.ix_(rows, cols)] += Q[i]
    for a in (A, BC, BDC):
        a.setflags(write=False)
    return A, BC, BDC


def synth_granules_stream(grbufs: np.ndarray, nbands: int, nch: int,
                          dtype=np.float32) -> np.ndarray:
    """Synthesize all granules of a stream at once (silence-start qmf).

    Args:
      grbufs: [G, 2, 576] time-domain granule buffers. Mono uses plane 0.
      dtype: float32 (as the reference decodes) or float64.
    Returns [G * 32 * nbands, nch] PCM in [-1, 1].
    """
    A, BC, BDC = (a.astype(dtype) for a in granule_maps(nbands, nch))
    G = grbufs.shape[0]
    d_in = 576 * nch
    X = np.ascontiguousarray(grbufs.reshape(G, -1)[:, :d_in], dtype=dtype)
    out = X @ A.T
    if G > 1:
        out[1:] += X[:-1] @ BC.T
    if G > 2:
        out[2:] += X[:-2] @ BDC.T
    return out.reshape(G * 32 * nbands, nch)


class Mp3Synth(torch.nn.Module):
    """The MP3 dense half on a device, batched over S streams.

    ``forward(X [S, G, C, 576] float32, kinds [S, G, C, 32] int8)`` ->
    PCM [S, G * 32 * nbands, nch]: the hybrid IMDCT (kind-masked products
    and the shifted overlap-add) and the QMF polyphase (3-tap matmul FIR
    over granules), every stream starting from silence. ``kinds=None``
    skips the IMDCT: Layer I/II hands over time-domain band slices, with
    ``nbands = 12``. C may exceed nch (mono streams carry two planes and
    use the first). The maps are buffers on the module's device.
    """

    def __init__(self, nch: int, nbands: int = 18, device=None):
        super().__init__()
        self.nch = nch
        self.nbands = nbands
        m = M()
        A, BC, BDC = granule_maps(nbands, nch)

        def buf(name, a):
            self.register_buffer(
                name, torch.tensor(np.ascontiguousarray(a), device=device),
                persistent=False)

        # the IMDCT maps pre-transposed for x @ map
        buf("A1t", m["A1"].transpose(0, 2, 1))      # [3, 18, 18]
        buf("A2t", m["A2"].transpose(0, 2, 1))      # [3, 18, 9]
        buf("B1t", m["B1"].transpose(0, 2, 1))      # [3, 9, 18]
        buf("sign", _sign_mask())                    # [32, 18]
        buf("At", A.T)
        buf("BCt", BC.T)
        buf("BDCt", BDC.T)

    def imdct(self, X: torch.Tensor, kinds: torch.Tensor) -> torch.Tensor:
        """[S, G, C, 576] frequency planes -> time-domain band slices."""
        S, G, C = X.shape[:3]
        Xr = X.reshape(S, G, C, 32, 18)
        out = torch.zeros_like(Xr)
        ov = Xr.new_zeros(Xr.shape[:-1] + (9,))
        masks = [(kinds == k).unsqueeze(-1) for k in range(3)]
        for k in range(3):
            out += torch.where(masks[k], Xr @ self.A1t[k], 0.0)
            ov += torch.where(masks[k], Xr @ self.A2t[k], 0.0)
        ovprev = torch.cat([torch.zeros_like(ov[:, :1]), ov[:, :-1]], dim=1)
        del ov
        for k in range(3):
            out += torch.where(masks[k], ovprev @ self.B1t[k], 0.0)
        out *= self.sign
        return out.reshape(S, G, C * 576)

    def forward(self, X: torch.Tensor,
                kinds: torch.Tensor = None) -> torch.Tensor:
        S, G, C = X.shape[:3]
        d_in = 576 * self.nch
        if kinds is None:
            Y = X.reshape(S, G, C * 576)
        else:
            Y = self.imdct(X, kinds)
        Y = Y[..., :d_in]
        pcm = Y @ self.At
        if G > 1:
            pcm[:, 1:] += Y[:, :-1] @ self.BCt
        if G > 2:
            pcm[:, 2:] += Y[:, :-2] @ self.BDCt
        return pcm.reshape(S, G * 32 * self.nbands, self.nch)


@functools.lru_cache(maxsize=16)
def synth_module(nch: int, nbands: int, device: torch.device) -> Mp3Synth:
    """One cached Mp3Synth per (nch, nbands, device)."""
    return Mp3Synth(nch, nbands, device)
