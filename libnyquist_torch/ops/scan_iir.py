"""CELT deemphasis as a block-Toeplitz product.

Deemphasis is a 1-pole IIR carried across every sample (reference:
celt_decoder_clean.c:189-256, ``m = coef0*tmp`` per sample). Split the
stream into blocks of L samples: within a block the recurrence is a
lower-triangular Toeplitz product y = T @ x; the block-to-block carry
has ratio coef^L ~ 1e-9, so it collapses to one shifted multiply-add
(terms from two blocks back are below float32 resolution). The product
is a plain ``torch.matmul``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

BLOCK = 128
COEF = 0.85000610351562500


@functools.lru_cache(maxsize=None)
def _toeplitz(coef: float, block: int) -> np.ndarray:
    """Lower-triangular T with T[i, j] = coef^(i-j) for i >= j."""
    i = np.arange(block)
    d = i[:, None] - i[None, :]
    T = np.where(d >= 0, np.power(float(coef), np.maximum(d, 0)), 0.0)
    return T.astype(np.float32)


_DEVICE_T: dict = {}


def _toeplitz_t(coef: float, device: torch.device) -> torch.Tensor:
    """T transposed, uploaded once per (coef, device)."""
    k = (coef, str(device))
    t = _DEVICE_T.get(k)
    if t is None:
        t = torch.from_numpy(
            np.ascontiguousarray(_toeplitz(coef, BLOCK).T)).to(device)
        _DEVICE_T[k] = t
    return t


def deemphasis(x: torch.Tensor, mem: torch.Tensor, coef: float = COEF):
    """y[n] = x[n] + coef * y[n-1], batched.

    Args:
      x: [B, S] input (S padded to a multiple of BLOCK by the caller).
      mem: [B] carry (previous stream sample's y).
    Returns (y [B, S], new_mem [B]).
    """
    B, S = x.shape
    if S % BLOCK:
        raise ValueError(f"deemphasis: S={S} is not a multiple of {BLOCK}")
    nblk = S // BLOCK
    # Within-block solution with zero carry.
    y0 = (x.reshape(B * nblk, BLOCK) @ _toeplitz_t(coef, x.device)
          ).reshape(B, nblk, BLOCK)
    # Block carries: c_n = coef^L * c_{n-1} + y0_last[n]; contributions
    # from two blocks back vanish below float32 resolution, so the exact
    # scan reduces to a single shifted multiply-add.
    c32 = torch.tensor(coef, dtype=torch.float32, device=x.device)
    last = y0[:, :, -1]                                   # [B, nblk]
    decay = c32 ** BLOCK
    shifted = torch.cat([mem[:, None], last[:, :-1]], dim=1)
    carries = last + decay * shifted                      # c_n
    prev_carry = torch.cat([mem[:, None], carries[:, :-1]], dim=1)
    # Add the carried tail: y[n, i] = y0[n, i] + coef^(i+1) * c_{n-1}.
    powers = c32 ** torch.arange(1, BLOCK + 1, dtype=torch.float32,
                                 device=x.device)
    y = y0 + prev_carry[:, :, None] * powers[None, None, :]
    return y.reshape(B, S), carries[:, -1]
