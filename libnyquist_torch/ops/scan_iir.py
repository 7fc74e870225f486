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

from ..device import resident

BLOCK = 128
COEF = 0.85000610351562500


@functools.lru_cache(maxsize=None)
def _toeplitz(coef: float, block: int) -> np.ndarray:
    """Lower-triangular T with T[i, j] = coef^(i-j) for i >= j."""
    i = np.arange(block)
    d = i[:, None] - i[None, :]
    T = np.where(d >= 0, np.power(float(coef), np.maximum(d, 0)), 0.0)
    return T.astype(np.float32)


def _toeplitz_t(coef: float, device: torch.device) -> torch.Tensor:
    """T transposed, resident on the device."""
    return resident(("deemph_T", coef, BLOCK),
                    lambda: _toeplitz(coef, BLOCK).T, device)


def _carry_terms(coef: float, device: torch.device):
    """(coef^BLOCK, [coef^1 .. coef^BLOCK]) in float32, resident on the
    device: the block carry's decay and the tail's powers."""
    c32 = torch.tensor(coef, dtype=torch.float32)
    decay = resident(("deemph_decay", coef, BLOCK), lambda: c32 ** BLOCK,
                     device)
    powers = resident(
        ("deemph_powers", coef, BLOCK),
        lambda: c32 ** torch.arange(1, BLOCK + 1, dtype=torch.float32),
        device)
    return decay, powers


def row_products(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a [B, M, K] @ m [K, P] as B products of [M, K] @ [K, P]: each
    call's shape, and so the library's reduction order, is the same for
    every B."""
    out = a.new_empty(a.shape[0], a.shape[1], m.shape[1])
    for b in range(a.shape[0]):
        torch.mm(a[b], m, out=out[b])
    return out


def deemphasis(x: torch.Tensor, mem: torch.Tensor, coef: float = COEF,
               per_row: bool = False):
    """y[n] = x[n] + coef * y[n-1], batched.

    Args:
      x: [B, S] input (S padded to a multiple of BLOCK by the caller).
      mem: [B] carry (previous stream sample's y).
      per_row: one [S/BLOCK, BLOCK] product per row, so that a row's
        output does not depend on B (a matrix library may pick another
        reduction order for another row count).
    Returns (y [B, S], new_mem [B]).
    """
    B, S = x.shape
    if S % BLOCK:
        raise ValueError(f"deemphasis: S={S} is not a multiple of {BLOCK}")
    nblk = S // BLOCK
    # Within-block solution with zero carry.
    T = _toeplitz_t(coef, x.device)
    if per_row:
        y0 = row_products(x.reshape(B, nblk, BLOCK), T)
    else:
        y0 = (x.reshape(B * nblk, BLOCK) @ T).reshape(B, nblk, BLOCK)
    # Block carries: c_n = coef^L * c_{n-1} + y0_last[n]; contributions
    # from two blocks back vanish below float32 resolution, so the exact
    # scan reduces to a single shifted multiply-add.
    decay, powers = _carry_terms(coef, x.device)
    last = y0[:, :, -1]                                   # [B, nblk]
    shifted = torch.cat([mem[:, None], last[:, :-1]], dim=1)
    carries = last + decay * shifted                      # c_n
    prev_carry = torch.cat([mem[:, None], carries[:, :-1]], dim=1)
    # Add the carried tail: y[n, i] = y0[n, i] + coef^(i+1) * c_{n-1}.
    y = y0 + prev_carry[:, :, None] * powers[None, None, :]
    return y.reshape(B, S), carries[:, -1]
