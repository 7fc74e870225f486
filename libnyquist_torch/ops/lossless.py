"""The dense tail of the lossless decoders (FLAC, WavPack) on the device.

The entropy decode and the integer prediction stay on the host in C
(``native/flac_stream.c``, ``native/wv_words.c``, ``native/wv_dsd.c``);
their int32 samples, float bit patterns or DSD bytes go to the device in
one copy and finish there, bit for bit as the host formulas:

* ``scale_int``: int32 -> float32 times the float32 ``2^-(bits-1)``
  (FLAC and integer WavPack; a power of two, so the product is exact and
  only the int -> float32 conversion rounds, to nearest even on both
  sides);
* ``normalize_float_bits``: WavpackFloatNormalize with OPEN_NORMALIZE
  (reference: wavpack/src/common_utils.c:576) on IEEE-754 bit patterns,
  in integer ops, then a view as float32 (NaN payloads survive);
* ``dsd_decimate``: the 8:1 DSD -> 24-bit PCM decimation (reference:
  unpack_dsd.c decimate_dsd_run, OPEN_DSD_AS_PCM): a 56-tap integer filter
  done as 7 gathers of a [7, 256] table of per-byte partial sums, history
  primed with six 0x55 bytes, ``>> 4``, then ``x 2^-23``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EXP_MASK = 0xFF << 23              # the float32 exponent field
_SIGN = -(1 << 31)                  # the float32 sign bit as an int32

DSD_DECM_FILTER = (
    4, 17, 56, 147, 336, 692, 1315, 2337,
    3926, 6281, 9631, 14216, 20275, 28021, 37619, 49155,
    62616, 77870, 94649, 112551, 131049, 149507, 167220, 183448,
    197472, 208636, 216402, 220385, 220385, 216402, 208636, 197472,
    183448, 167220, 149507, 131049, 112551, 94649, 77870, 62616,
    49155, 37619, 28021, 20275, 14216, 9631, 6281, 3926,
    2337, 1315, 692, 336, 147, 56, 17, 4,
)
DSD_HISTORY = 6                     # bytes of history before each output


def scale_int(x: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 samples of ``bits`` significant bits -> float32 in [-1, 1),
    times the float32 ``2^-(bits-1)`` (a width below 1 raises ValueError,
    as the host formula's negative shift does)."""
    return x.to(torch.float32) * float(np.float32(1.0 / (1 << (bits - 1))))


def normalize_float_bits(bits: torch.Tensor, norm_exp) -> torch.Tensor:
    """float32 bit patterns (int32) re-biased from exponent ``norm_exp``
    to 127, as float32. ``norm_exp`` is an int, or an int32 tensor of
    ``bits``' shape (one value per sample, from each block's FLOAT_INFO).
    Exponents that leave the range flush to zero (sign dropped) or to
    infinity (sign kept); a block with ``norm_exp`` 127 passes through
    untouched, NaN payloads and denormals included."""
    if isinstance(norm_exp, int) and norm_exp == 127:
        return bits.view(torch.float32)
    delta = 127 - norm_exp
    e = (bits >> 23) & 0xFF
    new_e = e + delta
    out = (bits & ~_EXP_MASK) | (new_e.clamp(0, 255) << 23)
    out = torch.where((e == 0) | (new_e <= 0), torch.zeros_like(out), out)
    out = torch.where((e == 255) | (new_e >= 255),
                      (out & _SIGN) | _EXP_MASK, out)
    if not isinstance(delta, int):
        out = torch.where(delta == 0, bits, out)
    return out.view(torch.float32)


@functools.lru_cache(maxsize=1)
def dsd_table() -> np.ndarray:
    """[7, 256] int64: entry [i, b] is the filter's contribution of byte
    b at history position i (taps 8i..8i+7, MSB first, +term for a one
    bit, -term for a zero), with the taps scaled to 24 bits plus 4."""
    filt = np.asarray(DSD_DECM_FILTER, np.int64)
    scale = ((1 << 23) - 1) / float(filt.sum()) * 16.0
    lut = np.zeros((7, 256), np.int64)
    j = np.arange(256)
    for i in range(56):
        term = int(np.floor(filt[i] * scale + 0.5))
        if term:
            bit = (j & (0x80 >> (i & 7))) != 0
            lut[i >> 3] += np.where(bit, term, -term)
    return lut


@functools.lru_cache(maxsize=8)
def _dsd_table_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(dsd_table()).to(device)


def dsd_decimate_int(dsd: torch.Tensor) -> torch.Tensor:
    """DSD bytes [n, ch] uint8 -> 24-bit PCM [n, ch] int32."""
    n, ch = dsd.shape
    lut = _dsd_table_on(dsd.device)
    prime = torch.full((DSD_HISTORY, ch), 0x55, dtype=torch.uint8,
                       device=dsd.device)
    hist = torch.cat([prime, dsd]).to(torch.int64)
    acc = torch.zeros((n, ch), dtype=torch.int64, device=dsd.device)
    for i in range(DSD_HISTORY + 1):
        acc += lut[i][hist[i : i + n]]
    return (acc >> 4).to(torch.int32)


def dsd_decimate(dsd: torch.Tensor) -> torch.Tensor:
    """DSD bytes [n, ch] uint8 -> float32 PCM [n, ch] in [-1, 1]."""
    return scale_int(dsd_decimate_int(dsd), 24)
