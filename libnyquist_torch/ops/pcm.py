"""PCM <-> float32 conversion, dither and channel interleave on the device.

The reference converts one sample at a time on the CPU (reference:
src/Common.cpp:223-362 ConvertToFloat32/ConvertFromFloat32,
include/libnyquist/Common.h:273-313 dither and scale macros, :647-694
interleave helpers). Here the raw bytes go to the device as integers in
one copy and the whole buffer converts there: the 24-bit unpack, the
sign extension and the scale are tensor expressions, and big-endian
input is byte-swapped on the device too (torch has no big-endian dtypes).

Scaling conventions follow the reference exactly:
  u8:  (x - 128) / 127            (Common.h int8_to_float32 via uint8 bias)
  s8:  x / 127
  s16: x / 32767
  s24: x / 8388607
  s32: x / 2147483647
  s64: x / 9223372036854775807, divided in float64
  f32/f64: passthrough / cast
Each scale is the float32 product by the float32 reciprocal, as the
reference package computes it, so integer formats convert bit for bit.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..audio_data import PCMFormat

_INT_SCALE = {
    PCMFormat.PCM_S8: 127.0,
    PCMFormat.PCM_16: 32767.0,
    PCMFormat.PCM_24: 8388607.0,
    PCMFormat.PCM_32: 2147483647.0,
}
_LE_DTYPES = {
    PCMFormat.PCM_U8: np.uint8, PCMFormat.PCM_S8: np.int8,
    PCMFormat.PCM_16: "<i2", PCMFormat.PCM_32: "<i4",
    PCMFormat.PCM_64: "<i8", PCMFormat.PCM_FLT: "<f4",
    PCMFormat.PCM_DBL: "<f8",
}
_TORCH_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}
_TORCH_FLOAT = {4: torch.float32, 8: torch.float64}


def _recip(scale: float) -> float:
    """1/scale rounded to float32 (exact as a Python float)."""
    return float(np.float32(1.0 / scale))


def bytes_to_int_array(data, fmt: PCMFormat) -> np.ndarray:
    """View raw little-endian PCM bytes as a host array, without a copy;
    PCM_24 comes back as [n, 3] uint8 for the device unpack."""
    if fmt == PCMFormat.PCM_24:
        return np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
    if fmt not in _LE_DTYPES:
        raise ValueError(f"unsupported source format {fmt}")
    return np.frombuffer(data, dtype=_LE_DTYPES[fmt])


def host_to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array (a read-only view of the file's bytes, often) on
    ``device`` in one copy. The tensor over the view is only read."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(arr)
    return t.to(device)


def pcm_to_float32(raw: torch.Tensor, fmt: PCMFormat) -> torch.Tensor:
    """Normalize integer/float PCM to float32 in [-1, 1] where ``raw``
    lies (PCM_24: [n, 3] uint8 little-endian bytes)."""
    if fmt == PCMFormat.PCM_U8:
        return (raw.to(torch.float32) - 128.0) * _recip(127.0)
    if fmt == PCMFormat.PCM_24:
        return _unpack24_normalize(raw)
    if fmt == PCMFormat.PCM_FLT:
        return raw.to(torch.float32, copy=True)
    if fmt == PCMFormat.PCM_DBL:
        return raw.to(torch.float32)
    if fmt == PCMFormat.PCM_64:
        return (raw.to(torch.float64) / 9223372036854775807.0).to(
            torch.float32)
    return raw.to(torch.float32) * _recip(_INT_SCALE[fmt])


def _unpack24_normalize(b: torch.Tensor) -> torch.Tensor:
    """[n, 3] uint8 LE bytes -> sign-extended int24 -> float32 / 2^23-1
    (the reference's byte-assembly loop, src/Common.cpp:254-268)."""
    b = b.to(torch.int32)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    v = torch.where(v >= (1 << 23), v - (1 << 24), v)
    return v.to(torch.float32) * _recip(8388607.0)


def be_to_float32(raw: torch.Tensor, bits: int, is_float: bool = False
                  ) -> torch.Tensor:
    """Big-endian PCM bytes (uint8, whole samples) -> float32 in [-1, 1]:
    signed integers of 8, 16, 24 or 32 bits, or IEEE floats of 32/64. The
    bytes are swapped where ``raw`` lies."""
    k = bits // 8
    if bits == 8 and not is_float:
        return pcm_to_float32(raw.view(torch.int8), PCMFormat.PCM_S8)
    le = raw.view(-1, k).flip(1).contiguous()       # [n, k] little-endian
    if bits == 24 and not is_float:
        return _unpack24_normalize(le)
    if is_float:
        return le.view(_TORCH_FLOAT[k]).reshape(-1).to(torch.float32)
    fmt = {2: PCMFormat.PCM_16, 4: PCMFormat.PCM_32}[k]
    return pcm_to_float32(le.view(_TORCH_INT[k]).reshape(-1), fmt)


def float32_to_pcm(x: torch.Tensor, fmt: PCMFormat, dither: bool = False,
                   seed: int = 0, generator: torch.Generator = None
                   ) -> torch.Tensor:
    """Quantize float32 [-1, 1] back to integer PCM, optionally with TPDF
    dither of 1 LSB peak to peak (reference: ConvertFromFloat32,
    src/Common.cpp:318-362, and the triangle dither of
    Common.h:273-294). The noise comes from ``generator`` (on x's device),
    or from a fresh one seeded with ``seed``."""
    if fmt == PCMFormat.PCM_FLT:
        return x.to(torch.float32)
    if fmt == PCMFormat.PCM_DBL:
        return x.to(torch.float64)
    scale = _INT_SCALE.get(fmt, 127.0 if fmt == PCMFormat.PCM_U8 else None)
    if scale is None:
        raise ValueError(f"unsupported target format {fmt}")
    y = x.to(torch.float32)
    if dither:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(seed)
        u = torch.rand((2,) + tuple(x.shape), generator=generator,
                       device=x.device)
        y = y + (u[0] + u[1] - 1.0) / scale
    v = torch.round(torch.clamp(y, -1.0, 1.0) * scale)
    if fmt == PCMFormat.PCM_U8:
        return (v + 128.0).to(torch.uint8)
    if fmt == PCMFormat.PCM_S8:
        return v.to(torch.int8)
    if fmt == PCMFormat.PCM_16:
        return v.to(torch.int16)
    # 1.0 * 2^31 - 1 rounds to 2^31 in float32: saturate as the
    # reference package's conversion does
    return v.to(torch.float64).clamp(-2147483648.0, 2147483647.0).to(
        torch.int32)


def convert_buffer_to_float32(data, fmt: PCMFormat, device) -> torch.Tensor:
    """Little-endian PCM bytes -> normalized float32 on ``device``: one
    copy of the raw samples to the device, the conversion there."""
    return pcm_to_float32(host_to_device(bytes_to_int_array(data, fmt),
                                         device), fmt)


def interleave(channels: torch.Tensor) -> torch.Tensor:
    """[C, N] -> interleaved [N*C] (reference: Common.h:647-660)."""
    return channels.T.reshape(-1)


def deinterleave(samples: torch.Tensor, num_channels: int) -> torch.Tensor:
    """Interleaved [N*C] -> [C, N] (reference: Common.h:662-675)."""
    return samples.reshape(-1, num_channels).T


def stereo_to_mono(stereo_interleaved: torch.Tensor) -> torch.Tensor:
    """Average L/R (reference: Common.h:677-685)."""
    pairs = stereo_interleaved.reshape(-1, 2)
    return 0.5 * (pairs[:, 0] + pairs[:, 1])


def mono_to_stereo(mono: torch.Tensor) -> torch.Tensor:
    """Duplicate a mono channel (reference: Common.h:687-694)."""
    return torch.stack([mono, mono], dim=1).reshape(-1)
