"""IMA-ADPCM decode as log-step scans on the device.

The reference decodes IMA-ADPCM with a serial per-nibble predictor loop
(reference: src/WavDecoder.cpp:75-134, decode_nibble + decode_ima_adpcm).
Both of its carried states are scans:

* the step index evolves as s' = clip(s + index_table[nibble], 0, 88), a
  composition of "add then clip" maps; such maps stay in the family
  f(s) = clip(s + a, lo, hi) under composition, so the whole sequence is
  one inclusive scan of (a, lo, hi) triples, run here as a Hillis-Steele
  (log-step) scan over the nibble axis: about 11 steps for the usual
  ~2,000-nibble blocks;
* the WAV predictor wraps as a C int16 (WavDecoder.cpp:87), so it is a
  plain cumulative sum taken mod 2^16; Apple's 'ima4' saturates at the
  int16 rails instead, which is the same clip-compose scan again.

Each block carries its own predictor and step header, so decode is
batched over [blocks x channels] rows with no carry between rows. The
nibbles are split from the raw bytes on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..runtime.batching import bucket_size
from .pcm import host_to_device

# Standard IMA tables (spec constants; reference: WavDecoder.cpp:40-72).
IMA_INDEX_TABLE = np.array(
    [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], np.int32
)
IMA_STEP_TABLE = np.array(
    [
        7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34,
        37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143,
        157, 173, 190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494,
        544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552,
        1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026,
        4428, 4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442,
        11487, 12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623,
        27086, 29794, 32767,
    ],
    np.int32,
)
# A header step index past the table reads this in the reference
# package's gather (its out-of-bounds fill for int32)
_STEP_FILL = np.iinfo(np.int32).min
_PAD_BLOCKS = 16     # the reference package's smallest block bucket


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    return (torch.from_numpy(IMA_INDEX_TABLE).to(device),
            torch.from_numpy(IMA_STEP_TABLE).to(device))


def clip_compose_scan(a, lo, hi):
    """Inclusive scan over dim 1 of the maps f(s) = clip(s + a, lo, hi),
    each element composed after the ones before it: log-step
    (Hillis-Steele), log2(S) rounds of one shifted compose each.

    With (a1, lo1, hi1) then (a2, lo2, hi2):
      g(f(s)) = clip(s + a1 + a2, clip(lo1 + a2, lo2, hi2),
                     clip(hi1 + a2, lo2, hi2))
    """
    d = 1
    S = a.shape[1]
    while d < S:
        a2, lo2, hi2 = a[:, d:], lo[:, d:], hi[:, d:]
        na = a[:, :-d] + a2
        nlo = torch.clamp(lo[:, :-d] + a2, lo2, hi2)
        nhi = torch.clamp(hi[:, :-d] + a2, lo2, hi2)
        a = torch.cat([a[:, :d], na], 1)
        lo = torch.cat([lo[:, :d], nlo], 1)
        hi = torch.cat([hi[:, :d], nhi], 1)
        d *= 2
    return a, lo, hi


def _step_and_diff(nibbles, init_step):
    """The signed difference each nibble adds to the predictor, from the
    step index in force before it."""
    idx_t, step_t = _tables(nibbles.device)
    deltas = idx_t[nibbles.long()]
    a, slo, shi = clip_compose_scan(
        deltas, torch.zeros_like(deltas), torch.full_like(deltas, 88))
    s_after = torch.clamp(init_step[:, None] + a, slo, shi)
    s_used = torch.cat([init_step[:, None], s_after[:, :-1]], 1)
    step = torch.where(s_used <= 88, step_t[s_used.clamp(0, 88).long()],
                       torch.full_like(s_used, _STEP_FILL))
    zero = torch.zeros_like(step)
    diff = ((step >> 3)
            + torch.where((nibbles & 4) != 0, step, zero)
            + torch.where((nibbles & 2) != 0, step >> 1, zero)
            + torch.where((nibbles & 1) != 0, step >> 2, zero))
    return torch.where((nibbles & 8) != 0, -diff, diff)


def decode_ima_nibbles(nibbles: torch.Tensor, init_predictor: torch.Tensor,
                       init_step: torch.Tensor) -> torch.Tensor:
    """Batched nibble rows -> int16 PCM (as int32), WAV semantics.

    Args:
      nibbles: [B, S] int32 in [0, 15], S nibbles per block-channel.
      init_predictor: [B] int32 initial predictor (header bytes 0-1).
      init_step: [B] int32 initial step index (header byte 2).
    Returns [B, S] int32 samples, the predictor wrapping mod 2^16.
    """
    diff = _step_and_diff(nibbles, init_step)
    psum = init_predictor[:, None].long() + torch.cumsum(diff, 1)
    return (((psum + 0x8000) & 0xFFFF) - 0x8000).to(torch.int32)


def decode_ima4_nibbles(nibbles: torch.Tensor, init_predictor: torch.Tensor,
                        init_step: torch.Tensor) -> torch.Tensor:
    """Apple 'ima4' variant (AIFF-C / CAF packets): the same tables, the
    predictor saturating at the int16 rails (a clip-compose scan)."""
    diff = _step_and_diff(nibbles, init_step)
    pa, plo, phi = clip_compose_scan(diff, torch.full_like(diff, -32768),
                                     torch.full_like(diff, 32767))
    return torch.clamp(init_predictor[:, None] + pa, plo, phi)


def _nibbles(per_row: torch.Tensor) -> torch.Tensor:
    """[rows, n] bytes -> [rows, 2n] int32 nibbles, low nibble first."""
    b = per_row.to(torch.int32)
    return torch.stack([b & 0xF, b >> 4], -1).reshape(b.shape[0], -1)


def unpack_ima4_packets(data: torch.Tensor, channels: int):
    """Split an Apple ima4 payload (uint8, on its device) into per-packet
    nibble rows.

    Packet layout (AIFF-C 'ima4' / CAF ima4): per channel a 34-byte
    packet — a 2-byte big-endian header (bits 15..7: the predictor's top
    9 bits, bits 6..0: the step index), then 32 bytes = 64 nibbles, low
    nibble first; the channels' packets of one 64-frame group adjacent.
    Returns (nibbles [n_packets, 64], predictors, steps), rows group-major
    then channel.
    """
    n_packets = data.numel() // 34
    pk = data[: n_packets * 34].view(n_packets, 34).to(torch.int32)
    hdr = (pk[:, 0] << 8) | pk[:, 1]
    predictors = ((hdr & 0xFF80) ^ 0x8000) - 0x8000        # int16 sign
    steps = torch.clamp(hdr & 0x7F, max=88)
    return _nibbles(pk[:, 2:]), predictors, steps


def _finalize(decoded: torch.Tensor, channels: int) -> torch.Tensor:
    """[n_blocks*channels, S] int32 -> interleaved float32 [-1, 1]."""
    nb_c, s = decoded.shape
    d = decoded.view(nb_c // channels, channels, s)
    inter = d.permute(0, 2, 1).reshape(-1)
    return inter.to(torch.float32) * float(np.float32(1.0 / 32767.0))


def _to_length(inter, total_samples, padded_len):
    """Cut to total_samples; where the header asks for more than the
    payload decodes, the reference package's bucket-padded decode gives
    zeros up to its padded length, and so does this."""
    want = min(int(total_samples), padded_len)
    if want <= inter.numel():
        return inter[:want]
    return torch.cat([inter, inter.new_zeros(want - inter.numel())])


def decode_ima4(data: np.ndarray, channels: int, total_samples: int,
                device) -> torch.Tensor:
    """Apple ima4 payload (host uint8) -> interleaved float32 on
    ``device``, cut to total_samples."""
    raw = host_to_device(data, device)
    nibbles, preds, steps = unpack_ima4_packets(raw, channels)
    rows = nibbles.shape[0]
    n_groups = -(-rows // channels)
    pad = n_groups * channels - rows
    decoded = decode_ima4_nibbles(nibbles, preds, steps)
    if pad:                 # a part group: its missing packets decode to 0
        decoded = torch.cat([decoded, decoded.new_zeros(pad, 64)])
    padded_len = bucket_size(max(rows // channels, 1), _PAD_BLOCKS) * (
        channels * 64)
    return _to_length(_finalize(decoded, channels), total_samples,
                      padded_len)


def check_ima_headers(data: np.ndarray, block_size: int, channels: int):
    """The reserved header byte of every block-channel must be 0
    (reference: WavDecoder.cpp:113); read on the host without a copy."""
    n_blocks = data.size // block_size
    blocks = data[: n_blocks * block_size].reshape(n_blocks, block_size)
    if np.any(blocks[:, 3 : 4 * channels : 4] != 0):
        raise ValueError("adpcm decode error")


def unpack_ima_blocks(data: torch.Tensor, block_size: int, channels: int):
    """Split a raw WAV IMA-ADPCM payload (uint8, on its device) into
    per-(block, channel) nibble rows.

    Block layout (reference: WavDecoder.cpp:104-130): per channel a
    4-byte header (predictor lo, predictor hi, step index, reserved 0),
    then the payload as interleaved 4-byte words per channel, each byte
    two samples, low nibble first.
    Returns (nibbles [n_blocks*channels, S], predictors, steps).
    """
    n_blocks = data.numel() // block_size
    blocks = data[: n_blocks * block_size].view(n_blocks, block_size)
    hdr = blocks[:, : 4 * channels].reshape(n_blocks, channels, 4).to(
        torch.int32)
    predictors = ((hdr[:, :, 0] | (hdr[:, :, 1] << 8)) ^ 0x8000) - 0x8000
    steps = hdr[:, :, 2]
    payload = blocks[:, 4 * channels:]
    words = (block_size - 4 * channels) // (4 * channels)
    per_chan = payload[:, : words * 4 * channels].reshape(
        n_blocks, words, channels, 4).permute(0, 2, 1, 3).reshape(
        n_blocks * channels, words * 4)
    return _nibbles(per_chan), predictors.reshape(-1), steps.reshape(-1)


def decode_ima_adpcm(data: np.ndarray, block_size: int, channels: int,
                     total_samples: int, device) -> torch.Tensor:
    """A WAV IMA-ADPCM payload (host uint8) -> interleaved float32 on
    ``device``, cut to total_samples (= the fact chunk's length times
    channels, reference WavDecoder.cpp:297)."""
    check_ima_headers(data, block_size, channels)
    raw = host_to_device(data, device)
    nibbles, preds, steps = unpack_ima_blocks(raw, block_size, channels)
    decoded = decode_ima_nibbles(nibbles, preds, steps)
    n_blocks = data.size // block_size
    padded_len = bucket_size(n_blocks, _PAD_BLOCKS) * channels * (
        nibbles.shape[1])
    return _to_length(_finalize(decoded, channels), total_samples,
                      padded_len)
