"""Encoder API (reference: include/libnyquist/Encoders.h:33-41).

The reference fork declares ``encode_wav_to_disk`` / ``encode_opus_to_disk``
but ships no implementation; upstream libnyquist implements the WAV
encoder. This module provides:

* WAV (PCM u8/16/24/32 and IEEE float32) and AIFF (integer PCM)
  writers with the upstream validation semantics: the samples go to the
  device once, convert there (``ops/pcm.py`` ``float32_to_pcm``, with
  TPDF dither from an explicit ``torch.Generator`` on that device), and
  come back once for the bytes;
* Ogg Opus writers: CELT, SILK (with DTX and in-band FEC), hybrid,
  automatic mode selection, and family-1 multistream. Input at another
  rate is resampled to 48 kHz on the device (``ops/src.py``), as is
  SILK's front end to its internal rate; the encoders themselves are
  serial host NumPy (``formats/opus/*_encoder.py``, ``analysis.py``).

Every entry point takes ``device=None`` and runs its device work on
CUDA unless the caller names another device. Invalid input raises
ValueError with an ``EncoderError`` name; the ``*_to_disk`` forms return
the reference's integer codes.
"""

from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np
import torch

from .audio_data import AudioData, PCMFormat
from .device import resolve_device


class EncoderError(enum.IntEnum):
    """Mirrors Common.h:391-401."""

    NoError = 0
    InsufficientSampleData = 1
    FileIOError = 2
    UnsupportedSamplerate = 3
    UnsupportedChannelConfiguration = 4
    UnsupportedBitdepth = 5
    UnsupportedChannelMix = 6
    BufferTooBig = 7


class DitherType(enum.IntEnum):
    DITHER_NONE = 0
    DITHER_TRIANGLE = 1


@dataclasses.dataclass
class EncoderParams:
    """Mirrors Common.h:384-389."""

    channel_count: int
    target_format: PCMFormat
    dither: DitherType = DitherType.DITHER_NONE


_BITS = {
    PCMFormat.PCM_U8: 8,
    PCMFormat.PCM_16: 16,
    PCMFormat.PCM_24: 24,
    PCMFormat.PCM_32: 32,
    PCMFormat.PCM_FLT: 32,
}


def _pack24(v: np.ndarray) -> bytes:
    """int32 -> little-endian 3-byte packing."""
    b = np.empty((len(v), 3), np.uint8)
    u = v.astype(np.int64) & 0xFFFFFF
    b[:, 0] = u & 0xFF
    b[:, 1] = (u >> 8) & 0xFF
    b[:, 2] = (u >> 16) & 0xFF
    return b.tobytes()


def _f80(rate: int) -> bytes:
    """Encode a sample rate as an 80-bit IEEE extended float (AIFF COMM)."""
    if rate <= 0:
        raise ValueError(EncoderError.UnsupportedSamplerate.name)
    exp = rate.bit_length() - 1
    mant = rate << (63 - exp)
    return struct.pack(">HQ", 16383 + exp, mant)


def _check_pcm_params(p: EncoderParams, d: AudioData) -> None:
    if d.samples is None or len(d.samples) == 0:
        raise ValueError(EncoderError.InsufficientSampleData.name)
    if d.sample_rate <= 0:
        raise ValueError(EncoderError.UnsupportedSamplerate.name)
    if p.channel_count < 1 or p.channel_count > 8:
        raise ValueError(EncoderError.UnsupportedChannelConfiguration.name)


def _to_pcm(p: EncoderParams, d: AudioData, dither: bool, device,
            generator) -> np.ndarray:
    """The samples on the device in one copy, the stereo->mono mixdown
    (the only mix upstream supports) and the conversion there, and the
    integer (or float) samples back on the host in one copy."""
    from .ops import pcm as pcm_ops

    dev = resolve_device(device)
    x = d.samples
    x = (x.to(dev, torch.float32) if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev))
    if p.channel_count != d.channel_count:
        if d.channel_count == 2 and p.channel_count == 1:
            x = 0.5 * (x[0::2] + x[1::2])
        else:
            raise ValueError(EncoderError.UnsupportedChannelMix.name)
    if dither and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return pcm_ops.float32_to_pcm(x, p.target_format, dither=dither,
                                  generator=generator).cpu().numpy()


def encode_wav_to_buffer(p: EncoderParams, d: AudioData, device=None,
                         generator: torch.Generator = None) -> bytes:
    """Serialize AudioData to a RIFF/WAVE byte string. Dither noise comes
    from ``generator`` (on ``device``), else from one seeded with 0.

    Raises ValueError with an EncoderError name on invalid input;
    encode_wav_to_disk converts these to the reference's int codes.
    """
    _check_pcm_params(p, d)
    if p.target_format not in _BITS:
        raise ValueError(EncoderError.UnsupportedBitdepth.name)
    pcm = _to_pcm(p, d, p.dither == DitherType.DITHER_TRIANGLE
                  and p.target_format != PCMFormat.PCM_FLT, device,
                  generator)

    bits = _BITS[p.target_format]
    is_float = p.target_format == PCMFormat.PCM_FLT
    if p.target_format == PCMFormat.PCM_24:
        payload = _pack24(pcm)
    else:
        payload = pcm.tobytes()

    # RIFF sizes are uint32 (Common.h EncoderError::BufferTooBig): the
    # data chunk length and the total RIFF size must both fit.
    if len(payload) + 64 > 0xFFFFFFFF:
        raise ValueError(EncoderError.BufferTooBig.name)

    ch = p.channel_count
    byte_rate = d.sample_rate * ch * (bits // 8)
    block_align = ch * (bits // 8)
    fmt_code = 3 if is_float else 1

    out = bytearray()
    out += b"RIFF"
    out += b"\x00\x00\x00\x00"  # patched below
    out += b"WAVE"
    out += b"fmt "
    out += struct.pack("<IHHIIHH", 16, fmt_code, ch, d.sample_rate,
                       byte_rate, block_align, bits)
    if is_float:
        out += b"fact" + struct.pack("<II", 4, len(pcm) // ch)
    out += b"data" + struct.pack("<I", len(payload))
    out += payload
    if len(payload) & 1:
        out += b"\x00"
    struct.pack_into("<I", out, 4, len(out) - 8)
    return bytes(out)


def _to_disk(encode, path: str) -> int:
    try:
        buf = encode()
    except ValueError as e:
        if str(e) in EncoderError.__members__:
            return int(EncoderError[str(e)])
        raise
    try:
        with open(path, "wb") as f:
            f.write(buf)
    except OSError:
        return int(EncoderError.FileIOError)
    return int(EncoderError.NoError)


def encode_wav_to_disk(p: EncoderParams, d: AudioData, path: str,
                       device=None) -> int:
    """Reference signature (Encoders.h:36): returns an EncoderError code."""
    return _to_disk(lambda: encode_wav_to_buffer(p, d, device), path)


def encode_aiff_to_buffer(p: EncoderParams, d: AudioData, device=None,
                          generator: torch.Generator = None) -> bytes:
    """Serialize AudioData to an AIFF byte string (big-endian PCM).

    Writer parity with the reference example app, which saves WAV and
    AIFF (reference: examples/src/AudioFile.h:105). Integer PCM
    8/16/24/32; AIFF stores signed 8-bit (unlike WAV's unsigned), so
    PCM_U8 is written as signed. Float output would need an AIFC "fl32"
    container and is rejected, as by the reference writer.
    """
    _check_pcm_params(p, d)
    if p.target_format not in _BITS or p.target_format == PCMFormat.PCM_FLT:
        raise ValueError(EncoderError.UnsupportedBitdepth.name)
    pcm = _to_pcm(p, d, p.dither == DitherType.DITHER_TRIANGLE, device,
                  generator)

    bits = _BITS[p.target_format]
    if p.target_format == PCMFormat.PCM_U8:
        payload = (pcm.astype(np.int16) - 128).astype(np.int8).tobytes()
    elif p.target_format == PCMFormat.PCM_24:
        le = np.frombuffer(_pack24(pcm), np.uint8).reshape(-1, 3)
        payload = le[:, ::-1].tobytes()
    else:
        payload = pcm.astype(">i%d" % (bits // 8)).tobytes()

    ch = p.channel_count
    frames = len(pcm) // ch
    if len(payload) + 64 > 0xFFFFFFFF:
        raise ValueError(EncoderError.BufferTooBig.name)

    out = bytearray()
    out += b"FORM\x00\x00\x00\x00AIFF"
    out += b"COMM" + struct.pack(">IhIh", 18, ch, frames, bits) + _f80(
        d.sample_rate)
    out += b"SSND" + struct.pack(">III", len(payload) + 8, 0, 0)
    out += payload
    if len(payload) & 1:
        out += b"\x00"
    struct.pack_into(">I", out, 4, len(out) - 8)
    return bytes(out)


def encode_aiff_to_disk(p: EncoderParams, d: AudioData, path: str,
                        device=None) -> int:
    """AIFF analog of encode_wav_to_disk: returns an EncoderError code."""
    return _to_disk(lambda: encode_aiff_to_buffer(p, d, device), path)


def _host_samples(d: AudioData) -> np.ndarray:
    """The samples on the host; NaN or Inf input is refused with the
    typed error (it would otherwise surface deep in the analysis)."""
    if d.samples is None or len(d.samples) == 0:
        raise ValueError(EncoderError.InsufficientSampleData.name)
    x = d.samples
    x = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x))
    if not np.isfinite(x).all():
        raise ValueError(EncoderError.InsufficientSampleData.name)
    return x


def _to_48k(samples: np.ndarray, ch: int, rate: int, device) -> np.ndarray:
    """Interleaved float32 at ``rate`` -> interleaved float32 at 48 kHz,
    the channels resampled together on ``device``."""
    if rate == 48000:
        return samples
    from .ops.src import resample

    per = resample(samples.reshape(-1, ch).T, rate, 48000, device=device)
    return per.cpu().numpy().T.reshape(-1).astype(np.float32)


def encode_opus_to_buffer(p: EncoderParams, d: AudioData,
                          bitrate_kbps: int = 96,
                          frame_ms: float = 20,
                          mode: str = "celt",
                          bandwidth: str = "wb",
                          dtx: bool = False,
                          fec: bool = False,
                          device=None) -> bytes:
    """Encode AudioData to Ogg Opus.

    mode="celt" (default): CELT-only fullband frames of 2.5/5/10/20 ms.
    mode="silk": SILK-only, mono or stereo (mid/side with per-frame
    stereo prediction; reference: silk/enc_API.c, stereo_LR_to_MS.c),
    closed-loop VBR (bitrate_kbps is ignored); bandwidth "nb" (8 kHz),
    "mb" (12 kHz) or "wb" (16 kHz); frame_ms 10/20/40/60. dtx=True
    (SILK mono and CELT) writes TOC-only packets through silence with a
    ~400 ms refresh. fec=True (SILK 20 ms) adds in-band LBRR: each
    packet re-encodes the previous frame at coarser gains, so a lost
    packet recovers from the next (``OpusDecoder.decode_packet(next,
    fec=True)``).
    mode="hybrid": SILK low band plus CELT from 8 kHz up in one range
    coder per packet, mono or stereo, frame_ms 10/20, bandwidth "swb" or
    "fb" (anything else means "fb").
    mode="auto": per-segment celt/silk/hybrid selection from a
    speech/music analysis (formats/opus/analysis.py), 20 ms frames.

    Input at another rate is resampled to 48 kHz with the polyphase SRC
    on ``device`` first; SILK's front end resamples on it too.
    """
    x = _host_samples(d)
    ch = d.channel_count
    if p.channel_count != ch:
        if ch == 2 and p.channel_count == 1:
            x, ch = 0.5 * (x[0::2] + x[1::2]), 1
        else:
            raise ValueError(EncoderError.UnsupportedChannelMix.name)
    x = x.astype(np.float32, copy=False)
    if ch not in (1, 2):
        raise ValueError(EncoderError.UnsupportedChannelConfiguration.name)
    samples = _to_48k(x, ch, d.sample_rate, device)
    if mode == "auto":
        from .formats.opus.analysis import encode_ogg_opus_auto

        return encode_ogg_opus_auto(samples, ch, bitrate_kbps=bitrate_kbps,
                                    dtx=dtx, fec=fec, device=device)
    if mode == "silk":
        from .formats.opus import silk_encoder

        if ch == 2:
            return silk_encoder.encode_ogg_opus_silk_stereo(
                samples, 48000, bandwidth=bandwidth, frame_ms=int(frame_ms),
                lbrr=fec, device=device)
        return silk_encoder.encode_ogg_opus_silk(
            samples, 48000, bandwidth=bandwidth, frame_ms=int(frame_ms),
            dtx=dtx, lbrr=fec, device=device)
    if mode == "hybrid":
        from .formats.opus.hybrid_encoder import encode_ogg_opus_hybrid

        return encode_ogg_opus_hybrid(
            samples, 48000, bitrate_kbps, channels=ch,
            frame_ms=int(frame_ms),
            bandwidth=bandwidth if bandwidth in ("swb", "fb") else "fb",
            device=device)
    from .formats.opus.celt_encoder import encode_ogg_opus

    return encode_ogg_opus(samples, ch, 48000, bitrate_kbps,
                           frame_ms=frame_ms, dtx=dtx)


def encode_opus_multistream_to_buffer(p: EncoderParams, d: AudioData,
                                      bitrate_kbps: int | None = None,
                                      frame_ms: float = 20,
                                      device=None) -> bytes:
    """Encode 1-8 channel AudioData to Ogg Opus with channel mapping
    family 1 (the reference's surround encoder surface,
    opus_multistream_encoder.c, and RFC 7845 §5.1.1.2). Channels in
    Vorbis surround order; bitrate_kbps is the total target (default 48
    kbps a channel). Input at another rate is resampled on ``device``."""
    x = _host_samples(d).astype(np.float32, copy=False)
    ch = d.channel_count
    if not 1 <= ch <= 8:
        raise ValueError(EncoderError.UnsupportedChannelConfiguration.name)
    from .formats.opus.celt_encoder import encode_ogg_opus_multistream

    return encode_ogg_opus_multistream(
        _to_48k(x, ch, d.sample_rate, device), ch, 48000, bitrate_kbps,
        frame_ms=frame_ms)


def encode_opus_to_disk(p: EncoderParams, d: AudioData, path: str,
                        device=None) -> int:
    """Reference signature (Encoders.h:40): returns an EncoderError code."""
    return _to_disk(lambda: encode_opus_to_buffer(p, d, device=device), path)
