"""AIFF / AIFF-C (.aiff/.aif/.aifc) and CAF (.caf) decoders.

The reference ships Apple-container IMA4 fixtures and its example app
writes AIFF (reference: examples/src/AudioFile.h:105), but registers no
reader for either container. This module covers both: AIFF PCM, the
AIFF-C compression types NONE/twos/sowt/raw/fl32/fl64/ima4/ulaw/alaw, and
CAF lpcm/ima4/ulaw/alaw.

The chunk parse stays on the host; the payload goes to the device as raw
bytes in one copy, and the byte swap of big-endian samples, the integer
and float conversions, the G.711 expansions and the ima4 scans
(``ops/adpcm.py``) run there.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..audio_data import AudioData, PCMFormat
from ..errors import DecodeError
from ..ops import pcm as pcm_ops

_PCM_BE = {8: PCMFormat.PCM_S8, 16: PCMFormat.PCM_16,
           24: PCMFormat.PCM_24, 32: PCMFormat.PCM_32}


def _parse_f80(b: bytes) -> int:
    """80-bit IEEE extended float -> integer sample rate."""
    if len(b) != 10:
        raise DecodeError("bad extended-float field")
    exp = ((b[0] & 0x7F) << 8) | b[1]
    mant = int.from_bytes(b[2:10], "big")
    if exp == 0 and mant == 0:
        return 0
    val = mant * 2.0 ** (exp - 16383 - 63)
    if b[0] & 0x80:
        val = -val
    return int(round(val))


def _bytes(raw, itemsize: int, device, whole: bool = True) -> torch.Tensor:
    """The payload's samples as uint8 on ``device``. ``whole``: the
    length must be a multiple of ``itemsize`` (else ValueError, as a
    NumPy view of that dtype raises); otherwise a part sample is
    dropped."""
    arr = np.frombuffer(raw, np.uint8)
    if arr.size % itemsize:
        if whole:
            raise ValueError("buffer size must be a multiple of element size")
        arr = arr[: arr.size - arr.size % itemsize]
    return pcm_ops.host_to_device(arr, device)


def _be_int_to_float(raw: bytes, bits: int, device) -> torch.Tensor:
    """Big-endian signed PCM -> float32 in [-1, 1], swapped and converted
    on the device."""
    if bits not in _PCM_BE:
        raise DecodeError(f"unsupported AIFF bit depth {bits}")
    k = bits // 8
    return pcm_ops.be_to_float32(_bytes(raw, k, device, whole=bits != 24),
                                 bits)


def _ulaw_to_float(raw: torch.Tensor) -> torch.Tensor:
    """G.711 mu-law expansion (spec formulas, table-free) / 32768."""
    u = (~raw).to(torch.int32) & 0xFF
    exp = (u >> 4) & 7
    mag = (((u & 0xF) << 3) + 0x84 << exp) - 0x84
    return torch.where((u & 0x80) != 0, -mag, mag).to(torch.float32) / 32768.0


def _alaw_to_float(raw: torch.Tensor) -> torch.Tensor:
    """G.711 A-law expansion (spec formulas, table-free) / 32768."""
    a = (raw ^ 0x55).to(torch.int32)
    exp = (a >> 4) & 7
    mant = a & 0xF
    mag = torch.where(exp == 0, (mant << 4) + 8,
                      ((mant << 4) + 0x108) << (exp - 1).clamp(min=0))
    return torch.where((a & 0x80) != 0, -mag, mag).to(torch.float32) / 32768.0


def _decode_payload(comp: bytes, raw: bytes, bits: int, channels: int,
                    frames: int, audio: AudioData, device) -> None:
    comp = comp.lower()
    if comp in (b"none", b"twos"):
        samples = _be_int_to_float(raw, bits, device)
        audio.source_format = _PCM_BE[bits]
    elif comp == b"sowt":
        if bits != 16:
            raise DecodeError("sowt expects 16-bit PCM")
        samples = pcm_ops.convert_buffer_to_float32(raw, PCMFormat.PCM_16,
                                                    device)
        audio.source_format = PCMFormat.PCM_16
    elif comp == b"raw ":
        samples = pcm_ops.convert_buffer_to_float32(raw, PCMFormat.PCM_U8,
                                                    device)
        audio.source_format = PCMFormat.PCM_U8
    elif comp in (b"fl32", b"fl64"):
        k = 4 if comp == b"fl32" else 8
        samples = pcm_ops.be_to_float32(_bytes(raw, k, device), 8 * k,
                                        is_float=True)
        audio.source_format = (PCMFormat.PCM_FLT if k == 4
                               else PCMFormat.PCM_DBL)
    elif comp == b"ima4":
        from ..ops.adpcm import decode_ima4

        n_payload = (len(raw) // (34 * channels)) * 64 * channels
        # COMM numSampleFrames is unreliable for compressed AIFF-C (in the
        # wild writers store packet or garbage counts): trust the payload
        # size, honoring COMM only for a sub-packet trim of the tail
        total = n_payload
        if frames and 0 <= n_payload - frames * channels < 64 * channels:
            total = frames * channels
        samples = decode_ima4(np.frombuffer(raw, np.uint8), channels, total,
                              device)
        frames = 0  # already cut
        audio.source_format = PCMFormat.PCM_16
    elif comp == b"ulaw":
        samples = _ulaw_to_float(_bytes(raw, 1, device))
        audio.source_format = PCMFormat.PCM_16
    elif comp == b"alaw":
        samples = _alaw_to_float(_bytes(raw, 1, device))
        audio.source_format = PCMFormat.PCM_16
    else:
        raise DecodeError(f"unsupported AIFF-C/CAF compression {comp!r}")
    if frames and samples.numel() > frames * channels:
        samples = samples[: frames * channels]
    audio.samples = samples.cpu().numpy()


def decode_aiff_buffer(data: bytes, audio: AudioData, device) -> None:
    if len(data) < 12 or data[:4] != b"FORM":
        raise DecodeError("bad FORM header")
    form_type = data[8:12]
    if form_type not in (b"AIFF", b"AIFC"):
        raise DecodeError(f"not an AIFF form: {form_type!r}")
    is_aifc = form_type == b"AIFC"

    pos, end = 12, min(len(data), 8 + struct.unpack_from(">I", data, 4)[0])
    channels = frames = bits = rate = 0
    comp = b"NONE"
    ssnd = None
    view = memoryview(data)           # chunk bodies without copies
    while pos + 8 <= end:
        cid = data[pos : pos + 4]
        size = struct.unpack_from(">I", data, pos + 4)[0]
        body = view[pos + 8 : pos + 8 + size]
        if cid == b"COMM":
            if len(body) < 18:
                raise DecodeError("short COMM chunk")
            channels, frames, bits = struct.unpack_from(">hIh", body, 0)
            rate = _parse_f80(bytes(body[8:18]))
            if is_aifc and len(body) >= 22:
                comp = bytes(body[18:22])
        elif cid == b"SSND":
            if len(body) < 8:
                raise DecodeError("short SSND chunk")
            offset, _blk = struct.unpack_from(">II", body, 0)
            ssnd = body[8 + offset :]
        pos += 8 + size + (size & 1)

    if channels <= 0 or rate <= 0:
        raise DecodeError("missing or invalid COMM chunk")
    if ssnd is None:
        raise DecodeError("missing SSND chunk")
    audio.channel_count = channels
    audio.sample_rate = rate
    audio.frame_size = channels * max(bits // 8, 1)
    _decode_payload(comp, ssnd, bits, channels, frames, audio, device)
    audio.length_seconds = (
        audio.sample_count / channels / rate if rate else 0.0)


def decode_caf_buffer(data: bytes, audio: AudioData, device) -> None:
    """Core Audio Format: 'caff' header, 'desc' + 'data' chunks."""
    if len(data) < 8 or data[:4] != b"caff":
        raise DecodeError("bad caff header")
    pos = 8
    fmt = None
    payload = None
    view = memoryview(data)
    while pos + 12 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack_from(">q", data, pos + 4)[0]
        if size < 0:  # -1 on the final data chunk = rest of file
            size = len(data) - (pos + 12)
        body = view[pos + 12 : pos + 12 + size]
        if cid == b"desc":
            fmt = struct.unpack_from(">d4sIIIII", body, 0)
        elif cid == b"data":
            payload = body[4:]  # skip edit count
        pos += 12 + size
    if fmt is None or payload is None:
        raise DecodeError("missing desc or data chunk")

    srate, fid, fflags, bpp, _fpp, cpf, bpc = fmt
    channels = int(cpf)
    rate = int(round(srate))
    audio.channel_count = channels
    audio.sample_rate = rate
    audio.frame_size = int(bpp)
    if fid == b"lpcm":
        is_float = bool(fflags & 1)
        is_le = bool(fflags & 2)
        if is_float:
            k = 4 if bpc == 32 else 8
            raw = _bytes(payload, k, device)
            fmt_ = PCMFormat.PCM_FLT if k == 4 else PCMFormat.PCM_DBL
            if is_le:
                samples = pcm_ops.pcm_to_float32(
                    raw.view(torch.float32 if k == 4 else torch.float64), fmt_)
            else:
                samples = pcm_ops.be_to_float32(raw, 8 * k, is_float=True)
            audio.source_format = fmt_
            audio.samples = samples.cpu().numpy()
        elif is_le:
            if bpc == 16:
                f = pcm_ops.convert_buffer_to_float32(
                    payload, PCMFormat.PCM_16, device)
            elif bpc == 32:
                f = pcm_ops.convert_buffer_to_float32(
                    payload, PCMFormat.PCM_32, device)
            elif bpc == 24:
                f = pcm_ops.pcm_to_float32(
                    _bytes(payload, 3, device, whole=False).view(-1, 3),
                    PCMFormat.PCM_24)
            else:
                raise DecodeError(f"unsupported CAF lpcm depth {bpc}")
            audio.source_format = _PCM_BE.get(int(bpc), PCMFormat.PCM_16)
            audio.samples = f.cpu().numpy()
        else:
            _decode_payload(b"none", payload, int(bpc), channels, 0, audio,
                            device)
    elif fid == b"ima4":
        n_frames = (len(payload) // (34 * channels)) * 64
        _decode_payload(b"ima4", payload, 16, channels, n_frames, audio,
                        device)
    elif fid in (b"ulaw", b"alaw"):
        _decode_payload(fid, payload, 16, channels, 0, audio, device)
    else:
        raise DecodeError(f"unsupported CAF format {fid!r}")
    audio.length_seconds = (
        audio.sample_count / channels / rate if rate else 0.0)
