"""WAV (RIFF) decoder: host chunk parse, device sample conversion.

Behavioral equivalent of the reference WavDecoder
(reference: src/WavDecoder.cpp:146-321), quirks included:
  * chunks are found by scanning the whole file for the fourcc on 2-byte
    boundaries (reference: ScanForChunk, include/libnyquist/Common.h:
    579-597), which tolerates junk between chunks;
  * a declared RIFF size inconsistent with the true file size is an error
    (WavDecoder.cpp:178-182), and so is big-endian RIFX;
  * the extensible format (0xFFFE) goes by its bit depth, 32 bits as
    integers;
  * IMA-ADPCM (format 0x11) decodes to the fact chunk's sample count.

The parse stays on the host; the raw samples go to the device in one copy
and convert there (``ops/pcm.py``, ``ops/adpcm.py``).
"""

from __future__ import annotations

import struct

import numpy as np

from ..audio_data import AudioData, PCMFormat
from ..errors import DecodeError
from ..ops import adpcm as adpcm_ops
from ..ops import pcm as pcm_ops

FORMAT_PCM = 0x0001
FORMAT_IEEE = 0x0003
FORMAT_ALAW = 0x0006
FORMAT_MULAW = 0x0007
FORMAT_IMA_ADPCM = 0x0011
FORMAT_EXT = 0xFFFE


def _scan_for_chunk(data: bytes, fourcc: bytes):
    """Find ``fourcc`` at any 2-byte boundary: (offset of the fourcc,
    declared size), or (0, 0) when absent (Common.h:579-597)."""
    start = 0
    while True:
        idx = data.find(fourcc, start)
        if idx < 0:
            return 0, 0
        if idx % 2 == 0:
            if idx + 8 <= len(data):
                return idx, struct.unpack_from("<I", data, idx + 4)[0]
            return idx, 0
        start = idx + 1


def _source_format(bit_depth: int, wformat: int) -> PCMFormat:
    if bit_depth == 4:
        return PCMFormat.PCM_16          # IMA ADPCM decodes to 16-bit
    if bit_depth == 8:
        return PCMFormat.PCM_U8
    if bit_depth == 16:
        return PCMFormat.PCM_16
    if bit_depth == 24:
        return PCMFormat.PCM_24
    if bit_depth == 32:
        return (PCMFormat.PCM_FLT if wformat == FORMAT_IEEE
                else PCMFormat.PCM_32)
    if bit_depth == 64:
        return (PCMFormat.PCM_DBL if wformat == FORMAT_IEEE
                else PCMFormat.PCM_64)
    raise DecodeError(f"unsupported bit depth {bit_depth}")


def decode_wav_buffer(data: bytes, audio: AudioData, device) -> None:
    if len(data) < 12:
        raise DecodeError("file too small for RIFF header")
    riff_id = data[0:4]
    file_size = struct.unpack_from("<I", data, 4)[0]
    if riff_id != b"RIFF":
        if riff_id in (b"RIFX", b"FFIR"):
            raise DecodeError("big endian RIFF files not supported")
        raise DecodeError("bad RIFF/RIFX/FFIR file header")
    if data[8:12] != b"WAVE":
        raise DecodeError("bad WAVE header")
    if len(data) - file_size != 8:
        raise DecodeError("declared size of file less than file size")

    fmt_off, fmt_size = _scan_for_chunk(data, b"fmt ")
    if fmt_off == 0:
        raise DecodeError("couldn't find fmt chunk")
    if fmt_size < 16:
        raise DecodeError("format chunk too small")
    (wformat, channel_count, sample_rate, _data_rate, frame_size,
     bit_depth) = struct.unpack_from("<HHIIHH", data, fmt_off + 8)
    audio.channel_count = channel_count
    audio.sample_rate = sample_rate
    audio.frame_size = frame_size
    audio.source_format = _source_format(bit_depth, wformat)
    if wformat == 0:
        raise DecodeError("unknown wave format")

    fact_sample_length = 0
    if wformat in (FORMAT_IEEE, FORMAT_IMA_ADPCM, FORMAT_EXT):
        fact_off, fact_size = _scan_for_chunk(data, b"fact")
        if fact_size >= 4 and fact_off + 12 <= len(data):
            fact_sample_length = struct.unpack_from("<I", data,
                                                    fact_off + 8)[0]

    data_off, data_size = _scan_for_chunk(data, b"data")
    if data_off == 0:
        raise DecodeError("couldn't find data chunk")
    payload_off = data_off + 8
    data_size = min(data_size, len(data) - payload_off)

    if wformat == FORMAT_IMA_ADPCM:
        if frame_size <= 0:
            raise DecodeError("bad ADPCM block align")
        total_samples = fact_sample_length * channel_count
        raw = np.frombuffer(
            data, dtype=np.uint8, count=(data_size // frame_size) * frame_size,
            offset=payload_off)
        samples = adpcm_ops.decode_ima_adpcm(raw, frame_size, channel_count,
                                             total_samples, device)
        audio.samples = samples.cpu().numpy()
        audio.length_seconds = (
            total_samples / sample_rate / channel_count if sample_rate else 0.0)
        return

    total_frames = data_size // frame_size if frame_size else 0
    total_samples = total_frames * channel_count
    bytes_per_sample = frame_size // channel_count if channel_count else 0
    payload = memoryview(data)[payload_off : payload_off
                               + total_samples * bytes_per_sample]
    audio.samples = pcm_ops.convert_buffer_to_float32(
        payload, audio.source_format, device).cpu().numpy()
    audio.length_seconds = total_frames / sample_rate if sample_rate else 0.0
