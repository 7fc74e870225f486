"""FLAC decoder (native .flac and Ogg FLAC): host frame decode, device scale.

After the libFLAC decode path (reference: third_party/FLAC/src/
stream_decoder.c — frame header read_frame_header_, subframes
:2463-2533, Rice residual :2597; lpc.c:784 FLAC__lpc_restore_signal;
fixed.c FLAC__fixed_restore_signal; Ogg mapping ogg_decoder_aspect.c,
ogg_mapping.c), re-derived from the FLAC format specification.

* Host: the metadata walk below, then every audio frame in one C call
  (``native/flac_stream.c`` ``flac_decode_stream``): frame headers,
  subframes, Rice residuals, the integer predictors, the stereo
  decorrelation, interleaved into int32. The call resumes at a frame
  boundary when its output fills, so the output grows from what the
  frames hold, never from the untrusted header total.
* Device: the int32 samples go up in one copy and scale there
  (``ops/lossless.py`` ``scale_int``: ``x / 2^(bps-1)`` in float32, as
  upstream libnyquist's FlacDecoder).

A malformed frame raises DecodeError. There is no Python version of
what the C decodes. Neither CRC is checked; the STREAMINFO MD5 is, when
``LIBNYQUIST_FLAC_MD5`` is set (off by default, like libFLAC's
md5_checking).
"""

from __future__ import annotations

import ctypes
import hashlib
import os

import numpy as np
import torch

from ..audio_data import AudioData, PCMFormat
from ..errors import DecodeError
from ..ops import lossless
from ..ops.pcm import host_to_device
from ..runtime import native
from . import ogg

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
# flac_stream.c: FLAC_MAX_CH * (FLAC_MAX_ORDER + FLAC_MAX_BLOCK) subframe
# buffers plus one FLAC_MAX_BLOCK residual scratch
_WORK_VALUES = 8 * (32 + 65536) + 65536
_SOURCE_FORMAT = {
    8: PCMFormat.PCM_S8, 16: PCMFormat.PCM_16, 20: PCMFormat.PCM_24,
    24: PCMFormat.PCM_24, 32: PCMFormat.PCM_32,
}


def read_metadata(data: bytes):
    """Walk the metadata blocks after ``fLaC``: (first frame's byte
    offset, STREAMINFO dict with rate, channels, bps, total_samples and
    md5; the defaults when there is none)."""
    if not data.startswith(b"fLaC"):
        raise DecodeError("bad FLAC marker")
    info = {"rate": 0, "channels": 0, "bps": 16, "total_samples": 0,
            "md5": b""}
    pos = 4
    while pos + 4 <= len(data):
        hdr = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if hdr & 0x7F == 0 and length >= 34:            # STREAMINFO
            info["rate"] = int.from_bytes(body[10:13], "big") >> 4
            info["channels"] = ((body[12] >> 1) & 0x7) + 1
            info["bps"] = (((body[12] & 1) << 4) | (body[13] >> 4)) + 1
            info["total_samples"] = (((body[13] & 0xF) << 32)
                                     | int.from_bytes(body[14:18], "big"))
            info["md5"] = bytes(body[18:34])
        pos += 4 + length
        if hdr & 0x80:
            break
    return pos, info


def decode_frames(data: bytes, pos: int, stream_bps: int,
                  stream_channels: int, total_samples: int) -> np.ndarray:
    """Every frame from byte ``pos`` on: interleaved int32 [n, ch].

    The output doubles each time the C call stops on a full buffer, and
    the call resumes at the frame it stopped before."""
    L = native.codec_lib()
    ch = stream_channels or 1
    # total_samples is an untrusted 36-bit header field: a corrupt value
    # must not drive a huge allocation. Start from it only when it is
    # plausible against the input size; undershoot grows and resumes.
    cap = max(1 << 20, 2 * len(data))
    if total_samples:
        cap = min((total_samples + 65536) * ch, max(cap, 64 * len(data)))
    work = np.empty(_WORK_VALUES, np.int32)
    state = np.zeros(4, np.int64)
    state[0] = pos
    chunks = []
    while True:
        out = np.empty(cap, np.int32)
        r = L.flac_decode_stream(
            data, len(data), stream_bps, out.ctypes.data_as(_I32P), cap, -1,
            work.ctypes.data_as(_I32P), state.ctypes.data_as(_I64P))
        if r < 0:
            raise DecodeError("malformed FLAC frame")
        chunks.append(out[: int(state[2])])
        if state[3] != 1:            # 0 = end of data; 1 = output full
            break
        cap *= 2
    got_ch = int(state[1])
    pcm = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    if got_ch == 0:
        raise DecodeError("no FLAC frames decoded")
    return pcm.reshape(-1, got_ch)


def _check_md5(pcm: np.ndarray, bps: int, md5: bytes) -> None:
    """STREAMINFO MD5 of the unencoded data: interleaved little-endian
    signed samples of (bps+7)/8 bytes (libFLAC md5.c format_input_)."""
    nb = (bps + 7) // 8
    flat = pcm.reshape(-1)
    if nb in (1, 2, 4):
        raw = flat.astype(f"<i{nb}").tobytes()
    else:
        raw = flat.astype("<i8").view(np.uint8).reshape(-1, 8)[:, :nb].tobytes()
    if hashlib.md5(raw).digest() != md5:
        raise DecodeError("FLAC MD5 signature mismatch")


def decode_host(data: bytes):
    """The host half of a native FLAC buffer: (interleaved int32 [n, ch],
    STREAMINFO dict), cut to the header's total when it gives one, and
    held against its MD5 when ``LIBNYQUIST_FLAC_MD5`` is set."""
    pos, info = read_metadata(data)
    pcm = decode_frames(data, pos, info["bps"], info["channels"],
                        info["total_samples"])
    if info["total_samples"]:
        pcm = pcm[: info["total_samples"]]
    md5 = info["md5"]
    if md5 and md5 != b"\x00" * 16 and os.environ.get("LIBNYQUIST_FLAC_MD5"):
        _check_md5(pcm, info["bps"], md5)
    return pcm, info


def device_tail(pcm: np.ndarray, bps: int, device) -> torch.Tensor:
    """The int32 samples on ``device`` in one copy, scaled there to
    float32 (interleaved)."""
    x = host_to_device(np.ascontiguousarray(pcm).reshape(-1), device)
    return lossless.scale_int(x, bps)


def decode_flac_buffer(data: bytes, audio: AudioData, device) -> None:
    pcm, info = decode_host(data)
    bps, rate = info["bps"], info["rate"]
    audio.channel_count = pcm.shape[1]
    audio.sample_rate = rate
    audio.source_format = _SOURCE_FORMAT.get(bps, PCMFormat.PCM_16)
    audio.samples = device_tail(pcm, bps, device).cpu().numpy()
    audio.length_seconds = pcm.shape[0] / rate if rate else 0.0


def decode_ogg_flac(data: bytes, audio: AudioData, device) -> None:
    """Ogg-encapsulated FLAC: the first packet is 0x7F 'FLAC', major and
    minor mapping version, the header count (be16), then 'fLaC' and
    STREAMINFO; header packets follow, then one frame per packet. The
    9-byte mapping header is stripped and the packets joined, which
    makes a native FLAC buffer."""
    st = ogg.first_stream_matching(ogg.demux(data), b"\x7fFLAC")
    if st is None:
        raise DecodeError("no Ogg FLAC stream found")
    first = st.packets[0].data
    if len(first) < 13 or first[9:13] != b"fLaC":
        raise DecodeError("bad Ogg FLAC first packet")
    if first[5] != 1:
        raise DecodeError("unsupported Ogg FLAC mapping version")
    body = bytearray(first[9:])
    for p in st.packets[1:]:
        body += p.data
    decode_flac_buffer(bytes(body), audio, device)
