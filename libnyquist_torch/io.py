"""load(): the port's decode facade.

Equivalent of the reference's ``nqr::NyquistIO::Load`` (reference:
src/Common.cpp:36-151) for the formats the port covers so far: Ogg Opus
with CELT-only streams, Ogg Vorbis, MP3 (Layer I/II and Layer III),
Musepack (SV7 and SV8), WAV (PCM and IMA-ADPCM), AIFF/AIFF-C and CAF.
FLAC and WavPack raise NotImplementedError naming the ROADMAP.md queue
item that ports them.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Union

from .audio_data import AudioData, PCMFormat
from .device import resolve_device
from .errors import DecodeError, UnsupportedExtensionError

_LOSSLESS_ITEM = "queue item 'FLAC and WavPack'"
_LATER = dict.fromkeys(("flac", "oggflac", "wv"), _LOSSLESS_ITEM)
_BYTES_PER_SAMPLE = {
    PCMFormat.PCM_U8: 1, PCMFormat.PCM_S8: 1, PCMFormat.PCM_16: 2,
    PCMFormat.PCM_24: 3, PCMFormat.PCM_32: 4, PCMFormat.PCM_64: 8,
    PCMFormat.PCM_FLT: 4, PCMFormat.PCM_DBL: 8,
}


def _ogg_subtype(data: bytes) -> Optional[str]:
    """'opus' / 'vorbis' / 'flac' from the first Ogg page, else None
    (reference: match_ogg_subtype, Common.cpp:93-105)."""
    if len(data) < 27 or data[:4] != b"OggS":
        return None
    off = 27 + data[26]
    head = data[off : off + 8]
    if head == b"OpusHead":
        return "opus"
    if head[:7] == b"\x01vorbis":
        return "vorbis"
    if head[:5] == b"\x7fFLAC":
        return "flac"
    return None


def sniff_extension(data: bytes) -> Optional[str]:
    """The format from magic bytes (reference: Common.cpp:66-127), as a
    canonical extension, or None."""
    if len(data) < 12:
        return None
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if data[:4] == b"FORM" and data[8:12] in (b"AIFF", b"AIFC"):
        return "aiff"
    if data[:4] == b"caff":
        return "caf"
    if data[:4] == b"fLaC":
        return "flac"
    if data[:4] == b"OggS":
        return {"opus": "opus", "flac": "oggflac"}.get(_ogg_subtype(data),
                                                      "ogg")
    if data[:4] == b"wvpk":
        return "wv"
    if data[:4] == b"MPCK" or data[:3] == b"MP+":
        return "mpc"
    if data[:3] == b"ID3":
        return "mp3"
    if data[0] == 0xFF and (data[1] & 0xE0) == 0xE0:
        return "mp3"
    return None


def _decoder(ext: str):
    """The decoder registered for ``ext`` (reference registry:
    Common.cpp:166-188), imported on first use."""
    if ext == "mp3":
        from .formats.mp3 import decode_mp3_buffer
        return decode_mp3_buffer
    if ext == "mpc":
        from .formats.musepack import decode_musepack_buffer
        return decode_musepack_buffer
    if ext in ("ogg", "oga", "vorbis"):
        from .formats.vorbis import decode_vorbis_buffer
        return decode_vorbis_buffer
    if ext in ("wav", "wave", "ambix"):
        from .formats.wav import decode_wav_buffer
        return decode_wav_buffer
    if ext in ("aiff", "aif", "aifc"):
        from .formats.aiff import decode_aiff_buffer
        return decode_aiff_buffer
    if ext == "caf":
        from .formats.aiff import decode_caf_buffer
        return decode_caf_buffer
    return None


def load(
    source: Union[str, bytes, bytearray, memoryview],
    extension: Optional[str] = None,
    device=None,
) -> AudioData:
    """Decode an audio file or in-memory buffer on ``device`` (default
    CUDA; raises when CUDA is absent). Returns host AudioData.

    Dispatch as the reference's: explicit extension, then the path's,
    then the buffer's magic bytes; an Ogg container goes by its first
    page whatever the extension says."""
    dev = resolve_device(device)
    if isinstance(source, str):
        with open(source, "rb") as f:
            data = f.read()
        if extension is None:
            extension = os.path.splitext(source)[1][1:]
    else:
        data = bytes(source)
    ext = (extension or "").lower().lstrip(".") or sniff_extension(data) or ""
    sub = _ogg_subtype(data)
    decode = _decoder(ext)
    audio = AudioData()
    if sub == "opus" or (sub is None and ext == "opus"):
        from .formats.opus import decode_opus_buffer

        try:
            decode_opus_buffer(data, audio, device=dev)
        except (ValueError, IndexError) as e:
            raise DecodeError(
                f"malformed opus stream: {type(e).__name__}: {e}") from e
    elif sub == "flac":
        raise NotImplementedError(f"Ogg FLAC: see ROADMAP.md, {_LOSSLESS_ITEM}")
    else:
        if sub == "vorbis":
            decode = _decoder("vorbis")
        if decode is None:
            if ext in _LATER:
                raise NotImplementedError(
                    f"{ext} files: see ROADMAP.md, {_LATER[ext]}")
            raise UnsupportedExtensionError(
                f"no decoder for extension {ext!r}")
        try:
            decode(data, audio, dev)
        except (ValueError, IndexError, KeyError, OverflowError,
                struct.error) as e:
            # malformed input tripped an internal path
            raise DecodeError(
                f"malformed {ext} stream: {type(e).__name__}: {e}") from e
    if audio.sample_rate > 0 and audio.channel_count > 0:
        audio.length_seconds = (
            audio.sample_count / audio.channel_count / audio.sample_rate)
    if not audio.frame_size:
        audio.frame_size = audio.channel_count * _BYTES_PER_SAMPLE.get(
            audio.source_format, 4)
    return audio
