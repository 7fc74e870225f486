"""load(): the port's decode facade.

Equivalent of the reference's ``nqr::NyquistIO::Load`` (reference:
src/Common.cpp:36-151) for the formats the port covers so far: Ogg Opus
with CELT-only streams. Other formats raise NotImplementedError naming
the ROADMAP.md queue item that ports them.
"""

from __future__ import annotations

import os
from typing import Optional, Union

from .audio_data import AudioData
from .device import resolve_device
from .errors import DecodeError, UnsupportedExtensionError

_PCM_ITEM = "queue item 'PCM, ADPCM and the load facade'"
_CODEC_ITEM = "queue item 'Other codecs'"
_LATER = {
    **dict.fromkeys(("wav", "wave", "aiff", "aif", "aifc", "caf"),
                    _PCM_ITEM),
    **dict.fromkeys(("flac", "mp3", "wv", "mpc"), _CODEC_ITEM),
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


def load(
    source: Union[str, bytes, bytearray, memoryview],
    extension: Optional[str] = None,
    device=None,
) -> AudioData:
    """Decode an audio file or in-memory buffer on ``device`` (default
    CUDA; raises when CUDA is absent). Returns host AudioData."""
    dev = resolve_device(device)
    if isinstance(source, str):
        with open(source, "rb") as f:
            data = f.read()
        if extension is None:
            extension = os.path.splitext(source)[1][1:]
    else:
        data = bytes(source)
    ext = (extension or "").lower().lstrip(".")
    sub = _ogg_subtype(data)
    if sub == "opus" or (sub is None and ext == "opus"):
        from .formats.opus import decode_opus_buffer

        audio = AudioData()
        try:
            decode_opus_buffer(data, audio, device=dev)
        except (ValueError, IndexError) as e:
            raise DecodeError(
                f"malformed opus stream: {type(e).__name__}: {e}") from e
        audio.frame_size = audio.channel_count * 4
        if audio.sample_rate > 0 and audio.channel_count > 0:
            audio.length_seconds = (
                audio.sample_count / audio.channel_count / audio.sample_rate)
        return audio
    if sub is not None:
        raise NotImplementedError(
            f"Ogg {sub}: see ROADMAP.md, {_CODEC_ITEM}")
    if ext in _LATER:
        raise NotImplementedError(
            f"{ext} files: see ROADMAP.md, {_LATER[ext]}")
    raise UnsupportedExtensionError(f"no decoder for extension {ext!r}")
