"""load(): the port's decode facade.

Equivalent of the reference's ``nqr::NyquistIO`` (reference:
src/Common.cpp:36-151 — Load entry points, :66-74 magic-number map,
:93-105 Ogg subtype sniffing, :153-188 extension parsing and decoder
table) over the seven formats: Ogg Opus (CELT, SILK and hybrid, lost
pages, chained links), Ogg Vorbis, FLAC (native and Ogg), WavPack, MP3
(Layer I/II and Layer III), Musepack (SV7 and SV8), WAV (PCM and
IMA-ADPCM), AIFF/AIFF-C and CAF.
Paths a slice has not ported yet raise NotImplementedError naming their
ROADMAP.md item.
"""

from __future__ import annotations

import importlib
import os
from typing import Callable, Dict, Optional, Union

from .audio_data import AudioData, PCMFormat
from .device import resolve_device
from .errors import DecodeError, NyquistError, UnsupportedExtensionError

# extension -> (module under formats/, decoder); every decoder is
# fn(data: bytes, audio: AudioData, device) and fills ``audio``
_DECODERS = {
    **dict.fromkeys(("wav", "wave", "ambix"), ("wav", "decode_wav_buffer")),
    **dict.fromkeys(("aiff", "aif", "aifc"), ("aiff", "decode_aiff_buffer")),
    "caf": ("aiff", "decode_caf_buffer"),
    "flac": ("flac", "decode_flac_buffer"),
    "oggflac": ("flac", "decode_ogg_flac"),
    "mp3": ("mp3", "decode_mp3_buffer"),
    "ogg": ("vorbis", "decode_vorbis_buffer"),
    "oga": ("vorbis", "decode_vorbis_buffer"),
    "opus": ("opus", "decode_opus_buffer"),
    "wv": ("wavpack", "decode_wavpack_buffer"),
    "mpc": ("musepack", "decode_musepack_buffer"),
}
# A decoder is fn(data: bytes, audio: AudioData, device) that fills
# ``audio`` (reference: BaseDecoder::LoadFromBuffer, Decoders.h:38-44).
DecoderFn = Callable[[bytes, AudioData, object], None]
# decoders added by register_decoder; load() looks here first
_REGISTERED: Dict[str, DecoderFn] = {}
# an explicit extension is taken at its word except these, which defer to
# the container's first page
_RESNIFF = ("ogg", "oga", "opus")
_BYTES_PER_SAMPLE = {
    PCMFormat.PCM_U8: 1, PCMFormat.PCM_S8: 1, PCMFormat.PCM_16: 2,
    PCMFormat.PCM_24: 3, PCMFormat.PCM_32: 4, PCMFormat.PCM_64: 8,
    PCMFormat.PCM_FLT: 4, PCMFormat.PCM_DBL: 8,
}


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
        # the first page's payload tells Opus, Vorbis and FLAC apart
        # (reference: match_ogg_subtype, Common.cpp:93-105)
        off = 27 + (data[26] if len(data) > 26 else 0)
        head = data[off : off + 8]
        if head == b"OpusHead":
            return "opus"
        if head[:5] == b"\x7fFLAC":
            return "oggflac"
        return "ogg"
    if data[:4] == b"wvpk":
        return "wv"
    if data[:4] == b"MPCK" or data[:3] == b"MP+":
        return "mpc"
    if data[:3] == b"ID3":
        return "mp3"
    if data[0] == 0xFF and (data[1] & 0xE0) == 0xE0:
        return "mp3"
    return None


def parse_path_for_extension(path: str) -> str:
    """Lowercased extension without the dot (reference: Common.cpp:153-164)."""
    ext = os.path.splitext(path)[1]
    return ext[1:].lower() if ext else ""


def register_decoder(extensions, fn: DecoderFn) -> None:
    """Register ``fn`` as the decoder of one extension or a list of them
    (lowercased); it takes precedence over a built-in decoder of the same
    extension. ``fn(data, audio, device)`` fills ``audio``: the port's
    decoders take the device as a third argument, its one difference
    from the JAX package's ``DecoderFn`` of ``(data, audio)``."""
    if isinstance(extensions, str):
        extensions = [extensions]
    for ext in extensions:
        _REGISTERED[ext.lower()] = fn


def is_file_supported(path: str) -> bool:
    """Whether a decoder is registered for the path's extension."""
    ext = parse_path_for_extension(path)
    return ext in _REGISTERED or ext in _DECODERS


def _decoder(ext: str):
    """The decoder registered for ``ext``; a built-in one is imported on
    first use."""
    if ext in _REGISTERED:
        return _REGISTERED[ext]
    module, name = _DECODERS[ext]
    return getattr(importlib.import_module(f".formats.{module}", __package__),
                   name)


def load(
    source: Union[str, bytes, bytearray, memoryview],
    extension: Optional[str] = None,
    device=None,
) -> AudioData:
    """Decode an audio file or in-memory buffer on ``device`` (default
    CUDA; raises when CUDA is absent). Returns host AudioData.

    Dispatch as the reference's: an explicit extension, then the path's,
    then the buffer's magic bytes. An extension of ``ogg``, ``oga`` or
    ``opus`` defers to the magic bytes (an .ogg holding Opus or FLAC);
    any other is taken at its word."""
    dev = resolve_device(device)
    if isinstance(source, str):
        with open(source, "rb") as f:
            data = f.read()
        if extension is None:
            extension = parse_path_for_extension(source)
    else:
        data = bytes(source)
    if not extension:
        extension = sniff_extension(data)
    else:
        extension = extension.lower().lstrip(".")
        sniffed = sniff_extension(data)
        if sniffed is not None and extension in _RESNIFF:
            extension = sniffed
    if not extension or not (extension in _REGISTERED
                             or extension in _DECODERS):
        raise UnsupportedExtensionError(
            f"no decoder for extension {extension!r}")
    audio = AudioData()
    try:
        _decoder(extension)(data, audio, dev)
    except (NyquistError, NotImplementedError):
        raise
    except Exception as e:      # malformed input tripped an internal path
        raise DecodeError(
            f"malformed {extension} stream: {type(e).__name__}: {e}") from e
    if audio.sample_rate > 0 and audio.channel_count > 0:
        audio.length_seconds = (
            audio.sample_count / audio.channel_count / audio.sample_rate)
    if not audio.frame_size:
        audio.frame_size = audio.channel_count * _BYTES_PER_SAMPLE.get(
            audio.source_format, 4)
    return audio


class NyquistIO:
    """The reference class shape (Decoders.h:48-63) over ``load``."""

    def load(self, source, extension: Optional[str] = None,
             device=None) -> AudioData:
        return load(source, extension, device)
