"""libnyquist_torch: the PyTorch/CUDA port of the libnyquist decoders.

Host code (Python plus native C, built at first use) does the entropy
decode; PyTorch on an NVIDIA card does the dense work: for CELT/Opus
the PVQ value-plane replay and the synthesis, with the spreading
rotation and the pitch postfilter as hand-written CUDA kernels; for MP3,
Musepack and Vorbis the synthesis filterbanks as products; for PCM,
FLAC and WavPack the sample conversion, the float normalization and the
DSD decimation. Entry points take ``device=None`` and run on CUDA unless
the caller passes another device (``device="cpu"`` runs the plain
PyTorch versions). The encoders (``encoders.py``: WAV, AIFF and Ogg
Opus) convert and resample on the device and code on the host. The
positioned readers (``streaming.py``, over files, buffers or HTTP(S)
through ``net.py``) decode bounded windows on the device.

Importing the package builds nothing.
"""

from .audio_data import AudioData, PCMFormat
from .errors import (
    DecodeError,
    LoadBufferNotImplementedError,
    LoadPathNotImplementedError,
    NyquistError,
    TruncatedDataError,
    UnsupportedExtensionError,
)
from .io import NyquistIO, is_file_supported, load
from .ops.src import resample
from .streaming import (
    ChainedOggSeekReader,
    FlacSeekReader,
    Mp3SeekReader,
    OggSeekReader,
    StreamReader,
    seek_reader,
)


def open_url(url: str, device=None, **kw):
    """Lazy seek reader over HTTP(S), the opusfile op_url analog (the
    import is lazy so that importing the package opens no socket/ssl
    modules)."""
    from .net import open_url as _open_url

    return _open_url(url, device=device, **kw)


def load_url(url: str, extension=None, device=None, **kw):
    """Full decode of an HTTP(S) resource through the facade."""
    from .net import load_url as _load_url

    return _load_url(url, extension=extension, device=device, **kw)


__all__ = [
    "AudioData", "PCMFormat", "NyquistIO", "load", "is_file_supported",
    "NyquistError", "DecodeError", "TruncatedDataError",
    "UnsupportedExtensionError", "LoadPathNotImplementedError",
    "LoadBufferNotImplementedError", "resample", "StreamReader",
    "OggSeekReader", "ChainedOggSeekReader", "Mp3SeekReader",
    "FlacSeekReader", "seek_reader", "open_url", "load_url",
]
