"""libnyquist_torch: the PyTorch/CUDA port of the libnyquist decoders.

Host code (Python plus native C, built at first use) does the entropy
decode; PyTorch on an NVIDIA card does the dense work: for CELT/Opus
the PVQ value-plane replay and the synthesis, with the spreading
rotation and the pitch postfilter as hand-written CUDA kernels; for MP3,
Musepack and Vorbis the synthesis filterbanks as products; for PCM,
FLAC and WavPack the sample conversion, the float normalization and the
DSD decimation. Entry points take ``device=None`` and run on CUDA unless
the caller passes another device (``device="cpu"`` runs the plain
PyTorch versions).

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

__all__ = [
    "AudioData", "PCMFormat", "NyquistIO", "load", "is_file_supported",
    "NyquistError", "DecodeError", "TruncatedDataError",
    "UnsupportedExtensionError", "LoadPathNotImplementedError",
    "LoadBufferNotImplementedError",
]
