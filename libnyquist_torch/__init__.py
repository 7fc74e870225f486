"""libnyquist_torch: the PyTorch/CUDA port of the libnyquist decoders.

Host code (Python plus native C, built at first use) does the entropy
decode; PyTorch on an NVIDIA card does the dense per-frame work: for
CELT/Opus the PVQ value-plane replay and the synthesis, with the
spreading rotation and the pitch postfilter as hand-written CUDA
kernels; for MP3 and Musepack the synthesis filterbanks as products. Entry points
take ``device=None`` and run on CUDA unless the caller passes another
device (``device="cpu"`` runs the plain PyTorch versions).

Importing the package builds nothing.
"""

from .audio_data import AudioData, PCMFormat
from .errors import DecodeError, NyquistError, UnsupportedExtensionError
from .io import load

__all__ = [
    "AudioData", "PCMFormat", "DecodeError", "NyquistError",
    "UnsupportedExtensionError", "load",
]
