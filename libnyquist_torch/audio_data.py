"""AudioData: the decoded-audio result container.

Equivalent of the reference's ``nqr::AudioData`` struct (reference:
include/libnyquist/Common.h:350-364): interleaved float32 samples in
[-1, +1] as a host NumPy array, plus stream metadata. The device work
ends with one copy to the host.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class PCMFormat(enum.Enum):
    """Source PCM sample formats (reference: Common.h:316-327)."""

    PCM_U8 = "u8"
    PCM_S8 = "s8"
    PCM_16 = "s16"
    PCM_24 = "s24"
    PCM_32 = "s32"
    PCM_64 = "s64"
    PCM_FLT = "f32"
    PCM_DBL = "f64"
    PCM_END = "end"


@dataclasses.dataclass
class AudioData:
    """Decoded audio: interleaved float32 in [-1, +1] plus metadata."""

    samples: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.float32)
    )
    channel_count: int = 0
    sample_rate: int = 0
    source_format: PCMFormat = PCMFormat.PCM_END
    length_seconds: float = 0.0
    frame_size: int = 0  # channels * bytes-per-sample of the source
    metadata: Optional[dict] = None

    @property
    def sample_count(self) -> int:
        return int(self.samples.size)

    def deinterleaved(self) -> np.ndarray:
        """Return samples as [channels, frames]."""
        if self.channel_count <= 1:
            return self.samples.reshape(1, -1)
        return self.samples.reshape(-1, self.channel_count).T.copy()
