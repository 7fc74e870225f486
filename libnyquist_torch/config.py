"""Runtime configuration surface.

The reference exposes its options at build time (CMake: USE_CUDA,
ENABLE_CPU_PROFILING, LIBNYQUIST_BUILD_EXAMPLE, backend selectors). The
port has no build step of its own beyond the kernels' nvcc at first use,
so its surface is the environment flags below, read at first use by the
modules that own them and gathered here.

| flag | effect |
|---|---|
| LIBNYQUIST_FLAC_MD5        | verify the STREAMINFO MD5 of decoded FLAC
|                            | audio (libFLAC md5_checking;
|                            | formats/flac.py) |
| CUDA_HOME, CUDA_PATH       | where nvcc is found for the kernel build
|                            | (kernels/__init__.py; default
|                            | /usr/local/cuda) |
| LIBNYQUIST_BENCH_TRIALS    | the bench's headline trials (bench.py;
|                            | default 10) |
| LIBNYQUIST_BENCH_DEADLINE_S | the bench run's budget in s; timed loops
|                            | take fewer trials near it (default 720;
|                            | <= 0: none) |
| LIBNYQUIST_BENCH_SPLIT     | 0: the bench skips its stage split |
| LIBNYQUIST_BENCH_IMDCT     | 0: the bench skips its IMDCT frames/s
|                            | micro |
| LIBNYQUIST_BENCH_REFERENCE | a directory of the reference's test files
|                            | (sb-reverie.opus, ad_hoc/...); the bench
|                            | takes a file there in place of its
|                            | in-repo stream (default none) |

Flags of the JAX package with no counterpart here, and why:

| flag | why none |
|---|---|
| LIBNYQUIST_NO_NATIVE_CELT, _SILK, _MP3, _VORBIS, _MPC, _FLAC | they
|   select pure-Python fallbacks of the native planes, which the port
|   left out: every plane runs its C |
| LIBNYQUIST_OPUS_PIPELINE, LIBNYQUIST_OPUS_FRAME_SYNTH | they choose
|   between the device route and the host synthesis route; the port has
|   only the device route |
| LIBNYQUIST_ROT_PALLAS | it opts into the Pallas rotation; the port
|   always runs its CUDA rotation kernel (csrc/rot.cu) |
| LIBNYQUIST_TPU_PEAK_GBPS, LIBNYQUIST_TPU_PEAK_TFLOPS | they override
|   the TPU's published peaks; utils/profiling.py reads the card's
|   peaks from a constant table keyed by its name, and a card it lacks
|   gets a row there, not a flag |
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# environment name -> Config field
FLAGS = {
    "LIBNYQUIST_FLAC_MD5": "flac_md5",
    "CUDA_HOME": "cuda_home",
    "CUDA_PATH": "cuda_home",
    "LIBNYQUIST_BENCH_TRIALS": "bench_trials",
    "LIBNYQUIST_BENCH_DEADLINE_S": "bench_deadline_s",
    "LIBNYQUIST_BENCH_SPLIT": "bench_split",
    "LIBNYQUIST_BENCH_IMDCT": "bench_imdct",
    "LIBNYQUIST_BENCH_REFERENCE": "bench_reference",
}


@dataclass(frozen=True)
class Config:
    flac_md5: bool
    cuda_home: str | None
    bench_trials: int = 10
    bench_deadline_s: float = 720.0
    bench_split: bool = True
    bench_imdct: bool = True
    bench_reference: str | None = None


def current() -> Config:
    """Snapshot of the flag environment (flags are consulted lazily by
    the modules that own them; this is the introspection surface)."""
    e = os.environ.get
    return Config(
        flac_md5=bool(e("LIBNYQUIST_FLAC_MD5")),
        cuda_home=e("CUDA_HOME") or e("CUDA_PATH") or None,
        bench_trials=int(e("LIBNYQUIST_BENCH_TRIALS", "10")),
        bench_deadline_s=float(e("LIBNYQUIST_BENCH_DEADLINE_S", "720")),
        bench_split=e("LIBNYQUIST_BENCH_SPLIT", "1") != "0",
        bench_imdct=e("LIBNYQUIST_BENCH_IMDCT", "1") != "0",
        bench_reference=e("LIBNYQUIST_BENCH_REFERENCE") or None,
    )
