"""Native host-ops loader: builds and binds the port's CELT host library.

The entropy decode (range decoder, bit allocation, PVQ index decode) and
the Ogg/Opus packet scan are branchy byte-serial work that stays on the
host in C (``libnyquist_torch/native/``). The library is built with the
system ``cc`` at first use into ``libnyquist_torch/_build/`` and bound
with ctypes. There is no Python fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
_NATIVE_DIR = _PKG / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = ("celt_bands.c", "ogg_opus.c")
_HEADERS = ("ecdec.h",)
_LIB = None
_LOCK = threading.Lock()


def _build() -> pathlib.Path:
    srcs = [_NATIVE_DIR / s for s in SOURCES]
    deps = srcs + [_NATIVE_DIR / h for h in _HEADERS]
    out = BUILD_DIR / "libcelthost.so"
    if out.exists() and all(
        out.stat().st_mtime >= d.stat().st_mtime for d in deps
    ):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a per-process temp file and rename it into place
    # atomically, so concurrent builders (parallel test workers) never
    # load a half-written library. -march=native is safe because the
    # library is always built on the machine that runs it; retry without
    # it for compilers that reject the flag.
    tmp = out.with_name(f".libcelthost.{os.getpid()}.so")
    errors = []
    for extra in (["-march=native"], []):
        cmd = ["cc", "-O3", *extra, "-fPIC", "-shared",
               *map(str, srcs), "-o", str(tmp), "-lm"]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(getattr(e, "stderr", None) or str(e))
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        return out
    raise RuntimeError(
        "building the CELT host library failed:\n" + "\n".join(errors))


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_i32, c_i64 = ctypes.c_int, ctypes.c_int32, ctypes.c_int64
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    L.celt_decode_stream.restype = c_i64
    L.celt_decode_stream.argtypes = [
        ctypes.c_char_p, i64p, i64p,            # payload, offs, lens
        i32p, i32p, i32p, c_i64,                # fsz, ends, chs, n
        i16p, c_int, i16p, i16p,                # eBands, nb, logN, ci
        ctypes.c_char_p, ctypes.c_char_p,       # cache_bits, cache_caps
        ctypes.c_char_p, c_int,                 # allocVectors, nbAV
        f64p, i32p,                             # eMeans, prob_model
        c_int, c_int,                           # shortMdctSize, effEBands
        f64p, f64p, f64p, f64p, i64p,           # state + rng
        c_int, c_int,                           # CC, CCout
        c_int, c_int,                           # downsample, start
        c_i32, f32p,                            # nmax, freq_out
        i32p, i32p, f64p, i32p, i32p,           # sb, pfp, pfg, pft, sil
    ]
    L.ogg_opus_celt_scan.restype = c_i64
    L.ogg_opus_celt_scan.argtypes = [
        ctypes.c_char_p, c_i64,                 # data, len
        ctypes.c_char_p, c_i64,                 # payload_out, cap
        i64p, i64p,                             # offs, lens
        i32p, i32p, i32p,                       # fsz, ends, chs
        c_i64, i32p,                            # max_frames, info
    ]
    return L


def lib() -> ctypes.CDLL:
    """The bound host library, built on first call. Raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(_build())))
        return _LIB
