"""Build-and-bind loader for the port's hand-written CUDA kernels.

Each kernel lives in ``libnyquist_torch/csrc/<name>.cu`` and exports a
plain C launch function (no PyTorch headers, so ``nvcc`` takes seconds).
At first use the source is compiled for Hopper (``sm_90a``) into
``libnyquist_torch/_build/lib<name>.so`` and bound with ctypes; the
wrapper in ``ops/`` passes device pointers and the current CUDA stream
as integers. Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LIBS: dict = {}
_LOCK = threading.Lock()
build_log: dict = {}     # name -> nvcc's -Xptxas -v report of the last build


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME (default /usr/local/cuda) or $PATH."""
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "libnyquist_torch are built from source at first use")
    return found


def _build(name: str) -> pathlib.Path:
    src = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Per-process temp file renamed into place: concurrent builders never
    # load a half-written library.
    tmp = out.with_name(f".lib{name}.{os.getpid()}.so")
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {src.name} (rc={proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    build_log[name] = proc.stderr.strip()
    os.replace(tmp, out)
    return out


def build_all(names) -> None:
    """Build several kernel libraries at once, one nvcc process each, all
    started together (a thread per process). load() then finds them."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        list(pool.map(_build, names))


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use. Raises on failure."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _LIBS[name] = lib
        return lib
