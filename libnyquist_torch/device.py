"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on CUDA unless the
caller names another device (the tests pass ``device="cpu"``). A CUDA
request on a machine without a card raises; nothing falls back to the
CPU quietly.

The synthesis products run in full float32. The reference pins its
matrix products to full precision for the 1e-4 decode contract; TF32
keeps about three decimal digits and would break it, so the first
resolution switches it off for both matmuls and convolutions.

Constant tables (synthesis matrices, index tables of the replay, the
deemphasis terms) live on the device: ``resident`` uploads each once per
(table, device) and keeps it, so the per-batch body makes no host copy
and no synchronisation, and a CUDA graph capture of it (runtime/graphs.py)
finds every table already there.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_PINNED = False
_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()
table_builds = 0     # tables uploaded so far, over every device


def _pin_fp32() -> None:
    global _PINNED
    if _PINNED:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _PINNED = True


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    _pin_fp32()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "libnyquist_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain versions")
    return dev


def resident(key, build, device) -> torch.Tensor:
    """The constant table ``key`` on ``device``: ``build()`` (a NumPy
    array or a CPU tensor) is called and uploaded on the first request
    for that (key, device) and the tensor kept; later requests return it
    and build nothing. Callers never write to the tensor."""
    global table_builds
    dev = torch.device(device)
    k = (key, str(dev))
    with _TABLES_LOCK:
        t = _TABLES.get(k)
        if t is None:
            v = build()
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v, order="C"))
            t = v.to(dev)
            _TABLES[k] = t
            table_builds += 1
    return t
