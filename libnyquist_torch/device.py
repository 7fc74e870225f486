"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on CUDA unless the
caller names another device (the tests pass ``device="cpu"``). A CUDA
request on a machine without a card raises; nothing falls back to the
CPU quietly.

The synthesis products run in full float32. The reference pins its
matrix products to full precision for the 1e-4 decode contract; TF32
keeps about three decimal digits and would break it, so the first
resolution switches it off for both matmuls and convolutions.
"""

from __future__ import annotations

import torch

_PINNED = False


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
