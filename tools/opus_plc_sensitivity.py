"""How far CELT pitch concealment carries a rounding difference.

    JAX_PLATFORMS=cpu python tools/opus_plc_sensitivity.py [k] [n_packets]

Decodes stream k of tools/opus_stream.py (default 2: stereo, 2 % of its
pages lost) on the CPU three ways and prints the largest differences:
the PyTorch port against the JAX package (float32 synthesis against
float64), and the port against itself with every concealment history it
brings to the host (``CeltLane.history``) changed by a relative 2e-7,
about two float32 roundings: what a card's other summation order does.
Accuracy only; no time is taken.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(k: int = 2, n_packets: int = 3000) -> None:
    sys.path.insert(0, str(ROOT))
    import libnyquist_torch as nqt
    import libnyquist_tpu as nq
    from libnyquist_torch.runtime import opus_pipeline

    spec = importlib.util.spec_from_file_location(
        "_tool_opus_stream", ROOT / "tools" / "opus_stream.py")
    os_ = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(os_)
    data, info = os_.make_opus_stream(k, n_packets)
    port = nqt.load(data, extension="opus", device="cpu").samples
    ref = nq.load(data, extension="opus").samples
    print(f"stream {k}: {n_packets} packets, {len(info['lost_pages'])} "
          f"pages lost; port vs JAX package max|d| "
          f"{np.abs(port - ref).max():.3e} (max|ref| "
          f"{np.abs(ref).max():.3f})")

    orig = opus_pipeline.CeltLane.history
    rng = np.random.default_rng(0)

    def perturbed(lane):
        fresh = lane.host is None
        mem, pre = orig(lane)
        if fresh:
            mem = mem * (1.0 + 2e-7 * rng.standard_normal(mem.shape))
        return mem, pre

    opus_pipeline.CeltLane.history = perturbed
    try:
        moved = nqt.load(data, extension="opus", device="cpu").samples
    finally:
        opus_pipeline.CeltLane.history = orig
    print(f"histories changed by a relative 2e-7: output max|d| "
          f"{np.abs(moved - port).max():.3e}")


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))
