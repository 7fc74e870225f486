"""A device program captured once into a CUDA graph and replayed.

The JAX package runs its main path as one compiled program per static
key (``runtime/serving.py`` ``make_opus_stream_program_batched``): the
constant tables are constants of the program and XLA makes its
launches. The port's counterpart is the same eager PyTorch code,
recorded once into a ``torch.cuda.CUDAGraph`` over static input buffers
and replayed:

* a call copies its inputs into the buffers the graph reads
  (``copy_into``) and launches the graph once, however many kernels it
  holds;
* every intermediate comes from the graph's private memory pool, and
  the outputs are tensors of that pool, overwritten by the next replay;
* a capture may not copy from the host or synchronise, so the constant
  tables must already be resident (``device.resident``): one eager
  warm-up run on a side stream before the capture uploads them, builds
  the kernels and creates the library handles;
* the hand-written kernels launch through ctypes and count their own
  launches: during the capture they record them (``kernels.recording``)
  and each replay counts what was recorded (``kernels.note_replay``).

A capture that fails raises; nothing carries on eagerly instead.
"""

from __future__ import annotations

import torch

from .. import kernels


def tensors_of(tree) -> list:
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


def _empty_like(tree):
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, memory_format=torch.contiguous_format)
    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_empty_like(v) for v in tree)
    return tree


def copy_into(dst, src, where="input") -> None:
    """Copy the nest ``src`` into the nest of static buffers ``dst``;
    raises unless both hold the same keys, and tensors of the same
    shape, dtype and device at the same places (a copy never broadcasts
    or converts)."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor):
            raise TypeError(f"{where}: expected a tensor, got {type(src)}")
        if (src.shape != dst.shape or src.dtype != dst.dtype
                or src.device != dst.device):
            raise ValueError(
                f"{where}: {tuple(src.shape)} {src.dtype} on {src.device}, "
                f"the captured program takes {tuple(dst.shape)} "
                f"{dst.dtype} on {dst.device}")
        dst.copy_(src)
    elif isinstance(dst, dict):
        if not isinstance(src, dict) or list(src) != list(dst):
            raise ValueError(f"{where}: the entries differ from the "
                             f"captured program's")
        for k in dst:
            copy_into(dst[k], src[k], f"{where}[{k!r}]")
    elif isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(src) != len(dst):
            raise ValueError(f"{where}: expected {len(dst)} entries")
        for i, (d, s) in enumerate(zip(dst, src)):
            copy_into(d, s, f"{where}[{i}]")
    elif dst != src:
        raise ValueError(f"{where}: {src!r}, the captured program was "
                         f"recorded with {dst!r}")


class CapturedProgram:
    """``fn(*inputs)`` recorded into one CUDA graph.

    ``inputs`` (tensors, and dicts, lists and tuples of them, on one CUDA
    device) fix the shapes; the program keeps static buffers of those
    shapes, and a call ``prog(*inputs)`` copies new inputs into them,
    replays the graph and returns the outputs (tensors of the graph's
    pool, valid until the next call). ``launches`` maps each kernel
    wrapper captured to [launches, bytes] per replay."""

    def __init__(self, fn, *inputs):
        flat = tensors_of(inputs)
        if not flat or any(t.device.type != "cuda" for t in flat):
            raise ValueError("CapturedProgram: the inputs must be CUDA "
                             "tensors")
        dev = flat[0].device
        self.inputs = _empty_like(inputs)
        copy_into(self.inputs, inputs)
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*self.inputs)       # warm-up: tables, kernels, handles
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with kernels.recording() as rec:
                with torch.cuda.graph(self.graph,
                                      capture_error_mode="thread_local"):
                    self.outputs = fn(*self.inputs)
        self.launches = {w: list(v) for w, v in rec.items()}

    def __call__(self, *inputs):
        copy_into(self.inputs, inputs)
        self.graph.replay()
        kernels.note_replay(self.launches)
        return self.outputs
