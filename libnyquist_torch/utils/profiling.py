"""Per-stage decode profiling, operation and byte counters, the card's
published peaks and trace capture.

The reference ships two observability tools: the CUDA-event stage
breakdown printed by its batch-8 path (reference:
cuda/mdct_cuda_b8.cu:344-464 — H2D / pre-rotation / IFFT / post / D2H
percentages) and compile-time MDCT_PROFILE timers (mdct.c:274-277).
Here:

- ``StageProfile`` — wall-clock stage recorder with the same style of
  report (stage, ms, share of total).
- ``profile_opus_load`` — stage breakdown of the native-scan Ogg Opus
  load route (demux/TOC scan, C entropy decode, frame marshalling,
  synthesis on the device through K1, gain/trim). A stage that touches
  the device ends with a synchronize, so its wall time holds its device
  work.
- ``profile_load`` — coarse read/decode split for any format.
- ``op_flops`` / ``op_cost`` — operations and bytes of one call, counted
  per aten op, plus the bytes each hand-written kernel launch reports.
- ``device_peak_gbps`` / ``device_peak_tflops`` — the card's published
  peaks by name, for roofline shares.
- ``device_trace`` — ``torch.profiler`` around a block, written as a
  Chrome trace.

CLI: ``python -m libnyquist_torch.utils.profiling FILE [--trace-dir D]
[--device cpu|cuda]``.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import kernels
from ..device import resolve_device


@dataclass
class StageProfile:
    """Wall-clock stage recorder; report() mirrors the reference's
    CUDA-event percentage printout (mdct_cuda_b8.cu:430-464)."""

    stages: List[Tuple[str, float]] = field(default_factory=list)

    def record(self, name: str, seconds: float) -> None:
        self.stages.append((name, seconds))

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    @property
    def total(self) -> float:
        return sum(s for _, s in self.stages)

    def report(self) -> str:
        total = self.total or 1e-12
        lines = [f"{'stage':<24s} {'ms':>9s} {'share':>7s}"]
        for name, s in self.stages:
            lines.append(
                f"{name:<24s} {s * 1e3:9.2f} {100.0 * s / total:6.1f}%"
            )
        lines.append(f"{'total':<24s} {total * 1e3:9.2f} {100.0:6.1f}%")
        return "\n".join(lines)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_opus_load(data: bytes, device=None) -> StageProfile:
    """Stage breakdown of the native-scan Ogg Opus load
    (formats/opus._decode_via_native_scan, stage for stage), with the
    synthesis on ``device`` (CUDA by default, so K1). Raises ValueError
    when the file needs another route (SILK/hybrid, multistream, lost
    pages) — profile those with profile_load instead."""
    from ..formats.opus import _apply_gain
    from ..formats.opus.celt_host import (
        CeltDecoderState, _raw_to_infos, celt_decode_ogg_raw,
        celt_scan_ogg_native,
    )
    from ..runtime.opus_pipeline import synthesize_stream

    dev = resolve_device(device)
    prof = StageProfile()
    with prof.time("ogg scan + TOC split"):
        scan = celt_scan_ogg_native(data)
    if scan is None:
        raise ValueError("not a single-stream CELT file; use profile_load")
    channels = int(scan[6][0])
    if channels not in (1, 2):
        raise ValueError(f"{channels} channels in one stream; use "
                         f"profile_load")
    st = CeltDecoderState(channels=channels)
    with prof.time("entropy decode (C)"):
        out = celt_decode_ogg_raw(st, data)
    if out is None:
        raise ValueError("entropy decode fell back; use profile_load")
    raw, scan_info = out[:8], out[8]
    with prof.time("frame marshalling"):
        infos = _raw_to_infos(st, raw)
    if not infos:
        raise ValueError("no CELT frames; use profile_load")
    with prof.time("synthesis (GEMM+comb)"):
        pcm = synthesize_stream(infos, channels, device=dev)
        _sync(dev)
    with prof.time("gain + trim"):
        pcm = _apply_gain(pcm.cpu().numpy().astype("float64"),
                          int(scan_info[3]))
        start = int(scan_info[1])
        end_granule = int(scan_info[7])
        end = min(pcm.shape[0], end_granule) if end_granule >= 0 \
            else pcm.shape[0]
        pcm = pcm[start:end]
    return prof


def profile_load(path: str, device=None) -> StageProfile:
    """Coarse read/decode breakdown for any supported format (``load()``
    returns host samples, so the decode stage holds its device work)."""
    from .. import io as nqio

    dev = resolve_device(device)
    prof = StageProfile()
    with prof.time("read file"):
        data = pathlib.Path(path).read_bytes()
    ext = pathlib.Path(path).suffix.lstrip(".").lower()
    with prof.time("decode"):
        nqio.load(data, extension=ext, device=dev)
    return prof


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes each aten op moves: its input tensors read and its
    output tensors written, an unfused count, like XLA's "bytes
    accessed" of an unfused program. Views move nothing and are
    skipped; so are the template input of a factory that only takes
    its shape (``*_like``, ``new_*``), the output of an allocation
    (``empty*``, ``new_empty*``) and an ``out=`` argument on the input
    side (it is written, and counted as the output)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if not func.is_view:
            name = func._schema.name.split("::")[-1]
            moved = []
            if not (name.endswith("_like") or name.startswith("new_")):
                outs = {a.name for a in func._schema.arguments if a.is_out}
                moved += [args, {k: v for k, v in kwargs.items()
                                 if k not in outs}]
            if not (name.startswith("empty") or name.startswith("new_empty")):
                moved.append(out)
            leaves, _ = tree_flatten(moved)
            self.bytes += sum(t.nbytes for t in leaves
                              if isinstance(t, torch.Tensor))
        return out


def op_flops(fn, *args) -> float | None:
    """Floating-point operations of one call ``fn(*args)`` (which runs),
    the counterpart of the JAX package's ``xla_flops`` (a jitted
    program's XLA cost analysis).

    Counted by ``torch.utils.flop_counter.FlopCounterMode``: matrix
    products and convolutions only (two per multiply-add), nothing
    elementwise, and nothing a hand-written kernel does behind ctypes.
    Its numbers are therefore not XLA's. None when the call ran no op
    the counter counts."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn(*args)
    total = fc.get_total_flops()
    return float(total) if total else None


def op_cost(fn, *args) -> dict:
    """{"flops": ..., "bytes": ...} of one call ``fn(*args)``, the
    counterpart of the JAX package's ``xla_cost``. "flops" as op_flops
    (omitted when it counts nothing). "bytes" sums every aten op's input
    and output tensors, an unfused count, plus each launch of a
    hand-written kernel (K1, K2) with each of its inputs read once and
    each output written once, which its wrapper reports (the kernels
    launch through ctypes, where no aten op sees them). An allocation
    moves no byte: ``empty*`` outputs and the templates of ``*_like``
    and ``new_*`` factories are not counted, while a ``zeros``/``full``
    output is a write and is. On the CPU the
    plain versions run instead and their aten ops are counted, unfused,
    so a step that holds a kernel counts more bytes there than on the
    card. {} when the call ran no aten op and no kernel."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = _ByteCounter()
    k0 = kernels.launch_bytes
    with FlopCounterMode(display=False) as fc, counter:
        fn(*args)
    kernel_bytes = kernels.launch_bytes - k0
    if not counter.ops and not kernel_bytes:
        return {}
    out = {"bytes": float(counter.bytes + kernel_bytes)}
    if fc.get_total_flops():
        out["flops"] = float(fc.get_total_flops())
    return out


# Published per-card peaks (NVIDIA data sheets): memory rate in GB/s and
# float32 TFLOP/s outside the tensor cores, which is the roofline of the
# port's products since device.py turns TF32 off. Substring-matched,
# first match wins, against torch.cuda.get_device_name() in lower case
# ("NVIDIA H100 80GB HBM3" is the SXM part).
_GPU_PEAKS = (
    ("h100 nvl", 3900.0, 60.0),
    ("h100 pcie", 2000.0, 51.0),
    ("h100", 3350.0, 66.9),
)


def _card_peak(col: int) -> float | None:
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name().lower()
    for row in _GPU_PEAKS:
        if row[0] in name:
            return row[col]
    return None


def device_peak_gbps() -> float | None:
    """The card's memory rate in GB/s, looked up by its name. None on
    the CPU or for a card the table lacks (add its row)."""
    return _card_peak(1)


def device_peak_tflops() -> float | None:
    """The card's float32 peak in TFLOP/s (outside the tensor cores),
    looked up by its name. None on the CPU or for a card the table
    lacks (add its row)."""
    return _card_peak(2)


def flops_report(flops: float | None, seconds: float,
                 peak_tflops: float | None = None) -> str:
    """'x GFLOP, y TFLOP/s[, z% MFU]' — peak defaults to
    device_peak_tflops() (the card's name)."""
    if not flops or seconds <= 0:
        return "flops: n/a"
    if peak_tflops is None:
        peak_tflops = device_peak_tflops()
    rate = flops / seconds
    s = f"{flops / 1e9:.2f} GFLOP, {rate / 1e12:.3f} TFLOP/s"
    if peak_tflops:
        s += f", {100.0 * rate / (peak_tflops * 1e12):.2f}% MFU"
    return s


# A torch.profiler session drops the device records of its first few
# kernels, more the longer the process has run (measured on an NVIDIA
# H100 80GB HBM3): none in a fresh process, about one more every 12-18 s,
# all 23 of the entry step's after 7 min (tools/profiler_sessions_check.py,
# chip_smoke.py). So device_trace opens its window with this many empty
# kernels, which take the loss.
WARMUP_KERNELS = 1024


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[object]:
    """``torch.profiler`` over the block (CPU activity, and CUDA where
    a card is present), written as a Chrome trace
    ``trace_<pid>_<ns>.json`` into ``logdir``. Yields the profiler.

    With a card the window opens with WARMUP_KERNELS empty kernels
    (``spin_kernel``, under the annotation "device_trace warm-up") and a
    synchronize, so the records a session loses at its start are theirs
    and not the block's; how many of them the trace kept tells how many
    were lost."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        if cuda:
            with record_function("device_trace warm-up"):
                for _ in range(WARMUP_KERNELS):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
        yield prof
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("file")
    ap.add_argument("--trace-dir", help="also write a torch.profiler "
                                        "trace here")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="device of the decode (default cuda)")
    args = ap.parse_args(argv)
    data = pathlib.Path(args.file).read_bytes()

    ctx = device_trace(args.trace_dir) if args.trace_dir \
        else contextlib.nullcontext()
    with ctx:
        if args.file.lower().endswith(".opus"):
            try:
                prof = profile_opus_load(data, device=args.device)
            except ValueError:
                prof = profile_load(args.file, device=args.device)
        else:
            prof = profile_load(args.file, device=args.device)
    print(prof.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
