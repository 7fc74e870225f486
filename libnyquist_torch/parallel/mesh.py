"""Device-mesh helpers for multi-card decode scaling.

The decode step scales over a (dp, sp, tp) mesh of ranks, one process
and one device a rank:
  dp — data parallel over concurrent streams (the serving axis), no
       collective,
  sp — sequence parallel over the frame/time axis, with point-to-point
       halo exchanges (``right_halo``) for the state that crosses shard
       boundaries: TDAC overlap-add tails, comb-filter history (HIST
       samples) and the deemphasis carry (256 samples is exact in
       float32: 0.85^256 ~ 1e-18),
  tp — tensor parallel over the IMDCT synthesis-matrix contraction,
       partial products summed over the group (``axis_sum``).

The backend follows the device: NCCL on CUDA, one card a rank; gloo on
the CPU. ``run_ranks`` spawns the ranks behind a ``FileStore`` in a fresh
temporary directory. A world of one needs no process group: every axis
is a singleton and the helpers make no call.

``entry.sharded_decode_step`` builds the full step with these helpers.
"""

from __future__ import annotations

import collections
import datetime
import os
import pickle
import shutil
import tempfile
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device

# halo sizes that make sharded filters exact in float32
DEEMPH_HALO = 256          # 0.85^256 is far below float32 resolution
AXES = ("dp", "sp", "tp")
RANK_TIMEOUT_S = 600       # a spawned set of ranks, and each collective


def factor_mesh(n_devices: int, serving: bool = False) -> tuple[int, int, int]:
    """Factor a device count into (dp, sp, tp).

    serving=True: pure data parallel (n, 1, 1). Concurrent decode
    streams are independent, so dp scales with no collective, while
    every tp slice adds a sum to a contraction that is already small per
    device and every sp slice adds halo exchanges plus sp - 1 serialized
    comb-refinement passes. sp and tp serve the latency-critical single
    stream case (one long stream, many cards).

    serving=False (default): the mixed (dp, sp, 2)-leaning factoring
    used by the dry run and the tests, so that the halo exchange, the
    sum and the sp refinement chain all stay exercised.
    """
    if serving:
        return n_devices, 1, 1
    tp = 2 if n_devices % 2 == 0 else 1
    rem = n_devices // tp
    sp = 2 if rem % 2 == 0 else 1
    dp = rem // sp
    return dp, sp, tp


@dataclass
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index
    along it, the process group of the ranks that share the other
    coordinates (None for a singleton or a mesh without a process
    group) and their global ranks in axis order. ``calls`` is the
    mesh's count of collective calls, shared by its axes."""

    name: str
    size: int
    index: int
    group: object = None
    ranks: tuple = ()
    calls: collections.Counter = field(default_factory=collections.Counter)

    def _require_group(self, what: str) -> None:
        if self.group is None:
            raise RuntimeError(
                f"{what}: axis {self.name!r} of size {self.size} has no "
                f"process group; run the step on its ranks (run_ranks)")


@dataclass
class Mesh:
    """This rank's view of a (dp, sp, tp) mesh: the shape, the device and
    one Axis per name. ``calls`` counts the collective calls the helpers
    made on it ("halo": right_halo, "sum": axis_sum)."""

    shape: tuple
    device: torch.device
    axes: dict
    calls: collections.Counter

    def __getitem__(self, name: str) -> Axis:
        return self.axes[name]

    @property
    def coords(self) -> tuple:
        return tuple(self.axes[a].index for a in AXES)


def local_mesh(shape, device=None) -> Mesh:
    """Rank 0's view of a mesh of ``shape`` without a process group: a
    step on it runs in the calling process where every axis it
    communicates over is a singleton, and raises otherwise."""
    calls = collections.Counter()
    axes = {a: Axis(a, n, 0, calls=calls) for a, n in zip(AXES, shape)}
    return Mesh(tuple(shape), resolve_device(device), axes, calls)


def make_mesh(n_devices: int | None = None, device=None,
              serving: bool = False) -> Mesh:
    """The (dp, sp, tp) mesh over the ranks of the current process group
    (``init_device_mesh``), factored by ``factor_mesh``. Without a
    process group the world is one rank and every axis a singleton."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh: {n} ranks asked for, the process "
                         f"group has {world}")
    shape = factor_mesh(n, serving)
    if n == 1:
        return local_mesh(shape, dev)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, shape, mesh_dim_names=AXES)
    calls = collections.Counter()
    axes = {}
    for a in AXES:
        group = dm.get_group(a)
        axes[a] = Axis(a, dm.size(AXES.index(a)), dm.get_local_rank(a),
                       group, tuple(dist.get_process_group_ranks(group)),
                       calls)
    return Mesh(shape, dev, axes, calls)


def right_halo(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Send each shard's tensor to its right neighbour along ``axis``;
    the first shard receives zeros (stream start). A singleton axis
    makes no call and returns zeros."""
    x = x.contiguous()
    if axis.size == 1:      # singleton axis: the only shard is the start
        return torch.zeros_like(x)
    axis._require_group("right_halo")
    received = torch.zeros_like(x)
    ops = []
    if axis.index + 1 < axis.size:
        ops.append(dist.P2POp(dist.isend, x, axis.ranks[axis.index + 1],
                              axis.group))
    if axis.index > 0:
        ops.append(dist.P2POp(dist.irecv, received,
                              axis.ranks[axis.index - 1], axis.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    axis.calls["halo"] += 1
    return received


def axis_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (the counterpart of
    ``psum``), computed in place on a contiguous ``x`` and returned. A
    singleton axis makes no call."""
    if axis.size == 1:
        return x
    axis._require_group("axis_sum")
    x = x.contiguous()
    dist.all_reduce(x, group=axis.group)
    axis.calls["sum"] += 1
    return x


def _rank_main(rank, world, backend, device_type, tmp):
    """One spawned rank: join the FileStore's process group, run the
    job the parent left in ``tmp`` as ``fn(device, *args)``, write its
    result for the parent, leave."""
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        result = fn(device, *args)
        if device_type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    part = os.path.join(tmp, f"rank{rank}.part")
    with open(part, "wb") as f:
        pickle.dump(result, f)
    os.replace(part, os.path.join(tmp, f"rank{rank}.pkl"))


def run_ranks(n_devices: int, fn, args=(), device=None) -> list:
    """Run ``fn(device, *args)`` on each of ``n_devices`` spawned ranks of
    one process group and return the results in rank order. ``fn`` and
    ``args`` are pickled to the workers (``fn`` a module-level function).

    On CUDA the backend is NCCL with one card a rank: fewer cards than
    ranks raises, since NCCL refuses two ranks on one card and gloo has
    no CUDA send/recv. On the CPU it is gloo. A rank that fails, or a
    run longer than RANK_TIMEOUT_S, stops every rank and raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(
                f"run_ranks: {n_devices} ranks on CUDA need {n_devices} "
                f"cards (NCCL takes one card a rank); {have} present")
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"run_ranks: no backend for {dev}")
    tmp = tempfile.mkdtemp(prefix="nq_ranks_")
    try:
        # The job goes by file: a spawn writes its arguments down a pipe
        # that the child drains only after its imports, one child at a
        # time.
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        ctx = mp.start_processes(
            _rank_main, args=(n_devices, backend, dev.type, tmp),
            nprocs=n_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"run_ranks: {n_devices} ranks still running "
                        f"after {RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        results = []
        for r in range(n_devices):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
