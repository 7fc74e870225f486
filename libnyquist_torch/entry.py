"""Entry points: the single-card decode step and the sharded step.

The flagship pipeline of the package is the batched Opus/CELT decode:
IMDCT synthesis products + TDAC overlap-add + pitch postfilter (K1,
``csrc/comb.cu`` on a card) + deemphasis. ``entry`` returns the
single-card step with its example arguments; ``sharded_decode_step``
runs the same step over a (dp, sp, tp) mesh of ranks
(``parallel/mesh.py``):

  dp — data parallel over concurrent streams (rows), no collective,
  sp — sequence parallel over the frames; the overlap-add tail and the
       postfilter and deemphasis histories cross shard boundaries and go
       to the right neighbour by point-to-point send/recv,
  tp — tensor parallel over the synthesis products' contraction
       dimension (spectrum bins), summed over the group.

A world of one runs in the calling process; more ranks are spawned
processes, one device each (NCCL on CUDA, gloo on the CPU).
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import torch
import torch.nn.functional as nnf

from .device import resolve_device
from .ops import comb as comb_ops
from .ops import imdct as imdct_ops
from .ops import scan_iir
from .ops.scan_iir import row_products
from .parallel.mesh import (DEEMPH_HALO, axis_sum, factor_mesh, local_mesh,
                            make_mesh, right_halo, run_ranks)

N, OVERLAP = 960, 120          # 20 ms CELT frames at 48 kHz
SCALE = 1.0 / 32768.0


def _build_step(F, overlap, device):
    Tm, Tp, Tt = (torch.from_numpy(t).to(device) for t in
                  imdct_ops.celt_synthesis_matrices_paired(2 * N, overlap, 1))
    S = F * N
    pad = (-S) % scan_iir.BLOCK

    def step(spec, tails, comb_hist, deemph_mem, T0, T1, g0, g1, fade):
        r = spec.shape[0]
        main = spec.reshape(-1, N) @ Tm
        prev = torch.cat([spec.new_zeros(r, 1, N), spec[:, :-1]],
                         dim=1).reshape(-1, N)
        raw = (main + prev @ Tp).reshape(r, F, N)
        raw[:, 0, :overlap] += tails
        raw = raw.reshape(r, S)
        new_tails = spec[:, -1] @ Tt
        y, new_hist = comb_ops.comb_filter(
            raw, comb_hist, T0, T1, g0, g1, fade)
        out, new_mem = scan_iir.deemphasis(nnf.pad(y, (0, pad)), deemph_mem)
        return out[:, :S] * SCALE, new_tails, new_hist, new_mem

    return step


def _example_args(rows, F, overlap, device):
    n_chunks = F * N // comb_ops.CHUNK
    rng = np.random.default_rng(0)
    f32 = np.float32
    arrays = (
        rng.standard_normal((rows, F, N)).astype(f32),
        np.zeros((rows, overlap), f32),
        np.zeros((rows, comb_ops.HIST), f32),
        np.zeros((rows,), f32),
        np.full((rows, n_chunks), 40, np.int32),
        np.full((rows, n_chunks), 40, np.int32),
        rng.uniform(0, 0.3, (rows, n_chunks, 3)).astype(f32),
        rng.uniform(0, 0.3, (rows, n_chunks, 3)).astype(f32),
        rng.uniform(0, 1, (rows, n_chunks, comb_ops.CHUNK)).astype(f32),
    )
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def entry(device=None):
    """(the single-card forward step of the flagship decode pipeline,
    its example arguments on ``device``)."""
    dev = resolve_device(device)
    rows, F = 4, 8
    return _build_step(F, OVERLAP, dev), _example_args(rows, F, OVERLAP, dev)


def real_content_args(path, rows: int = 16, F: int = 16):
    """Decoded stream content for sharded_decode_step from an Ogg Opus
    file of stereo CELT frames.

    Host-decodes the file's CELT frames to denormalised spectra and the
    signaled postfilter parameters (the host/device boundary of the
    serving path, runtime/serving.py), picks runs of F consecutive
    long-block frames (the single-matrix step's shape class) and puts a
    different window on each stream's rows. Returns dict(spec, T0, T1,
    g0, g1, fade) of numpy arrays, or None when the native decode does
    not take the file or it has too few such windows."""
    from .formats.opus.celt_host import CeltDecoderState, celt_decode_ogg_raw
    from .formats.opus.celt_tables import mode48000
    from .runtime.serving import postfilter_params_arrays

    data = pathlib.Path(path).read_bytes()
    out = celt_decode_ogg_raw(CeltDecoderState(channels=2), data)
    if out is None:
        return None
    freq, fsizes, _chs, short_blocks, pf_pitch, pf_gain, pf_tapset = out[:7]
    mode = mode48000()
    CC = freq.shape[1]
    long_ok = (np.asarray(short_blocks) == 0) & (np.asarray(fsizes) == N)
    TA, gA, TB, gB = postfilter_params_arrays(
        short_blocks, pf_pitch, pf_gain, pf_tapset)

    # windows of F consecutive long-block frames, one per stream copy
    n_streams = rows // CC
    starts, f0 = [], 0
    while len(starts) < n_streams and f0 + F <= len(fsizes):
        if long_ok[f0 : f0 + F].all():
            starts.append(f0)
            f0 += F
        else:
            f0 += 1
    if len(starts) < n_streams:
        return None

    n_chunks = F * N // comb_ops.CHUNK
    spec = np.zeros((rows, F, N), np.float32)
    T0 = np.zeros((rows, n_chunks), np.int32)
    T1 = np.zeros((rows, n_chunks), np.int32)
    g0 = np.zeros((rows, n_chunks, 3), np.float32)
    g1 = np.zeros((rows, n_chunks, 3), np.float32)
    fade = np.zeros((rows, n_chunks, comb_ops.CHUNK), np.float32)
    for k, s in enumerate(starts):
        rs = slice(k * CC, (k + 1) * CC)
        spec[rs] = np.transpose(freq[s : s + F, :, :N], (1, 0, 2))
        fp = [dict(T0a=int(TA[f]), T1a=int(TA[f]), g0a=gA[f], g1a=gA[f],
                   T0b=int(TA[f]), T1b=int(TB[f]), g0b=gA[f], g1b=gB[f],
                   frame_size=N, LM=3)
              for f in range(s, s + F)]
        ch = comb_ops.build_chunk_params(fp, N, mode.window,
                                         mode.shortMdctSize)
        T0[rs] = ch["T0"]
        T1[rs] = ch["T1"]
        g0[rs] = ch["gains0"]
        g1[rs] = ch["gains1"]
        fade[rs] = ch["fade"]
    return dict(spec=spec, T0=T0, T1=T1, g0=g0, g1=g1, fade=fade)


def _global_arrays(rows, F, content):
    """The step's whole inputs as numpy: the caller's content, or random
    spectra and postfilter parameters from a seed of 0."""
    n_chunks = F * N // comb_ops.CHUNK
    if content is not None:
        arrays = dict(
            spec=np.asarray(content["spec"], np.float32),
            T0=np.asarray(content["T0"], np.int32),
            T1=np.asarray(content["T1"], np.int32),
            g0=np.asarray(content["g0"], np.float32),
            g1=np.asarray(content["g1"], np.float32),
            fade=np.asarray(content["fade"], np.float32))
        if arrays["spec"].shape != (rows, F, N):
            raise ValueError(f"content spec has shape "
                             f"{arrays['spec'].shape}, expected "
                             f"{(rows, F, N)}")
        return arrays
    rng = np.random.default_rng(0)
    spec = rng.standard_normal((rows, F, N)).astype(np.float32)
    T0 = np.full((rows, n_chunks), 40, np.int32)
    g0 = rng.uniform(0, 0.3, (rows, n_chunks, 3)).astype(np.float32)
    fade = rng.uniform(0, 1, (rows, n_chunks, comb_ops.CHUNK)).astype(
        np.float32)
    return dict(spec=spec, T0=T0, T1=T0, g0=g0, g1=g0, fade=fade)


def _shard_args(mesh, rows, F, content):
    """This rank's block of the step's inputs, contiguous on its device:
    rows over dp, frames (and their chunks) over sp, the contraction
    dimension N over tp, with the synthesis matrices' rows."""
    dp, sp, tp = mesh.shape
    if rows % dp or F % sp or N % tp:
        raise ValueError(f"mesh {mesh.shape} does not divide rows={rows}, "
                         f"F={F}, N={N}")
    d, s, t = mesh.coords
    r, f, n = rows // dp, F // sp, N // tp
    c = f * N // comb_ops.CHUNK
    g = _global_arrays(rows, F, content)
    rs, cs, ns = (slice(d * r, (d + 1) * r), slice(s * c, (s + 1) * c),
                  slice(t * n, (t + 1) * n))
    blocks = (g["spec"][rs, s * f : (s + 1) * f, ns], g["T0"][rs, cs],
              g["T1"][rs, cs], g["g0"][rs, cs], g["g1"][rs, cs],
              g["fade"][rs, cs])
    mats = tuple(m[ns] for m in imdct_ops.celt_synthesis_matrices_paired(
        2 * N, OVERLAP, 1))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
                 for a in blocks + mats)


def _local_step(mesh, spec, T0, T1, g0, g1, fade, Tm, Tpm, Tt, halos=None):
    """One rank's step. spec: [rows/dp, F/sp, N/tp], the tensor-parallel
    contraction slice. Collectives over singleton axes make no call, so
    the serving factoring (n, 1, 1) runs with none. ``halos``, when
    given, receives each postfilter pass's history halo."""
    r, f_local, n_local = spec.shape
    # Every product runs per stream row (scan_iir.row_products): its
    # shape is then the same for every dp, so a dp slice computes its
    # rows bit for bit as world 1 does.
    main = row_products(spec, Tm)
    # Frame f-1 within the shard; the shard-crossing frame's tail comes
    # from the left sp neighbour below.
    prev = torch.cat([spec.new_zeros(r, 1, n_local), spec[:, :-1]], dim=1)
    part = (main + row_products(prev, Tpm)).reshape(-1)
    my_tail = row_products(spec[:, -1:], Tt)
    # tp: the partial contraction and the tail, summed in one call.
    if mesh["tp"].size > 1:
        both = axis_sum(torch.cat([part, my_tail.reshape(-1)]), mesh["tp"])
        part, my_tail = both[: part.numel()], both[part.numel():]
    raw = part.view(r, f_local, N)
    # sp: the last local frame's tail goes to the right neighbour.
    left_tail = right_halo(my_tail.reshape(r, OVERLAP), mesh["sp"])
    raw[:, 0, :OVERLAP] += left_tail
    raw = raw.reshape(r, -1)

    # sp: postfilter history halo. Pass 0 seeds with the left neighbour's
    # raw tail; each refinement pass replaces it with the left
    # neighbour's *filtered* tail, which is exact for shard k after k
    # passes (shard 0 is exact at once: its halo is zeros).
    y = raw
    for _ in range(mesh["sp"].size):
        halo = right_halo(y[:, -comb_ops.HIST:], mesh["sp"])
        if halos is not None:
            halos.append(halo)
        y, _ = comb_ops.comb_filter(raw, halo, T0, T1, g0, g1, fade)

    # Deemphasis with an exact halo (0.85^256 ~ 1e-18).
    dhalo = right_halo(y[:, -DEEMPH_HALO:], mesh["sp"])
    ext = torch.cat([dhalo, y], dim=1)
    ext = nnf.pad(ext, (0, (-ext.shape[1]) % scan_iir.BLOCK))
    out, _ = scan_iir.deemphasis(ext, ext.new_zeros(r), per_row=True)
    return out[:, DEEMPH_HALO : DEEMPH_HALO + y.shape[1]] * SCALE


def _step_ms(step, device, reps):
    """Median ms of ``reps`` runs of step() after a warm-up run, timed in
    this rank: CUDA events on a card, the host clock on the CPU."""
    step()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            step()
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _decode_rank(device, cases):
    """Each case's sharded step on this rank (the rank worker of
    decode_cases): per case dict(coords, shape, out, halos, calls,
    comb_launches), arrays as numpy; comb_launches counts this rank's
    K1 launches (none on the CPU), calls its collective calls of the one
    step. A case with ``measure`` = r also gets this rank's cost of a
    step (``flops`` of its products, ``bytes`` moved, by op_cost) and
    ``step_ms``, the median of r more steps after a warm-up."""
    from .utils.profiling import op_cost

    results = []
    for case in cases:
        mesh = make_mesh(device=device, serving=case["serving_mesh"])
        args = _shard_args(mesh, case["rows"], case["F"], case["content"])
        halos = []
        k0 = comb_ops.comb_filter_cuda.launches
        out = _local_step(mesh, *args, halos=halos)
        res = dict(
            coords=mesh.coords, shape=mesh.shape, out=out.cpu().numpy(),
            halos=[h.cpu().numpy() for h in halos], calls=dict(mesh.calls),
            comb_launches=comb_ops.comb_filter_cuda.launches - k0)
        if case.get("measure"):
            cost = op_cost(_local_step, mesh, *args)
            res.update(flops=cost.get("flops", 0.0), bytes=cost["bytes"],
                       step_ms=_step_ms(lambda: _local_step(mesh, *args),
                                        mesh.device, case["measure"]))
        results.append(res)
    return results


def decode_cases(n_devices: int, cases, device=None) -> list:
    """Run each case's sharded step once on an ``n_devices`` mesh, all
    cases in one set of ranks. A case is dict(rows, F, content,
    serving_mesh[, measure]). Returns, per case, each rank's dict
    (_decode_rank) in rank order. One device runs in the calling
    process; more are spawned ranks (``run_ranks``)."""
    dev = resolve_device(device)
    cases = [{"rows": 8, "F": 16, "content": None, "serving_mesh": False,
              **c} for c in cases]
    if n_devices == 1:
        per_rank = [_decode_rank(dev, cases)]
    else:
        per_rank = run_ranks(n_devices, _decode_rank, (cases,), dev)
    return [[rank[i] for rank in per_rank] for i in range(len(cases))]


def assemble(results, rows: int, F: int) -> np.ndarray:
    """The [rows, F*N] output from the ranks' blocks (tp index 0 of each
    (dp, sp) block; the tp ranks hold the same block)."""
    out = np.zeros((rows, F * N), np.float32)
    for res in results:
        d, s, t = res["coords"]
        if t == 0:
            r, w = res["out"].shape
            out[d * r : (d + 1) * r, s * w : (s + 1) * w] = res["out"]
    return out


def sharded_decode_step(n_devices: int, rows: int = 8, F: int = 16,
                        return_fn: bool = False, content: dict = None,
                        serving_mesh: bool = False, device=None):
    """Build and run the full sharded decode step on an n_devices mesh.

    Returns (output [rows, F*N] as np.ndarray, (dp, sp, tp)); or, with
    return_fn=True, (fn, args, (dp, sp, tp)): rank 0's local step and
    its block of the inputs, callable in this process without spawning
    where the mesh makes no collective call (the serving factoring, or
    one device). Default shapes are fixed (rows=8, F=16) so outputs are
    comparable across mesh sizes. The comb postfilter halo is made
    exact by sp - 1 refinement passes: pass k feeds each shard the left
    neighbour's pass-(k-1) filtered tail, and shard 0's halo is exact
    (zeros) from the start, so after sp - 1 passes every shard has the
    exact history by induction."""
    dev = resolve_device(device)
    shape = factor_mesh(n_devices, serving=serving_mesh)
    if return_fn:
        mesh = local_mesh(shape, dev)
        args = _shard_args(mesh, rows, F, content)
        return (lambda *a: _local_step(mesh, *a)), args, shape
    case = dict(rows=rows, F=F, content=content, serving_mesh=serving_mesh)
    results = decode_cases(n_devices, [case], dev)[0]
    return assemble(results, rows, F), shape


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded step on an n_devices (dp, sp, tp) mesh, on random
    spectra. On CUDA it needs n_devices cards (one a rank) and raises
    with fewer; device="cpu" runs gloo ranks."""
    out, (dp, sp, tp) = sharded_decode_step(n_devices, device=device)
    if not np.isfinite(out).all():
        raise RuntimeError("dryrun_multichip: non-finite output")
    print(f"dryrun_multichip ok: mesh dp={dp} sp={sp} tp={tp}, "
          f"out {out.shape}")
