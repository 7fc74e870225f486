#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (libnyquist_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME, default /usr/local/cuda) and cc;
builds everything it runs from this checkout. Phases, in order; any
failure exits non-zero before the result line:

0. card name and power limit (nvidia-smi); build the native host
   library and the CUDA kernels (csrc/comb.cu, csrc/rot.cu, one nvcc
   each, started together); the host half of the serving batch: K = 8
   stereo streams of 11,100 frames of 20 ms (3.7 min each), stream k
   cycling the packets of case (0, 1, 6, 7, 13)[k % 5] with a fresh
   decoder state, once as the bits-only trace + replay arrays (the main
   path) and once as the full native decode (the comparison);
1. kernel phase: every kernel against its plain PyTorch version on the
   card, times by CUDA events. K1 (comb) at the reference tests' shapes
   and at the serving shape (16 rows x 40,960 chunks) on random inputs.
   K2 (rotation) on a seeded plane with eight sigma classes and at the
   serving shape [800, 22,200] on the real markers and values of stream
   0 (captured from its replay);
2. load phase: load() of tests/fixtures/ms8ch.opus (8 channels, family
   1) against tests/golden/ms8ch.npz, and opus_packets.bin CELT cases
   0, 1, 2 (mono), 3, 6, 7, 13 against their libopus PCM, all within
   1e-4;
3. serving phase (the main path at full size): upload the replay
   arrays, then run_stream_batched (device replay of each stream, then
   the synthesis step loop with f_chunk = 512: 22 steps of 16 rows).
   K1 is also held against its plain version on this real data. Checks:
   each stream's first cycle against libopus (1e-4); the replayed
   spectra against the full native decode (max d/(1+|ref|) < 1e-3,
   mean(rel > 1e-4) < 1e-5); the PCM against the spectra-in path
   run_synthesis_batched on the native spectra (1e-4); each full stream
   against the single-stream unified path (1e-6). Reports host seconds
   of both host halves, device seconds, the replay / imdct / comb /
   deemph split with the replay's inner stages, the realtime factor,
   and from one torch.profiler run the device busy share and the top
   kernels.

The kernel counts are set to 0 just before the main path runs and read
just after; a kernel of the path with no launch there fails the run.
Output: the card line, one {"kernels": [...]} JSON line, and as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
FIXTURES = ROOT / "tests" / "fixtures"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM data sheet, float32 outside the tensor cores
LOAD_CASES = (0, 1, 2, 3, 6, 7, 13)
SERVE_CASES = (0, 1, 6, 7, 13)
K_STREAMS = 8
SERVE_FRAMES = 11100
F_CHUNK = 512
COMB_SERVE_SHAPE = (16, 40960)    # B = K*CC rows, 512*960/12 chunks
ROT_SERVE_SHAPE = (800, 22200)    # WB positions, 2F rows of one stream
KERNELS = ("comb", "rot")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def read_case(idx: int):
    """Case idx of tests/golden/opus_packets.bin (written by
    tools/opus_packets_golden.c): (channels, packets, libopus PCM)."""
    raw = (GOLDEN / "opus_packets.bin").read_bytes()
    pos = 4
    for i in range(idx + 1):
        ch, _, n_packets, _ = struct.unpack_from("<4i", raw, pos)
        pos += 16
        pkts = []
        for _ in range(n_packets):
            (ln,) = struct.unpack_from("<i", raw, pos)
            pkts.append(raw[pos + 4 : pos + 4 + ln])
            pos += 4 + ln
        (ns,) = struct.unpack_from("<q", raw, pos)
        pcm = np.frombuffer(raw, "<f4", ns, pos + 8)
        pos += 8 + 4 * ns
    return ch, pkts, pcm


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median CUDA-event milliseconds of fn() over reps runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def comb_work(B: int, n: int):
    """(bytes, flops) the comb function needs: each input read once, each
    output written once; 19 float ops per sample (two 5-tap mixes of 3
    products and 4 adds, then the crossfade's 5)."""
    S = 12 * n
    io = 4 * (2 * B * S + 2 * B * 1026 + 2 * B * n + 6 * B * n + 12 * B * n)
    return io, 19 * B * S


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    d = (got - ref).abs().max().item()
    return d, d / max(ref.abs().max().item(), 1e-30)


def phase0_build(nqt_native, kernels):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    t0 = time.perf_counter()
    nqt_native.lib()
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels.build_all(KERNELS)
    for name in KERNELS:
        kernels.load(name)
    log(f"phase 0: host library built in {t_host:.2f} s; kernels "
        f"{', '.join(KERNELS)} in {time.perf_counter() - t0:.2f} s")
    for name, rep in kernels.build_log.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    return card


def host_batch(card):
    """The host half of the serving batch, both ways, timed on one core.
    Per stream: the bits-only trace + replay arrays (the main path) and
    the full native decode to spectra (the comparison and the
    spectra-in path). Returns (traces, decodes, seconds dict)."""
    from libnyquist_torch.formats.opus import (
        decode_celt_raw, trace_celt_packets)
    from libnyquist_torch.formats.opus.packet import parse_packet

    cases = {i: read_case(i) for i in SERVE_CASES}
    traces, decodes = [], []
    trace_s = decode_s = 0.0
    F = SERVE_FRAMES
    for k in range(K_STREAMS):
        ch, pkts, _ = cases[SERVE_CASES[k % len(SERVE_CASES)]]
        check(ch == 2, "serving cases must be stereo")
        fpp = len(parse_packet(pkts[0]).frames)          # frames per packet
        check(F % fpp == 0, "stream length must be whole packets")
        n_pk = F // fpp
        cyc = (pkts * -(-n_pk // len(pkts)))[:n_pk]
        t0 = time.perf_counter()
        tr, arrs, key, _ = trace_celt_packets(cyc, ch)
        trace_s += time.perf_counter() - t0
        check(len(tr.fsz) == F and bool((tr.fsz == 960).all()),
              "serving frames must be 11,100 x 20 ms")
        check(key[9] is not None and key[10] is not None
              and key[11] is not None,
              "the serving trace must be raw-iy, heap and idx mode")
        traces.append((tr, arrs, key))
        t0 = time.perf_counter()
        freq, fsz, _, sb, pfp, pfg, pft, _ = decode_celt_raw(cyc, ch)
        decode_s += time.perf_counter() - t0
        check(len(fsz) == F, "full decode frame count")
        for a, b in ((sb, tr.sb), (pfp, tr.pfp), (pfg, tr.pfg),
                     (pft, tr.pft)):
            check(np.array_equal(a, b), "trace and decode side info differ")
        decodes.append((np.ascontiguousarray(freq[:, :ch]), sb, pfp, pfg,
                        pft))
    audio_s = K_STREAMS * F * 960 / 48000.0
    nbytes = sum(v.nbytes for _, arrs, _ in traces for v in arrs.values())
    log(f"  host halves for {audio_s:.1f} s of audio (one core, host of "
        f"{card}): trace + replay arrays {trace_s:.2f} s "
        f"({nbytes / 1e6:.1f} MB of arrays), full decode {decode_s:.2f} s "
        f"({sum(d[0].nbytes for d in decodes) / 1e9:.2f} GB of spectra)")
    return traces, decodes, {"host_trace_s": trace_s,
                             "host_decode_s": decode_s,
                             "trace_array_bytes": nbytes}


def random_comb_args(B, n, seed, dev, realistic):
    """Comb inputs from numpy: the shapes and seeds of the reference
    kernel test, or (realistic) CELT-range gains that keep the IIR
    stable over a long row."""
    from libnyquist_torch.formats.opus.celt_tables import COMB_GAINS

    rng = np.random.default_rng(seed)
    S = 12 * n
    if realistic:
        tbl = np.asarray(COMB_GAINS, np.float32)
        g = [(tbl[rng.integers(0, 3, (B, n))]
              * rng.uniform(0, 0.75, (B, n, 1))).astype(np.float32)
             for _ in range(2)]
        x = rng.standard_normal((B, S)).astype(np.float32) * 3000
        h = rng.standard_normal((B, 1026)).astype(np.float32) * 3000
    else:
        g = [(rng.standard_normal((B, n, 3)) * 0.2).astype(np.float32)
             for _ in range(2)]
        x = rng.standard_normal((B, S)).astype(np.float32) * 0.1
        h = rng.standard_normal((B, 1026)).astype(np.float32) * 0.1
    arrs = (x, h, rng.integers(15, 1025, (B, n)).astype(np.int32),
            rng.integers(15, 1025, (B, n)).astype(np.int32), g[0], g[1],
            rng.uniform(0, 1, (B, n, 12)).astype(np.float32))
    return [torch.from_numpy(a).to(dev) for a in arrs]


def compare_comb(comb, args, label, tol=1e-5):
    y_k, h_k = comb.comb_filter_cuda(*args)
    y_r, h_r = comb.comb_filter_stream_ref(*args)
    torch.cuda.synchronize()
    ae, re = rel_err(y_k, y_r)
    he, hre = rel_err(h_k, h_r)
    check(bool(torch.isfinite(y_k).all()), f"comb {label}: non-finite")
    check(re <= tol and hre <= tol,
          f"comb {label}: rel err {re:.3e} / hist {hre:.3e} > {tol}")
    log(f"  comb {label}: max|d| {ae:.3e}, max|d|/max|ref| {re:.3e}")
    return ae, re


def rot_work(W: int, R: int, ops_done: int):
    """(bytes, flops) the rotation needs: x and the three dense marker
    planes (pk, theta, gain) read once, y written once; six float ops
    per Givens step these markers need plus one gain product per
    value."""
    return 4 * 5 * W * R, 6 * ops_done + W * R


def random_rot_args(R, seed, dev):
    """A seeded position-major plane [800, R] with its dense marker
    planes: per row and band a rotating leaf, a plain leaf, a leaf that
    ends at half the band, or nothing. Eight sigma classes."""
    from libnyquist_torch.formats.opus.celt_tables import mode48000
    from libnyquist_torch.ops.celt_replay import _sigma2_of

    mode = mode48000()
    band_off = [8 * int(e) for e in mode.eBands[: mode.nbEBands + 1]]
    W = band_off[-1]
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (W, R)).astype(np.float32)
    pk = np.full((W, R), -1, np.int32)
    th = np.zeros((W, R), np.float32)
    g = np.zeros((W, R), np.float32)
    sigmas = set()
    for b in range(len(band_off) - 1):
        col, n = band_off[b], band_off[b + 1] - band_off[b]
        kind = rng.integers(0, 4, R)     # 0 none, 1 rotating, 2 plain, 3 half
        s2 = _sigma2_of(n, 1)
        rotating = (kind == 1) & (s2 > 0)
        if rotating.any():
            sigmas.add(s2)
        ln = np.where(kind == 3, max(n // 2, 1), n)
        pk[col] = np.where(
            kind > 0, (col << 13) | (ln << 4) | (1 + np.where(rotating, s2, 0)),
            -1)
        th[col] = np.where(rotating, rng.uniform(0.02, 0.5, R), 0.0)
        g[col] = np.where(kind > 0, rng.uniform(0.05, 1.0, R), 0.0)
    planes = [torch.from_numpy(a).to(dev) for a in (x, pk, th, g)]
    return planes + [tuple(sorted(sigmas)), band_off]


def rot_steps(pk, th):
    """Givens steps these markers need: per rotating sub-segment (theta
    > 0) of length n and sigma class sg, (n - 1) + (n - 2) steps at lag
    1 and (n - sg) + (n - 2 sg) at stride sg."""
    p = pk[(pk >= 0) & (th > 0)].to(torch.int64)
    n = (p >> 4) & 0x1FF
    sg = (p & 15) - 1
    lag1 = (n - 1).clamp(min=0) + (n - 2).clamp(min=0)
    lag_s = torch.where(sg > 0, (n - sg).clamp(min=0)
                        + (n - 2 * sg).clamp(min=0), 0)
    return int((lag1 + lag_s).sum().item())


def compare_rot(rot, args, label, tol=1e-5):
    """The kernel against its plain version on one set of planes.
    Returns (abs err, rel err, plain ms of that one run)."""
    y_k = rot.rotate_plane_cuda(*args)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    y_r = rot.rotate_plane_ref(*args)
    b.record()
    torch.cuda.synchronize()
    ae, re = rel_err(y_k, y_r)
    check(bool(torch.isfinite(y_k).all()), f"rot {label}: non-finite")
    moved = (y_r - args[0]).abs().max().item()
    check(moved > 0, f"rot {label}: the plain version changed nothing")
    check(re <= tol, f"rot {label}: rel err {re:.3e} > {tol}")
    log(f"  rot {label}: max|d| {ae:.3e}, max|d|/max|ref| {re:.3e}")
    return ae, re, a.elapsed_time(b)


def capture_rotation_inputs(trace, dev):
    """Stream 0's rotation inputs at the serving shape: run its replay
    once with rot.rotate_plane wrapped to keep the arguments."""
    from libnyquist_torch.ops import celt_replay, rot

    _, arrs, key = trace
    kept = {}
    orig = rot.rotate_plane

    def keep(*args):
        kept["args"] = args
        return orig(*args)

    rot.rotate_plane = keep
    try:
        celt_replay._replay_builder(key)(
            celt_replay.replay_arrays_from_numpy(arrs, dev))
    finally:
        rot.rotate_plane = orig
    check("args" in kept, "stream 0's replay ran no rotation")
    return list(kept["args"])


def phase1_kernels(comb, rot, trace0, dev):
    log("phase 1: kernels against their plain versions on the card")
    for B, n in ((4, 140), (8, 257)):       # the reference kernel test
        compare_comb(comb, random_comb_args(B, n, B * 1000 + n, dev, False),
                     f"B={B} n={n}")
    B, n = COMB_SERVE_SHAPE
    args = random_comb_args(B, n, 2024, dev, True)
    ae, re = compare_comb(comb, args, f"serving shape B={B} n={n} random")
    k_ms = cuda_ms(lambda: comb.comb_filter_cuda(*args), reps=7)
    p_ms = cuda_ms(lambda: comb.comb_filter_stream_ref(*args), reps=3,
                   warmup=0)
    nbytes, flops = comb_work(B, n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    log(f"  comb serving shape: kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms, "
        f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    comb_row = {
        "name": "comb_filter",
        "route": "cuda",
        "source": "libnyquist_torch/csrc/comb.cu",
        "replaces": "libnyquist_tpu/ops/comb_pallas.py:44",
        "launches": None,
        "max_abs_err": ae,
        "max_rel_err": re,
        "ms": k_ms,
        "kernel_ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"B": B, "n_chunks": n},
    }
    del args

    rargs = random_rot_args(300, 7, dev)
    check(len(rargs[4]) >= 3, "seeded plane needs several sigma classes")
    compare_rot(rot, rargs, f"W=800 R=300 seeded, sigmas {rargs[4]}")
    rargs = capture_rotation_inputs(trace0, dev)
    W, R = rargs[0].shape
    check((W, R) == ROT_SERVE_SHAPE, f"rotation plane is {(W, R)}")
    ae, re, p_ms = compare_rot(
        rot, rargs, f"serving shape W={W} R={R} real markers, sigmas "
        f"{tuple(rargs[4])}")
    k_ms = cuda_ms(lambda: rot.rotate_plane_cuda(*rargs), reps=7)
    steps = rot_steps(rargs[1], rargs[2])
    nbytes, flops = rot_work(W, R, steps)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    log(f"  rot serving shape: kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms "
        f"(one run, all rows), bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB: x, pk, theta, gain planes in and y out; "
        f"{steps / 1e6:.2f} M Givens steps, {flops / 1e9:.3f} GFLOP)")
    rot_row = {
        "name": "rotate_plane",
        "route": "cuda",
        "source": "libnyquist_torch/csrc/rot.cu",
        "replaces": "libnyquist_tpu/ops/rot_pallas.py:56",
        "launches": None,
        "max_abs_err": ae,
        "max_rel_err": re,
        "ms": k_ms,
        "kernel_ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"W": W, "R": R, "sigmas": list(rargs[4])},
    }
    return comb_row, rot_row


def phase2_load(nqt, comb, dev):
    from libnyquist_torch.formats.opus import decode_celt_packets

    log("phase 2: load() and packet decode on the card")
    before = comb.comb_filter_cuda.launches
    g = np.load(GOLDEN / "ms8ch.npz")
    t0 = time.perf_counter()
    audio = nqt.load(str(FIXTURES / "ms8ch.opus"), device=dev)
    dt = time.perf_counter() - t0
    check(audio.channel_count == int(g["channels"]), "ms8ch channels")
    check(audio.sample_rate == int(g["rate"]), "ms8ch rate")
    check(audio.sample_count == int(g["count"]), "ms8ch sample count")
    err = float(np.abs(audio.samples - g["full"]).max())
    total = float(audio.samples.astype(np.float64).sum())
    check(err < 1e-4, f"ms8ch max err {err}")
    check(abs(total - float(g["sum64"])) < max(1e-2, 1e-4 * audio.sample_count),
          "ms8ch sum")
    log(f"  ms8ch.opus: max|d| vs golden {err:.3e} ({dt:.2f} s)")
    for idx in LOAD_CASES:
        ch, pkts, ref = read_case(idx)
        out = decode_celt_packets(pkts, ch, device=dev).cpu().numpy()
        e = float(np.abs(out.reshape(-1) - ref[: out.size]).max())
        check(out.size == ref.size, f"case {idx}: {out.size} != {ref.size}")
        check(e < 1e-4, f"case {idx}: max err {e}")
        log(f"  case {idx}: {ch} ch, {out.shape[0]} samples, max|d| vs "
            f"libopus {e:.3e}")
    grew = comb.comb_filter_cuda.launches - before
    check(grew > 0, "load phase launched no comb kernel")
    log(f"  comb kernel launches in the load phase: {grew}")


def profile_main_path(fn, card):
    """torch.profiler over one run of fn: device time summed over kernels
    (self time, so nothing counts twice), the busy share of the traced
    wall time, and the five kernels with the most device time. Reports
    None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side events only (kernels, copies): the CPU ops that launch
    # them report the same time again as their own device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    if not events:
        log("  traced run: the profiler saw no device time (not measured)")
        return {"traced_wall_s": wall, "traced_busy_s": None,
                "traced_idle_share": None}
    top = sorted(events, key=dev_us, reverse=True)[:5]
    log(f"  traced run: wall {wall:.3f} s, device busy {busy_s:.3f} s, idle "
        f"share {1 - busy_s / wall:.3f} on {card}; top kernels: " + "; ".join(
            f"{e.key[:60]} {dev_us(e) / 1e3:.1f} ms x{e.count}" for e in top))
    return {"traced_wall_s": wall, "traced_busy_s": busy_s,
            "traced_idle_share": 1 - busy_s / wall}


def replay_stage_split(streams_dev):
    """CUDA-event times of the replay's inner stages, summed over the
    streams of one batch (one pass, after the warm-up the earlier runs
    gave)."""
    from libnyquist_torch.ops import celt_replay

    totals = {}
    for arrs, key in streams_dev:
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        celt_replay._replay_builder(key)(arrs, mark=mark)
        torch.cuda.synchronize()
        for (_, e0), (name, e1) in zip(events, events[1:]):
            totals[name] = totals.get(name, 0.0) + e0.elapsed_time(e1)
    return totals


def phase3_serving(comb, rot, serving, dev, rows, card, traces, decodes,
                   host):
    from libnyquist_torch.ops import celt_replay

    log(f"phase 3: serving K={K_STREAMS} stereo streams x {SERVE_FRAMES} "
        f"frames from their host traces (main path)")
    K, CC, F, N = K_STREAMS, 2, SERVE_FRAMES, 960
    n_steps = -(-F // F_CHUNK)
    synth = serving.synth_from_numpy(serving.synth_tables(
        [d[1:] for d in decodes], N, n_steps, F_CHUNK), dev)
    t0 = time.perf_counter()
    streams_dev = [(celt_replay.replay_arrays_from_numpy(arrs, dev), key)
                   for _, arrs, key in traces]
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    keys = {key for _, key in streams_dev}
    audio_s = K * F * N / 48000.0
    log(f"  replay arrays uploaded in {upload_s:.3f} s; {len(keys)} "
        f"distinct structure keys among {K} streams")
    # the native decode's spectra, for the comparison and the spectra-in
    # path
    spec_h = np.stack([d[0][:, c] for c in range(CC) for d in decodes])
    spec_nat = torch.from_numpy(spec_h).to(dev)          # [R, F, N] c*K+k
    del spec_h

    # K1 against its plain version on real decode data: step 1's comb
    # inputs, with the history step 0 left behind
    mode_ov, short = 120, 120
    R = K * CC
    zeros = dict(tails=torch.zeros(R, mode_ov, device=dev),
                 hist=torch.zeros(R, 1026, device=dev),
                 mem=torch.zeros(R, device=dev))

    def rows_of(name, step):
        v = synth[name][:, step]
        return v.repeat((CC,) + (1,) * (v.dim() - 1))

    def step_args(step):
        return (spec_nat[:, step * F_CHUNK : (step + 1) * F_CHUNK],
                rows_of("msk", step), rows_of("TA", step),
                rows_of("gA", step), rows_of("TB1", step),
                rows_of("gB1", step), synth["fade"],
                synth["T1m"], synth["T1p"], synth["T8m"], synth["T8p"])

    _, tails1, hist1, _ = serving.unified_step_row_body(
        *step_args(0), zeros["tails"], zeros["hist"], zeros["mem"],
        mode_ov, short)
    raw1, _, _, _ = serving.unified_step_row_body(
        *step_args(1), tails1, hist1, zeros["mem"], mode_ov, short,
        with_comb=False, with_deemph=False)
    a = step_args(1)
    real_args = [raw1 * 32768.0, hist1] + list(serving.expand_comb_params(
        a[2], a[3], a[4], a[5], synth["fade"], N, short))
    compare_comb(comb, real_args, f"serving shape B={R} real decode data")
    del real_args, raw1

    # the main path: counts to 0 just before, read just after
    comb.comb_filter_cuda.launches = 0
    rot.rotate_plane_cuda.launches = 0
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    acc, pcm = serving.run_stream_batched(streams_dev, synth, K, CC, n_steps,
                                          F_CHUNK)
    ev1.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    dev_s = ev0.elapsed_time(ev1) / 1e3
    launches = {"comb_filter": comb.comb_filter_cuda.launches,
                "rotate_plane": rot.rotate_plane_cuda.launches}
    for row in rows:
        check(launches[row["name"]] > 0,
              f"the main path launched no {row['name']} kernel")
        row["launches"] = launches[row["name"]]
    check(tuple(acc.shape) == (K, CC) and bool(torch.isfinite(acc).all()),
          "acc shape / finiteness")
    check(tuple(pcm.shape) == (R, F * N) and bool(torch.isfinite(pcm).all()),
          "pcm shape / finiteness")
    log(f"  main path: replay + {n_steps} steps, launches {launches}, "
        f"device {dev_s:.3f} s (wall {wall_s:.3f} s), realtime x"
        f"{audio_s / dev_s:.1f} on {card}")

    # first cycle of each stream against libopus
    for k in range(K):
        idx = SERVE_CASES[k % len(SERVE_CASES)]
        _, _, ref = read_case(idx)
        n = ref.size // CC
        got = pcm[k::K, :n].T.cpu().numpy().reshape(-1)
        e = float(np.abs(got - ref).max())
        check(e < 1e-4, f"stream {k} (case {idx}) first cycle err {e}")
        log(f"  stream {k} (case {idx}) first cycle: max|d| vs libopus "
            f"{e:.3e}")

    # the replayed spectra against the full native decode, all frames
    spec_rep = serving.replay_streams(streams_dev, K, CC)
    rel = (spec_rep - spec_nat).abs() / (1.0 + spec_nat.abs())
    rel_max = rel.max().item()
    rel_frac = (rel > 1e-4).float().mean().item()
    del rel
    check(rel_max < 1e-3, f"replay vs native decode: max rel {rel_max}")
    check(rel_frac < 1e-5, f"replay vs native decode: {rel_frac} of the "
          f"values differ by more than 1e-4")
    log(f"  replayed spectra vs native decode ({spec_rep.numel()} values): "
        f"max d/(1+|ref|) {rel_max:.3e}, share above 1e-4 {rel_frac:.3e}")
    # the trace path's PCM against the spectra-in path
    _, pcm_nat = serving.run_synthesis_batched(spec_nat, synth, K, CC,
                                               n_steps, F_CHUNK)
    pcm_d = (pcm - pcm_nat).abs().max().item()
    check(pcm_d < 1e-4, f"trace path vs spectra-in path: max|d| {pcm_d}")
    log(f"  trace-path PCM vs spectra-in path: max|d| {pcm_d:.3e}")
    del pcm_nat

    # stage split: the replay by CUDA events, the synthesis stages by the
    # stage switches (cumulative variants) on the replayed spectra
    def run(with_comb, with_deemph):
        serving.run_synthesis_batched(spec_rep, synth, K, CC, n_steps,
                                      F_CHUNK, with_comb=with_comb,
                                      with_deemph=with_deemph)

    t_replay = cuda_ms(lambda: serving.replay_streams(streams_dev, K, CC),
                       reps=3)
    inner = replay_stage_split(streams_dev)
    t_imdct = cuda_ms(lambda: run(False, False), reps=3)
    t_comb = cuda_ms(lambda: run(True, False), reps=3)
    t_synth = cuda_ms(lambda: run(True, True), reps=3)
    split = {"replay_ms": t_replay, "imdct_ms": t_imdct,
             "comb_ms": t_comb - t_imdct, "deemph_ms": t_synth - t_comb,
             "synth_ms": t_synth, "full_ms": t_replay + t_synth}
    log("  stage split (median of 3, per batch): " + ", ".join(
        f"{k} {v:.1f}" for k, v in split.items()) + f" on {card}")
    log("  replay inner stages (one pass, summed over the streams): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in inner.items()))
    log(f"  host seconds for the batch (one core): trace path "
        f"{host['host_trace_s']:.2f}, full decode "
        f"{host['host_decode_s']:.2f}; device seconds of the main path "
        f"{dev_s:.3f}")
    # one traced run of the main path: device busy time by kernel name
    trace = profile_main_path(
        lambda: serving.run_stream_batched(streams_dev, synth, K, CC,
                                           n_steps, F_CHUNK), card)
    # every stream against the single-stream unified path on the card
    worst = 0.0
    for k, (freq, sb, pfp, pfg, pft) in enumerate(decodes):
        one = serving.synthesize_streams_unified(
            np.asarray(spec_rep[k::K].permute(1, 0, 2).cpu()), sb, pfp, pfg,
            pft, CC, f_chunk=F_CHUNK, device=dev)
        worst = max(worst, (one.T - pcm[k::K]).abs().max().item())
    log(f"  batched vs single-stream: max|d| {worst:.3e}")
    check(worst < 1e-6, f"batched vs single max err {worst}")

    return {"K": K, "frames": F, "audio_s": audio_s, **host,
            "upload_s": upload_s, "structure_keys": len(keys),
            "device_s": dev_s, "wall_s": wall_s,
            "realtime_x": audio_s / dev_s,
            "realtime_x_full_median": audio_s / (split["full_ms"] / 1e3),
            "launches": launches, "batched_vs_single": worst,
            "replay_vs_native_max_rel": rel_max,
            "replay_vs_native_share_above_1e-4": rel_frac,
            "trace_vs_spectra_in_pcm": pcm_d,
            **split, "replay_inner_ms": inner, **trace}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(ROOT))
    import libnyquist_torch as nqt
    from libnyquist_torch import kernels
    from libnyquist_torch.device import resolve_device
    from libnyquist_torch.ops import comb, rot
    from libnyquist_torch.runtime import native, serving

    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    card = phase0_build(native, kernels)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    traces, decodes, host = host_batch(card)
    rows = phase1_kernels(comb, rot, traces[0], dev)
    phase2_load(nqt, comb, dev)
    serve = phase3_serving(comb, rot, serving, dev, rows, card, traces,
                           decodes, host)
    log(json.dumps({"serving": serve, "card": card}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": list(rows)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
