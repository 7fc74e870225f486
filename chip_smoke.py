#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (libnyquist_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME, default /usr/local/cuda) and cc;
builds everything it runs from this checkout. Phases, in order; any
failure exits non-zero before the result line:

0. card name and power limit (nvidia-smi); build the native host
   library and the CUDA kernel (csrc/comb.cu);
1. kernel phase: every kernel against its plain PyTorch version on the
   card, at the reference tests' shapes and at the serving shape
   (16 rows x 40,960 chunks) on random inputs; times by CUDA events;
2. load phase: load() of tests/fixtures/ms8ch.opus (8 channels, family
   1) against tests/golden/ms8ch.npz, and opus_packets.bin CELT cases
   0, 1, 2 (mono), 3, 6, 7, 13 against their libopus PCM, all within
   1e-4;
3. serving phase (the main path at full size): K = 8 stereo streams of
   11,100 frames of 20 ms (3.7 min each), stream k cycling the packets
   of case (0, 1, 6, 7, 13)[k % 5] with a fresh decoder state; host
   decode, then run_synthesis_batched with f_chunk = 512 (22 steps of
   16 rows). The kernel is also held against its plain version on this
   real data. Checks: each stream's first cycle against libopus (1e-4),
   each full stream against the single-stream unified path (1e-6).
   Reports host-decode seconds, device seconds, the imdct/comb/deemph
   split (stage switches), the realtime factor, and from one
   torch.profiler run the device busy share and the top kernels.

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
    kernels.load("comb")
    log(f"phase 0: host library built in {t_host:.2f} s; kernel comb "
        f"{time.perf_counter() - t0:.2f} s")
    for name, rep in kernels.build_log.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    return card


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


def phase1_kernels(comb, dev):
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
    return {
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


def serving_streams():
    """K stereo streams of SERVE_FRAMES 20 ms frames, host-decoded with a
    fresh state each. Returns (per-stream raw arrays, host seconds)."""
    from libnyquist_torch.formats.opus import decode_celt_raw
    from libnyquist_torch.formats.opus.packet import parse_packet

    cases = {i: read_case(i) for i in SERVE_CASES}
    streams, host_s = [], 0.0
    for k in range(K_STREAMS):
        ch, pkts, _ = cases[SERVE_CASES[k % len(SERVE_CASES)]]
        check(ch == 2, "serving cases must be stereo")
        fpp = len(parse_packet(pkts[0]).frames)          # frames per packet
        n_pk = -(-SERVE_FRAMES // fpp)
        cyc = (pkts * -(-n_pk // len(pkts)))[:n_pk]
        t0 = time.perf_counter()
        freq, fsz, _, sb, pfp, pfg, pft, _ = decode_celt_raw(cyc, ch)
        host_s += time.perf_counter() - t0
        F = SERVE_FRAMES
        check(bool((fsz[:F] == 960).all()), "serving frames must be 20 ms")
        streams.append((np.ascontiguousarray(freq[:F, :ch]), sb[:F],
                        pfp[:F], pfg[:F], pft[:F]))
    return streams, host_s


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


def phase3_serving(comb, serving, dev, kernel_row, card):
    log(f"phase 3: serving K={K_STREAMS} stereo streams x {SERVE_FRAMES} "
        f"frames (main path)")
    streams, host_s = serving_streams()
    K, CC, F, N = K_STREAMS, 2, SERVE_FRAMES, 960
    n_steps = -(-F // F_CHUNK)
    synth = serving.synth_from_numpy(serving.synth_tables(
        [s[1:] for s in streams], N, n_steps, F_CHUNK), dev)
    spec_h = np.stack([s[0][:, c] for c in range(CC) for s in streams])
    spec = torch.from_numpy(spec_h).to(dev)              # [R, F, N] c*K+k
    del spec_h
    audio_s = K * F * N / 48000.0
    log(f"  host decode: {host_s:.2f} s for {audio_s:.1f} s of audio "
        f"({spec.numel() * 4 / 1e9:.2f} GB of spectra; host of {card})")

    # the kernel against its plain version on real decode data: step 1's
    # comb inputs, with the history step 0 left behind
    mode_ov, short = 120, 120
    R = K * CC
    zeros = dict(tails=torch.zeros(R, mode_ov, device=dev),
                 hist=torch.zeros(R, 1026, device=dev),
                 mem=torch.zeros(R, device=dev))

    def rows(name, step):
        v = synth[name][:, step]
        return v.repeat((CC,) + (1,) * (v.dim() - 1))

    def step_args(step):
        return (spec[:, step * F_CHUNK : (step + 1) * F_CHUNK],
                rows("msk", step), rows("TA", step), rows("gA", step),
                rows("TB1", step), rows("gB1", step), synth["fade"],
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

    # the main path: counts to 0 just before, read just after
    comb.comb_filter_cuda.launches = 0
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    acc, pcm = serving.run_synthesis_batched(spec, synth, K, CC, n_steps,
                                             F_CHUNK)
    ev1.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    dev_s = ev0.elapsed_time(ev1) / 1e3
    launches = comb.comb_filter_cuda.launches
    check(launches > 0, "the main path launched no comb kernel")
    kernel_row["launches"] = launches
    check(tuple(acc.shape) == (K, CC) and bool(torch.isfinite(acc).all()),
          "acc shape / finiteness")
    check(tuple(pcm.shape) == (R, F * N) and bool(torch.isfinite(pcm).all()),
          "pcm shape / finiteness")
    log(f"  main path: {n_steps} steps, comb launches {launches}, device "
        f"{dev_s:.3f} s (wall {wall_s:.3f} s), realtime x"
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

    # stage split by the stage switches (cumulative variants)
    def run(with_comb, with_deemph):
        serving.run_synthesis_batched(spec, synth, K, CC, n_steps, F_CHUNK,
                                      with_comb=with_comb,
                                      with_deemph=with_deemph)

    t_imdct = cuda_ms(lambda: run(False, False), reps=3)
    t_comb = cuda_ms(lambda: run(True, False), reps=3)
    t_full = cuda_ms(lambda: run(True, True), reps=3)
    split = {"imdct_ms": t_imdct, "comb_ms": t_comb - t_imdct,
             "deemph_ms": t_full - t_comb, "full_ms": t_full}
    log("  stage split (median of 3, per batch): " + ", ".join(
        f"{k} {v:.1f}" for k, v in split.items()) + f" on {card}")
    # one traced run of the main path: device busy time by kernel name
    trace = profile_main_path(lambda: run(True, True), card)
    # every stream against the single-stream unified path on the card
    worst = 0.0
    for k, (freq, sb, pfp, pfg, pft) in enumerate(streams):
        one = serving.synthesize_streams_unified(
            freq, sb, pfp, pfg, pft, CC, f_chunk=F_CHUNK, device=dev)
        worst = max(worst, (one.T - pcm[k::K]).abs().max().item())
    log(f"  batched vs single-stream: max|d| {worst:.3e}")
    check(worst < 1e-6, f"batched vs single max err {worst}")

    return {"K": K, "frames": F, "audio_s": audio_s, "host_decode_s": host_s,
            "device_s": dev_s, "wall_s": wall_s,
            "realtime_x": audio_s / dev_s,
            "realtime_x_full_median": audio_s / (t_full / 1e3),
            "comb_launches": launches, "batched_vs_single": worst,
            **split, **trace}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(ROOT))
    import libnyquist_torch as nqt
    from libnyquist_torch import kernels
    from libnyquist_torch.device import resolve_device
    from libnyquist_torch.ops import comb
    from libnyquist_torch.runtime import native, serving

    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    card = phase0_build(native, kernels)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    kernel_row = phase1_kernels(comb, dev)
    phase2_load(nqt, comb, dev)
    serve = phase3_serving(comb, serving, dev, kernel_row, card)
    log(json.dumps({"serving": serve, "card": card}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": [kernel_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
