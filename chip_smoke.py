#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (libnyquist_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME, default /usr/local/cuda) and cc;
builds everything it runs from this checkout. Phases, in order; any
failure exits non-zero before the result line:

0. card name and power limit (nvidia-smi); build the native host
   libraries (CELT, and the codecs: MP3, Musepack, Vorbis, FLAC,
   WavPack), the CUDA kernels (csrc/comb.cu, csrc/rot.cu) and the
   shared-memory probe (tools/smem_round_trip.cu), one nvcc each, all
   started together; the host half of the serving batch: K = 8
   stereo streams of 11,100 frames of 20 ms (3.7 min each), stream k
   cycling the packets of case (0, 1, 6, 7, 13)[k % 5] with a fresh
   decoder state, once as the bits-only trace + replay arrays (the main
   path) and once as the full native decode (the comparison); from the
   batch's real tables, what the kernels have to live with: the
   postfilter's lag and zero-gain statistics and its step plan, the
   rotation's markers, sub-segment lengths and Givens steps per row;
1. kernel phase: every kernel against its plain PyTorch version on the
   card, times by CUDA events. K1 (comb) at the reference tests' shapes
   and at the serving shape (16 rows x 40,960 chunks) on random inputs
   (a fresh lag per chunk, the hardest case for wide steps); with every
   lag 15 (every step one chunk), with all gains zero, on the serving
   batch's real per-frame tables, and at a row count that is not 16;
   the steps each launch took against the plain step plan; timed on
   wide steps and, with every lag 15, on steps of one chunk, beside the
   chain bound from the measured shared-memory round trip of a block of
   the kernel's size. K2 (rotation) through the
   row-major entry on a seeded plane with eight sigma classes, on a
   plane where later markers cut sub-segments short and rows have no
   marker, and at the serving shape [22,200 x 960] on the real markers
   and values of stream 0 (captured from its replay), none of which
   rotates before the first column of its sigma class;
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
   kernels;
4. MP3 phase: K = 8 stereo Layer III streams of 3.7 min (about 17,000
   granules each) written by tools/l3_stream.py from distinct seeds; the
   host half (the native whole-stream entropy decode) timed on one core,
   the device half (ops/mp3_synth.py Mp3Synth over [8, G, 2, 576])
   timed by CUDA events; stream 0's first 2,048 granules against a
   float64 NumPy evaluation of the same maps (1e-4 of max(|ref|, 1)),
   batched against single-stream (1e-6), load() of the five Layer I/II
   fixtures against their minimp3 goldens (1e-4) and of a 2 s generated
   Layer III stream on the card against the CPU (1e-5);
5. Musepack phase: load() of tests/fixtures/sv7_stereo.mpc against its
   libmpcdec golden (1e-4), the host decode timed; the serving
   synthesis (runtime.serving.synthesize_mpc_streams, float32) on the
   fixture's requantized rows cycled to 3.7 min for 8 stereo streams
   with staggered start frames ([16, 305,928, 32]), row 0 against the
   float64 plain synthesis (1e-4 of max(|ref|, 1)) and batched against
   single (1e-6).
6. Vorbis phase: K = 8 stereo floor-1 streams of 3.7 min at 44.1 kHz,
   blocksizes 256/2048, written by tools/vorbis_stream.py from seeds
   200-207 with one block-size sequence (one lap plan); the host half
   (the native whole-stream entropy decode) timed on one core, the device
   half (runtime.serving.synthesize_vorbis_streams_mixed on [16, F, 1024],
   F about 10,000 packets) timed by CUDA events; row 0 against a float64
   NumPy evaluation of the same plan (1e-4 of max(|ref|, 1)), batched
   against single-stream (1e-6), load() of tests/fixtures/floor0_mono8k.ogg
   against its libvorbis golden (1e-3) and of a 2 s writer stream on the
   card against the CPU (1e-5);
7. PCM phase: WAV u8/s16/s24/s32/f32/f64 stereo at 44.1 kHz, s24 at
   96 kHz, a WAV IMA-ADPCM file (block align 2,048, stereo), AIFC ima4,
   ulaw and sowt and a big-endian CAF, 3.7 min each, written here with
   struct from seeded bytes: load() on the card against the CPU (exactly
   equal, the float formats reported), the first 64 ADPCM blocks against
   a scalar IMA decoder; per file the load() wall time, the host-to-device
   copy and the device conversion or scan by CUDA events beside its byte
   bound.
8. FLAC and WavPack phase: K = 8 stereo FLAC streams of 3.7 min at
   44.1 kHz, four 16-bit and four 24-bit, written by tools/flac_stream.py
   in 8 worker processes, and K = 8 WavPack streams of 3.7 min written
   by tools/wv_stream.py (int16 joint stereo, int24, float32 with the wvx
   side stream, int32 info; two each); the host half of each format
   (formats/flac.py and formats/wavpack.py decode_host) timed on one
   core; per stream the device tail on the card against the CPU and
   load() on the card against both, bit for bit (FLAC also against the
   writer's samples); the Ogg FLAC fixture and the six WavPack fixtures
   on the card against their goldens, exactly; the upload (host clock)
   and the device tails (ops/lossless.py scale_int, normalize_float_bits,
   dsd_decimate on the DSD fixtures and on 3.7 min of DSD64 cycled from
   one) by CUDA events beside their byte bounds.
Phases 4 to 6 print host seconds and host audio-seconds per second,
device seconds and the device realtime factor, and the bounds reckoned
from the shapes (float ops at the card's float32 peak outside the tensor
cores, bytes at its memory rate). Their paths and phase 7's reach no
hand-written kernel.

The kernel counts are set to 0 just before the main path runs and read
just after; a kernel of the path with no launch there fails the run.
Output: the card line, one {"kernels": [...]} JSON line, and as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import pathlib
import statistics
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
ROT_SERVE_SHAPE = (22200, 800)    # 2F rows of one stream, WB positions
KERNELS = ("comb", "rot")
L3_SECONDS = 222.0                # 3.7 min a stream, as the Opus batch
MP3_REF_GRANULES = 2048
L12_FIXTURES = ("l2_stereo_44k", "l2_joint_44k", "l2_mono_44k_56k",
                "l1_stereo_44k", "l2_mpeg2_22k")
MPC_FRAMES = 8498                 # 3.7 min of 1,152-sample frames at 44.1 kHz
VORBIS_SECONDS = 222.0            # 3.7 min a stream, as the other batches
VORBIS_BLOCK_SEED = 5             # one block-size sequence for the batch
PCM_SECONDS = 222.0
LOSSLESS_SECONDS = 222.0          # phase 8's writer streams, 3.7 min each
FLAC_BPS = (16, 16, 16, 16, 24, 24, 24, 24)
WV_KINDS = ("int16_joint", "int24", "float32_wvx", "int32_info")
WV_FIXTURES = ("hybrid_mono", "hybrid_shape", "hybrid_stereo", "dsd_fast",
               "dsd_high", "dsd_raw")
ADPCM_BLOCK = 2048                # WAV IMA-ADPCM block align, stereo
PROBE_SRC = ROOT / "tools" / "smem_round_trip.cu"
COMB_THREADS = 128                # threads of one row's block in csrc/comb.cu


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


def build_probe(kernels):
    """The shared-memory round-trip probe, built beside the kernels;
    returns its bound launch function."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / "libsmem_round_trip.so"
    cmd = [kernels.nvcc_path(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(PROBE_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"nvcc failed for {PROBE_SRC.name}:\n"
          f"{proc.stdout}\n{proc.stderr}")
    launch = ctypes.CDLL(str(out)).smem_round_trip_launch
    launch.restype = ctypes.c_int
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
    return launch


def phase0_build(nqt_native, kernels):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    t0 = time.perf_counter()
    nqt_native.lib()
    nqt_native.codec_lib()
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        probe = pool.submit(build_probe, kernels)
        kernels.build_all(KERNELS)
        probe = probe.result()
    for name in KERNELS:
        kernels.load(name)
    log(f"phase 0: host libraries built in {t_host:.2f} s; kernels "
        f"{', '.join(KERNELS)} and the probe in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, rep in kernels.build_log.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    return card, probe


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


def comb_table_stats(synth, K, n_steps):
    """What wide steps can buy on the batch's real postfilter tables
    (host side, counts only): lags of the chunks that filter at all, the
    share of chunks and of frames whose gains are all zero, the longest
    legal step at each chunk and the step plan's length per launch."""
    from libnyquist_torch.ops import comb
    from libnyquist_torch.runtime import serving

    names = ("TA", "gA", "TB1", "gB1")
    tabs = {k: torch.from_numpy(np.ascontiguousarray(synth[k])) for k in names}
    fade = torch.from_numpy(synth["fade"])
    active_f = ((tabs["gA"] != 0).any(-1) | (tabs["gB1"] != 0).any(-1))
    edges = [15, 26, 38, 50, 62, 74, 86, 98, 200, 400, 1025]
    lag_hist = np.zeros(len(edges) - 1, np.int64)
    width_hist = np.zeros(comb.MAX_STEP + 1, np.int64)
    chunks = active = steps = 0
    slowest = []
    for step in range(n_steps):
        T0, T1, g0, g1, _ = serving.expand_comb_params(
            tabs["TA"][:, step].int(), tabs["gA"][:, step],
            tabs["TB1"][:, step].int(), tabs["gB1"][:, step], fade, 960, 120)
        act = (g0 != 0).any(-1) | (g1 != 0).any(-1)
        chunks += act.numel()
        active += int(act.sum())
        lag_hist += np.histogram(torch.minimum(T0, T1)[act].numpy(),
                                 edges)[0]
        width_hist += np.bincount(
            comb.comb_step_widths(T0, T1, g0, g1).numpy().ravel(),
            minlength=comb.MAX_STEP + 1)
        count = [len(p) for p in comb.comb_step_plan(T0, T1, g0, g1)]
        steps += sum(count)
        slowest.append(max(count))
    log(f"  comb tables of the batch ({K} streams, {n_steps} launches, "
        f"{chunks} chunks of 12): chunks with all six gains zero "
        f"{1 - active / chunks:.4f}, frames with all gains zero "
        f"{1 - active_f.float().mean().item():.4f} (the padding of the "
        f"last launch included)")
    log("  min(T0, T1) over filtering chunks, bins "
        + ", ".join(f"{a}-{b - 1}: {n}" for a, b, n in
                    zip(edges, edges[1:], lag_hist)))
    log("  longest legal step at each chunk (chunks: count) "
        + ", ".join(f"{m}: {n}" for m, n in enumerate(width_hist) if m)
        + f"; plan {steps} steps, mean width {chunks / steps:.3f} chunks; "
        f"slowest row per launch {min(slowest)}..{max(slowest)} steps")
    return {"zero_gain_chunk_share": 1 - active / chunks,
            "plan_steps": steps, "mean_step_chunks": chunks / steps,
            "slowest_row_steps": slowest}


def rot_marker_stats(traces):
    """The load balance the rotation kernel has to live with, per
    stream, from the compact markers (host side, counts only)."""
    out = []
    for k, (_, arrs, key) in enumerate(traces):
        F2 = 2 * key[0]
        keep = arrs["rot_rows"] < F2
        rows, pk, th = (arrs[n][keep] for n in ("rot_rows", "rot_pk",
                                                "rot_th"))
        ln, sg = (pk >> 4) & 0x1FF, (pk & 15) - 1
        rotating = th > 0
        steps = np.where(rotating, np.maximum(ln - 1, 0)
                         + np.maximum(ln - 2, 0)
                         + np.where(sg > 0, np.maximum(ln - sg, 0)
                                    + np.maximum(ln - 2 * sg, 0), 0), 0)
        per_row = np.bincount(rows, weights=steps, minlength=F2)
        per_row_m = np.bincount(rows, minlength=F2)
        lens, counts = np.unique(ln[rotating], return_counts=True)
        out.append({"markers": int(keep.sum()),
                    "rotating": int(rotating.sum()),
                    "steps_per_row_mean": float(per_row.mean()),
                    "steps_per_row_max": float(per_row.max())})
        log(f"  rot markers, stream {k}: {keep.sum()} markers "
            f"({per_row_m.mean():.1f} a row, max {per_row_m.max()}), "
            f"{rotating.sum()} rotating sub-segments, lengths "
            + " ".join(f"{a}:{b}" for a, b in zip(lens, counts))
            + f"; Givens steps a row mean {per_row.mean():.1f} max "
            f"{per_row.max():.0f}, longest sub-segment {steps.max()} steps")
    return out


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


def real_table_comb_args(synth, step, K, CC, n, seed, dev):
    """Comb inputs on the serving batch's real per-frame tables: launch
    `step`'s lags and gains for the K*CC rows, expanded per chunk as the
    main path expands them and cut to the first n chunks; x and the
    history random at PCM scale."""
    from libnyquist_torch.runtime import serving

    def rows_of(name):
        v = synth[name][:, step]
        return v.repeat((CC,) + (1,) * (v.dim() - 1))

    T0, T1, g0, g1, fade = (t[:, :n].contiguous()
                            for t in serving.expand_comb_params(
        rows_of("TA"), rows_of("gA"), rows_of("TB1"), rows_of("gB1"),
        synth["fade"], 960, 120))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K * CC, 12 * n)).astype(np.float32) * 3000
    h = rng.standard_normal((K * CC, 1026)).astype(np.float32) * 3000
    return [torch.from_numpy(x).to(dev), torch.from_numpy(h).to(dev),
            T0, T1, g0, g1, fade]


def compare_comb(comb, args, label, tol=1e-5):
    """The kernel against its plain version on one set of inputs, and
    the steps its chains took against the plain step plan. Returns (abs
    err, rel err, steps per row as the kernel counted them)."""
    taken = torch.zeros(args[0].shape[0], dtype=torch.int64,
                        device=args[0].device)
    y_k, h_k = comb.comb_filter_cuda(*args, step_counts=taken)
    y_r, h_r = comb.comb_filter_stream_ref(*args)
    torch.cuda.synchronize()
    ae, re = rel_err(y_k, y_r)
    he, hre = rel_err(h_k, h_r)
    check(bool(torch.isfinite(y_k).all()), f"comb {label}: non-finite")
    check(re <= tol and hre <= tol,
          f"comb {label}: rel err {re:.3e} / hist {hre:.3e} > {tol}")
    plan = np.array([len(p) for p in comb.comb_step_plan(
        *(a.cpu() for a in args[2:6]))])
    taken = taken.cpu().numpy()
    check(np.array_equal(taken, plan),
          f"comb {label}: the kernel took {taken.tolist()} steps, the "
          f"plain plan has {plan.tolist()}")
    log(f"  comb {label}: max|d| {ae:.3e}, max|d|/max|ref| {re:.3e}; "
        f"{int(taken.sum())} steps as planned, mean width "
        f"{args[2].numel() / taken.sum():.3f} chunks")
    return ae, re, taken


def rot_work(W: int, nmax: int, R: int, markers: int, ops_done: int):
    """(bytes, flops) the rotation needs: x [R, nmax] read once and y
    [R, nmax] written once (the columns past W pass through), the marker
    plane pk [R, W] read once, theta and gain (4 bytes each) read at the
    markers only; six float ops per Givens step these markers need plus
    one gain product per value."""
    return 4 * (2 * nmax + W) * R + 8 * markers, 6 * ops_done + W * R


def random_rot_args(R, seed, dev):
    """A seeded row-major plane [R, 800] with its dense marker planes:
    per row and band a rotating leaf, a plain leaf, a leaf that ends at
    half the band, or nothing. Eight sigma classes."""
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
    planes = [torch.from_numpy(np.ascontiguousarray(a.T)).to(dev)
              for a in (x, pk, th, g)]
    return planes + [tuple(sorted(sigmas)), band_off]


def edge_rot_args(dev, copies=25, tail=160):
    """Row-major planes [4 * copies, 800 + tail] of edge cases: markers
    whose sub-segment a later marker cuts short (one of them rotating), a
    zero-length sub-segment, one that runs past the last position, a
    marker in the last column, sub-segments of 2 and 3 values, and a row
    with no marker. The row count is no multiple of the kernel's rows
    per block, and x is wider than the marker planes."""
    from libnyquist_torch.formats.opus.celt_tables import mode48000

    mode = mode48000()
    band_off = [8 * int(e) for e in mode.eBands[: mode.nbEBands + 1]]
    W = band_off[-1]
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, (4, W + tail)).astype(np.float32)
    pk = np.full((4, W), -1, np.int32)
    th = np.zeros((4, W), np.float32)
    g = np.zeros((4, W), np.float32)

    def mark(r, col, ln, lag, theta, gain):
        pk[r, col] = (col << 13) | (ln << 4) | lag
        th[r, col], g[r, col] = theta, gain

    mark(0, 0, 32, 1 + 3, 0.31, 0.5)        # cut short at column 20
    mark(0, 20, 16, 1, 0.0, 0.25)
    mark(0, 36, 0, 1 + 3, 0.2, 9.0)         # zero length
    mark(0, 200, 24, 1 + 4, 0.12, 0.75)     # cut short by a rotating one
    mark(0, 212, 48, 1 + 4, 0.4, 0.6)
    mark(1, 700, 176, 1 + 9, 0.27, 0.8)     # runs past W
    mark(2, W - 1, 8, 1, 0.3, 0.5)          # last column
    mark(2, 100, 3, 1, 0.45, 2.0)
    mark(2, 110, 2, 1, 0.45, 2.0)
    planes = [torch.from_numpy(np.tile(a, (copies, 1))).to(dev)
              for a in (x, pk, th, g)]
    return planes + [(3, 4, 9), band_off]


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


def compare_rot(rot, args, label, tol=1e-5, must_move=True):
    """The kernel, through its row-major entry, against the plain
    (position-major) version on one set of planes; the columns past the
    marker planes must come back as they went in. Returns (abs err, rel
    err, plain ms of that one run)."""
    x, pk, th, g, sigmas, band_off = args
    W = pk.shape[1]
    y_k = rot.rotate_plane(*args)
    ref_in = [t.t().contiguous() for t in (x[:, :W], pk, th, g)]
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    y_r = rot.rotate_plane_ref(*ref_in, sigmas, band_off)
    b.record()
    torch.cuda.synchronize()
    ae, re = rel_err(y_k[:, :W], y_r.t())
    check(tuple(y_k.shape) == tuple(x.shape), f"rot {label}: output shape")
    check(bool(torch.isfinite(y_k).all()), f"rot {label}: non-finite")
    check(bool(torch.equal(y_k[:, W:], x[:, W:])),
          f"rot {label}: the columns past W changed")
    moved = (y_r.t() - x[:, :W]).abs().max().item()
    check(moved > 0 or not must_move,
          f"rot {label}: the plain version changed nothing")
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


def round_trip(probe, dev, threads, iters=2_000_000):
    """(cycles of one shared-memory round trip of a block of `threads`
    threads, SM clock in MHz while the probe ran): the probe's own cycle
    count over its CUDA-event time."""
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(n):
        rc = probe(out.data_ptr(), n, threads, stream)
        check(rc == 0, f"round trip probe launch failed: CUDA error {rc}")

    run(1000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run(iters)
    b.record()
    b.synchronize()
    cycles = out[0].item()
    return cycles / iters, cycles / (a.elapsed_time(b) * 1e3)


def check_sigma_first_columns(rot, pk, th, sigmas, band_off, label):
    """The one place where the kernel and the plain version part: the
    plain version starts a sigma class's sweeps at the first column the
    class can occur in (the first band wide enough for it), the kernel
    does not look. On these markers they are the same function only if
    no rotating marker lies before its class's first column."""
    m = (pk >= 0) & (th > 0)
    col = torch.arange(pk.shape[1], device=pk.device).expand_as(pk)[m]
    sg = (pk[m] & 15) - 1
    for s in sigmas:
        lo = rot._sigma_lo_col(s, band_off)
        sel = sg == s
        check(not bool(sel.any()) or int(col[sel].min()) >= lo,
              f"rot {label}: a marker of sigma class {s} rotates before "
              f"column {lo}")
    check(bool(torch.isin(sg[sg > 0], torch.tensor(
        list(sigmas), device=pk.device)).all()),
        f"rot {label}: a rotating marker outside the classes {sigmas}")


def phase1_kernels(comb, rot, probe, trace0, synth, dev):
    log("phase 1: kernels against their plain versions on the card")
    K, CC = K_STREAMS, 2
    for B, n in ((4, 140), (8, 257)):       # the reference kernel test
        compare_comb(comb, random_comb_args(B, n, B * 1000 + n, dev, False),
                     f"B={B} n={n}")
    # a row count that is not 16, a ragged last tile
    compare_comb(comb, random_comb_args(5, 1000, 77, dev, True),
                 "B=5 n=1000 random")
    n_small = 4096
    args = random_comb_args(16, n_small, 15, dev, True)
    args[2].fill_(15)
    args[3].fill_(15)
    _, _, taken = compare_comb(comb, args, f"B=16 n={n_small} every lag 15")
    check(int(taken.min()) == n_small, "lag 15 must force one-chunk steps")
    args = random_comb_args(16, n_small, 16, dev, True)
    args[4].zero_()
    args[5].zero_()
    compare_comb(comb, args, f"B=16 n={n_small} all gains zero")
    check(bool(torch.equal(comb.comb_filter_cuda(*args)[0], args[0])),
          "all gains zero must give y = x")
    args = real_table_comb_args(synth, 1, K, CC, n_small, 17, dev)
    compare_comb(comb, args, f"B={K * CC} n={n_small} real per-frame tables")

    B, n = COMB_SERVE_SHAPE
    rt_cycles, sm_mhz = round_trip(probe, dev, COMB_THREADS)
    warp_cycles, _ = round_trip(probe, dev, 32)
    log(f"  shared-memory round trip of a block of {COMB_THREADS} threads, "
        f"as the comb kernel's (store, __syncthreads, load from another "
        f"warp, add): {rt_cycles:.1f} cycles at {sm_mhz:.0f} MHz; of one "
        f"warp {warp_cycles:.1f} cycles")

    def chain_ms(steps):          # the slowest row's chain, one trip a step
        return int(steps.max()) * rt_cycles / (sm_mhz * 1e3)

    args = random_comb_args(B, n, 2024, dev, True)
    ae, re, taken = compare_comb(comb, args,
                                 f"serving shape B={B} n={n} random")
    k_ms = cuda_ms(lambda: comb.comb_filter_cuda(*args), reps=7)
    p_ms = cuda_ms(lambda: comb.comb_filter_stream_ref(*args), reps=1,
                   warmup=0)          # one run: the comparison warmed it up
    # the same work in steps of one chunk: every lag 15
    args[2].fill_(15)
    args[3].fill_(15)
    k1_ms = cuda_ms(lambda: comb.comb_filter_cuda(*args), reps=5)
    del args
    real = real_table_comb_args(synth, 1, K, CC, n, 18, dev)
    taken_real = torch.zeros(B, dtype=torch.int64, device=dev)
    comb.comb_filter_cuda(*real, step_counts=taken_real)
    taken_real = taken_real.cpu().numpy()
    kr_ms = cuda_ms(lambda: comb.comb_filter_cuda(*real), reps=7)
    del real
    nbytes, flops = comb_work(B, n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    log(f"  comb serving shape, random inputs: kernel {k_ms:.3f} ms "
        f"({int(taken.max())} steps in the slowest row, chain bound "
        f"{chain_ms(taken):.3f} ms), with every lag 15 (steps of one chunk) "
        f"{k1_ms:.3f} ms (chain bound "
        f"{n * rt_cycles / (sm_mhz * 1e3):.3f} ms), plain "
        f"{p_ms:.1f} ms, byte bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    log(f"  comb serving shape, real per-frame tables: kernel {kr_ms:.3f} "
        f"ms ({int(taken_real.max())} steps in the slowest row, mean width "
        f"{B * n / taken_real.sum():.3f} chunks, chain bound "
        f"{chain_ms(taken_real):.3f} ms)")
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
        "chain_bound_ms": chain_ms(taken),
        "ms_one_chunk_steps": k1_ms,
        "ms_real_tables": kr_ms,
        "chain_bound_real_tables_ms": chain_ms(taken_real),
        "slowest_row_steps": int(taken.max()),
        "slowest_row_steps_real_tables": int(taken_real.max()),
        "round_trip_cycles": rt_cycles,
        "round_trip_cycles_one_warp": warp_cycles,
        "sm_clock_mhz": sm_mhz,
    }

    rargs = random_rot_args(300, 7, dev)
    check(len(rargs[4]) >= 3, "seeded plane needs several sigma classes")
    compare_rot(rot, rargs, f"R=300 W=800 seeded, sigmas {rargs[4]}")
    rargs = edge_rot_args(dev)
    compare_rot(rot, rargs, f"R={rargs[0].shape[0]} cut-short, zero-length "
                f"and overlong sub-segments, rows without a marker, "
                f"nmax={rargs[0].shape[1]}")
    x, pk = rargs[0], rargs[1]
    y = rot.rotate_plane(*rargs)
    torch.cuda.synchronize()
    check(bool((pk[3] < 0).all()) and bool(torch.equal(y[3::4], x[3::4])),
          "rows without a marker must pass through")
    rargs = capture_rotation_inputs(trace0, dev)
    R, W = rargs[1].shape
    nmax = rargs[0].shape[1]
    check((R, W) == ROT_SERVE_SHAPE, f"rotation marker plane is {(R, W)}")
    check_sigma_first_columns(rot, rargs[1], rargs[2], rargs[4], rargs[5],
                              "real markers")
    ae, re, p_ms = compare_rot(
        rot, rargs, f"serving shape R={R} W={W} nmax={nmax} real markers, "
        f"sigmas {tuple(rargs[4])}")
    k_ms = cuda_ms(lambda: rot.rotate_plane_cuda(*rargs), reps=7)
    steps = rot_steps(rargs[1], rargs[2])
    markers = int((rargs[1] >= 0).sum().item())
    nbytes, flops = rot_work(W, nmax, R, markers, steps)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    log(f"  rot serving shape: kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms "
        f"(one run, all rows), bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB: x [R, {nmax}] in, y out, pk [R, {W}] in, "
        f"theta and gain at {markers} markers; {steps / 1e6:.2f} M Givens "
        f"steps, {flops / 1e9:.3f} GFLOP)")
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
        "shape": {"R": R, "W": W, "nmax": nmax, "sigmas": list(rargs[4])},
        "markers": markers,
        "bound_bytes": nbytes,
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
                   host, synth):
    from libnyquist_torch.ops import celt_replay

    log(f"phase 3: serving K={K_STREAMS} stereo streams x {SERVE_FRAMES} "
        f"frames from their host traces (main path)")
    K, CC, F, N = K_STREAMS, 2, SERVE_FRAMES, 960
    n_steps = -(-F // F_CHUNK)
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
    expected = {"comb_filter": n_steps, "rotate_plane": K}
    for row in rows:
        check(launches[row["name"]] == expected[row["name"]],
              f"the main path launched the {row['name']} kernel "
              f"{launches[row['name']]} times, expected "
              f"{expected[row['name']]}")
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


def mp3_flops_per_granule(nch: int) -> int:
    """Float ops of the MP3 synthesis per granule (all channels): the
    three QMF products of [576 nch] by [576 nch x 576 nch] and the
    kind-masked IMDCT, which evaluates all three kinds' A1 (18 x 18), A2
    (9 x 18) and B1 (18 x 9) on every band."""
    d = 576 * nch
    return 3 * 2 * d * d + 3 * 2 * (18 * 18 + 9 * 18 + 18 * 9) * 32 * nch


def load_tool(name: str):
    """A module of this checkout's tools/ by its path (tools/ is no
    package, and another ``tools`` on the path must not shadow it)."""
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rate_line(label, audio_s, host_s, dev_s, card):
    log(f"  {label}: {audio_s:.1f} s of audio; host {host_s:.3f} s on one "
        f"core = {audio_s / host_s:.1f} audio-s per s; device {dev_s * 1e3:.3f}"
        f" ms = realtime x{audio_s / dev_s:.1f} on {card}")


def phase4_mp3(nqt, card, dev):
    """The MP3 serving shape: K Layer III streams, host entropy decode on
    one core, then the batched device synthesis; checks against a float64
    evaluation of the same maps, single-stream runs and load()."""
    from libnyquist_torch.formats import mp3
    from libnyquist_torch.ops import mp3_synth
    from libnyquist_torch.runtime import serving

    make_l3_stream = load_tool("l3_stream").make_l3_stream
    K = K_STREAMS
    log(f"phase 4: MP3 Layer III, K={K} stereo streams x {L3_SECONDS:.0f} s")
    t0 = time.perf_counter()
    datas = [make_l3_stream(100 + k, L3_SECONDS) for k in range(K)]
    gen_s = time.perf_counter() - t0
    mp3.l3_stream_entropy(make_l3_stream(1, 0.2))    # tables set, warm
    t0 = time.perf_counter()
    ents = [mp3.l3_stream_entropy(d) for d in datas]
    host_s = time.perf_counter() - t0
    check(all(e[2:] == (2, 44100) for e in ents), "streams must be 44.1 kHz "
          "stereo")
    G = ents[0][0].shape[0]
    check(all(e[0].shape[0] == G for e in ents), "equal granule counts")
    X = np.stack([e[0] for e in ents])
    kinds = np.stack([e[1] for e in ents])
    del ents
    share = np.bincount(kinds.reshape(-1), minlength=3) / kinds.size
    log(f"  {K} streams written in {gen_s:.2f} s ({sum(map(len, datas)) / 1e6:.1f}"
        f" MB); G = {G} granules a stream; band kinds long / stop-window / "
        f"short {share[0]:.3f} / {share[1]:.3f} / {share[2]:.3f}")
    t0 = time.perf_counter()
    Xd = torch.from_numpy(X).to(dev)
    Kd = torch.from_numpy(kinds).to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    def synth(x, k):
        return serving.synthesize_mp3_streams(x, k, 2, dev)

    dev_ms = cuda_ms(lambda: synth(Xd, Kd), reps=5)
    pcm = synth(Xd, Kd)
    torch.cuda.synchronize()
    check(tuple(pcm.shape) == (K, G * 576, 2), f"pcm shape {tuple(pcm.shape)}")
    check(bool(torch.isfinite(pcm).all()), "mp3 pcm not finite")
    audio_s = K * G * 576 / 44100.0
    rate_line("MP3 batch", audio_s, host_s, dev_ms / 1e3, card)

    n0 = MP3_REF_GRANULES
    ref = mp3_synth.synth_granules_stream(
        mp3_synth.imdct_granules_stream(X[0, :n0], kinds[0, :n0], np.float64),
        18, 2, np.float64)
    got = pcm[0, : n0 * 576].double().cpu().numpy()
    err = float(np.abs(got - ref).max())
    scale = max(float(np.abs(ref).max()), 1.0)
    check(err <= 1e-4 * scale, f"mp3 stream 0 vs float64 maps: {err}")
    worst = 0.0
    for k in (0, K - 1):
        one = synth(Xd[k : k + 1], Kd[k : k + 1])[0]
        worst = max(worst, (one - pcm[k]).abs().max().item())
    bscale = max(pcm.abs().max().item(), 1.0)
    check(worst <= 1e-6 * bscale, f"mp3 batched vs single: {worst}")
    log(f"  stream 0, first {n0} granules vs float64 maps: max|d| {err:.3e} "
        f"(max|ref| {scale:.3f}); batched vs single: max|d| {worst:.3e}")
    del pcm, Xd, Kd

    flops = mp3_flops_per_granule(2) * K * G
    nbytes = X.nbytes + kinds.nbytes + K * G * 576 * 2 * 4
    t_ops = flops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  bound: {flops / 1e12:.3f} TFLOP at 67 TFLOP/s = {t_ops:.2f} ms, "
        f"{nbytes / 1e6:.1f} MB at 3.35 TB/s = {t_bytes:.3f} ms; device "
        f"{dev_ms:.2f} ms is {dev_ms / max(t_ops, t_bytes):.2f}x the bound")

    errs = {}
    for name in L12_FIXTURES:
        g = np.load(GOLDEN / f"{name}.npz")
        a = nqt.load(str(FIXTURES / f"{name}.mp3"), device=dev)
        check(a.channel_count == int(g["channels"])
              and a.sample_rate == int(g["rate"])
              and a.sample_count == int(g["count"]), f"{name} shape")
        errs[name] = float(np.abs(a.samples - g["full"]).max())
        check(errs[name] < 1e-4, f"{name} vs golden: {errs[name]}")
    log("  load() of the Layer I/II fixtures vs minimp3 goldens: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    data = make_l3_stream(7, 2.0)
    t0 = time.perf_counter()
    a = nqt.load(data, extension="mp3", device=dev)
    load_s = time.perf_counter() - t0
    b = nqt.load(data, extension="mp3", device="cpu")
    e = float(np.abs(a.samples - b.samples).max())
    check(a.sample_count == b.sample_count and e <= 1e-5,
          f"mp3 load on the card vs the CPU: {e}")
    log(f"  load() of a 2 s Layer III stream: card vs CPU max|d| {e:.3e} "
        f"({load_s:.3f} s on the card)")
    return {"K": K, "granules": G, "audio_s": audio_s, "gen_s": gen_s,
            "host_s": host_s, "host_x": audio_s / host_s,
            "upload_s": upload_s, "device_ms": dev_ms,
            "realtime_x": audio_s / (dev_ms / 1e3), "flops": flops,
            "bytes": nbytes, "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes,
            "vs_float64": err, "batched_vs_single": worst,
            "l12_vs_golden": errs, "l3_load_card_vs_cpu": e,
            "kind_share": share.tolist()}


def phase5_mpc(nqt, card, dev):
    """Musepack: load() against its golden, then the serving synthesis on
    the fixture's requantized rows cycled to 3.7 min a stream."""
    from libnyquist_torch.formats import musepack
    from libnyquist_torch.runtime import serving

    K = K_STREAMS
    log(f"phase 5: Musepack, load() and K={K} stereo streams x "
        f"{MPC_FRAMES} frames")
    path = FIXTURES / "sv7_stereo.mpc"
    data = path.read_bytes()
    g = np.load(GOLDEN / "mpc_sv7.npz")
    t0 = time.perf_counter()
    a = nqt.load(str(path), device=dev)
    load_s = time.perf_counter() - t0
    check(a.channel_count == 2 and a.sample_rate == int(g["rate"])
          and a.sample_count == int(g["count"]), "sv7 shape")
    err_g = float(np.abs(a.samples - g["full"]).max())
    check(err_g < 1e-4, f"sv7 vs golden: {err_g}")
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        Y, ch, rate = musepack.requantized_rows(data)
        host.append(time.perf_counter() - t0)
    host_s = statistics.median(host)
    F0 = Y.shape[1] // 36
    fix_s = a.sample_count / 2 / rate
    log(f"  sv7_stereo.mpc: max|d| vs libmpcdec golden {err_g:.3e}; load() "
        f"{load_s:.3f} s on the card; host decode (entropy + requantize, "
        f"{F0} frames, {fix_s:.3f} s of audio) {host_s * 1e3:.2f} ms = "
        f"{fix_s / host_s:.1f} audio-s per s on one core")
    Yf = Y.reshape(2, F0, 36, 32)
    ys = np.empty((2 * K, MPC_FRAMES * 36, 32), np.float32)
    for k in range(K):
        fr = (5 * k + np.arange(MPC_FRAMES)) % F0    # staggered starts
        ys[2 * k : 2 * k + 2] = Yf[:, fr].reshape(2, -1, 32)
    t0 = time.perf_counter()
    ysd = torch.from_numpy(ys).to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    dev_ms = cuda_ms(lambda: serving.synthesize_mpc_streams(ysd, dev), reps=5)
    out = serving.synthesize_mpc_streams(ysd, dev)
    torch.cuda.synchronize()
    T = MPC_FRAMES * 36
    check(tuple(out.shape) == (2 * K, T * 32), f"mpc out {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "mpc pcm not finite")
    audio_s = K * T * 32 / rate
    ref = musepack._synth_stream(ys[0].astype(np.float64)).reshape(-1)
    err = float(np.abs(out[0].double().cpu().numpy() - ref).max())
    scale = max(float(np.abs(ref).max()), 1.0)
    check(err <= 1e-4 * scale, f"mpc row 0 vs float64: {err}")
    one = serving.synthesize_mpc_streams(ysd[3:4], dev)[0]
    worst = (one - out[3]).abs().max().item()
    check(worst <= 1e-6 * max(out.abs().max().item(), 1.0),
          f"mpc batched vs single: {worst}")
    nbytes = ys.nbytes + out.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  Musepack batch: {audio_s:.1f} s of audio; device {dev_ms:.3f} ms"
        f" = realtime x{audio_s / (dev_ms / 1e3):.1f} on {card} (the host "
        f"half is the fixture's rate above)")
    log(f"  row 0 vs float64 plain synthesis: max|d| {err:.3e} (max|ref| "
        f"{scale:.3f}); batched vs single: max|d| {worst:.3e}; bound "
        f"{nbytes / 1e6:.1f} MB at 3.35 TB/s = {t_bytes:.3f} ms, device "
        f"{dev_ms:.3f} ms is {dev_ms / t_bytes:.1f}x the bound")
    return {"K": K, "rows": 2 * K, "T": T, "audio_s": audio_s,
            "fixture_s": fix_s, "host_fixture_s": host_s,
            "host_x": fix_s / host_s, "load_s": load_s,
            "upload_s": upload_s, "device_ms": dev_ms,
            "realtime_x": audio_s / (dev_ms / 1e3), "bytes": nbytes,
            "bound_bytes_ms": t_bytes, "vs_golden": err_g,
            "vs_float64": err, "batched_vs_single": worst}


def vorbis_plan_f64(specs_row: np.ndarray, plan: dict) -> np.ndarray:
    """One row's mixed-block synthesis in float64 NumPy: the same plan
    (products by the float64 IMDCT matrices, the lap windows, the two
    gathers), independent of the device code."""
    from libnyquist_torch.formats import vorbis

    F = specs_row.shape[0]
    nmax = plan["nmax"]
    ns = np.asarray(plan["ns"])
    tw = np.zeros((F, nmax))
    for n in sorted(set(plan["ns"])):
        sel = np.nonzero(ns == n)[0]
        tw[sel, :n] = specs_row[sel, : n // 2].astype(np.float64) @ \
            vorbis.imdct_matrix(n).T
    flat = (tw * plan["W"]).reshape(-1)
    ip, ic = plan["idx_prev"], plan["idx_cur"]
    return (np.where(ip >= 0, flat[np.maximum(ip, 0)], 0.0)
            + np.where(ic >= 0, flat[np.maximum(ic, 0)], 0.0))


def phase6_vorbis(nqt, card, dev):
    """The Vorbis serving shape: K floor-1 streams written by
    tools/vorbis_stream.py with one block-size sequence (one lap plan),
    host entropy decode on one core, then the batched device synthesis;
    checks against a float64 evaluation of the plan, single-stream runs
    and load()."""
    from libnyquist_torch.formats import vorbis
    from libnyquist_torch.runtime import serving

    make = load_tool("vorbis_stream").make_vorbis_stream
    K = K_STREAMS
    log(f"phase 6: Ogg Vorbis, K={K} stereo streams x {VORBIS_SECONDS:.0f} s"
        f" at 44.1 kHz, blocksizes 256/2048")
    t0 = time.perf_counter()
    datas = [make(200 + k, VORBIS_SECONDS, block_seed=VORBIS_BLOCK_SEED)
             for k in range(K)]
    gen_s = time.perf_counter() - t0

    def entropy(data):
        return vorbis._decode_stream_packets(
            vorbis._collect_stream_native(data))

    entropy(make(1, 0.2))            # library built, setup parsed
    t0 = time.perf_counter()
    ents = [entropy(d) for d in datas]
    host_s = time.perf_counter() - t0
    staged0, bss, ch, rate, _ = ents[0]
    check(ch == 2 and rate == 44100 and bss == (256, 2048),
          "streams must be 44.1 kHz stereo, blocksizes 256/2048")
    meta = [(n, bf, lp, ln) for (_s, n, bf, lp, ln, _nz) in staged0]
    for st, *_ in ents[1:]:
        check([(n, bf, lp, ln) for (_s, n, bf, lp, ln, _nz) in st] == meta,
              "the streams must share one block-size sequence")
    t0 = time.perf_counter()
    plan = serving.vorbis_lap_plan(meta, bss)
    specs = np.concatenate([vorbis.staged_specs(st, ch, plan["nmax"] // 2)
                            for st, *_ in ents])
    stage_s = time.perf_counter() - t0
    F, out_len = len(meta), plan["out_len"]
    n_long = sum(m[0] == 2048 for m in meta)
    log(f"  {K} streams written in {gen_s:.2f} s "
        f"({sum(map(len, datas)) / 1e6:.1f} MB); F = {F} packets a stream "
        f"({n_long} long, {F - n_long} short); lap plan and padded spectra "
        f"[{specs.shape[0]}, {F}, {specs.shape[2]}] in {stage_s:.2f} s")
    t0 = time.perf_counter()
    specs_d = torch.from_numpy(specs).to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serving._vorbis_plan_tensors(plan, dev)
    torch.cuda.synchronize()
    plan_upload_s = time.perf_counter() - t0

    def synth(x):
        return serving.synthesize_vorbis_streams_mixed(x, plan, dev)

    torch.cuda.reset_peak_memory_stats()
    dev_ms = cuda_ms(lambda: synth(specs_d), reps=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pcm = synth(specs_d)
    torch.cuda.synchronize()
    R = 2 * K
    check(tuple(pcm.shape) == (R, out_len), f"pcm {tuple(pcm.shape)}")
    check(bool(torch.isfinite(pcm).all()), "vorbis pcm not finite")
    audio_s = K * out_len / rate
    rate_line("Vorbis batch", audio_s, host_s, dev_ms / 1e3, card)

    ref = vorbis_plan_f64(specs[0], plan)
    err = float(np.abs(pcm[0].double().cpu().numpy() - ref).max())
    scale = max(float(np.abs(ref).max()), 1.0)
    check(err <= 1e-4 * scale, f"vorbis row 0 vs float64: {err}")
    worst = 0.0
    for k in (0, K - 1):
        one = synth(specs_d[2 * k : 2 * k + 2])
        worst = max(worst, (one - pcm[2 * k : 2 * k + 2]).abs().max().item())
    bscale = max(pcm.abs().max().item(), 1.0)
    check(worst <= 1e-6 * bscale, f"vorbis batched vs single: {worst}")
    log(f"  row 0 vs float64 evaluation of the plan: max|d| {err:.3e} "
        f"(max|ref| {scale:.3f}); batched vs single: max|d| {worst:.3e}; "
        f"peak device memory {peak_gb:.2f} GB")
    del pcm, one

    # the bounds, from the shapes: the products' float ops at the float32
    # rate; the function's bytes (spectra, windows, indices and masks in,
    # pcm out) at the memory rate; the plain path also writes and reads
    # the [R, F, 2048] windowed plane
    flops = 2 * R * sum(n * (n // 2) for n, *_ in meta)
    io_bytes = (specs.nbytes + plan["W"].nbytes + 2 * out_len * (8 + 4)
                + R * out_len * 4)
    plane = 2 * R * F * plan["nmax"] * 4
    t_ops = flops / FP32_FLOPS * 1e3
    t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  bound: {flops / 1e12:.3f} TFLOP at 67 TFLOP/s = {t_ops:.2f} ms, "
        f"{io_bytes / 1e9:.2f} GB in and out at 3.35 TB/s = {t_bytes:.3f} ms "
        f"(+ {plane / 1e9:.2f} GB of windowed plane written and read = "
        f"{plane / HBM_BYTES_PER_S * 1e3:.3f} ms); device {dev_ms:.2f} ms is "
        f"{dev_ms / max(t_ops, t_bytes):.2f}x the bound")
    del specs_d

    g = np.load(GOLDEN / "floor0_mono8k.npz")
    a = nqt.load(str(FIXTURES / "floor0_mono8k.ogg"), device=dev)
    check(a.channel_count == 1 and a.sample_rate == 8000
          and a.sample_count == int(g["count"]), "floor0 shape")
    err_g = float(np.abs(a.samples - g["full"]).max())
    check(err_g < 1e-3, f"floor0 vs golden: {err_g}")
    data = make(7, 2.0)
    t0 = time.perf_counter()
    a = nqt.load(data, extension="ogg", device=dev)
    load_s = time.perf_counter() - t0
    b = nqt.load(data, extension="ogg", device="cpu")
    e = float(np.abs(a.samples - b.samples).max())
    check(a.sample_count == b.sample_count and e <= 1e-5,
          f"vorbis load on the card vs the CPU: {e}")
    log(f"  load() of tests/fixtures/floor0_mono8k.ogg vs libvorbis golden: "
        f"max|d| {err_g:.3e}; of a 2 s writer stream: card vs CPU max|d| "
        f"{e:.3e} ({load_s:.3f} s on the card)")
    return {"K": K, "packets": F, "long_packets": n_long,
            "out_len": out_len, "audio_s": audio_s, "gen_s": gen_s,
            "host_s": host_s, "host_x": audio_s / host_s,
            "stage_s": stage_s, "upload_s": upload_s,
            "plan_upload_s": plan_upload_s, "device_ms": dev_ms,
            "realtime_x": audio_s / (dev_ms / 1e3), "flops": flops,
            "io_bytes": io_bytes, "plane_bytes": plane,
            "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes,
            "peak_gb": peak_gb, "vs_float64": err, "batched_vs_single": worst,
            "floor0_vs_golden": err_g, "load_card_vs_cpu": e}


# --------------------------------------------------------------------------
# phase 7: PCM containers written here with struct
# --------------------------------------------------------------------------
def wav_file(fmt_code, ch, rate, bits, payload, block_align=None, fact=None):
    """A RIFF/WAVE file around ``payload`` (fmt, optional fact, data)."""
    ba = block_align or ch * bits // 8
    body = b"WAVE" + b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_code, ch, rate, rate * ba, ba, bits)
    if fact is not None:
        body += b"fact" + struct.pack("<II", 4, fact)
    body += b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        body += b"\0"
    return b"RIFF" + struct.pack("<I", len(body)) + body


def aifc_file(comp, ch, bits, payload, frames, rate=44100):
    """An AIFF-C file: FORM AIFC, COMM with a compression type, SSND."""
    exp = rate.bit_length() - 1
    f80 = struct.pack(">HQ", 16383 + exp, rate << (63 - exp))
    comm = struct.pack(">hIh", ch, frames, bits) + f80 + comp + b"\0\0"
    body = b"AIFC" + b"COMM" + struct.pack(">I", len(comm)) + comm
    body += b"SSND" + struct.pack(">III", len(payload) + 8, 0, 0) + payload
    if len(payload) & 1:
        body += b"\0"
    return b"FORM" + struct.pack(">I", len(body)) + body


def caf_file(fid, flags, bpp, fpp, ch, bpc, payload, rate=44100.0):
    """A CAF file: caff header, desc, data (edit count, then samples)."""
    desc = struct.pack(">d4sIIIII", rate, fid, flags, bpp, fpp, ch, bpc)
    return (b"caff\x00\x01\x00\x00" + b"desc" + struct.pack(">q", len(desc))
            + desc + b"data" + struct.pack(">q", len(payload) + 4)
            + b"\0\0\0\0" + payload)


def scalar_ima(nibbles, pred, step):
    """The serial IMA decoder of the spec (reference WavDecoder.cpp:75-134),
    the predictor wrapping as a C int16."""
    from libnyquist_torch.ops.adpcm import IMA_INDEX_TABLE, IMA_STEP_TABLE

    out = np.empty(len(nibbles), np.int64)
    for i, nb in enumerate(nibbles):
        s = int(IMA_STEP_TABLE[step])
        diff = (s >> 3) + (s if nb & 4 else 0) + (s >> 1 if nb & 2 else 0) \
            + (s >> 2 if nb & 1 else 0)
        pred = ((pred - diff if nb & 8 else pred + diff) + 0x8000) % 65536 \
            - 0x8000
        step = min(max(step + int(IMA_INDEX_TABLE[nb]), 0), 88)
        out[i] = pred
    return out


def pcm_inputs(rng):
    """(name, file bytes, extension, device conversion on the uploaded
    raw payload, raw payload bytes, exact): 3.7 min of stereo each."""
    from libnyquist_torch.audio_data import PCMFormat as PF
    from libnyquist_torch.formats import aiff
    from libnyquist_torch.ops import adpcm, pcm

    frames = int(PCM_SECONDS * 44100)
    out = []

    def rand_bytes(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    for name, bits, code, fmt, dtype in (
            ("u8", 8, 1, PF.PCM_U8, torch.uint8),
            ("s16", 16, 1, PF.PCM_16, torch.int16),
            ("s24", 24, 1, PF.PCM_24, None),
            ("s32", 32, 1, PF.PCM_32, torch.int32),
            ("f32", 32, 3, PF.PCM_FLT, torch.float32),
            ("f64", 64, 3, PF.PCM_DBL, torch.float64)):
        if code == 3:
            payload = (rng.standard_normal(2 * frames) * 0.3).astype(
                f"<f{bits // 8}").tobytes()
        else:
            payload = rand_bytes(2 * frames * bits // 8)

        def conv(raw, fmt=fmt, dtype=dtype):
            return pcm.pcm_to_float32(
                raw.view(-1, 3) if dtype is None else raw.view(dtype), fmt)

        out.append((f"WAV {name}", wav_file(code, 2, 44100, bits, payload,
                                            fact=frames if code == 3 else None),
                    "wav", conv, payload, code != 3))
    f96 = int(PCM_SECONDS * 96000)
    payload = rand_bytes(2 * f96 * 3)
    out.append(("WAV s24 96 kHz", wav_file(1, 2, 96000, 24, payload), "wav",
                lambda raw: pcm.pcm_to_float32(raw.view(-1, 3), PF.PCM_24),
                payload, True))
    # IMA-ADPCM: block align 2,048 stereo, legal headers, seeded nibbles
    per_block = (ADPCM_BLOCK - 8) * 2 // 2
    n_blocks = -(-frames // per_block)
    blocks = rng.integers(0, 256, (n_blocks, ADPCM_BLOCK), dtype=np.uint8)
    hdr = blocks[:, :8].reshape(n_blocks, 2, 4)
    hdr[:, :, 2] = rng.integers(0, 89, (n_blocks, 2))
    hdr[:, :, 3] = 0
    payload = blocks.tobytes()

    def adpcm_conv(raw):
        nib, pr, st = adpcm.unpack_ima_blocks(raw, ADPCM_BLOCK, 2)
        return adpcm._finalize(adpcm.decode_ima_nibbles(nib, pr, st), 2)

    out.append(("WAV IMA-ADPCM", wav_file(0x11, 2, 44100, 4, payload,
                                          ADPCM_BLOCK, fact=frames),
                "wav", adpcm_conv, payload, True))
    groups = -(-frames // 64)
    payload = rand_bytes(groups * 2 * 34)

    def ima4_conv(raw):
        nib, pr, st = adpcm.unpack_ima4_packets(raw, 2)
        return adpcm._finalize(adpcm.decode_ima4_nibbles(nib, pr, st), 2)

    out.append(("AIFC ima4", aifc_file(b"ima4", 2, 16, payload, groups * 64),
                "aifc", ima4_conv, payload, True))
    payload = rand_bytes(2 * frames)
    out.append(("AIFC ulaw", aifc_file(b"ulaw", 2, 16, payload, frames),
                "aifc", aiff._ulaw_to_float, payload, True))
    payload = rand_bytes(4 * frames)
    out.append(("AIFC sowt", aifc_file(b"sowt", 2, 16, payload, frames),
                "aifc", lambda raw: pcm.pcm_to_float32(raw.view(torch.int16),
                                                       PF.PCM_16),
                payload, True))
    payload = rand_bytes(4 * frames)
    out.append(("CAF lpcm s16 BE", caf_file(b"lpcm", 0, 4, 1, 2, 16, payload),
                "caf", lambda raw: pcm.be_to_float32(raw, 16), payload, True))
    return out


def phase7_pcm(nqt, card, dev):
    """PCM, IMA-ADPCM and the Apple/RIFF containers at 3.7 min a file:
    load() on the card against the CPU, the host-to-device copy and the
    device conversion timed apart, beside its byte bound."""
    from libnyquist_torch.ops import pcm

    log(f"phase 7: PCM / ADPCM containers, {PCM_SECONDS:.0f} s of stereo a "
        f"file, load() on the card vs the CPU")
    rng = np.random.default_rng(700)
    t0 = time.perf_counter()
    inputs = pcm_inputs(rng)
    log(f"  {len(inputs)} files written in {time.perf_counter() - t0:.2f} s")
    rows = []
    for name, data, ext, conv, payload, exact in inputs:
        nqt.load(data, extension=ext, device=dev)       # warm
        t0 = time.perf_counter()
        a = nqt.load(data, extension=ext, device=dev)
        load_s = time.perf_counter() - t0
        b = nqt.load(data, extension=ext, device="cpu")
        check(a.sample_count == b.sample_count and a.sample_count > 0,
              f"{name}: sample counts {a.sample_count} / {b.sample_count}")
        d = float(np.abs(a.samples - b.samples).max())
        if exact:
            check(np.array_equal(a.samples, b.samples),
                  f"{name}: card and CPU differ (max|d| {d})")
        host = np.frombuffer(payload, np.uint8)
        torch.cuda.synchronize()
        h2d = []
        for _ in range(3):
            t0 = time.perf_counter()
            raw = pcm.host_to_device(host, dev)
            torch.cuda.synchronize()
            h2d.append(time.perf_counter() - t0)
        out = conv(raw)
        check(out.numel() >= a.sample_count
              and bool(torch.equal(out[: a.sample_count].cpu(),
                                   torch.from_numpy(a.samples))),
              f"{name}: the timed conversion is not load()'s")
        conv_ms = cuda_ms(lambda: conv(raw), reps=5)
        nbytes = host.nbytes + out.numel() * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        audio_s = a.sample_count / a.channel_count / a.sample_rate
        rows.append({"name": name, "MB": len(data) / 1e6,
                     "audio_s": audio_s, "load_s": load_s,
                     "h2d_ms": statistics.median(h2d) * 1e3,
                     "convert_ms": conv_ms, "bound_ms": bound,
                     "card_vs_cpu": d})
        log(f"  {name}: {len(data) / 1e6:.1f} MB, load() {load_s:.3f} s "
            f"(realtime x{audio_s / load_s:.0f}); copy to the card "
            f"{statistics.median(h2d) * 1e3:.2f} ms; device conversion "
            f"{conv_ms:.3f} ms, byte bound {bound:.3f} ms "
            f"({nbytes / 1e6:.0f} MB); card vs CPU max|d| {d:.1e}")
        del raw, out
        if name == "WAV IMA-ADPCM":
            per = (ADPCM_BLOCK - 8) // 2 * 2       # nibbles a channel
            nb = min(64, a.sample_count // (2 * per))
            blocks = host.reshape(-1, ADPCM_BLOCK)[:nb]
            got = a.samples[: nb * per * 2].reshape(nb, per, 2)
            for k, blk in enumerate(blocks):
                for c in range(2):
                    lo, hi = int(blk[4 * c]), int(blk[4 * c + 1])
                    pred = ((lo | (hi << 8)) ^ 0x8000) - 0x8000
                    words = blk[8:].reshape(-1, 2, 4)[:, c].reshape(-1)
                    nib = np.stack([words & 15, words >> 4], 1).reshape(-1)
                    ref = scalar_ima(nib, pred, int(blk[4 * c + 2]))
                    want = ref.astype(np.float32) * np.float32(1.0 / 32767.0)
                    check(np.array_equal(got[k, :, c], want),
                          f"ADPCM block {k} channel {c} vs the scalar decoder")
            log(f"  WAV IMA-ADPCM: the first {nb} blocks equal the scalar "
                f"IMA decoder")
    return rows


# --------------------------------------------------------------------------
# phase 8: FLAC and WavPack
# --------------------------------------------------------------------------
def _flac_stream(job):
    """One FLAC writer stream, (bytes, int samples); run in a worker."""
    seed, seconds, bps = job
    return load_tool("flac_stream").make_flac_stream(seed, seconds, bps=bps)


def bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal float32 arrays, compared as int32 (NaN payloads included)."""
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def tail_row(name, n, fn, nbytes, card):
    """One device-tail function timed by CUDA events beside its byte bound
    (each input read once, each output written once)."""
    ms = cuda_ms(fn, reps=5)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  {name}: {n} samples in {ms:.3f} ms by CUDA events; byte bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s), {ms / bound:.1f}x"
        f" on {card}")
    return {"name": name, "samples": n, "ms": ms, "bound_ms": bound,
            "bytes": nbytes}


def lossless_batch(nqt, label, datas, decode_host, device_tail, ext, dev,
                   card):
    """K streams of one format: the host half timed on one core, then per
    stream the device tail on the card against the CPU and load() on the
    card against both. Returns (host results, dict of the batch)."""
    t0 = time.perf_counter()
    hosts = [decode_host(d) for d in datas]
    host_s = time.perf_counter() - t0
    outs = []
    for d, h in zip(datas, hosts):
        card_out = device_tail(h, dev).cpu().numpy()
        check(bits_equal(card_out, device_tail(h, "cpu").numpy()),
              f"{label}: the device tail on the card and the CPU differ")
        a = nqt.load(d, extension=ext, device=dev)
        check(bits_equal(a.samples, card_out),
              f"{label}: load() on the card differs from its parts")
        outs.append(a)
    b = nqt.load(datas[0], extension=ext, device="cpu")
    check(bits_equal(outs[0].samples, b.samples),
          f"{label}: load() on the card and the CPU differ")
    audio_s = sum(a.sample_count / a.channel_count / a.sample_rate
                  for a in outs)
    log(f"  {label}: {len(datas)} streams, {audio_s:.1f} s of audio, "
        f"{sum(map(len, datas)) / 1e6:.1f} MB; host {host_s:.3f} s on one "
        f"core = {audio_s / host_s:.1f} audio-s per s; card equals the CPU")
    return hosts, {"K": len(datas), "audio_s": audio_s,
                   "MB": sum(map(len, datas)) / 1e6, "host_s": host_s,
                   "host_x": audio_s / host_s}


def upload_ms(arr, dev):
    """Median host-clock milliseconds of one copy of ``arr`` to the card."""
    from libnyquist_torch.ops.pcm import host_to_device

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_to_device(arr, dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase8_lossless(nqt, card, dev):
    """FLAC and WavPack: writer streams of 3.7 min (FLAC against the
    writer's samples), the fixtures against their goldens, the host half
    timed on one core, the upload and the device tails beside their byte
    bounds, every card result against the CPU bit for bit."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from libnyquist_torch.formats import flac, wavpack
    from libnyquist_torch.ops import lossless
    from libnyquist_torch.ops.pcm import host_to_device

    K = K_STREAMS
    t_phase = time.perf_counter()
    log(f"phase 8: FLAC and WavPack, K={K} stereo writer streams each x "
        f"{LOSSLESS_SECONDS:.0f} s at 44.1 kHz, and the fixtures")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            K, mp_context=multiprocessing.get_context("spawn")) as pool:
        flacs = list(pool.map(_flac_stream, [
            (800 + k, LOSSLESS_SECONDS, bps)
            for k, bps in enumerate(FLAC_BPS)]))
    fl_gen_s = time.perf_counter() - t0
    log(f"  {K} FLAC streams ({'/'.join(map(str, sorted(set(FLAC_BPS))))}-bit"
        f") written in {fl_gen_s:.2f} s by {K} processes")
    hosts, fl = lossless_batch(
        nqt, "FLAC", [d for d, _ in flacs], flac.decode_host,
        lambda h, d: flac.device_tail(h[0], h[1]["bps"], d), "flac", dev,
        card)
    fl["gen_s"] = fl_gen_s
    for (pcm, info), (_, want), bps in zip(hosts, flacs, FLAC_BPS):
        check(info["bps"] == bps and np.array_equal(pcm, want),
              "FLAC host decode vs the writer's samples")
    log("  FLAC: every stream's int32 samples equal the writer's")
    rows = []
    for k in (0, K - 1):
        pcm, info = hosts[k]
        flat = np.ascontiguousarray(pcm).reshape(-1)
        fl[f"upload_ms_{info['bps']}"] = upload_ms(flat, dev)
        x = host_to_device(flat, dev)
        rows.append(tail_row(f"scale_int FLAC {info['bps']}-bit", flat.size,
                             lambda: lossless.scale_int(x, info["bps"]),
                             flat.size * 8, card))
        del x
    log(f"  FLAC upload (host clock): {fl['upload_ms_16']:.2f} ms 16-bit, "
        f"{fl['upload_ms_24']:.2f} ms 24-bit a stream")
    del flacs, hosts

    g = np.load(GOLDEN / "KittyPurr8_Stereo_Dithered_flac.npz")
    a = nqt.load(str(FIXTURES / "kitty8_dithered.oga"), device=dev)
    check(a.sample_count == int(g["count"]) and np.array_equal(a.samples,
                                                              g["full"]),
          "Ogg FLAC fixture vs its golden")
    log("  Ogg FLAC: tests/fixtures/kitty8_dithered.oga equals its golden")

    fixtures = {}
    for name in WV_FIXTURES:
        g = np.load(GOLDEN / f"{name}_wv.npz")
        a = nqt.load(str(FIXTURES / f"{name}.wv"), device=dev)
        check(a.sample_count == int(g["count"])
              and a.sample_rate == int(g["rate"])
              and np.array_equal(a.samples, g["full"]),
              f"{name}.wv vs its golden")
        fixtures[name] = a.sample_count
    log(f"  WavPack fixtures equal their goldens: {', '.join(WV_FIXTURES)}")

    make_wv = load_tool("wv_stream").make_wv_stream
    t0 = time.perf_counter()
    wvs = [make_wv(900 + k, LOSSLESS_SECONDS, WV_KINDS[k % len(WV_KINDS)])
           for k in range(K)]
    log(f"  {K} WavPack streams ({', '.join(WV_KINDS)}) written in "
        f"{time.perf_counter() - t0:.2f} s")
    hosts, wv = lossless_batch(
        nqt, "WavPack", wvs, wavpack.decode_host,
        lambda h, d: wavpack.device_tail(*h, d), "wv", dev, card)
    info, raw, norm = hosts[WV_KINDS.index("float32_wvx")]
    wv["upload_ms_float"] = upload_ms(raw, dev)
    x = host_to_device(raw, dev)
    nt = wavpack.norm_on(norm, raw.size, dev)
    rows.append(tail_row(
        "normalize_float_bits WavPack float", raw.size,
        lambda: lossless.normalize_float_bits(x, nt), raw.size * 8
        + (0 if isinstance(norm, int) else raw.size * 4), card))
    info, raw, norm = hosts[WV_KINDS.index("int16_joint")]
    x = host_to_device(raw, dev)
    rows.append(tail_row("scale_int WavPack 16-bit", raw.size,
                         lambda: lossless.scale_int(x, info["bps"]),
                         raw.size * 8, card))
    del wvs, hosts, x, nt

    for name in ("dsd_fast", "dsd_high", "dsd_raw"):
        _, raw, _ = wavpack.decode_host((FIXTURES / f"{name}.wv").read_bytes())
        x = host_to_device(raw, dev)
        rows.append(tail_row(f"dsd_decimate {name}.wv", raw.size,
                             lambda: lossless.dsd_decimate(x),
                             raw.size * 5, card))
    # 3.7 min of DSD64 stereo (352,800 bytes a second a channel), the
    # decoded bytes of dsd_fast.wv cycled
    _, raw, _ = wavpack.decode_host((FIXTURES / "dsd_fast.wv").read_bytes())
    n = int(LOSSLESS_SECONDS * 352800)
    big = np.ascontiguousarray(np.resize(raw, (n, raw.shape[1])))
    x = host_to_device(big, dev)
    check(bits_equal(lossless.dsd_decimate(x[:65536]).cpu().numpy(),
                     lossless.dsd_decimate(torch.from_numpy(big[:65536]))
                     .numpy()), "dsd_decimate on the card vs the CPU")
    rows.append(tail_row("dsd_decimate 3.7 min DSD64", big.size,
                         lambda: lossless.dsd_decimate(x), big.size * 5, card))
    del x, big
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 8 took {phase_s:.1f} s")
    return {"flac": fl, "wavpack": wv, "wv_fixtures": fixtures,
            "tails": rows, "phase_s": phase_s, "card": card}


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
    card, probe = phase0_build(native, kernels)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    traces, decodes, host = host_batch(card)
    n_steps = -(-SERVE_FRAMES // F_CHUNK)
    synth_np = serving.synth_tables([d[1:] for d in decodes], 960, n_steps,
                                    F_CHUNK)
    host["comb_tables"] = comb_table_stats(synth_np, K_STREAMS, n_steps)
    host["rot_markers"] = rot_marker_stats(traces)
    synth = serving.synth_from_numpy(synth_np, dev)
    rows = phase1_kernels(comb, rot, probe, traces[0], synth, dev)
    phase2_load(nqt, comb, dev)
    serve = phase3_serving(comb, rot, serving, dev, rows, card, traces,
                           decodes, host, synth)
    del traces, decodes, synth
    torch.cuda.empty_cache()
    mp3 = phase4_mp3(nqt, card, dev)
    mpc = phase5_mpc(nqt, card, dev)
    torch.cuda.empty_cache()
    vorbis = phase6_vorbis(nqt, card, dev)
    torch.cuda.empty_cache()
    pcm_rows = phase7_pcm(nqt, card, dev)
    torch.cuda.empty_cache()
    lossless = phase8_lossless(nqt, card, dev)
    log(json.dumps({"serving": serve, "mp3": mp3, "mpc": mpc,
                    "vorbis": vorbis, "pcm": pcm_rows, "lossless": lossless,
                    "card": card}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": list(rows)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
