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
   the synthesis step loop with f_chunk = 512: 22 steps of 16 rows) by
   its serving route: the first call (a first sighting) runs eagerly,
   the second captures one CUDA graph, the counted run replays it; the
   first two are timed as a cold batch by either route.
   K1 is also held against its plain version on this real data. Checks:
   each stream's first cycle against libopus (1e-4); the replayed
   spectra against the full native decode (max d/(1+|ref|) < 1e-3,
   mean(rel > 1e-4) < 1e-5); the PCM against the spectra-in path
   run_synthesis_batched on the native spectra (1e-4); each full stream
   against the single-stream unified path (1e-6). Reports host seconds
   of both host halves, device seconds, the replay / imdct / comb /
   deemph split with the replay's inner stages, the realtime factor,
   and from one traced graph replay (utils.profiling.device_trace) the
   device busy share, the top kernels and K1's and K2's records, which
   must number one a step and one a stream, and their times as the
   graph launches them;
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
9. Opus general path phase: K = 8 Ogg Opus streams of 3,000 packets
   (60 s of 20 ms packets; the mono streams' 10 ms cases make them
   shorter) cut from the golden libopus packets by tools/opus_stream.py:
   streams 0-3 stereo cycling cases (9, 12, 0, 13) (SILK, hybrid, CELT,
   CELT), 4-7 mono cycling (8, 11, 2, 14, 17), each from a different
   case; streams 2 and 6 lose 2 % of their pages, stream 3 is two chained
   links; and a family-1 file of a SILK and a hybrid stream. load() on
   the card against the port on the CPU (8 worker processes; 1e-5 of
   max(|ref|, 1)), each stream's first case against libopus (1e-4), the
   golden SILK and hybrid cases as files against libopus (1e-4), the
   reference's SILK concealment (opus_plc.bin) bit for bit, and a
   malformed-input pass (truncations and byte flips: a NyquistError or
   the CPU's samples, then a valid load() again). K1's launches are
   counted from 0 over the streams' load(). Per stream: host seconds
   outside the synthesis and mix calls, their device span by CUDA
   events, flushes, synthesize_segment calls, K1 launches, the realtime
   factor of load().
10. encode phase: the polyphase resampler on [2, 3.7 min] at 44.1->48,
   22.05->48 and 48->16 kHz against a float64 evaluation of its sum on
   windows (1e-5 of max(|ref|, 1)), a tone above 80 dB and decimation's
   zero-filled tail; the WAV and AIFF writers of every format on 3.7
   min of stereo equal to the CPU's bytes, dither within 1 LSB; the
   Opus encoders on the host with their resamples on the card (CELT 10
   s stereo, equal to the CPU's bytes; CELT from 44.1 kHz, multistream 3
   s of 6 channels, SILK 4 s mono with in-band FEC and 2 s stereo,
   hybrid 2 s, automatic 6 s of music, speech, music), each stream's
   load() on the card above the JAX package's tests' SNR floors; FEC:
   packet 40 of the SILK stream dropped and recovered from the next on
   the card (above 12 dB, equal to the CPU); free-format and
   mixed-layer MP3 through load() against the CPU (1e-5). CPU references
   in 4 worker processes; K1's launches counted over the round trips.
   Host seconds and audio-seconds per second of each encoder, device ms
   of the resampler and of float32_to_pcm beside their byte bounds.
11. seek phase: one stream per lazy reader type at the sizes above (Opus
   streams 0 and 3 of phase 9, Vorbis, FLAC, MP3 and WAV s16 of 3.7 min,
   the Ogg FLAC fixture and two re-serialled copies chained, the SV7
   fixture, SV8 of 8,496 frames with an SO/ST seek table built by
   tests/test_torch_streaming.py); per stream 32 seeded seeks of 4,800
   samples and 10 s of 20 ms reads through seek_reader on the card, held
   against the card's load() (Opus 2e-4, Vorbis 1e-6 of max(|ref|, 1),
   FLAC, Ogg FLAC and WAV exactly; MP3 and Musepack: the gap printed) and
   against the port's reader on the CPU (7 worker processes; 1e-5 of
   max(|ref|, 1), exactly for FLAC and WAV); open ms, seek + read ms
   (median, p90), reads and bytes a seek, the device span of the window
   decodes by CUDA events and K1's launches a seek, counted from 0 over
   the seeks; open_url over a localhost HTTP server with Range support
   (Opus and FLAC; equal to the local reader, under 60 requests and twice
   the file's bytes); 12 seeded mutations a stream, each raising a
   NyquistError or reading what the CPU reads, then a valid read; the
   CLI on the card against the CPU.
12. mesh and profiling phase: entry()'s single-card step on the card
   against the CPU (1e-5 of max(|ref|, 1)); sharded_decode_step(1,
   rows=16, F=512) (the serving batch's 8 stereo streams, phase 3's
   512-frame chunk) on the card, K1's launches counted from 0 over it
   and K1 held against its plain version on the step's own inputs
   (1e-5), its kernel ms by CUDA events; the card's world 1 at (16, 16)
   against 8 gloo ranks on the CPU (1e-5); the serving mesh (dp, 1, 1)
   for dp 2, 4, 8 at (16, 16) and (16, 512): each dp slice's rows
   through the step a serving rank runs, on the card with singleton
   axes, torch.equal to world 1's (tools/mesh_nccl_check.py's
   dp_slices); NCCL ranks across the cards where there are two or more
   (run_case: the mixed mesh within 1e-5, the serving mesh bit-equal),
   else a line saying so; a CUDA request for more ranks than cards
   raises; profile_opus_load on the card (a CELT stream of 3,000 packets
   cycling the serving cases) with its report; the card's peaks by name;
   a device_trace of the single-card step that must hold its kernels, K1
   among them; op_cost of the step, and of K1 equal to K1's reported
   bytes plus its history copy.
13. malformed-input phase: every route of load() (tools/
   malformed_inputs.py: Ogg FLAC, FLAC, WavPack, Musepack SV7 and SV8,
   MP3 Layer I and II, Opus multistream and CELT-only, Vorbis floor 0
   and 1, IMA-ADPCM WAV, AIFF-C ima4, CAF) under seeded truncations and
   byte mutations, about 200 decodes: on the card each raises a
   NyquistError where the CPU raises one, or equals the CPU's samples
   (1e-5 of max(|ref|, 1); equal bits for integer PCM, FLAC and
   WavPack); after each route the card synchronizes and decodes a valid
   file of the route as the CPU does, so no device-side assert broke
   the context.
14. bench phase: libnyquist_torch.bench's headline in this process (8
   stereo streams of the bench stream, golden case 0 repeated to 100 s;
   3 trials), with its own checks (each stream's first 100 packets
   against libopus 1e-4, every stream against stream 0 1e-6, K1 and K2
   against their plain versions 1e-5), and its stage split; every field
   of its line present and finite, K1 launched once a step and K2 once a
   stream in one batch; then tools/mesh_nccl_check.py's scaling row of
   world 1 on card 0 (both meshes at (8, 16): GFLOP and GB by op_cost,
   step ms by CUDA events in the rank, no collective);
15. graph phase: the headline batch of phase 14 by the eager route and
   by the captured one (runtime/graphs.py): captured on the batch,
   replayed on a batch of the same static keys and new values (every
   stream's PCM moves) and on the batch again, the PCM bit-equal to
   eager each time; no hidden synchronisation in a captured batch; K1
   once a step and K2 once a stream in a replay, by the wrappers' counts
   and by the records of a traced replay (with their times); phase 14's
   replay and program device times by route; K1 and K2 each captured
   alone (K1 on step 1's inputs, K2 on stream 0's plane) and replayed on
   other inputs (step 2's, another stream's plane), equal to their eager
   launches and within 1e-5 of their plain versions; the key census of
   16 batches of 8 segments of 10 s of the golden CELT cases: the share
   of batches that repeat a program key.
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
import math
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
OPUS_GENERAL_PACKETS = 3000       # phase 9: 60 s of 20 ms packets a stream
MESH_SERVE = (16, 512)            # phase 12: rows of 8 stereo streams, frames
MESH_SMALL = (16, 16)             # phase 12: the card against 8 gloo ranks
PROFILE_PACKETS = 3000            # phase 12: profile_opus_load's stream
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
    from libnyquist_torch import bench

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

    rargs = bench.random_rot_args(300, 7, dev)
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


GRAPH_KERNELS = {"comb_filter": "comb_kernel", "rotate_plane": "rot_rows_kernel"}


def profile_main_path(fn, card):
    """One run of fn under utils.profiling.device_trace (its warm-up
    takes the records a session loses at its start): the device busy
    time (the union of the kernel, copy and set intervals), its share of
    the traced wall time, the five kernels with the most device time, and
    per hand-written kernel the records the trace holds and their mean
    duration (from a graph replay, the kernels as the graph launches
    them). Reports None where the trace saw no device time."""
    import shutil
    import tempfile

    from libnyquist_torch.utils import profiling

    tmp = tempfile.mkdtemp(prefix="nq_smoke_trace_")
    try:
        with profiling.device_trace(tmp):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        (f,) = pathlib.Path(tmp).glob("trace_*.json")
        events = json.loads(f.read_text()).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev_ev = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    warm = sum(1 for e in dev_ev if "spin" in e.get("name", ""))
    check(warm > 0, "the trace lost every warm-up kernel: it may have lost "
          "the run's own")
    dev_ev = [e for e in dev_ev if "spin" not in e.get("name", "")]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in dev_ev)
    busy_us, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    kernels = {}
    for name, prefix in GRAPH_KERNELS.items():
        durs = [float(e.get("dur", 0)) for e in dev_ev
                if e.get("cat") == "kernel"
                and e.get("name", "").startswith(prefix)]
        kernels[name] = {"records": len(durs),
                         "mean_ms": (sum(durs) / len(durs) / 1e3
                                     if durs else None)}
    if not spans:
        log("  traced run: the trace saw no device time (not measured)")
        return {"traced_wall_s": wall, "traced_busy_s": None,
                "traced_idle_share": None, "traced_kernels": kernels}
    busy_s = busy_us / 1e6
    by_name = {}
    for e in dev_ev:
        n = e.get("name", "")[:60]
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + float(e.get("dur", 0)), c + 1)
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:5]
    log(f"  traced run: wall {wall:.3f} s, device busy {busy_s:.3f} s, idle "
        f"share {1 - busy_s / wall:.3f} ({profiling.WARMUP_KERNELS - warm} "
        f"warm-up records lost) on {card}; top kernels: " + "; ".join(
            f"{n} {t / 1e3:.1f} ms x{c}" for n, (t, c) in top))
    log("  hand-written kernels in the trace: " + "; ".join(
        f"{n} {v['records']} records, {v['mean_ms']} ms each"
        for n, v in kernels.items()))
    return {"traced_wall_s": wall, "traced_busy_s": busy_s,
            "traced_idle_share": 1 - busy_s / wall,
            "traced_kernels": kernels}


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

    # the serving route ("auto" on a card) runs a batch's first sighting
    # eagerly and captures its second (an eager warm-up, then the
    # capture); the counted run replays the graph. The first two calls
    # are what a batch of distinct streams costs cold by each route.
    serving.clear_programs()
    serving.route_counts.clear()
    cold = {}
    for how in ("eager", "captured"):
        t0 = time.perf_counter()
        serving.run_stream_batched(streams_dev, synth, K, CC, n_steps,
                                   F_CHUNK)
        torch.cuda.synchronize()
        cold[how] = time.perf_counter() - t0
        check(serving.route_counts[how] == 1,
              f"the serving route went {dict(serving.route_counts)}, "
              f"expected one {how} call")
    capture_s = cold["captured"]
    log(f"  a cold batch of {len(keys)} structure keys: first sighting "
        f"eager {cold['eager']:.3f} s, second captured {capture_s:.3f} s "
        f"(warm-up, capture and one replay), wall clock")
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
    check(serving.route_counts["replayed"] == 1,
          f"the counted run was no graph replay: {dict(serving.route_counts)}")
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
    # one traced run of the main path (a graph replay): device busy time
    # by kernel name, and the hand-written kernels' records, counted
    # apart from the wrappers' counts and timed as the graph launches them
    trace = profile_main_path(
        lambda: serving.run_stream_batched(streams_dev, synth, K, CC,
                                           n_steps, F_CHUNK), card)
    check(serving.route_counts["replayed"] == 2,
          f"the traced run was no graph replay: {dict(serving.route_counts)}")
    for row in rows:
        got = trace["traced_kernels"][row["name"]]
        check(got["records"] == expected[row["name"]],
              f"the traced graph replay holds {got['records']} "
              f"{row['name']} kernel records, expected "
              f"{expected[row['name']]}")
        row["graph_ms"] = got["mean_ms"]
        row["graph_records"] = got["records"]
    # every stream against the single-stream unified path on the card
    worst = 0.0
    for k, (freq, sb, pfp, pfg, pft) in enumerate(decodes):
        one = serving.synthesize_streams_unified(
            np.asarray(spec_rep[k::K].permute(1, 0, 2).cpu()), sb, pfp, pfg,
            pft, CC, f_chunk=F_CHUNK, device=dev)
        worst = max(worst, (one.T - pcm[k::K]).abs().max().item())
    log(f"  batched vs single-stream: max|d| {worst:.3e}")
    check(worst < 1e-6, f"batched vs single max err {worst}")

    serving.clear_programs()
    return {"K": K, "frames": F, "audio_s": audio_s, **host,
            "upload_s": upload_s, "structure_keys": len(keys),
            "cold_eager_s": cold["eager"], "capture_s": capture_s,
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


def phase6_vorbis(nqt, card, dev):
    """The Vorbis serving shape: K floor-1 streams written by
    tools/vorbis_stream.py with one block-size sequence (one lap plan),
    host entropy decode on one core, then the batched device synthesis;
    checks against a float64 evaluation of the plan, single-stream runs
    and load()."""
    from libnyquist_torch import bench
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

    ref = bench.vorbis_plan_f64(specs[0], plan)
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
def file_writers():
    """tools/malformed_inputs.py's struct writers: (wav_file, aifc_file,
    caf_file)."""
    tool = load_tool("malformed_inputs")
    return tool.wav_file, tool.aifc_file, tool.caf_file


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

    wav_file, aifc_file, caf_file = file_writers()
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


# --------------------------------------------------------------------------
# phase 9: the Opus general path
# --------------------------------------------------------------------------
class HistoryTap:
    """Pitch concealment reads a CELT state's synthesis history on the
    host (``CeltLane.history``), and its LPC synthesis filter amplifies
    rounding differences in that history many times over. While on, this
    records each history the card hands over, or, given such a record,
    feeds it to a CPU decode in the same order, after checking that the
    CPU's own history equals it within 1e-5 of max(|h|, 1): the CPU
    reference then conceals from the same inputs as the card, and the
    comparison holds the device work alone."""

    def __init__(self, replay=None):
        from libnyquist_torch.runtime import opus_pipeline

        self.lane = opus_pipeline.CeltLane
        self.orig = self.lane.history
        self.record, self.replay = [], replay
        self.worst = 0.0
        tap = self

        def history(lane):
            fresh = lane.host is None
            mem, pre = tap.orig(lane)
            if not fresh:
                return mem, pre
            if tap.replay is None:
                tap.record.append((mem.copy(), pre.copy()))
                return mem, pre
            rmem, rpre = tap.replay[len(tap.record)]
            tap.record.append(None)
            d = float(np.abs(mem - rmem).max(initial=0.0)) / max(
                1.0, float(np.abs(rmem).max(initial=0.0)))
            tap.worst = max(tap.worst, d)
            check(mem.shape == rmem.shape and d <= 1e-5,
                  f"concealment history: CPU vs card {d}")
            return rmem.copy(), rpre.copy()

        self.lane.history = history

    def close(self):
        self.lane.history = self.orig


def _opus_cpu_load(job):
    """load() of one Ogg Opus file on the CPU, one thread, concealing from
    the card's histories; run in a worker. Returns (samples, channels,
    seconds, worst history difference)."""
    data, histories = job
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    import libnyquist_torch as nqt

    tap = HistoryTap(histories)
    t0 = time.perf_counter()
    a = nqt.load(data, extension="opus", device="cpu")
    dt = time.perf_counter() - t0
    tap.close()
    return a.samples, a.channel_count, dt, tap.worst


class GeneralPathMeter:
    """Counts and times the general path's device calls while it is on:
    lane synthesis passes with frames (flushes), synthesize_segment calls
    and mix passes, each wrapped in a pair of CUDA events (device span)
    and the host clock (time the host spends inside them)."""

    def __init__(self):
        from libnyquist_torch.runtime import opus_pipeline

        self.pipe = opus_pipeline
        self.orig = (opus_pipeline.CeltLane.synthesize,
                     opus_pipeline.synthesize_segment,
                     opus_pipeline.mix_on_device)
        self.reset()
        meter = self
        synth, segment, mix = self.orig

        def timed(fn, key):
            def run(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                out = fn(*a, **k)
                e1.record()
                meter.events.append((e0, e1))
                meter.inside_s += time.perf_counter() - t0
                meter.n[key] += 1
                return out
            return run

        def lane_synth(lane):
            if not lane.frames:
                return synth(lane)
            return timed(synth, "flushes")(lane)

        def seg(*a, **k):
            meter.n["segments"] += 1
            return segment(*a, **k)

        opus_pipeline.CeltLane.synthesize = lane_synth
        opus_pipeline.synthesize_segment = seg
        opus_pipeline.mix_on_device = timed(mix, "mixes")

    def reset(self):
        self.events, self.inside_s = [], 0.0
        self.n = {"flushes": 0, "segments": 0, "mixes": 0}

    def device_ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)

    def close(self):
        (self.pipe.CeltLane.synthesize, self.pipe.synthesize_segment,
         self.pipe.mix_on_device) = self.orig


def phase9_opus_general(nqt, comb, card, dev):
    """The Opus general path at full width: K = 8 Ogg Opus streams of
    OPUS_GENERAL_PACKETS packets cut from the golden libopus packets
    (tools/opus_stream.py: SILK, hybrid and CELT cases in turn, two
    streams losing 2 % of their pages, one of two chained links) and a
    family-1 SILK + hybrid file through load() on the card, each against
    the port on the CPU and its first case against libopus; the golden
    SILK and hybrid cases and the reference's SILK concealment on the
    card; a malformed-input pass. Per stream: host seconds, device span
    by CUDA events, flushes, synthesize_segment calls, K1 launches, the
    realtime factor."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from libnyquist_torch.errors import NyquistError
    from libnyquist_torch.formats.opus.decoder import OpusDecoder

    t_phase = time.perf_counter()
    K = K_STREAMS
    os_ = load_tool("opus_stream")
    cases = os_.read_cases()
    log(f"phase 9: the Opus general path, K={K} streams x "
        f"{OPUS_GENERAL_PACKETS} packets and a SILK + hybrid multistream "
        f"file")
    t0 = time.perf_counter()
    made = [os_.make_opus_stream(k, OPUS_GENERAL_PACKETS, cases)
            for k in range(K)]
    files = [d for d, _ in made] + [os_.make_opus_multistream(
        OPUS_GENERAL_PACKETS, cases=cases)]
    log(f"  {len(files)} files ({sum(map(len, files)) / 1e6:.2f} MB) "
        f"written in {time.perf_counter() - t0:.2f} s")
    meter = GeneralPathMeter()
    nqt.load(files[0], extension="opus", device=dev)    # warm-up
    meter.reset()
    # the general path: counts to 0 just before, read just after
    comb.comb_filter_cuda.launches = 0
    per = []
    outs = []
    histories = []
    for k, data in enumerate(files):
        before = comb.comb_filter_cuda.launches
        meter.reset()
        tap = HistoryTap()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = nqt.load(data, extension="opus", device=dev)
        wall = time.perf_counter() - t0
        tap.close()
        histories.append(tap.record)
        row = {"stream": k if k < K else "multistream",
               "channels": a.channel_count,
               "audio_s": a.sample_count / a.channel_count / 48000.0,
               "wall_s": wall, "host_s": wall - meter.inside_s,
               "device_ms": meter.device_ms(),
               "k1_launches": comb.comb_filter_cuda.launches - before,
               **meter.n}
        row["realtime_x"] = row["audio_s"] / wall
        per.append(row)
        outs.append(a)
    launches = comb.comb_filter_cuda.launches
    meter.close()
    check(launches > 0, "the general path launched no comb kernel")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            K, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = list(pool.map(_opus_cpu_load, zip(files, histories)))
    log(f"  the port on the CPU (references): {len(files)} files in "
        f"{time.perf_counter() - t0:.1f} s by {K} processes, "
        f"{sum(c[2] for c in cpu):.1f} s of CPU time; "
        f"{sum(map(len, histories))} concealment histories taken from the "
        f"card, the CPU's own within {max(c[3] for c in cpu):.2e} of them")

    for k, (a, (ref, ch, cpu_s, _)) in enumerate(zip(outs, cpu)):
        row = per[k]
        check(a.channel_count == ch and a.samples.shape == ref.shape,
              f"general stream {k}: card and CPU shapes differ")
        check(bool(np.isfinite(a.samples).all()),
              f"general stream {k}: non-finite samples")
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(a.samples - ref).max())
        check(err <= 1e-5 * scale, f"general stream {k}: card vs CPU {err}")
        row["err_vs_cpu"] = err
        row["cpu_s"] = cpu_s
        msg = ""
        if k < K:
            info = made[k][1]
            c = cases[info["first_case"]]
            want = c["pcm"][os_.PRE_SKIP * ch:]
            e1 = float(np.abs(a.samples[: want.size] - want).max())
            check(e1 < 1e-4, f"general stream {k}: first case "
                  f"{info['first_case']} vs libopus {e1}")
            row["first_case"] = info["first_case"]
            row["err_first_case_vs_libopus"] = e1
            row["lost_pages"] = len(info["lost_pages"])
            row["links"] = info["links"]
            msg = (f" first case {info['first_case']} vs libopus {e1:.2e};"
                   f" {len(info['lost_pages'])} pages lost, "
                   f"{info['links']} link(s);")
        log(f"  stream {row['stream']} ({ch} ch, {row['audio_s']:.1f} s):"
            f"{msg} host {row['host_s']:.3f} s on one core, device span "
            f"{row['device_ms']:.1f} ms by CUDA events, wall "
            f"{row['wall_s']:.3f} s = realtime x{row['realtime_x']:.1f}; "
            f"{row['flushes']} flushes, {row['segments']} synthesize_segment"
            f" calls, {row['k1_launches']} K1 launches, {row['mixes']} mixes;"
            f" card vs CPU {err:.2e} on {card}")

    # the golden SILK and hybrid cases as single-case files
    for idx in (8, 9, 10, 14, 15, 16, 11, 12, 17):
        c = cases[idx]
        a = nqt.load(os_.make_case_file(idx, cases), extension="opus",
                     device=dev)
        want = c["pcm"][os_.PRE_SKIP * c["ch"]:]
        check(a.samples.shape == want.shape, f"case file {idx} length")
        e = float(np.abs(a.samples - want).max())
        check(e < 1e-4, f"case file {idx} vs libopus {e}")
    log("  golden SILK cases 8, 9, 10, 14, 15, 16 and hybrid 11, 12, 17 as "
        "files: within 1e-4 of libopus")

    # the reference's own SILK concealment, bit for bit
    blob = (GOLDEN / "opus_plc.bin").read_bytes()
    (nplc,) = struct.unpack_from("<i", blob, 0)
    p = 4
    for _ in range(nplc):
        ci, ch, npk, _ = struct.unpack_from("<4i", blob, p)
        p += 16
        lost = np.frombuffer(blob, np.uint8, npk, p)
        p += npk
        (total,) = struct.unpack_from("<q", blob, p)
        p += 8
        ref = np.frombuffer(blob, np.float32, total, p)
        p += total * 4
        d = OpusDecoder(ch, device=dev)
        for i in range(npk):
            d.push_packet(None if lost[i] else cases[ci]["packets"][i])
        got = d.flush().cpu().numpy().reshape(-1)
        check(np.array_equal(got, ref), f"opus_plc.bin case {ci} on the card")
    log(f"  opus_plc.bin: {nplc} lossy SILK decodes on the card equal the "
        f"reference's concealment bit for bit")

    # malformed input: every mutation raises a NyquistError or equals the
    # CPU, and the card still decodes afterwards
    rng = np.random.default_rng(9)
    small = [os_.make_opus_stream(k, 120, cases)[0] for k in (1, 2, 5)]
    small.append(os_.make_opus_multistream(60, cases=cases))
    n_raised = n_equal = 0
    for data in small:
        muts = [data[: int(len(data) * f)] for f in (0.15, 0.5, 0.85)]
        muts.append(data[:40])                  # inside the OpusHead page
        for at in (37, 46):                     # channels, mapping family
            b = bytearray(data)
            b[at] ^= 0x7F
            muts.append(bytes(b))
        for _ in range(4):
            b = bytearray(data)
            for pos in rng.integers(120, len(b), 3):
                b[pos] ^= int(rng.integers(1, 256))
            muts.append(bytes(b))
        for m in muts:
            tap = HistoryTap()
            try:
                a = nqt.load(m, extension="opus", device=dev)
            except NyquistError:
                n_raised += 1
                continue
            finally:
                tap.close()
            tap = HistoryTap(tap.record)
            r = nqt.load(m, extension="opus", device="cpu")
            tap.close()
            check(a.samples.shape == r.samples.shape,
                  "malformed input: card and CPU lengths differ")
            if r.samples.size:
                scale = max(1.0, float(np.abs(r.samples).max()))
                check(float(np.abs(a.samples - r.samples).max())
                      <= 1e-5 * scale, "malformed input: card and CPU differ")
            n_equal += 1
    a = nqt.load(files[0], extension="opus", device=dev)
    ref = cpu[0][0]
    check(a.samples.shape == ref.shape and float(np.abs(
        a.samples - ref).max()) <= 1e-5 * max(1.0, float(np.abs(ref).max())),
        "the card decodes differently after the malformed pass")
    log(f"  malformed input: {n_raised + n_equal} truncations and byte "
        f"flips, {n_raised} raised a NyquistError, {n_equal} equal the "
        f"CPU; a valid load() after them equals the CPU")
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 9 took {phase_s:.1f} s; K1 launches in the general path "
        f"{launches}")
    return {"streams": per, "k1_launches": launches,
            "malformed": {"raised": n_raised, "equal_cpu": n_equal},
            "phase_s": phase_s, "card": card}


# --------------------------------------------------------------------------
# phase 10: the encode side and the two repairs
# --------------------------------------------------------------------------
ENC_SECONDS = 222.0               # the resampler's and PCM writers' input
SRC_CASES = ((44100, 48000, 1000.0), (22050, 48000, 5000.0),
             (48000, 16000, 6000.0))
FEC_LOST = 40                     # the SILK FEC stream's dropped packet


def speechish(seconds, sr=48000, level=0.5):
    """Gliding-pitch harmonics under a syllabic envelope over a noise
    floor (the JAX package's encoder tests' speech-like signal)."""
    t = np.arange(int(sr * seconds)) / sr
    f0 = 120 * (1 + 0.1 * np.sin(2 * np.pi * 2.5 * t))
    ph = np.cumsum(2 * np.pi * f0 / sr)
    x = sum(0.25 / np.sqrt(h) * np.sin(h * ph) for h in range(1, 9))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2
    x += 0.02 * np.random.default_rng(0).standard_normal(len(t))
    return (level * x / np.abs(x).max()).astype(np.float32)


def talk(seconds, hiss=0.1):
    """Syllables of a gliding buzz in noise (the JAX package's analysis
    tests' speech-like content), 48 kHz."""
    rng = np.random.default_rng(0)
    t = np.arange(int(48000 * seconds)) / 48000
    env = np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None) ** 2
    f0 = 120 * (1 + 0.25 * np.sin(2 * np.pi * 0.7 * t))
    ph = 2 * np.pi * np.cumsum(f0) / 48000
    buzz = sum(np.sin(k * ph) / k for k in range(1, 9))
    noise = rng.standard_normal(len(t)) * hiss
    return (env * (0.5 * buzz + noise)).astype(np.float32) * 0.4


def sines(ch, sr, seconds, base=220.0):
    t = np.arange(int(sr * seconds)) / sr
    return np.stack([0.4 * np.sin(2 * np.pi * base * (c + 1) * t)
                     for c in range(ch)], 1).reshape(-1).astype(np.float32)


def audio_of(samples, ch, sr):
    from libnyquist_torch.audio_data import AudioData, PCMFormat

    a = AudioData()
    a.samples, a.channel_count, a.sample_rate = samples, ch, sr
    a.source_format = PCMFormat.PCM_FLT
    return a


def snr_db(ref, out) -> float:
    ref = np.asarray(ref, np.float64).ravel()
    e = np.asarray(out, np.float64).ravel() - ref
    return float(10 * np.log10(np.dot(ref, ref) / max(np.dot(e, e), 1e-30)))


def aligned_snr_db(ref, out, skip=960):
    """The best lag in 0..199 and a least-squares gain first (the SILK
    resampler chain delays), as the JAX package's encoder tests measure."""
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    n = min(len(ref), len(out))
    ref, out = ref[:n], out[:n]
    lag = max(range(200), key=lambda k: float(np.dot(ref[:n - k], out[k:])))
    m = n - lag - skip
    o, r = out[lag:lag + m], ref[:m]
    return snr_db(r, float(np.dot(r, o) / max(np.dot(o, o), 1e-12)) * o)


def src_window_f64(x, W, K, L, M, delay, o0, n):
    """Outputs o0 .. o0 + n of the polyphase sum in float64 from the
    float32 weights: y[o] = sum_j W[p, j] x[c M - K + 1 + j] with
    o + delay = c L + p, zeros outside the input."""
    o = np.arange(o0, o0 + n) + delay
    c, p = o // L, o % L
    idx = c[:, None] * M - K + 1 + np.arange(W.shape[1])[None, :]
    valid = (idx >= 0) & (idx < len(x))
    xv = np.where(valid, x[np.clip(idx, 0, len(x) - 1)], 0.0)
    return (W.astype(np.float64)[p] * xv).sum(1)


def pcm_writers(samples, ch, sr, fmts, dev):
    """The WAV and AIFF bytes of every format, converted on ``dev``."""
    from libnyquist_torch import encoders as E
    from libnyquist_torch.audio_data import PCMFormat

    a = audio_of(samples, ch, sr)
    out = {}
    for name in fmts:
        p = E.EncoderParams(ch, getattr(PCMFormat, name))
        out["wav", name] = E.encode_wav_to_buffer(p, a, device=dev)
        if name != "PCM_FLT":
            out["aiff", name] = E.encode_aiff_to_buffer(p, a, device=dev)
    return out


def _encode_cpu(job):
    """One CPU reference of phase 10, run in a worker: ("pcm", ...) the
    WAV and AIFF bytes; ("celt", ...) the CELT encode; ("mp3", data) a
    load(); ("fec", packets, channels) a clean decode and the recovery
    of packet FEC_LOST."""
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    kind, *args = job
    t0 = time.perf_counter()
    if kind == "pcm":
        out = pcm_writers(*args, "cpu")
    elif kind == "celt":
        from libnyquist_torch import encoders as E
        from libnyquist_torch.audio_data import PCMFormat

        samples, ch, kbps = args
        out = E.encode_opus_to_buffer(E.EncoderParams(ch, PCMFormat.PCM_FLT),
                                      audio_of(samples, ch, 48000), kbps,
                                      device="cpu")
    elif kind == "mp3":
        import libnyquist_torch as nqt

        out = nqt.load(args[0], extension="mp3", device="cpu").samples
    else:
        out = fec_recovery(args[0], args[1], "cpu")
    return out, time.perf_counter() - t0


def fec_recovery(pkts, ch, dev):
    """(the clean decode of packet FEC_LOST, its recovery from the next
    packet's LBRR data after the loss) as host arrays."""
    from libnyquist_torch.formats.opus.decoder import OpusDecoder

    d = OpusDecoder(ch, device=dev)
    for q in pkts[:FEC_LOST]:
        d.push_packet(q)
    d.flush()
    clean = d.decode_packet(pkts[FEC_LOST]).cpu().numpy()
    d = OpusDecoder(ch, device=dev)
    for q in pkts[:FEC_LOST]:
        d.push_packet(q)
    d.flush()
    rec = d.decode_packet(pkts[FEC_LOST + 1], fec=True).cpu().numpy()
    return clean, rec


def phase10_encode(nqt, comb, card, dev):
    """The encode side at full width and the two repairs: the polyphase
    resampler and the WAV/AIFF writers on 3.7 min of stereo, the Opus
    encoders (CELT 10 s stereo, multistream 3 s of 6 channels, SILK 4 s
    mono with in-band FEC and 2 s stereo, hybrid 2 s, automatic 6 s) with
    their streams' load() on the card, FEC recovery on the card, and
    free-format and mixed-layer MP3 through load(). CPU references run
    in worker processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from libnyquist_torch import encoders as E
    from libnyquist_torch.audio_data import PCMFormat
    from libnyquist_torch.formats.ogg import demux
    from libnyquist_torch.ops import pcm as pcm_ops
    from libnyquist_torch.ops import src

    t_phase = time.perf_counter()
    log(f"phase 10: the encode side, {ENC_SECONDS:.0f} s of stereo through "
        f"the resampler and the WAV/AIFF writers, the Opus encoders, FEC "
        f"recovery and Layer III outside the native decode")
    rng = np.random.default_rng(10)
    n44 = int(44100 * ENC_SECONDS)
    pcm_in = np.stack([sines(1, 44100, ENC_SECONDS, 440.0),
                       (rng.standard_normal(n44) * 0.3).clip(-1.1, 1.1)],
                      1).reshape(-1).astype(np.float32)
    fmts = ("PCM_U8", "PCM_16", "PCM_24", "PCM_32", "PCM_FLT")
    celt_in = sines(2, 48000, 10.0, 440.0)
    l3 = load_tool("l3_stream")
    mp3s = {"free-format": l3.make_l3_stream(3, 2.0, free_format=True),
            "mixed layers": ((FIXTURES / "l2_stereo_44k.mp3").read_bytes()
                             + l3.make_l3_stream(3, 2.0))}
    pool = ProcessPoolExecutor(
        4, mp_context=multiprocessing.get_context("spawn"))
    cpu_pcm = pool.submit(_encode_cpu, ("pcm", pcm_in, 2, 44100, fmts))
    cpu_celt = pool.submit(_encode_cpu, ("celt", celt_in, 2, 160))
    cpu_mp3 = {k: pool.submit(_encode_cpu, ("mp3", v))
               for k, v in mp3s.items()}
    comb.comb_filter_cuda.launches = 0

    # the resampler on [2, 3.7 min]
    src_rows = []
    for sr_in, sr_out, freq in SRC_CASES:
        n = int(sr_in * ENC_SECONDS)
        t = np.arange(n) / sr_in
        x = np.stack([np.sin(2 * np.pi * freq * t),
                      rng.standard_normal(n) * 0.3]).astype(np.float32)
        xd = torch.from_numpy(x).to(dev)
        y = src.resample(xd, sr_in, sr_out, device=dev).cpu().numpy()
        n_out = round(n * sr_out / sr_in)
        check(y.shape == (2, n_out) and bool(np.isfinite(y).all()),
              f"resample {sr_in}->{sr_out}: shape or values")
        g = math.gcd(sr_in, sr_out)
        L, M = sr_out // g, sr_in // g
        W, K, delay = src.polyphase_weights(L, M)
        filled = (-(-n // M) + 1) * L - delay
        tail = max(0, n_out - filled)
        check(not y[:, n_out - tail:].any(), "resample: the tail past the "
              "filtered output is not zero")
        if sr_in > sr_out:
            check(tail > 0 and np.abs(y[1, n_out - tail - 64:n_out - tail]
                                      ).min() > 0,
                  f"resample {sr_in}->{sr_out}: no zero tail, or one too "
                  f"long")
        worst = 0.0
        for r in range(2):
            x64 = x[r].astype(np.float64)
            for o0 in (0, n_out // 2, n_out - tail - 4096):
                ref = src_window_f64(x64, W, K, L, M, delay, o0, 4096)
                d = float(np.abs(y[r, o0:o0 + 4096] - ref).max())
                worst = max(worst, d / max(1.0, float(np.abs(ref).max())))
        check(worst <= 1e-5, f"resample {sr_in}->{sr_out} vs float64 {worst}")
        ideal = np.sin(2 * np.pi * freq * np.arange(n_out) / sr_out)
        sl = slice(3000, n_out - tail - 3000)
        snr = snr_db(ideal[sl], y[0, sl])
        check(snr > 80.0, f"resample {sr_in}->{sr_out}: tone SNR {snr:.1f}")
        ms = cuda_ms(lambda: src.resample(xd, sr_in, sr_out, device=dev), 5)
        nbytes = 4 * (x.size + 2 * n_out)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        src_rows.append({"sr_in": sr_in, "sr_out": sr_out, "ms": ms,
                         "bound_ms": bound, "bytes": nbytes,
                         "err_vs_f64": worst, "tone_snr_db": snr,
                         "zero_tail": tail})
        log(f"  resample {sr_in}->{sr_out} on [2, {n}]: {ms:.3f} ms by CUDA "
            f"events (median of 5), byte bound {bound:.4f} ms "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s) = {ms / bound:.1f}x; "
            f"vs float64 {worst:.2e}, tone SNR {snr:.1f} dB, zero tail "
            f"{tail} on {card}")
        del xd

    # WAV and AIFF: the CPU's bytes with dither off; dither within 1 LSB
    t0 = time.perf_counter()
    got = pcm_writers(pcm_in, 2, 44100, fmts, dev)
    host_pcm = time.perf_counter() - t0
    ref, _ = cpu_pcm.result()
    for key in ref:
        check(got[key] == ref[key], f"{key[0]} {key[1]}: card and CPU bytes "
              f"differ")
    p16 = E.EncoderParams(2, PCMFormat.PCM_16, E.DitherType.DITHER_TRIANGLE)
    on = E.encode_wav_to_buffer(p16, audio_of(pcm_in, 2, 44100), device=dev,
                                generator=torch.Generator(dev).manual_seed(3))
    d = (np.frombuffer(on[44:], "<i2").astype(np.int64)
         - np.frombuffer(got["wav", "PCM_16"][44:], "<i2"))
    check(np.abs(d).max() == 1 and np.count_nonzero(d) > 0,
          f"dithered PCM_16 off by {np.abs(d).max()} LSB")
    xd = torch.from_numpy(pcm_in).to(dev)
    pcm_rows = []
    for name in fmts[:4]:       # float32 output is its input: no device work
        fmt = getattr(PCMFormat, name)
        width = {"PCM_U8": 1, "PCM_16": 2}.get(name, 4)
        ms = cuda_ms(lambda: pcm_ops.float32_to_pcm(xd, fmt), 5)
        nbytes = pcm_in.size * (4 + width)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        pcm_rows.append({"format": name, "ms": ms, "bound_ms": bound})
        log(f"  float32_to_pcm {name} on {pcm_in.size} samples: {ms:.3f} ms,"
            f" byte bound {bound:.4f} ms = {ms / bound:.1f}x")
    del xd
    log(f"  WAV and AIFF: {len(ref)} files of {ENC_SECONDS:.0f} s stereo "
        f"equal the CPU's bytes ({host_pcm:.2f} s for all on the card path);"
        f" dithered PCM_16 within 1 LSB ({np.count_nonzero(d)} samples "
        f"moved)")

    # the Opus encoders; their streams' load() on the card
    enc_rows = []
    fams = {}

    def enc(label, samples, ch, sr, seconds, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kw.pop("multistream", False):
            buf = E.encode_opus_multistream_to_buffer(
                E.EncoderParams(ch, PCMFormat.PCM_FLT),
                audio_of(samples, ch, sr), device=dev, **kw)
        else:
            buf = E.encode_opus_to_buffer(
                E.EncoderParams(ch, PCMFormat.PCM_FLT),
                audio_of(samples, ch, sr), device=dev, **kw)
        host = time.perf_counter() - t0
        back = nqt.load(buf, extension="opus", device=dev)
        check(back.channel_count == ch and bool(np.isfinite(
            back.samples).all()), f"{label}: load() channels or values")
        st = next(iter(demux(buf).values()))
        fams[label] = {"silk" if c < 12 else "hybrid" if c < 16 else "celt"
                       for c in (q.data[0] >> 3 for q in st.packets[2:])}
        row = {"encoder": label, "audio_s": seconds, "host_s": host,
               "audio_s_per_s": seconds / host, "bytes": len(buf)}
        enc_rows.append(row)
        return buf, back, st

    buf_celt, back, _ = enc("CELT 48 kHz stereo", celt_in, 2, 48000, 10.0,
                            bitrate_kbps=160)
    snr_celt = snr_db(celt_in, back.samples)
    check(snr_celt > 40.0, f"CELT round trip {snr_celt:.1f} dB")
    x441 = sines(2, 44100, 2.0, 440.0)
    _, back, _ = enc("CELT from 44.1 kHz", x441, 2, 44100, 2.0,
                     bitrate_kbps=160)
    check(abs(back.sample_count - round(x441.size * 48 / 44.1)) <= 2,
          "CELT from 44.1 kHz: length")
    ref48 = src.resample(x441.reshape(-1, 2).T, 44100, 48000,
                         device=dev).cpu().numpy().T.reshape(-1)
    snr_441 = snr_db(ref48, back.samples[:ref48.size])
    check(snr_441 > 40.0, f"CELT from 44.1 kHz round trip {snr_441:.1f} dB")
    ms_in = sines(6, 48000, 3.0)
    _, back, _ = enc("multistream 6 ch", ms_in, 6, 48000, 3.0,
                     multistream=True)
    out = back.samples.reshape(-1, 6)
    snr_ms = min(snr_db(ms_in.reshape(-1, 6)[:, c], out[:, c])
                 for c in range(6))
    check(back.sample_count == ms_in.size and snr_ms > 12.0,
          f"multistream round trip {snr_ms:.1f} dB")
    sp4 = speechish(4.0)
    buf_fec, back, st = enc("SILK mono (FEC)", sp4, 1, 48000, 4.0,
                            mode="silk", fec=True)
    snr_silk = aligned_snr_db(sp4, back.samples)
    check(snr_silk > 17.0, f"SILK mono round trip {snr_silk:.1f} dB")
    pkts = [q.data for q in st.packets[2:]]
    cpu_fec = pool.submit(_encode_cpu, ("fec", pkts, 1))
    sp2 = speechish(2.0)
    st_in = np.stack([sp2, np.roll(sp2, 240) * 0.9], 1).reshape(-1)
    _, back, _ = enc("SILK stereo", st_in, 2, 48000, 2.0, mode="silk")
    out = back.samples.reshape(-1, 2)
    snr_st = min(aligned_snr_db(st_in.reshape(-1, 2)[:, c], out[:, c])
                 for c in range(2))
    check(snr_st > 15.0, f"SILK stereo round trip {snr_st:.1f} dB")
    t2 = np.arange(sp2.size) / 48000
    hy_in = sp2 + (0.1 * np.sin(2 * np.pi * 10500 * t2)).astype(np.float32)
    _, back, _ = enc("hybrid mono", hy_in, 1, 48000, 2.0, mode="hybrid",
                     bitrate_kbps=64)
    snr_hy = aligned_snr_db(hy_in, back.samples)
    check(snr_hy > 11.0, f"hybrid round trip {snr_hy:.1f} dB")
    t15 = np.arange(int(48000 * 1.5)) / 48000
    chord = (0.2 * sum(np.sin(2 * np.pi * f * t15) for f in
                       (220.0, 277.2, 329.6, 440.0))).astype(np.float32)
    au_in = np.concatenate([chord, talk(3.0), chord])
    _, back, _ = enc("auto mono", au_in, 1, 48000, 6.0, mode="auto",
                     bitrate_kbps=24)
    snr_au = snr_db(au_in, back.samples)
    snr_tail = snr_db(au_in[-48000:], back.samples[-48000:])
    check(back.sample_count == au_in.size and snr_au > 15.0
          and snr_tail > 15.0, f"auto round trip {snr_au:.1f} / "
          f"{snr_tail:.1f} dB")
    check(fams["auto mono"] >= {"celt", "silk"},
          f"auto picked {sorted(fams['auto mono'])}")
    ref_celt, celt_cpu_s = cpu_celt.result()
    check(buf_celt == ref_celt, "CELT from 48 kHz: card and CPU bytes differ")
    for row in enc_rows:
        log(f"  encoder {row['encoder']}: {row['audio_s']:.1f} s of audio in "
            f"{row['host_s']:.3f} s on the host = {row['audio_s_per_s']:.2f} "
            f"audio-s per s, {row['bytes']} bytes")
    log(f"  round trips through load() on the card: CELT {snr_celt:.1f} dB, "
        f"from 44.1 kHz {snr_441:.1f}, multistream {snr_ms:.1f} (worst "
        f"channel), SILK {snr_silk:.1f} / stereo {snr_st:.1f}, hybrid "
        f"{snr_hy:.1f}, auto {snr_au:.1f} (tail {snr_tail:.1f}, "
        f"{sorted(fams['auto mono'])}); CELT bytes equal the CPU's "
        f"({celt_cpu_s:.1f} s there)")

    # in-band FEC on the card, against the clean decode and the CPU
    clean, rec = fec_recovery(pkts, 1, dev)
    g = float(np.dot(clean.ravel(), rec.ravel())
              / max(np.dot(rec.ravel(), rec.ravel()), 1e-12))
    snr_fec = snr_db(clean, g * rec)
    (cclean, crec), _ = cpu_fec.result()
    check(np.array_equal(rec, crec) and np.array_equal(clean, cclean),
          "FEC: card and CPU recoveries differ")
    check(snr_fec > 12.0, f"FEC recovery {snr_fec:.1f} dB")
    log(f"  FEC: packet {FEC_LOST} of the SILK stream dropped, recovered "
        f"from packet {FEC_LOST + 1}'s LBRR data on the card at "
        f"{snr_fec:.1f} dB against the clean decode, equal to the CPU's "
        f"recovery")

    # Layer III outside the native decode, through load()
    mp3_err = {}
    for k, data in mp3s.items():
        a = nqt.load(data, extension="mp3", device=dev)
        r, _ = cpu_mp3[k].result()
        check(a.samples.shape == r.shape and r.size > 0,
              f"MP3 {k}: card and CPU shapes")
        e = float(np.abs(a.samples - r).max())
        check(e <= 1e-5 * max(1.0, float(np.abs(r).max())),
              f"MP3 {k}: card vs CPU {e}")
        mp3_err[k] = e
    pool.shutdown()
    log(f"  MP3 free-format and mixed-layer load() on the card: "
        + ", ".join(f"{k} {e:.2e}" for k, e in mp3_err.items())
        + " against the CPU")
    launches = comb.comb_filter_cuda.launches
    check(launches > 0, "the encoders' round trips launched no comb kernel")
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 10 took {phase_s:.1f} s; K1 launches in the round trips "
        f"{launches}; {card}")
    return {"resample": src_rows, "float32_to_pcm": pcm_rows,
            "encoders": enc_rows, "k1_launches": launches,
            "snr_db": {"celt": snr_celt, "celt_441": snr_441,
                       "multistream": snr_ms, "silk": snr_silk,
                       "silk_stereo": snr_st, "hybrid": snr_hy,
                       "auto": snr_au, "fec": snr_fec},
            "mp3_err_vs_cpu": mp3_err, "phase_s": phase_s, "card": card}


# --------------------------------------------------------------------------
# phase 11: positioned reads and seeks, ranged reads over HTTP, the CLI
# --------------------------------------------------------------------------
SEEK_STREAMS = ("opus", "opus chained", "vorbis", "flac", "ogg flac",
                "ogg flac chained", "mp3", "mpc sv7", "mpc sv8", "wav s16")
SEEK_READS = 32                   # seeded seek positions a stream
SEEK_N = 4800                     # samples a seek reads
SEEK_SEQ_S = 10.0                 # sequential 20 ms reads after one seek
SEEK_MUTATIONS = 12               # malformed inputs a stream
# each reader's reads against the card's full load(), at the JAX
# package's seek tolerances (tests/test_seek.py) of max(|ref|, 1) as the
# script's other gates (the writers' noise peaks above 1; 0: equal bits);
# None: held against the port's CPU reader only, the gap to load() printed
SEEK_FULL_TOL = {"opus": 2e-4, "opus chained": 2e-4, "vorbis": 1e-6,
                 "flac": 0.0, "ogg flac": 0.0, "ogg flac chained": 0.0,
                 "wav s16": 0.0, "mp3": None, "mpc sv7": None,
                 "mpc sv8": None}
SEEK_EXACT = ("flac", "ogg flac", "ogg flac chained", "wav s16")


def load_seek_builders():
    """The content builders of tests/test_torch_streaming.py (NumPy and
    the writers only): the SV8 stream with a seek table, the Ogg
    re-serial."""
    spec = importlib.util.spec_from_file_location(
        "_seek_builders", ROOT / "tests" / "test_torch_streaming.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seek_stream(name: str) -> bytes:
    """Phase 11's input ``name`` at the earlier phases' sizes."""
    b = load_seek_builders()
    if name in ("opus", "opus chained"):
        k = 0 if name == "opus" else 3          # stream 3: two links
        return load_tool("opus_stream").make_opus_stream(
            k, OPUS_GENERAL_PACKETS)[0]
    if name == "vorbis":
        return load_tool("vorbis_stream").make_vorbis_stream(
            310, VORBIS_SECONDS)
    if name == "flac":
        return load_tool("flac_stream").make_flac_stream(
            311, LOSSLESS_SECONDS)[0]
    if name in ("ogg flac", "ogg flac chained"):
        fl = (FIXTURES / "kitty8_dithered.oga").read_bytes()
        return fl if name == "ogg flac" else (b.reserial(fl, 0x7001)
                                              + b.reserial(fl, 0x7002))
    if name == "mp3":
        return load_tool("l3_stream").make_l3_stream(312, L3_SECONDS)
    if name == "mpc sv7":
        return (FIXTURES / "sv7_stereo.mpc").read_bytes()
    if name == "mpc sv8":
        return b.sv8_with_seek_table(313, block_pwr=2, n_ap=MPC_FRAMES // 4)
    payload = np.random.default_rng(314).integers(
        0, 256, int(PCM_SECONDS * 44100) * 4, np.uint8).tobytes()
    return file_writers()[0](1, 2, 44100, 16, payload)


def _seek_stream_job(name):
    sys.path.insert(0, str(ROOT))
    return seek_stream(name)


def seek_plan(total: int, rate: int, seed: int) -> dict:
    """SEEK_READS seeded positions of SEEK_N-sample reads, then one seek
    and SEEK_SEQ_S of 20 ms reads."""
    rng = np.random.default_rng(seed)
    top = max(total - SEEK_N, 1)
    return {"positions": [int(p) for p in rng.integers(0, top, SEEK_READS)],
            "seq_pos": int(rng.integers(0, top)), "step": rate // 50,
            "seq_reads": int(SEEK_SEQ_S * 50)}


def seek_mutations(data: bytes, seed: int):
    """SEEK_MUTATIONS byte mutations as tests/test_seek.py:319-357 makes
    them (1 to 10 bytes anywhere, or in the first 2 KiB), each with four
    (fraction of the total, read size) steps."""
    import random

    rng = random.Random(seed)
    out = []
    for _ in range(SEEK_MUTATIONS):
        region = rng.choice([len(data), min(2048, len(data))])
        edits = [(rng.randrange(region), rng.randrange(256))
                 for _ in range(rng.randint(1, 10))]
        steps = [(rng.random(), rng.randrange(1, 4000)) for _ in range(4)]
        out.append((edits, steps))
    return out


def seek_reads(reader, src, plan, comb=None):
    """The plan's reads through ``reader`` -> (outputs, per-seek rows of
    (host ms, reads, bytes, K1 launches)). A read returns host samples,
    so the host clock stops after the device finished."""
    outs, rows = [], []
    for pos in plan["positions"]:
        r0, b0 = src.reads, src.bytes_read
        k0 = comb.comb_filter_cuda.launches if comb else 0
        t0 = time.perf_counter()
        reader.pcm_seek(pos)
        outs.append(reader.read(SEEK_N))
        rows.append(((time.perf_counter() - t0) * 1e3, src.reads - r0,
                     src.bytes_read - b0,
                     (comb.comb_filter_cuda.launches - k0) if comb else 0))
    reader.pcm_seek(plan["seq_pos"])
    for _ in range(plan["seq_reads"]):
        outs.append(reader.read(plan["step"]))
    return outs, rows


def drive_mutation(seek_reader, data, edits, steps, device):
    """Open the mutated input and take its steps -> (outputs, the error's
    class name or None); an error outside the NyquistError hierarchy
    propagates."""
    from libnyquist_torch.errors import NyquistError

    mut = bytearray(data)
    for pos, val in edits:
        mut[pos] = val
    outs = []
    try:
        r = seek_reader(bytes(mut), device=device)
        total = r.pcm_total()
        for frac, n in steps:
            if total > 1:
                r.pcm_seek(int(frac * total))
            outs.append(r.read(n))
    except NyquistError as e:
        return outs, type(e).__name__
    return outs, None


def seek_cpu_jobs(name, data, plan, muts):
    """The CPU reference work of one stream as worker jobs (name, part,
    data, plan, mutations): an Opus stream's seeks in chunks of 4, its
    sequential reads and its mutations one by one (its windows are the
    slow ones on the CPU), any other stream whole."""
    if not name.startswith("opus"):
        return [(name, 0, data, plan, muts)]
    quiet = dict(plan, seq_reads=0)
    jobs = [(name, i, data, dict(quiet, positions=plan["positions"][i:i + 4]),
             []) for i in range(0, len(plan["positions"]), 4)]
    jobs.append((name, len(jobs), data, dict(plan, positions=[]), []))
    jobs += [(name, len(jobs) + j, data, dict(quiet, positions=[]), [m])
             for j, m in enumerate(muts)]
    return jobs


def _seek_cpu(job):
    """The port's lazy reader on the CPU over one stream (or one part of
    its work), one thread: the plan's reads and the malformed inputs'
    steps; run in a worker."""
    name, part, data, plan, muts = job
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from libnyquist_torch import streaming

    t0 = time.perf_counter()
    src = streaming.CountingSource(data)
    outs, _ = seek_reads(streaming.seek_reader(src, device="cpu"), src, plan)
    mres = [drive_mutation(streaming.seek_reader, data, e, s, "cpu")
            for e, s in muts]
    return name, part, outs, mres, time.perf_counter() - t0


class WindowMeter:
    """CUDA events around every window decode (and every WAV read, which
    converts on the card) while on: the device span of the windows."""

    def __init__(self):
        from libnyquist_torch import streaming

        self.targets = [(streaming.OggSeekReader, "_decode_window"),
                        (streaming.Mp3SeekReader, "_decode_window"),
                        (streaming.FlacSeekReader, "_decode_window"),
                        (streaming.MpcSeekReader, "_decode_window"),
                        (streaming.WavSeekReader, "read")]
        self.orig = [getattr(c, m) for c, m in self.targets]
        self.events = []
        meter = self

        def timed(fn):
            def run(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                meter.events.append((e0, e1))
                return out
            return run

        for (cls, m), fn in zip(self.targets, self.orig):
            setattr(cls, m, timed(fn))

    def take(self):
        """(windows, device ms) since the last take."""
        torch.cuda.synchronize()
        ev, self.events = self.events, []
        return len(ev), sum(a.elapsed_time(b) for a, b in ev)

    def close(self):
        for (cls, m), fn in zip(self.targets, self.orig):
            setattr(cls, m, fn)


def worst(outs, refs, scaled=True):
    """Largest |a - b| over paired reads (scaled by max(|ref|, 1)), or
    None when a pair differs in shape."""
    err, peak = 0.0, 1.0
    for a, b in zip(outs, refs):
        if a.shape != b.shape:
            return None
        if a.size:
            err = max(err, float(np.abs(a - b).max()))
            peak = max(peak, float(np.abs(b).max()))
    return err / peak if scaled else err


def full_reads(full, plan):
    """The plan's reads from the decode-backed reader over load()."""
    outs = []
    for pos in plan["positions"]:
        full.pcm_seek(pos)
        outs.append(full.read(SEEK_N))
    full.pcm_seek(plan["seq_pos"])
    for _ in range(plan["seq_reads"]):
        outs.append(full.read(plan["step"]))
    return outs


def range_server(files: dict):
    """A threaded HTTP/1.1 server on 127.0.0.1 serving ``files`` (path
    -> bytes) with Range support; returns (server, base URL)."""
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            body = files.get(self.path)
            if body is None:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            rng = self.headers.get("Range")
            if rng:
                lo_s, hi_s = rng.split("=", 1)[1].split(",")[0].split("-", 1)
                lo = int(lo_s)
                hi = min(int(hi_s) if hi_s else len(body) - 1, len(body) - 1)
                if lo >= len(body):
                    self.send_response(416)
                    self.send_header("Content-Range", f"bytes */{len(body)}")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                part = body[lo : hi + 1]
                self.send_response(206)
                self.send_header("Content-Range",
                                 f"bytes {lo}-{hi}/{len(body)}")
            else:
                part = body
                self.send_response(200)
            self.send_header("Content-Length", str(len(part)))
            self.end_headers()
            self.wfile.write(part)

    class Server(http.server.ThreadingHTTPServer):
        daemon_threads = True

        def handle_error(self, request, client_address):
            pass    # a reader closing a connection with a body in flight

    srv = Server(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def phase11_seek(nqt, comb, card, dev):
    """Positioned reads and seeks on the card: one stream per lazy reader
    type at the earlier phases' sizes, 32 seeded seeks of 4,800 samples
    and 10 s of 20 ms reads after one seek each, held against the card's
    full load() and against the port's lazy reader on the CPU (worker
    processes); open and seek times, reads and bytes per seek, the device
    span of the window decodes, K1 launches per Opus seek; ranged reads
    over HTTP; a malformed-input pass; the console entry point."""
    import contextlib
    import io
    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from libnyquist_torch import cli, streaming
    from libnyquist_torch.errors import NyquistError

    t_phase = time.perf_counter()
    log(f"phase 11: seeks on the card, {len(SEEK_STREAMS)} streams x "
        f"{SEEK_READS} seeks of {SEEK_N} samples and {SEEK_SEQ_S:.0f} s of "
        f"20 ms reads, HTTP, {SEEK_MUTATIONS} malformed inputs a stream, "
        f"the CLI")
    pool = ProcessPoolExecutor(
        8, mp_context=multiprocessing.get_context("spawn"))
    flac_job = pool.submit(_seek_stream_job, "flac")
    t0 = time.perf_counter()
    datas = {n: seek_stream(n) for n in SEEK_STREAMS if n != "flac"}
    log(f"  {len(datas)} streams ({sum(map(len, datas.values())) / 1e6:.1f} "
        f"MB) written in {time.perf_counter() - t0:.1f} s; FLAC in a worker")
    plans, muts = {}, {}

    def plan_for(name):
        """Totals from a reader on the card (opening reads headers and
        the tail only), then the stream's reads and mutations."""
        if name == "flac":
            datas[name] = flac_job.result()
        i = SEEK_STREAMS.index(name)
        r = streaming.seek_reader(datas[name], device=dev)
        plans[name] = seek_plan(r.pcm_total(), r.sample_rate, 400 + i)
        muts[name] = seek_mutations(datas[name], 500 + i)

    # the timed reads run with the CPU workers idle (FLAC, written in a
    # worker meanwhile, comes last)
    meter = WindowMeter()
    rows, card_outs = {}, {}
    # the seek path: K1's count to 0 just before, read just after
    comb.comb_filter_cuda.launches = 0
    for name in sorted(SEEK_STREAMS, key=lambda n: n == "flac"):
        plan_for(name)
        data = datas[name]
        src = streaming.CountingSource(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = streaming.seek_reader(src, device=dev)
        open_ms = (time.perf_counter() - t0) * 1e3
        open_io = (src.reads, src.bytes_read)
        meter.take()
        outs, per = seek_reads(r, src, plans[name], comb)
        n_win, dev_ms = meter.take()
        card_outs[name] = outs
        ms = sorted(p[0] for p in per)
        rows[name] = {
            "reader": type(r).__name__, "total": r.pcm_total(),
            "channels": r.channel_count, "rate": r.sample_rate,
            "bytes": len(data), "open_ms": open_ms, "open_reads": open_io[0],
            "open_bytes": open_io[1],
            "seek_read_ms_median": statistics.median(ms),
            "seek_read_ms_p90": ms[int(0.9 * (len(ms) - 1))],
            "reads_per_seek": sum(p[1] for p in per) / len(per),
            "bytes_per_seek": sum(p[2] for p in per) / len(per),
            "k1_per_seek": sum(p[3] for p in per) / len(per),
            "windows": n_win, "window_device_ms": dev_ms}
        log(f"  {name}: {SEEK_READS} seeks and {SEEK_SEQ_S:.0f} s of reads "
            f"on the card in {time.perf_counter() - t0:.1f} s")
    launches = comb.comb_filter_cuda.launches
    check(launches > 0, "the Opus seeks launched no comb kernel")
    meter.close()
    cpu_jobs = [pool.submit(_seek_cpu, job) for n in SEEK_STREAMS
                for job in seek_cpu_jobs(n, datas[n], plans[n], muts[n])]
    t_cpu = time.perf_counter()

    # the card's full load() of each stream
    t_rest = time.perf_counter()
    for name in SEEK_STREAMS:
        row = rows[name]
        data = datas[name]
        if name == "ogg flac chained":      # load() decodes the first link
            full = streaming.StreamReader(datas["ogg flac"], device=dev)
            full._buf = np.concatenate([full._buf, full._buf])
        else:
            full = streaming.StreamReader(data, device=dev)
        check(full.pcm_total() == row["total"],
              f"seek {name}: lazy total {row['total']} vs load() "
              f"{full.pcm_total()}")
        tol = SEEK_FULL_TOL[name]
        err = worst(card_outs[name], full_reads(full, plans[name]))
        check(err is not None, f"seek {name}: read shapes differ from load()")
        if tol is not None:
            check(err <= tol, f"seek {name}: card reads vs card load() {err}")
        row["err_vs_load"] = err
        check(all(bool(np.isfinite(o).all()) for o in card_outs[name]),
              f"seek {name}: non-finite samples")

    log(f"  load() of the {len(SEEK_STREAMS)} streams on the card in "
        f"{time.perf_counter() - t_rest:.1f} s")
    # ranged reads over HTTP against the local reader on the card
    srv, base = range_server({"/s.opus": datas["opus"],
                              "/s.flac": datas["flac"]})
    http_rows = {}
    for name, path in (("opus", "/s.opus"), ("flac", "/s.flac")):
        r = nqt.open_url(base + path, device=dev)
        hsrc = getattr(r.src, "parent", r.src)   # a one-link Ogg's view
        local = streaming.seek_reader(datas[name], device=dev)
        plan = dict(plans[name], positions=plans[name]["positions"][:4],
                    seq_reads=50)
        t0 = time.perf_counter()
        got, _ = seek_reads(r, hsrc, plan)
        wall = time.perf_counter() - t0
        want, _ = seek_reads(local, local.src, plan)
        # two decodes on the card: equal for FLAC; the Opus mix adds with
        # atomics (index_add_), so its order, and float rounding, may vary
        e = worst(got, want)
        check(e is not None and (e == 0.0 if name in SEEK_EXACT
                                 else e <= 1e-5),
              f"HTTP {name}: reads differ from the local reader's: {e}")
        size = len(datas[name])
        check(hsrc.requests < 60 and hsrc.bytes_fetched < 2 * size,
              f"HTTP {name}: {hsrc.requests} requests, "
              f"{hsrc.bytes_fetched} bytes of {size}")
        http_rows[name] = {"requests": hsrc.requests,
                           "bytes_fetched": hsrc.bytes_fetched,
                           "file_bytes": size, "wall_s": wall}
        hsrc.close()
        log(f"  HTTP {name}: 4 seeks and 1 s of reads equal the local "
            f"reader's ({e:.1e}); {hsrc.requests} requests, "
            f"{hsrc.bytes_fetched} "
            f"bytes fetched of a {size}-byte file, {wall:.2f} s")
    srv.shutdown()
    srv.server_close()

    # malformed input on the card: a NyquistError or the CPU's samples
    n_raised = n_equal = 0
    card_muts = {}
    t_rest = time.perf_counter()
    for name in SEEK_STREAMS:
        res = []
        for edits, steps in muts[name]:
            t0 = time.perf_counter()
            try:
                res.append(drive_mutation(streaming.seek_reader, datas[name],
                                          edits, steps, dev))
            except Exception as e:          # outside the hierarchy
                fail(f"malformed {name}: {type(e).__name__}: {e}")
            check(time.perf_counter() - t0 < 30.0,
                  f"malformed {name}: more than 30 s")
        card_muts[name] = res
    log(f"  {SEEK_MUTATIONS * len(SEEK_STREAMS)} mutated inputs on the card "
        f"in {time.perf_counter() - t_rest:.1f} s")

    # the CPU references, their parts in order
    cpu = {n: ([], [], 0.0) for n in SEEK_STREAMS}
    for job in cpu_jobs:
        name, _part, outs, mres, cpu_s = job.result()
        o, m, c = cpu[name]
        cpu[name] = (o + outs, m + mres, c + cpu_s)
    pool.shutdown()
    log(f"  the port on the CPU (references): {len(cpu_jobs)} jobs by 8 "
        f"processes, {sum(c[2] for c in cpu.values()):.1f} s of CPU time, "
        f"done {time.perf_counter() - t_cpu:.1f} s after they started")
    for name in SEEK_STREAMS:
        row = rows[name]
        outs, mres, cpu_s = cpu[name]
        exact = name in SEEK_EXACT
        err = worst(card_outs[name], outs)
        check(err is not None and len(outs) == len(card_outs[name]),
              f"seek {name}: card and CPU read shapes differ")
        check(err == 0.0 if exact else err <= 1e-5,
              f"seek {name}: card vs CPU reader {err}")
        row["err_vs_cpu"] = err
        row["cpu_s"] = cpu_s
        for (c_outs, c_err), (r_outs, r_err) in zip(card_muts[name], mres):
            if c_err is not None:
                n_raised += 1
            else:
                n_equal += 1
                check(r_err is None and len(r_outs) == len(c_outs),
                      f"malformed {name}: the card read what the CPU did not")
            k = min(len(c_outs), len(r_outs))
            e = worst(c_outs[:k], r_outs[:k])
            check(e is not None and (e == 0.0 if exact else e <= 1e-5),
                  f"malformed {name}: card vs CPU {e}")
        log(f"  {name} ({row['reader']}, {row['channels']} ch, "
            f"{row['total'] / row['rate']:.1f} s, {row['bytes']} bytes): "
            f"open {row['open_ms']:.1f} ms ({row['open_reads']} reads, "
            f"{row['open_bytes']} bytes); seek + {SEEK_N}-sample read "
            f"median {row['seek_read_ms_median']:.1f} ms, p90 "
            f"{row['seek_read_ms_p90']:.1f} ms (host wall); "
            f"{row['reads_per_seek']:.1f} reads and "
            f"{row['bytes_per_seek']:.0f} bytes a seek; {row['windows']} "
            f"windows, device span {row['window_device_ms']:.1f} ms by CUDA "
            f"events; K1 {row['k1_per_seek']:.2f} launches a seek; vs "
            f"load() {row['err_vs_load']:.2e}, vs the CPU reader "
            f"{err:.2e} on {card}")
    # the card after the malformed pass: a valid read equals the CPU's
    r = streaming.seek_reader(datas["opus"], device=dev)
    r.pcm_seek(plans["opus"]["positions"][0])
    e = worst([r.read(SEEK_N)], cpu["opus"][0][:1])
    check(e is not None and e <= 1e-5,
          "the card reads differently after the malformed pass")
    log(f"  malformed input: {n_raised + n_equal} mutated inputs, "
        f"{n_raised} raised a NyquistError, {n_equal} read what the CPU "
        f"read; a valid read after them equals the CPU")

    # the console entry point on the card against the CPU
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="seek_cli_", dir=ROOT))
    try:
        paths = {n: tmp / f"s.{ext}" for n, ext in (("flac", "flac"),
                                                      ("opus", "opus"))}
        for n, path in paths.items():
            path.write_bytes(datas[n])
        lines = {}
        for d in (dev, "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                check(cli.main([str(paths["flac"])], device=d) == 0,
                      f"cli on {d} failed")
                check(cli.main([str(paths["opus"]), "--info"],
                               device=d) == 0, f"cli --info on {d} failed")
            lines[str(d)] = buf.getvalue().splitlines()
        card_lines, cpu_lines = lines[str(dev)], lines["cpu"]
        check(card_lines[0] == cpu_lines[0] and card_lines[0].startswith(
            "len: "), f"cli: {card_lines[0]!r} vs {cpu_lines[0]!r}")
        info = (f"{rows['opus']['reader']}: {rows['opus']['total']} "
                f"samples/ch")
        check(card_lines[2] == cpu_lines[2] == info,
              f"cli --info: {card_lines[2]!r}")
        log(f"  cli on the card: {card_lines[0]!r} as on the CPU; --info "
            f"{card_lines[2]!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 11 took {phase_s:.1f} s; K1 launches in the Opus seeks "
        f"{launches}")
    return {"readers": rows, "http": http_rows, "k1_launches": launches,
            "malformed": {"raised": n_raised, "equal_cpu": n_equal},
            "phase_s": phase_s, "card": card}


# ----------------------------------------------------------------------
# phase 12: the sharded decode step, the profiler and the flag surface
# ----------------------------------------------------------------------

def phase12_mesh(comb, card, dev):
    """The entry module's steps on the card (K1 in the shard), the card
    against gloo ranks on the CPU, NCCL across cards where there are
    several, the stage profiler, the peaks, a trace and the counters."""
    import shutil
    import tempfile

    from libnyquist_torch import config, entry
    from libnyquist_torch.utils import profiling

    t_phase = time.perf_counter()
    log("phase 12: the sharded decode step, the profiler and the flag "
        "surface")
    step, args = entry.entry(device=dev)
    got = step(*args)
    cstep, cargs = entry.entry(device="cpu")
    ref = cstep(*cargs)
    err = max(float((g.cpu() - r).abs().max()) / max(float(r.abs().max()),
                                                    1.0)
              for g, r in zip(got, ref))
    check(err <= 1e-5, f"entry() on the card vs the CPU: {err:.3e}")
    entry_ms = cuda_ms(lambda: step(*args), reps=7)
    log(f"  entry() step (4 rows x 8 frames): card vs CPU {err:.2e} of "
        f"max(|ref|, 1); {entry_ms:.3f} ms by CUDA events")

    # the sharded step at the serving shape, K1 in its shard
    rows, F = MESH_SERVE
    captured = []
    plain = entry.comb_ops.comb_filter

    def capture(*a):
        captured.append(tuple(t.clone() for t in a))
        return plain(*a)

    entry.comb_ops.comb_filter = capture
    comb.comb_filter_cuda.launches = 0
    try:
        t0 = time.perf_counter()
        out, mesh = entry.sharded_decode_step(1, rows=rows, F=F, device=dev)
        step_s = time.perf_counter() - t0
    finally:
        entry.comb_ops.comb_filter = plain
    launches = comb.comb_filter_cuda.launches
    check(launches > 0, "the sharded step launched no comb kernel")
    check(launches == len(captured) == mesh[1],
          f"the sharded step launched K1 {launches} times for sp = "
          f"{mesh[1]}")
    check(out.shape == (rows, F * 960) and bool(np.isfinite(out).all()),
          f"sharded step output {out.shape}")
    k_args = captured[0]
    B, n = k_args[2].shape
    ae, re, taken = compare_comb(
        comb, k_args, f"in the sharded step ({B} rows x {n} chunks)")
    k_ms = cuda_ms(lambda: comb.comb_filter_cuda(*k_args), reps=7)
    nbytes, flops = comb_work(B, n)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    k_cost = profiling.op_cost(comb.comb_filter_cuda, *k_args)
    # the wrapper reports its inputs and its output y read or written
    # once; the new history is a copy of y's last HIST samples a row
    reported = sum(t.nbytes for t in k_args) + k_args[0].nbytes
    hist_copy = 2 * 4 * B * comb.HIST
    check(k_cost.get("bytes") == reported + hist_copy,
          f"op_cost of K1 {k_cost} is not the kernel's {reported} bytes "
          f"and the {hist_copy}-byte history copy")
    log(f"  op_cost of K1 in the shard: {k_cost['bytes'] / 1e6:.2f} MB = "
        f"the kernel's reported {reported / 1e6:.2f} MB + the history "
        f"copy {hist_copy / 1e6:.2f} MB (the function's bytes "
        f"{nbytes / 1e6:.2f} MB)")
    fn, fn_args, _ = entry.sharded_decode_step(1, rows=rows, F=F,
                                               return_fn=True, device=dev)
    step_ms = cuda_ms(lambda: fn(*fn_args), reps=7)
    log(f"  sharded_decode_step(1, rows={rows}, F={F}) on the card: "
        f"{step_s:.2f} s host wall (inputs made and uploaded, one step); "
        f"the local step {step_ms:.3f} ms by CUDA events; "
        f"K1 {launches} launch(es), kernel {k_ms:.3f} ms by CUDA events "
        f"(bound {bound:.4f} ms), {int(taken.max())} steps in the slowest "
        f"row; {card}")
    del captured, k_args, fn, fn_args

    # the card's world 1 against 8 gloo ranks on the CPU
    rows, F = MESH_SMALL
    one, _ = entry.sharded_decode_step(1, rows=rows, F=F, device=dev)
    t0 = time.perf_counter()
    cpu8, mesh8 = entry.sharded_decode_step(8, rows=rows, F=F, device="cpu")
    gloo_s = time.perf_counter() - t0
    scale = max(float(np.abs(cpu8).max()), 1.0)
    e8 = float(np.abs(one - cpu8).max()) / scale
    check(mesh8 == (2, 2, 2) and e8 <= 1e-5,
          f"card world 1 vs 8 gloo ranks {mesh8}: {e8:.3e}")
    log(f"  world 1 on the card vs 8 gloo ranks {mesh8} on the CPU at "
        f"({rows}, {F}): {e8:.2e} of max(|ref|, 1); the spawn and step "
        f"{gloo_s:.1f} s")
    n_cards = torch.cuda.device_count()
    nccl_tool = load_tool("mesh_nccl_check")
    # the serving mesh bit-equal to world 1: each dp slice's rows through
    # the step a serving rank runs, on card 0 with singleton axes
    slices, layouts = {}, {}
    for shape in (MESH_SMALL, MESH_SERVE):
        slices[shape] = nccl_tool.dp_slices(*shape, dps=(2, 4, 8),
                                            device=dev)
        others = layouts[shape] = nccl_tool.other_layouts(*shape, 4, dev)
        for dp, (equal, e) in slices[shape].items():
            check(equal, f"serving mesh ({dp}, 1, 1) at {shape}: a dp "
                  f"slice is {e:.3e} off world 1, not bit-equal")
        log(f"  serving mesh (dp, 1, 1) at {shape}, dp 2, 4, 8: every dp "
            f"slice's rows torch.equal to world 1's on the card; a "
            f"quarter of the rows as one product against the same rows "
            f"of the product over all, bit-equal: "
            + ", ".join(f"{k} {eq} ({e:.2e})"
                        for k, (eq, e) in others.items()) + f"; {card}")
    nccl = None
    if n_cards >= 2:
        nccl = [nccl_tool.run_case(nccl_tool.ranks_for(n_cards), rows, F,
                                   serving=serving)
                for serving in (False, True)]
        for row in nccl:
            log(f"  {row['ranks']} NCCL ranks {row['mesh']} on "
                f"{row['ranks']} cards vs world 1 at ({rows}, {F}): "
                f"{row['err']:.2e}, bit-equal {row['bit_equal']}; K1 "
                f"launches a rank {row['k1_launches']}; "
                f"{row['wall_s']:.1f} s with the spawn")
    else:
        log("  collectives on the card were not run (1 card): NCCL takes "
            "one card a rank; tools/mesh_nccl_check.py runs them on a "
            "machine with several")
    log(f"  {nccl_tool.check_too_many_ranks(n_cards)}")

    # the stage profiler on the card
    tool = load_tool("opus_stream")
    pkts, _ = tool.cycle_packets(tool.read_cases(), SERVE_CASES,
                                 PROFILE_PACKETS)
    data = tool.ogg_opus(pkts, tool.opus_head(2), 0x4E5D0000)
    prof = profiling.profile_opus_load(data, device=dev)
    names = [nm for nm, _ in prof.stages]
    check(names == ["ogg scan + TOC split", "entropy decode (C)",
                    "frame marshalling", "synthesis (GEMM+comb)",
                    "gain + trim"], f"profile stages {names}")
    log(f"  profile_opus_load on the card, {PROFILE_PACKETS} packets "
        f"({len(data)} bytes, {PROFILE_PACKETS * 0.02:.0f} s stereo):")
    for line in prof.report().splitlines():
        log(f"    {line}")

    gbps, tflops = profiling.device_peak_gbps(), profiling.device_peak_tflops()
    check(gbps is not None and tflops is not None,
          f"no published peaks for {torch.cuda.get_device_name(0)!r}")
    log(f"  peaks by name: {gbps} GB/s, {tflops} TFLOP/s float32 for "
        f"{torch.cuda.get_device_name(0)!r}; nvidia-smi: {card}")
    cost = profiling.op_cost(step, *args)
    check(cost.get("flops", 0) > 0 and cost.get("bytes", 0) > 0,
          f"op_cost of the entry step: {cost}")
    log(f"  op_cost of the entry step: {cost['flops'] / 1e9:.3f} GFLOP "
        f"(products only), {cost['bytes'] / 1e6:.1f} MB unfused; "
        f"{profiling.flops_report(cost['flops'], entry_ms / 1e3)}")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="trace_", dir=ROOT))
    try:
        with profiling.device_trace(str(tmp)):
            step(*args)
            torch.cuda.synchronize()
        files = list(tmp.glob("trace_*.json"))
        check(len(files) == 1, f"device_trace wrote {files}")
        events = json.loads(files[0].read_text()).get("traceEvents", [])
        names = [e.get("name", "") for e in events
                 if e.get("cat") == "kernel"]
        warm = sum(1 for nm in names if "spin" in nm)
        kernels = len(names) - warm
        check(kernels > 0 and any("comb" in nm for nm in names),
              f"device_trace of the entry step holds {kernels} kernel "
              f"events (K1 among them: "
              f"{any('comb' in nm for nm in names)})")
        log(f"  device_trace of the entry step: {files[0].stat().st_size} "
            f"bytes, {len(events)} events, {kernels} device kernel events "
            f"with K1; the warm-up lost "
            f"{profiling.WARMUP_KERNELS - warm} of its "
            f"{profiling.WARMUP_KERNELS} kernels")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  config: {config.current()}")
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 12 took {phase_s:.1f} s; K1 launches in the sharded step "
        f"{launches}")
    return {"entry_err": err, "entry_ms": entry_ms, "k1_launches": launches,
            "k1_ms": k_ms, "k1_err": [ae, re], "k1_bound_ms": bound,
            "step_s": step_s, "step_ms": step_ms, "gloo_err": e8,
            "gloo_s": gloo_s,
            "dp_slices": {str(k): v for k, v in slices.items()},
            "other_layouts_dp4": {str(k): v for k, v in layouts.items()},
            "k1_op_cost_bytes": k_cost["bytes"],
            "nccl": nccl, "profile": prof.stages, "peaks": [gbps, tflops],
            "op_cost": cost, "trace_kernel_events": kernels,
            "trace_warmup_lost": profiling.WARMUP_KERNELS - warm,
            "phase_s": phase_s, "card": card}


# ----------------------------------------------------------------------
# phase 13: malformed input through every route of load()
# ----------------------------------------------------------------------
MALFORMED_CORRUPTIONS = 4         # seeded 8-byte mutations an input
MALFORMED_HEADER_FLIPS = 3        # single flipped bytes in the first 96


def malformed_decode(nqt, data, ext, dev):
    """(float64 samples or None, the NyquistError's text or None)."""
    from libnyquist_torch.errors import NyquistError

    try:
        a = nqt.load(data, extension=ext, device=dev)
    except NyquistError as e:
        return None, f"{type(e).__name__}: {e}"
    return np.asarray(a.samples, np.float64), None


def phase13_malformed(nqt, card, dev):
    """Each route's valid inputs, truncated and mutated, through load()
    on the card against the CPU; then a valid decode of the route on
    the card again."""
    tool = load_tool("malformed_inputs")
    t_phase = time.perf_counter()
    inputs = tool.inputs()
    routes = {}
    for name, inp in inputs.items():
        routes.setdefault(inp.route, []).append(name)
    log(f"phase 13: malformed input, {len(inputs)} inputs over "
        f"{len(routes)} routes of load()")
    rows = {}
    for route, names in routes.items():
        t0 = time.perf_counter()
        n = raised = decoded = 0
        worst_err = 0.0
        for name in names:
            inp = inputs[name]
            rng = np.random.default_rng(sum(name.encode()))
            flips = tool.header_flips(inp.data)
            pick = rng.choice(len(flips), MALFORMED_HEADER_FLIPS,
                              replace=False)
            muts = (tool.truncations(inp.data)
                    + tool.corruptions(inp.data, sum(name.encode()) + 1,
                                       MALFORMED_CORRUPTIONS)
                    + [flips[i] for i in sorted(pick)])
            for k, data in enumerate(muts):
                where = f"malformed {route}: {name} #{k}"
                try:
                    got, g_err = malformed_decode(nqt, data, inp.ext, dev)
                except Exception as e:          # not a NyquistError
                    fail(f"{where} on the card raised {type(e).__name__}: "
                         f"{e}")
                ref, r_err = malformed_decode(nqt, data, inp.ext, "cpu")
                n += 1
                if got is None:
                    check(ref is None, f"{where}: the card raised "
                          f"{g_err!r}, the CPU decoded")
                    check("CUDA" not in g_err, f"{where}: {g_err}")
                    raised += 1
                    continue
                check(ref is not None and got.shape == ref.shape,
                      f"{where}: the card decoded {got.shape}, the CPU "
                      f"{'raised ' + repr(r_err) if ref is None else ref.shape}")
                e = float(np.abs(got - ref).max()) if got.size else 0.0
                if inp.tol is None:
                    check(np.array_equal(got, ref, equal_nan=True),
                          f"{where}: card vs CPU {e}")
                else:
                    e /= max(float(np.abs(ref).max()) if ref.size else 0.0,
                             1.0)
                    check(e <= 1e-5, f"{where}: card vs CPU {e:.3e}")
                worst_err = max(worst_err, e)
                decoded += 1
        try:
            torch.cuda.synchronize()
        except Exception as e:
            fail(f"malformed {route}: the card does not synchronize after "
                 f"the pass: {type(e).__name__}: {e}")
        name = names[0]
        inp = inputs[name]
        got, g_err = malformed_decode(nqt, inp.data, inp.ext, dev)
        ref, _ = malformed_decode(nqt, inp.data, inp.ext, "cpu")
        check(got is not None and ref is not None and got.shape == ref.shape,
              f"malformed {route}: {name} does not decode on the card after "
              f"the pass ({g_err})")
        e_valid = float(np.abs(got - ref).max()) / max(
            float(np.abs(ref).max()), 1.0)
        check(e_valid == 0.0 if inp.tol is None else e_valid <= 1e-5,
              f"malformed {route}: {name} after the pass, card vs CPU "
              f"{e_valid:.3e}")
        route_s = time.perf_counter() - t0
        rows[route] = dict(inputs=n, raised=raised, decoded=decoded,
                           worst_err=worst_err, valid_err=e_valid,
                           seconds=route_s)
        log(f"  {route}: {n} inputs from {len(names)} file(s), {raised} "
            f"raised a NyquistError on the card and the CPU, {decoded} "
            f"decoded as on the CPU (worst {worst_err:.2e}); then "
            f"{name} on the card vs the CPU {e_valid:.2e}; {route_s:.1f} s")
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 13 took {phase_s:.1f} s, "
        f"{sum(r['inputs'] for r in rows.values())} mutated inputs; {card}")
    return {"routes": rows, "phase_s": phase_s, "card": card}


# ----------------------------------------------------------------------
# phase 14: the port's bench on the card
# ----------------------------------------------------------------------
BENCH_STREAMS = 8
BENCH_TRIALS = 3
ROUTE_FIELDS = ("replay_s_graph", "replay_s_eager", "full_s_graph",
                "full_s_eager")
BENCH_FIELDS = ("host_s", "dev_s", "serial_s", "pipelined_s", "gil_gap_pct",
                "staging_s", "device_gflops", "device_gbytes", "mfu_pct",
                "hbm_util_pct", "device_busy_pct", "libopus_err",
                "batch_vs_stream0")


def finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def phase14_bench(card, dev):
    """libnyquist_torch.bench's headline at K = 8 with 3 trials and its
    stage split by either route, in this process; then the scaling
    table's world-1 row on card 0."""
    from libnyquist_torch import bench
    from libnyquist_torch.utils import profiling

    t_phase = time.perf_counter()
    log(f"phase 14: the port's bench, K={BENCH_STREAMS} streams of the bench "
        f"stream, {BENCH_TRIALS} trials, and the scaling row of world 1")
    prep = bench._prep_opus_device_batch(BENCH_STREAMS, dev)
    check(prep is not None, "the bench stream must take the trace path")
    head = bench.bench_e2e_opus_iy(BENCH_STREAMS, dev, prep=prep,
                                   trials=BENCH_TRIALS)
    splits, side = bench.route_splits(BENCH_STREAMS, dev, prep)
    head["config"].update(stage_split=splits["graph"],
                          stage_split_eager=splits["eager"], **side)
    cfg = head["config"]
    check(head["metric"] == "opus_e2e_decode_realtime_x"
          and finite(head["value"]) and head["value"] > 0,
          f"bench headline {head['metric']} = {head['value']}")
    for key in BENCH_FIELDS:
        check(finite(cfg.get(key)), f"bench config {key} = {cfg.get(key)}")
    for route, split in splits.items():
        for key, v in split.items():
            check(finite(v), f"bench stage split ({route}) {key} = {v}")
    check(isinstance(cfg["hidden_syncs_per_batch"], int),
          f"bench hidden syncs {cfg['hidden_syncs_per_batch']}")
    check(cfg["route"] == "graph", f"bench route {cfg['route']}")
    for key in ROUTE_FIELDS:
        check(finite(cfg.get(key)), f"bench config {key} = {cfg.get(key)}")
    check(cfg["trace_warmup_lost"] < profiling.WARMUP_KERNELS,
          "the bench's trace lost its whole warm-up")
    check(cfg["k1_per_batch"] == prep["n_steps"]
          and cfg["k2_per_batch"] == BENCH_STREAMS,
          f"a bench batch launched K1 {cfg['k1_per_batch']} times (steps "
          f"{prep['n_steps']}) and K2 {cfg['k2_per_batch']} (streams "
          f"{BENCH_STREAMS})")
    log(json.dumps(head))
    tool = load_tool("mesh_nccl_check")
    scaling = tool.scaling_rows([1], *tool.SCALING, device="cuda")
    for row in scaling:
        check(all(finite(v) and v > 0 for key in
                  ("gflops_per_rank", "gb_per_rank", "step_ms")
                  for v in row[key]), f"scaling row {row}")
        check(row["k1_launches"] == [1] and row["collectives"] == [{}],
              f"scaling world 1, {row['mesh']} mesh: K1 {row['k1_launches']},"
              f" collectives {row['collectives']}")
    log(json.dumps(scaling))
    log(tool.scaling_table(scaling, card))
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 14 took {phase_s:.1f} s; pipelined x{head['value']} on "
        f"{card}")
    from libnyquist_torch.runtime import serving
    serving.clear_programs()
    return {"headline": head, "scaling": scaling, "phase_s": phase_s}


# ----------------------------------------------------------------------
# phase 15: the headline batch eager and as one captured CUDA graph
# ----------------------------------------------------------------------
REPEAT_BATCHES = 16               # the key census's batches of K_STREAMS
REPEAT_FRAMES = 500               # 10 s segments


def kept_kernel_inputs(comb, rot, run, n_comb, n_rot):
    """run() with the K1 and K2 dispatchers wrapped to keep copies of the
    arguments of K1's first n_comb launches and K2's first n_rot: the
    kernels' inputs at the main path's shapes. Returns (run(), K1's,
    K2's)."""
    kept = {"comb": [], "rot": []}
    orig = comb.comb_filter, rot.rotate_plane

    def keep(name, fn, n):
        def wrapped(*args):
            if len(kept[name]) < n:
                kept[name].append([a.clone() if torch.is_tensor(a) else a
                                   for a in args])
            return fn(*args)
        return wrapped

    comb.comb_filter = keep("comb", orig[0], n_comb)
    rot.rotate_plane = keep("rot", orig[1], n_rot)
    try:
        out = run()
    finally:
        comb.comb_filter, rot.rotate_plane = orig
    check(len(kept["comb"]) == n_comb and len(kept["rot"]) == n_rot,
          f"the eager route launched K1 {len(kept['comb'])} times and K2 "
          f"{len(kept['rot'])}, fewer than kept")
    return out, kept["comb"], kept["rot"]


def kernel_in_graph(name, wrapper, plain, args_a, args_b):
    """One kernel captured alone into a CUDA graph on the main path's
    inputs ``args_a`` and replayed on ``args_b`` (other inputs of the
    same shapes): the replay's outputs equal the eager launch's on
    ``args_b`` bit for bit, lie within 1e-5 of max|ref| of its plain
    version's and differ from the capture's own."""
    from libnyquist_torch.runtime import graphs

    check(any(torch.is_tensor(a) and not torch.equal(a, b)
              for a, b in zip(args_a, args_b)),
          f"{name}: the replay's inputs equal the capture's")
    prog = graphs.CapturedProgram(wrapper, *args_a)
    tup = (lambda v: v if isinstance(v, tuple) else (v,))
    at_a = [t.clone() for t in tup(prog(*args_a))]
    got = tup(prog(*args_b))
    eager, ref = tup(wrapper(*args_b)), tup(plain(*args_b))
    torch.cuda.synchronize()
    check(all(torch.equal(g, e) for g, e in zip(got, eager)),
          f"{name} replayed on new inputs differs from its eager launch")
    check(not all(torch.equal(g, a) for g, a in zip(got, at_a)),
          f"{name} replayed on new inputs gave the capture's outputs")
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    ae, re = max(e[0] for e in errs), max(e[1] for e in errs)
    check(re <= 1e-5, f"{name} in a graph against its plain version: rel "
          f"err {re:.3e}")
    log(f"  {name} captured alone, replayed on other inputs: max|d| "
        f"{ae:.3e} ({re:.3e} of max|ref|) against its plain version, equal "
        f"to its eager launch")
    return ae


def other_batch(streams, synth, K):
    """The batch with new values under the same static keys: stream k's
    band gains scaled by 1 - 0.03 (k + 1) and its rotation angles by
    1 - 0.02 (k + 1), the postfilter gains halved."""
    out = []
    for k, (arrs, key) in enumerate(streams):
        arrs = dict(arrs)
        arrs["gains"] = arrs["gains"] * (1 - 0.03 * (k + 1))
        arrs["rot_th"] = arrs["rot_th"] * (1 - 0.02 * (k + 1))
        out.append((arrs, key))
    synth = dict(synth, gA=synth["gA"] * 0.5, gB1=synth["gB1"] * 0.5)
    return out, synth


def key_census(seed=0):
    """The program keys of a traffic of distinct content: REPEAT_BATCHES
    batches of K_STREAMS streams, each a REPEAT_FRAMES-frame segment of a
    SERVE_CASES case (drawn at random, cycled from a random packet). A
    batch's program key is its streams' static keys in order (the
    segment length fixes the rest). Returns the share of batches whose
    key an earlier one had (as drawn, and with each batch's streams
    sorted by key, as a batcher could order them), of streams whose key
    an earlier one had, and the distinct stream keys."""
    from libnyquist_torch.formats.opus import trace_celt_packets

    rng = np.random.default_rng(seed)
    cases = {i: read_case(i)[:2] for i in SERVE_CASES}
    seen_b, seen_sorted, seen_s = set(), set(), set()
    rep_b = rep_sorted = rep_s = 0
    for _ in range(REPEAT_BATCHES):
        keys = []
        for _ in range(K_STREAMS):
            ch, pkts = cases[SERVE_CASES[rng.integers(len(SERVE_CASES))]]
            o = int(rng.integers(len(pkts)))
            cyc = [pkts[(o + j) % len(pkts)] for j in range(REPEAT_FRAMES)]
            key = trace_celt_packets(cyc, ch)[2]
            rep_s += key in seen_s
            seen_s.add(key)
            keys.append(key)
        rep_b += tuple(keys) in seen_b
        seen_b.add(tuple(keys))
        ordered = tuple(sorted(keys, key=repr))
        rep_sorted += ordered in seen_sorted
        seen_sorted.add(ordered)
    return {"batches": REPEAT_BATCHES, "streams": REPEAT_BATCHES * K_STREAMS,
            "batch_repeat_share": rep_b / REPEAT_BATCHES,
            "sorted_batch_repeat_share": rep_sorted / REPEAT_BATCHES,
            "stream_repeat_share": rep_s / (REPEAT_BATCHES * K_STREAMS),
            "distinct_stream_keys": len(seen_s)}


def phase15_graph(comb, rot, card, dev, rows, bench_row):
    """The headline batch (8 streams of the bench stream) by the eager
    route and by the captured one: captured on the batch, replayed on
    another batch of the same static keys (other_batch) and on the batch
    again, bit-equal to eager on each; no hidden synchronisation in a
    captured batch; the launches a replay holds by the wrappers' counts
    and by a trace; K1 and K2 captured alone and replayed on other
    inputs against their plain versions; phase 14's device times by
    route; the key census of a traffic of distinct content."""
    from libnyquist_torch import bench
    from libnyquist_torch.runtime import serving

    t_phase = time.perf_counter()
    log(f"phase 15: the headline batch (K={BENCH_STREAMS}) eager and as "
        f"one captured CUDA graph")
    prep = bench._prep_opus_device_batch(BENCH_STREAMS, dev)
    check(prep is not None, "the bench stream must take the trace path")
    K, n_steps = prep["K"], prep["n_steps"]
    batch_a = (prep["streams"], prep["synth"])
    batch_b = other_batch(*batch_a, K)

    def run(batch, route):
        return serving.run_stream_batched(
            batch[0], batch[1], K, prep["CC"], n_steps, prep["f_chunk"],
            route=route)

    (acc_a, pcm_a), comb_args, rot_a = kept_kernel_inputs(
        comb, rot, lambda: run(batch_a, "eager"), 3, 1)
    (acc_b, pcm_b), _, rot_b = kept_kernel_inputs(
        comb, rot, lambda: run(batch_b, "eager"), 0, 2)
    serving.clear_programs()
    t0 = time.perf_counter()
    acc_c, pcm_c = run(batch_a, "graph")
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    comb.comb_filter_cuda.launches = 0
    rot.rotate_plane_cuda.launches = 0
    acc_g, pcm_g = run(batch_b, "graph")
    torch.cuda.synchronize()
    launches = {"comb_filter": comb.comb_filter_cuda.launches,
                "rotate_plane": rot.rotate_plane_cuda.launches}
    check(launches == {"comb_filter": n_steps, "rotate_plane": K},
          f"a captured batch launched {launches}, expected K1 {n_steps} "
          f"and K2 {K}")
    check(len(serving._PROGRAMS) == 1, "batch B was captured anew: its "
          "program key differs from batch A's")
    acc_a2, pcm_a2 = run(batch_a, "graph")
    same = all(torch.equal(x, y) for x, y in (
        (pcm_a, pcm_c), (acc_a, acc_c), (pcm_b, pcm_g), (acc_b, acc_g),
        (pcm_a, pcm_a2), (acc_a, acc_a2)))
    d = (pcm_g - pcm_b).abs().max().item()
    check(same, f"captured PCM differs from eager (batch B: max|d| "
          f"{d:.3e})")
    moved = [not torch.equal(pcm_g[k::K], pcm_a[k::K]) for k in range(K)]
    check(all(moved), f"a replay on batch B gave batch A's PCM for streams "
          f"{[k for k in range(K) if not moved[k]]}")
    check(not torch.equal(pcm_g[1::K], pcm_g[0::K]),
          "batch B's streams 0 and 1 are equal")
    check(bool(torch.isfinite(pcm_g).all()), "non-finite captured PCM")
    log(f"  captured on batch A in {capture_s:.3f} s; replayed on batch B "
        f"(same keys, new values: every stream's PCM moved), then on A: "
        f"PCM {tuple(pcm_g.shape)} bit-equal to eager each time; a replay "
        f"launches {launches}")
    del pcm_a, pcm_b, pcm_c, pcm_g, pcm_a2
    trace = profile_main_path(lambda: run(batch_a, "graph"), card)
    expected = {"comb_filter": n_steps, "rotate_plane": K}
    for name, n in expected.items():
        got = trace["traced_kernels"][name]["records"]
        check(got == n, f"the traced replay holds {got} {name} kernel "
              f"records, expected {n}")
    syncs, sites = bench._hidden_syncs(lambda: run(batch_a, "graph"))
    eager_syncs, eager_sites = bench._hidden_syncs(
        lambda: run(batch_a, "eager"))
    log(f"  hidden syncs a batch: captured {syncs} {sites}, eager "
        f"{eager_syncs} {eager_sites}")
    check(syncs == 0, f"the captured batch made {syncs} hidden syncs: "
          f"{sites}")
    cfg = bench_row["headline"]["config"]
    log(f"  replay device s (phase 14's split, median of "
        f"{bench.SPLIT_ROUNDS}): eager {cfg['replay_s_eager']:.4f}, captured "
        f"{cfg['replay_s_graph']:.4f}; whole program: eager "
        f"{cfg['full_s_eager']:.4f}, captured {cfg['full_s_graph']:.4f} on "
        f"{card}")
    k1_err = kernel_in_graph("K1", comb.comb_filter_cuda,
                             comb.comb_filter_stream_ref, comb_args[1],
                             comb_args[2])

    def rot_plain(x, pk, th, g, sigmas, band_off):
        W = pk.shape[1]
        y = rot.rotate_plane_ref(*(t.t().contiguous() for t in
                                   (x[:, :W], pk, th, g)), sigmas, band_off)
        return torch.cat([y.t(), x[:, W:]], dim=1)

    k2_err = kernel_in_graph("K2", rot.rotate_plane_cuda, rot_plain,
                             rot_a[0], rot_b[1])
    serving.clear_programs()
    census = key_census()
    log(f"  key census of distinct content ({census['batches']} batches of "
        f"{K_STREAMS} segments of {REPEAT_FRAMES} frames): batches that "
        f"repeat a program key {census['batch_repeat_share']:.3f} (sorted "
        f"by key {census['sorted_batch_repeat_share']:.3f}), streams "
        f"that repeat a static key {census['stream_repeat_share']:.3f}, "
        f"{census['distinct_stream_keys']} distinct stream keys")
    for row in rows:
        k1 = row["name"] == "comb_filter"
        row["graph_max_abs_err"] = k1_err if k1 else k2_err
        row["launches_per_captured_batch"] = launches[row["name"]]
        row["graph_ms_headline"] = trace["traced_kernels"][row["name"]][
            "mean_ms"]
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 15 took {phase_s:.1f} s")
    return {"capture_s": capture_s, "launches_per_captured_batch": launches,
            "hidden_syncs_captured": syncs, "hidden_syncs_eager": eager_syncs,
            "traced_kernels": trace["traced_kernels"],
            "traced_busy_s": trace["traced_busy_s"],
            "traced_wall_s": trace["traced_wall_s"], "key_census": census,
            "phase_s": phase_s}


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
    torch.cuda.empty_cache()
    general = phase9_opus_general(nqt, comb, card, dev)
    torch.cuda.empty_cache()
    encode = phase10_encode(nqt, comb, card, dev)
    torch.cuda.empty_cache()
    seek = phase11_seek(nqt, comb, card, dev)
    torch.cuda.empty_cache()
    mesh = phase12_mesh(comb, card, dev)
    torch.cuda.empty_cache()
    malformed = phase13_malformed(nqt, card, dev)
    torch.cuda.empty_cache()
    bench_row = phase14_bench(card, dev)
    graph_row = phase15_graph(comb, rot, card, dev, rows, bench_row)
    for row in rows:
        if row["name"] == "comb_filter":
            row["launches_opus_general"] = general["k1_launches"]
            row["launches_encode_round_trips"] = encode["k1_launches"]
            row["launches_seek"] = seek["k1_launches"]
            row["launches_mesh"] = mesh["k1_launches"]
            row["ms_mesh"] = mesh["k1_ms"]
    log(json.dumps({"serving": serve, "mp3": mp3, "mpc": mpc,
                    "vorbis": vorbis, "pcm": pcm_rows, "lossless": lossless,
                    "opus_general": general, "encode": encode,
                    "seek": seek, "mesh": mesh, "malformed": malformed,
                    "bench": bench_row, "graph": graph_row,
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
