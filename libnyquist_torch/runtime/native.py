"""Native host-ops loader: builds and binds the port's two host libraries.

* ``libcelthost.so`` (``lib()``): the CELT entropy decode (range
  decoder, bit allocation, PVQ index decode), the bits-only trace decode
  with its leaf packer, the Ogg/Opus packet scan and the one-pass Ogg
  packet collector the Vorbis decoder uses;
* ``libcodechost.so`` (``codec_lib()``): the MP3 Layer III whole-stream
  entropy decode, the Musepack SV7/SV8 frame reader, the Vorbis
  packet decode (floor 1, residues, coupling), the whole-stream FLAC
  frame decode and the WavPack entropy words, decorrelation passes
  (scalar, and eight blocks at a time with AVX2), float restores and
  DSD block decode.

Both are branchy byte-serial work that stays on the host in C
(``libnyquist_torch/native/``), built with the system ``cc`` at first
use into ``libnyquist_torch/_build/`` and bound with ctypes. There is no
Python fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
_NATIVE_DIR = _PKG / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = ("celt_bands.c", "ogg_opus.c", "replay_pack.c")
_HEADERS = ("ecdec.h",)
CODEC_SOURCES = ("mp3_stream.c", "mp3_huff.c", "mpc_frame.c", "vorbis_res.c",
                 "flac_stream.c", "wv_words.c", "wv_simd.c", "wv_dsd.c")
_LIB = None
_CODEC_LIB = None
_LOCK = threading.Lock()


def _build(name: str, sources, headers) -> pathlib.Path:
    srcs = [_NATIVE_DIR / s for s in sources]
    deps = srcs + [_NATIVE_DIR / h for h in headers]
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and all(
        out.stat().st_mtime >= d.stat().st_mtime for d in deps
    ):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a per-process temp file and rename it into place
    # atomically, so concurrent builders (parallel test workers) never
    # load a half-written library. -march=native is safe because the
    # library is always built on the machine that runs it; retry without
    # it for compilers that reject the flag.
    tmp = out.with_name(f".lib{name}.{os.getpid()}.so")
    errors = []
    for extra in (["-march=native"], []):
        cmd = ["cc", "-O3", *extra, "-fPIC", "-shared",
               *map(str, srcs), "-o", str(tmp), "-lm"]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(getattr(e, "stderr", None) or str(e))
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        return out
    raise RuntimeError(
        f"building the host library lib{name}.so failed:\n"
        + "\n".join(errors))


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_i32, c_i64 = ctypes.c_int, ctypes.c_int32, ctypes.c_int64
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    L.celt_decode_stream.restype = c_i64
    L.celt_decode_stream.argtypes = [
        ctypes.c_char_p, i64p, i64p,            # payload, offs, lens
        i32p, i32p, i32p, c_i64,                # fsz, ends, chs, n
        i16p, c_int, i16p, i16p,                # eBands, nb, logN, ci
        ctypes.c_char_p, ctypes.c_char_p,       # cache_bits, cache_caps
        ctypes.c_char_p, c_int,                 # allocVectors, nbAV
        f64p, i32p,                             # eMeans, prob_model
        c_int, c_int,                           # shortMdctSize, effEBands
        f64p, f64p, f64p, f64p, i64p,           # state + rng
        c_int, c_int,                           # CC, CCout
        c_int, c_int,                           # downsample, start
        c_i32, f32p,                            # nmax, freq_out
        i32p, i32p, f64p, i32p, i32p,           # sb, pfp, pfg, pft, sil
    ]
    # The bits-only trace decode: celt_decode_stream's arguments up to
    # the state, then the trace outputs in the order of its C prototype
    # (native/celt_bands.c celt_decode_stream_trace).
    L.celt_decode_stream_trace.restype = c_i64
    L.celt_decode_stream_trace.argtypes = [
        ctypes.c_char_p, i64p, i64p,            # payload, offs, lens
        i32p, i32p, i32p, c_i64,                # fsz, ends, chs, n
        i16p, c_int, i16p, i16p,                # eBands, nb, logN, ci
        ctypes.c_char_p, ctypes.c_char_p,       # cache_bits, cache_caps
        ctypes.c_char_p, c_int,                 # allocVectors, nbAV
        f64p, i32p,                             # eMeans, prob_model
        c_int, c_int,                           # shortMdctSize, effEBands
        f64p, f64p, f64p, f64p, i64p,           # state + rng
        c_int, c_int,                           # CC, CCout
        c_int, c_int,                           # downsample, start
        i32p, i32p, f64p, i32p, i32p,           # sb, pfp, pfg, pft, sil
        i64p,                                   # tcaps
        i32p, i8p, i8p, i8p,                    # lf frame, band, call, type
        i16p, i16p, i32p, i16p,                 # lf off, len, k, stride
        f64p, u32p, i64p,                       # lf gain, seed, iy_off
        i16p,                                   # iy_heap
        u8p, i32p, i8p,                         # bd mode, eff_lb, tf
        i16p, i16p, i16p,                       # bd imid, iside, itheta
        i8p, i8p, i8p,                          # bd inv, sign, cflag
        i32p, i8p, i8p, i8p,                    # ac frame, band, c, k
        u32p, f32p,                             # ac seed, r
        i32p, f32p,                             # fr_misc, fr_gains
        f32p, c_i32,                            # xs_dense, xs_nmax
        i32p, i32p, i32p,                       # rot row, col, pk
        f32p, f32p, i32p,                       # rot th, g, leaf
    ]
    L.celt_pvq_bucket_count.restype = c_i64
    L.celt_pvq_bucket_count.argtypes = [
        i8p, i16p, c_i64,                       # lf_type, lf_len, nleaf
        i32p, c_int, i64p,                      # edges, nedges, counts
    ]
    L.celt_pvq_bucket_fill.restype = None
    L.celt_pvq_bucket_fill.argtypes = [
        i8p, i16p, i32p, i8p,                   # lf type, len, frame, call
        i8p, i16p, i32p, u32p,                  # lf band, off, k, seed
        c_i64, i32p, c_int,                     # nleaf, edges, nedges
        i64p, i64p, c_i64, c_i64,               # bucket_base, band_off, nmax, F
        i32p, i32p, u32p, i32p,                 # out n, k, i, tgt
        i64p,                                   # rs_slot
    ]
    L.ogg_opus_celt_scan.restype = c_i64
    L.ogg_opus_celt_scan.argtypes = [
        ctypes.c_char_p, c_i64,                 # data, len
        ctypes.c_char_p, c_i64,                 # payload_out, cap
        i64p, i64p,                             # offs, lens
        i32p, i32p, i32p,                       # fsz, ends, chs
        c_i64, i32p,                            # max_frames, info
    ]
    L.ogg_collect_packets.restype = c_i64
    L.ogg_collect_packets.argtypes = [
        ctypes.c_char_p, c_i64,                 # data, len
        ctypes.c_char_p, c_int,                 # magic, magic_len
        ctypes.c_char_p, c_i64,                 # payload_out, cap
        i64p, i64p, c_i64,                      # offs, lens, max_packets
        i64p,                                   # info_out
    ]
    return L


def lib() -> ctypes.CDLL:
    """The bound host library, built on first call. Raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(_build("celthost", SOURCES,
                                                _HEADERS))))
        return _LIB


def _bind_codec(L: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_i32, c_i64 = ctypes.c_int, ctypes.c_int32, ctypes.c_int64
    vp = ctypes.c_void_p
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    # native/mp3_stream.c: table pointers, then the whole-stream decode
    L.mp3s_init_tables.restype = None
    L.mp3s_init_tables.argtypes = [
        vp, c_i32, vp, vp,                      # tabs, tabs_len, tab32, tab33
        vp, vp, vp,                             # tabindex, linbits, pow43
        vp, vp, vp, vp,                         # scf long, short, mixed, parts
        vp, vp, vp,                             # scfc_decode, mod, preamp
        vp, vp, vp,                             # expfrac, pan, aa
    ]
    L.mp3s_l3_stream.restype = c_i64
    L.mp3s_l3_stream.argtypes = [
        ctypes.c_char_p, c_i64, i64p, vp,       # data, len, pos (in/out), state
        vp, vp, vp,                             # grbufs, kinds, info
        c_i64, c_i32, i32p,                     # maxG, pending, flag (out)
    ]
    # native/mpc_frame.c
    L.mpc_set_tables.restype = None
    L.mpc_set_tables.argtypes = [
        i32p, ctypes.c_char_p, i64p,            # can rows/syms/meta
        i32p, i64p,                             # lut rows/meta
        i32p, i32p,                             # dc, res_bit
    ]
    L.mpc_read_frame.restype = c_i64
    L.mpc_read_frame.argtypes = (
        [ctypes.c_char_p, c_i64, i64p]          # buf, len, io
        + [c_int] * 4                           # sv7, key, max_band, ms
        + [i32p] * 11)                          # state planes
    L.mpc_read_frames_sv8.restype = c_i64
    L.mpc_read_frames_sv8.argtypes = (
        [ctypes.c_char_p, c_i64, i64p]          # buf, len, io
        + [c_int] * 4                           # n, key_first, max_band, ms
        + [i32p] * 15)                          # state planes, 4 snapshots
    # native/vorbis_res.c: the codebook registry (luts, trees, vq tables)
    # is the same nine pointers in every entry
    books = [i32p, i64p, i32p,                  # luts, lut_off, lut_w
             i32p, i64p, i32p,                  # trees, tree_off, maxlen
             f32p, i64p, i32p]                  # vqs, vq_off, dims
    L.vorbis_residue_decode.restype = None
    L.vorbis_residue_decode.argtypes = [
        ctypes.c_char_p, c_i64, i64p,           # data, nbytes, st [pos, eop]
        *books,
        c_int, c_i64, c_i64, c_i64,             # rtype, begin, end, psize
        c_int, c_int,                           # classifications, classbook
        i32p, ctypes.c_char_p,                  # books8, do_not_decode
        c_i64, c_i64, f32p,                     # ch, n2, work
    ]
    L.vorbis_floor1_decode.restype = c_i64
    L.vorbis_floor1_decode.argtypes = [
        ctypes.c_char_p, c_i64, i64p,           # data, nbytes, st
        i32p, i32p, i32p,                       # cfg, neighbors, sortidx
        *books[:6],                             # luts and trees
        f32p, c_i64, f32p,                      # fromdb, n2, curve_out
    ]
    stream_cfg = [
        c_int, c_int, c_int, c_int,             # channels, bs0, bs1, mode_bits
        i32p, c_int,                            # mode_cfg, nmodes
        i32p, i32p, i32p, i32p,                 # map meta, mux, submap, coup
        i32p, i32p, i32p, i64p,                 # floor cfgs, nbrs, sorts, off
        f32p,                                   # fromdb
        i32p, i32p,                             # res_meta, res_books8
        *books,
    ]
    L.vorbis_packet_decode.restype = c_i64
    L.vorbis_packet_decode.argtypes = [
        ctypes.c_char_p, c_i64,                 # data, nbytes
        *stream_cfg,
        f32p, i32p,                             # specs, info
    ]
    L.vorbis_stream_decode.restype = c_i64
    L.vorbis_stream_decode.argtypes = [
        ctypes.c_char_p, i64p, i64p, c_i64,     # payload, poff, plen, n
        *stream_cfg,
        c_i64, f32p, i32p,                      # specs_cap, specs_out, info_out
    ]
    # native/flac_stream.c
    L.flac_decode_stream.restype = c_i64
    L.flac_decode_stream.argtypes = [
        ctypes.c_char_p, c_i64, c_int,          # data, nbytes, stream_bps
        i32p, c_i64, c_i64,                     # out, cap_values, max_frames
        i32p, i64p,                             # work, state[4]
    ]
    # native/wv_words.c: st is [holding_one, holding_zero, zeros_acc,
    # values_written]; the words readers return the final bit position
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    c_u64 = ctypes.c_uint64
    L.wv_words_lossless.restype = c_u64
    L.wv_words_lossless.argtypes = [
        ctypes.c_char_p, c_u64, c_u64,          # buf, limit_bits, pos
        i32p, c_i64,                            # out, nvalues
        u32p, u32p, c_int,                      # medians, st, mono
    ]
    L.wv_words_hybrid.restype = c_u64
    L.wv_words_hybrid.argtypes = [
        ctypes.c_char_p, c_u64, c_u64,          # buf, limit_bits, pos
        i32p, c_i64,                            # out, nvalues
        u32p, u32p, i32p, c_int,                # medians, st, hybrid, flags
    ]
    L.wv_decorr_mono.restype = None
    L.wv_decorr_mono.argtypes = [
        c_int, c_int, i32p,                     # term, delta, weight
        i32p, i32p, c_i64,                      # samples_a, buf, nsamples
    ]
    L.wv_decorr_stereo.restype = None
    L.wv_decorr_stereo.argtypes = [
        c_int, c_int, i32p,                     # term, delta, weights[2]
        i32p, i32p, i32p, c_i64,                # samples_a, _b, buf, n
    ]
    L.wv_decode_block.restype = c_u64
    L.wv_decode_block.argtypes = [
        ctypes.c_char_p, c_u64,                 # buf, limit_bits
        i32p, c_i64,                            # out, nvalues
        u32p, u32p,                             # medians, st
        i32p, c_int, c_int,                     # hybrid state, flags, on
        c_int, i32p, i32p, i32p,                # npasses, terms, deltas, w
        i32p, i32p,                             # samples_a, samples_b
        c_int, c_int, c_i64,                    # mono, joint, block_samples
    ]
    L.wv_float_values.restype = None
    L.wv_float_values.argtypes = [
        i32p, c_i64,                            # values, n
        ctypes.c_char_p, c_u64,                 # wvx, wvx_bits
        c_int, c_int, c_int,                    # flags, shift, max_exp
        u32p,                                   # out_bits
    ]
    L.wv_float_nowvx.restype = None
    L.wv_float_nowvx.argtypes = [
        i32p, c_i64,                            # values, n
        c_int, c_int, c_int,                    # flags, shift, max_exp
        u32p,                                   # out_bits
    ]
    # native/wv_simd.c: 8 blocks' lanes; returns 0 when the CPU lacks
    # AVX2 or a term is out of range (the caller runs the scalar passes)
    L.wv_decorr_simd8.restype = c_int
    L.wv_decorr_simd8.argtypes = [
        c_int, i32p, i32p, i32p,                # npasses, terms, deltas, w
        i32p, i32p,                             # samples_a, samples_b
        ctypes.POINTER(vp), c_i64,              # lane buffers, nsamples
        c_int, c_int,                           # mono, joint
    ]
    # native/wv_dsd.c
    L.wv_dsd_decode.restype = c_i64
    L.wv_dsd_decode.argtypes = [
        ctypes.c_char_p, c_i64, c_int, c_int,   # data, len, mode, stereo
        c_i64, u8p,                             # nframes, out
    ]
    return L


def codec_lib() -> ctypes.CDLL:
    """The bound MP3/Musepack/Vorbis/FLAC/WavPack host library, built on
    first call. Raises on failure. Its table setters are called once by
    the format modules (``formats/mp3.py``, ``formats/musepack.py``),
    each under its lock."""
    global _CODEC_LIB
    with _LOCK:
        if _CODEC_LIB is None:
            _CODEC_LIB = _bind_codec(ctypes.CDLL(str(
                _build("codechost", CODEC_SOURCES, ()))))
        return _CODEC_LIB
