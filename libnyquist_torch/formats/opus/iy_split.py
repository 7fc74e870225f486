"""iy-split: host integer trace of the CELT PVQ value plane.

The native host decode (native/celt_bands.c) can run bits-only — range
decode, allocation, and cwrsi only where the values steer control flow —
and emit an integer trace; the float value plane (leaf scaling,
spreading rotations, haar merges, fold fills, stereo merge,
anti-collapse, denormalise) is replayed from the trace on the device
(ops/celt_replay.py).

Reference spec: celt/bands.c quant_all_bands (value plane), vq.c,
cwrs.c; the host half here is native/celt_bands.c
celt_decode_stream_trace. NumPy and C only: nothing here touches torch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from .celt_host import (
    _F32P, _F64P, _I32P, _I64P, CeltDecoderState, _mode_ptrs, _native_celt,
)
from .celt_tables import mode48000

EPSILON = 1e-15
LF_PVQ, LF_FOLD, LF_NOISE, LF_N1, LF_PVQ_IDX = 0, 1, 2, 4, 5
SPREAD_NONE = 0
SPREAD_FACTOR = (15, 10, 5)
LCG_A = np.uint32(1664525)
LCG_B = np.uint32(1013904223)

_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I16P = ctypes.POINTER(ctypes.c_int16)
_U32P = ctypes.POINTER(ctypes.c_uint32)


@dataclass
class CeltTrace:
    """Replay trace for a run of CELT frames (one homogeneous stream)."""
    # leaf stream
    lf_frame: np.ndarray
    lf_band: np.ndarray
    lf_call: np.ndarray
    lf_type: np.ndarray
    lf_off: np.ndarray
    lf_len: np.ndarray
    lf_k: np.ndarray
    lf_stride: np.ndarray
    lf_gain: np.ndarray
    lf_seed: np.ndarray
    lf_iy_off: np.ndarray
    iy_heap: np.ndarray
    # dense per (frame, band)
    bd_mode: np.ndarray      # [F, nb]
    bd_eff_lb: np.ndarray
    bd_tf: np.ndarray
    bd_imid: np.ndarray
    bd_iside: np.ndarray
    bd_itheta: np.ndarray
    bd_inv: np.ndarray
    bd_sign: np.ndarray
    bd_cflag: np.ndarray
    # anti-collapse records
    ac_frame: np.ndarray
    ac_band: np.ndarray
    ac_c: np.ndarray
    ac_k: np.ndarray
    ac_seed: np.ndarray
    ac_r: np.ndarray
    # frame records
    fr_misc: np.ndarray      # [F, 6]: spread, intensity, avg_band,
    #                          anti_collapse_on, codedBands, dual
    fr_gains: np.ndarray     # [F, 2, nb] float32 denormalise gains
    fsz: np.ndarray
    ends: np.ndarray
    chs: np.ndarray
    sb: np.ndarray           # shortBlocks per frame
    sil: np.ndarray
    pfp: np.ndarray
    pfg: np.ndarray
    pft: np.ndarray
    xs: np.ndarray           # [F, 2, nmax] f32 dense leaf plane: finished
    #                          values (raw_iy=False) or raw iy integers
    CC: int
    CCout: int
    start: int
    raw_iy: bool = False     # xs holds raw iy; lf_gain holds final g;
    #                          rotation+scale replayed on device
    xs_heap: bool = False    # xs is a dummy: values live in iy_heap
    #                          (decode order); the device scatter
    #                          pre-pass rebuilds the dense plane
    idx_mode: bool = False   # B<=1 PVQ leaves are LF_PVQ_IDX: lf_seed
    #                          = codeword index, lf_gain = PRE gain;
    #                          device cwrsi expands them
    rot_leaf: np.ndarray | None = None  # marker -> leaf id for PRE-
    #                          gain markers (-1 = rot_g already final)
    # native-emitted rotation sub-segment markers (raw_iy traces; None
    # -> assemble with celt_replay._rotation_markers, the Python spec of
    # the same plane)
    rot_rows: np.ndarray | None = None
    rot_cols: np.ndarray | None = None
    rot_pk: np.ndarray | None = None
    rot_th: np.ndarray | None = None
    rot_g: np.ndarray | None = None
    rot_sigmas: tuple = ()


def celt_trace_stream_arrays(
    st: CeltDecoderState, payload, offs, lens, fsz, enda, cha,
    with_heap: bool = True, raw_iy: bool = False, xs_heap: bool = False,
    idx_mode: bool = False,
):
    """Whole-stream bits-only decode emitting the iy-split trace
    (native celt_decode_stream_trace). Returns a CeltTrace, or None for
    an empty stream or a downsampling decoder. Updates ``st`` in place.

    raw_iy=True: the xs plane holds raw iy integers (as f32) and lf_gain
    holds the final per-leaf gain g = gain/sqrt(Ryy); the spreading
    rotation + scale run on the device (ops/rot.py) instead of in the
    host emitter.

    xs_heap=True (implies raw_iy): skip the dense xs plane entirely —
    values (iy ints + N1 signs) land in the compact int16 heap in decode
    order and the device scatter pre-pass rebuilds the dense plane
    (celt_replay heap_spec). Emission becomes sequential heap writes.

    idx_mode=True (implies xs_heap): B<=1 PVQ leaves (every leaf of long
    frames — their collapse mask is identically 1, so values cannot
    steer decode control flow) skip host cwrsi entirely: the leaf
    carries the codeword index (lf_seed) + pre gain (lf_gain) and the
    device cwrsi expands index -> iy and computes g = gain/sqrt(Ryy).
    The host value walk drops to the transient frames."""
    L = _native_celt()
    if st.downsample != 1:
        return None
    mode = mode48000()
    nb = mode.nbEBands
    n = len(offs)
    if n == 0:
        return None
    fsz = np.ascontiguousarray(fsz, np.int32)
    enda = np.ascontiguousarray(enda, np.int32)
    cha = np.ascontiguousarray(cha, np.int32)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    CC = st.channels
    CCout = max(CC, int(cha.max()))
    mp = _mode_ptrs(mode)

    if xs_heap and not raw_iy:
        raise ValueError("xs_heap requires raw_iy")
    if idx_mode and not xs_heap:
        raise ValueError("idx_mode requires xs_heap")
    lf_cap = 96 * n + 1024
    rot_cap = 128 * n + 1024 if raw_iy else 0
    # exact upper bound (disjoint leaves); 0 disables heap emission (the
    # heap feeds a validation replayer, and in xs_heap mode is the value
    # plane itself)
    iy_cap = 2 * 960 * n + 64 if (with_heap or xs_heap) else 0
    ac_cap = 8 * n + 1024
    while True:
        lf = {
            "frame": np.empty(lf_cap, np.int32),
            "band": np.empty(lf_cap, np.int8),
            "call": np.empty(lf_cap, np.int8),
            "type": np.empty(lf_cap, np.int8),
            "off": np.empty(lf_cap, np.int16),
            "len": np.empty(lf_cap, np.int16),
            "k": np.empty(lf_cap, np.int32),
            "stride": np.empty(lf_cap, np.int16),
            "gain": np.empty(lf_cap, np.float64),
            "seed": np.empty(lf_cap, np.uint32),
            "iy_off": np.empty(lf_cap, np.int64),
        }
        iy_heap = np.empty(max(iy_cap, 1), np.int16)
        bd = {
            "mode": np.zeros((n, nb), np.uint8),
            "eff_lb": np.full((n, nb), -1, np.int32),
            "tf": np.zeros((n, nb), np.int8),
            "imid": np.zeros((n, nb), np.int16),
            "iside": np.zeros((n, nb), np.int16),
            "itheta": np.zeros((n, nb), np.int16),
            "inv": np.zeros((n, nb), np.int8),
            "sign": np.zeros((n, nb), np.int8),
            "cflag": np.zeros((n, nb), np.int8),
        }
        ac = {
            "frame": np.empty(ac_cap, np.int32),
            "band": np.empty(ac_cap, np.int8),
            "c": np.empty(ac_cap, np.int8),
            "k": np.empty(ac_cap, np.int8),
            "seed": np.empty(ac_cap, np.uint32),
            "r": np.empty(ac_cap, np.float32),
        }
        fr_misc = np.zeros((n, 6), np.int32)
        fr_gains = np.zeros((n, 2, nb), np.float32)
        nmax = int(fsz.max())
        # xs_heap mode: no dense plane is written (or allocated)
        xs = (np.zeros((1, 2, 1), np.float32) if xs_heap
              else np.zeros((n, 2, nmax), np.float32))
        sb = np.zeros(n, np.int32)
        pfp = np.zeros(n, np.int32)
        pfg = np.zeros(n, np.float64)
        pft = np.zeros(n, np.int32)
        sil = np.zeros(n, np.int32)
        # state snapshot: a capacity retry must not double-apply updates
        old = np.ascontiguousarray(st.oldEBands, np.float64).copy()
        ole = np.ascontiguousarray(st.oldLogE, np.float64).copy()
        ole2 = np.ascontiguousarray(st.oldLogE2, np.float64).copy()
        bg = np.ascontiguousarray(st.backgroundLogE, np.float64).copy()
        rng = np.array([st.rng], np.int64)
        rot = {
            "rows": np.empty(max(rot_cap, 1), np.int32),
            "cols": np.empty(max(rot_cap, 1), np.int32),
            "pk": np.empty(max(rot_cap, 1), np.int32),
            "th": np.empty(max(rot_cap, 1), np.float32),
            "g": np.empty(max(rot_cap, 1), np.float32),
            "leaf": np.empty(max(rot_cap if idx_mode else 0, 1),
                             np.int32),
        }
        tcaps = np.array(
            [lf_cap, iy_cap, ac_cap, 0, 0, 0,
             (1 if raw_iy else 0) | (2 if xs_heap else 0)
             | (4 if idx_mode else 0),
             rot_cap, 0, 0],
            np.int64)

        rc = L.celt_decode_stream_trace(
            payload, offs.ctypes.data_as(_I64P), lens.ctypes.data_as(_I64P),
            fsz.ctypes.data_as(_I32P), enda.ctypes.data_as(_I32P),
            cha.ctypes.data_as(_I32P), n,
            mp["eb_p"], nb, mp["ln_p"], mp["ci_p"], mp["cb"], mp["ccaps"],
            mp["av"], int(mode.nbAllocVectors), mp["em_p"], mp["pmf_p"],
            int(mode.shortMdctSize), int(mode.effEBands),
            old.ctypes.data_as(_F64P), ole.ctypes.data_as(_F64P),
            ole2.ctypes.data_as(_F64P), bg.ctypes.data_as(_F64P),
            rng.ctypes.data_as(_I64P),
            int(CC), int(CCout), int(st.downsample), int(st.start),
            sb.ctypes.data_as(_I32P), pfp.ctypes.data_as(_I32P),
            pfg.ctypes.data_as(_F64P), pft.ctypes.data_as(_I32P),
            sil.ctypes.data_as(_I32P),
            tcaps.ctypes.data_as(_I64P),
            lf["frame"].ctypes.data_as(_I32P),
            lf["band"].ctypes.data_as(_I8P),
            lf["call"].ctypes.data_as(_I8P),
            lf["type"].ctypes.data_as(_I8P),
            lf["off"].ctypes.data_as(_I16P), lf["len"].ctypes.data_as(_I16P),
            lf["k"].ctypes.data_as(_I32P), lf["stride"].ctypes.data_as(_I16P),
            lf["gain"].ctypes.data_as(_F64P),
            lf["seed"].ctypes.data_as(_U32P),
            lf["iy_off"].ctypes.data_as(_I64P),
            iy_heap.ctypes.data_as(_I16P),
            bd["mode"].ctypes.data_as(_U8P),
            bd["eff_lb"].ctypes.data_as(_I32P),
            bd["tf"].ctypes.data_as(_I8P),
            bd["imid"].ctypes.data_as(_I16P),
            bd["iside"].ctypes.data_as(_I16P),
            bd["itheta"].ctypes.data_as(_I16P),
            bd["inv"].ctypes.data_as(_I8P), bd["sign"].ctypes.data_as(_I8P),
            bd["cflag"].ctypes.data_as(_I8P),
            ac["frame"].ctypes.data_as(_I32P),
            ac["band"].ctypes.data_as(_I8P), ac["c"].ctypes.data_as(_I8P),
            ac["k"].ctypes.data_as(_I8P), ac["seed"].ctypes.data_as(_U32P),
            ac["r"].ctypes.data_as(_F32P),
            fr_misc.ctypes.data_as(_I32P), fr_gains.ctypes.data_as(_F32P),
            xs.ctypes.data_as(_F32P), nmax,
            rot["rows"].ctypes.data_as(_I32P),
            rot["cols"].ctypes.data_as(_I32P),
            rot["pk"].ctypes.data_as(_I32P),
            rot["th"].ctypes.data_as(_F32P),
            rot["g"].ctypes.data_as(_F32P),
            rot["leaf"].ctypes.data_as(_I32P),
        )
        if rc == -2:
            lf_cap *= 4
            ac_cap *= 4
            if raw_iy:
                rot_cap *= 4
            continue
        if rc != 0:
            raise ValueError(
                f"celt_decode_stream_trace failed at frame {rc - 1}")
        break

    # commit decoder state
    st.oldEBands[:, :] = old
    st.oldLogE[:] = ole
    st.oldLogE2[:] = ole2
    st.backgroundLogE[:] = bg
    st.rng = int(rng[0])

    nl = int(tcaps[3])
    niy = int(tcaps[4])
    nac = int(tcaps[5])
    nrot = int(tcaps[7]) if raw_iy else 0
    smask = int(tcaps[8]) if raw_iy else 0
    rot_kw = {}
    if raw_iy:
        rot_kw = dict(
            rot_rows=rot["rows"][:nrot], rot_cols=rot["cols"][:nrot],
            rot_pk=rot["pk"][:nrot], rot_th=rot["th"][:nrot],
            rot_g=rot["g"][:nrot],
            rot_leaf=rot["leaf"][:nrot] if idx_mode else None,
            rot_sigmas=tuple(s for s in range(1, 16)
                             if smask & (1 << s)),
        )
    return CeltTrace(
        lf_frame=lf["frame"][:nl], lf_band=lf["band"][:nl],
        lf_call=lf["call"][:nl], lf_type=lf["type"][:nl],
        lf_off=lf["off"][:nl], lf_len=lf["len"][:nl], lf_k=lf["k"][:nl],
        lf_stride=lf["stride"][:nl], lf_gain=lf["gain"][:nl],
        lf_seed=lf["seed"][:nl], lf_iy_off=lf["iy_off"][:nl],
        iy_heap=iy_heap[:niy],
        bd_mode=bd["mode"], bd_eff_lb=bd["eff_lb"], bd_tf=bd["tf"],
        bd_imid=bd["imid"], bd_iside=bd["iside"], bd_itheta=bd["itheta"],
        bd_inv=bd["inv"], bd_sign=bd["sign"], bd_cflag=bd["cflag"],
        ac_frame=ac["frame"][:nac], ac_band=ac["band"][:nac],
        ac_c=ac["c"][:nac], ac_k=ac["k"][:nac], ac_seed=ac["seed"][:nac],
        ac_r=ac["r"][:nac],
        fr_misc=fr_misc, fr_gains=fr_gains,
        fsz=fsz, ends=enda, chs=cha, sb=sb, sil=sil,
        pfp=pfp, pfg=pfg, pft=pft, xs=xs,
        CC=CC, CCout=CCout, start=int(st.start), raw_iy=bool(raw_iy),
        xs_heap=bool(xs_heap), idx_mode=bool(idx_mode),
        **rot_kw,
    )


def trace_frames(st: CeltDecoderState, frames, frame_sizes, ends,
                 stream_chs, **modes):
    """celt_trace_stream_arrays over a Python list of frame payloads (the
    form celt_decode_stream_raw takes)."""
    n = len(frames)
    if n == 0:
        return None
    payload = b"".join(frames)
    lens = np.fromiter((len(fr) for fr in frames), np.int64, n)
    offs = np.concatenate(([0], np.cumsum(lens[:-1])))
    return celt_trace_stream_arrays(
        st, payload, offs, lens, np.asarray(frame_sizes, np.int32),
        np.asarray(ends, np.int32), np.asarray(stream_chs, np.int32),
        **modes)


# --------------------- transform chain machinery ---------------------

def _chain(N, B, tf_change):
    """The lowband pre-transform and X resynthesis step lists of
    quant_band (native/celt_bands.c quant_band; upstream
    bands.c:1026-1117) for one (band size N, frame B, tf_change), in the
    structural form the device replay lowers to reshapes and transposes:
      ('haar', n0, stride)                  haar1 butterfly
      ('deint'|'int', N0, stride, had)      hadamard (de)interleave
    Returns (pre, post)."""
    longBlocks = B == 1
    N_B = N // B
    recombine = tf_change if tf_change > 0 else 0
    pre = []
    for k in range(recombine):
        pre.append(("haar", N >> k, 1 << k))
    B2 = B >> recombine
    N_B <<= recombine
    time_divide = 0
    tfc = tf_change
    while (N_B & 1) == 0 and tfc < 0:
        pre.append(("haar", N_B, B2))
        B2 <<= 1
        N_B >>= 1
        time_divide += 1
        tfc += 1
    B0 = B2
    N_B0 = N_B
    if B0 > 1:
        pre.append(("deint", N_B >> recombine, B0 << recombine,
                    longBlocks))
    post = []
    if B0 > 1:
        post.append(("int", N_B >> recombine, B0 << recombine,
                     longBlocks))
    N_B = N_B0
    for k in range(time_divide):
        B2 >>= 1
        N_B <<= 1
        post.append(("haar", N_B, B2))
    for k in range(recombine):
        post.append(("haar", N >> k, 1 << k))
    return pre, post


def _lcg_tables(nmax):
    """A_e, B_e with lcg^e(s) = A_e * s + B_e (mod 2^32), e in [0, nmax].
    uint64 so products with 32-bit seeds never overflow."""
    A = np.empty(nmax + 1, np.uint64)
    Bc = np.empty(nmax + 1, np.uint64)
    a, b = 1664525, 1013904223
    Ai, Bi = 1, 0
    for e in range(nmax + 1):
        A[e] = Ai
        Bc[e] = Bi
        Ai = (a * Ai) % (1 << 32)
        Bi = (a * Bi + b) % (1 << 32)
    return A, Bc
