"""Device replay of the CELT PVQ value plane (the iy-split).

The host emits an integer trace (formats/opus/iy_split.py); this module
packs it into flat arrays (``build_replay_arrays``, NumPy and C) and
replays the float plane on the device as plain PyTorch around one
hand-written kernel:

  0. the dense raw plane: the int16 value heap scattered by position +
     per-leaf delta, and, for idx-mode traces, the codeword indices
     expanded to pulse vectors (``cwrsi_expand``, cwrs.c cwrsi);
  1. the spreading rotation and per-leaf gain over the whole plane
     (vq.c exp_rotation; ops/rot.py, kernel csrc/rot.cu);
  2. a 21-step band loop: transformed-lowband fetch (a per-row gather
     from the norm carry), fold/noise fills (LCG jumps as affine maps
     mod 2^32), haar/hadamard chains as reshape/transpose butterflies
     computed per (B, tf) class and selected per frame (bands.c
     quant_all_bands resynthesis), norm write, stereo merge / N=2
     butterfly / inversion;
  3. anti-collapse noise injection + band renormalise (bands.c:284);
  4. denormalise by band gains + channel mixes (bands.c:192).

Every large tensor is 2-D ``[rows, columns]`` with channel-major rows
``r = c * F + f`` (channel c of frame f): the heap and cwrsi targets, the
rotation markers after ``build_replay_arrays`` remaps them, the band
loop and the output all use it, and channels are contiguous F-row
blocks.

Validated against the reference package's replay and the full native
decode in tests/test_torch_replay.py.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import resident, resolve_device
from ..formats.opus.celt_tables import ORDERY_TABLE, mode48000
from ..formats.opus.iy_split import (
    EPSILON, LF_FOLD, LF_NOISE, LF_PVQ, LF_PVQ_IDX, SPREAD_NONE,
    CeltTrace, _chain, _lcg_tables,
)
from ..runtime import native
from . import rot as rot_ops

SPREAD_FACTORS = np.asarray([0, 15, 10, 5], np.int64)

UMAX = 243          # covers N <= 242, K+1 <= 242 (cwrs.c bounds)
PVQ_LEN_BUCKETS = (4, 8, 16, 24, 32, 48, 64, 96, 176)
_U32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=1)
def pvq_u_table_u32():
    """Saturated-u32 PVQ U(N,K) table [UMAX, UMAX] for the device cwrsi
    (reference: cwrs.c CELT_PVQ_U). Codeword indices fit u32 (V(N,K) <
    2^32 for codable N,K), so any cell whose exact value exceeds u32 may
    saturate: the expansion only compares such cells against an index
    (p > i always true) and never subtracts them."""
    U = np.zeros((UMAX, UMAX), object)
    U[0, 0] = 1
    for n in range(1, UMAX):
        for k in range(1, UMAX):
            U[n, k] = U[n - 1, k] + U[n, k - 1] + U[n - 1, k - 1]
    sat = np.vectorize(lambda v: min(int(v), _U32))(U)
    tab = sat.astype(np.uint32)
    tab.setflags(write=False)                     # shared by every caller
    return tab


def cwrsi_expand(utab, n_v, k_v, i_v, Lb):
    """Vectorized PVQ index -> pulse-vector expansion (cwrs.c cwrsi) as a
    loop over the DIMENSION COUNTER m descending Lb..1, all leaves of a
    length bucket advancing in lockstep. A leaf of dimension n_v is
    active for the last n_v steps (m <= n_v), so every active leaf reads
    the same U-table row U(m, .) at each step.

    Per step the two host branches (k >= n / k < n) unify to

        q = U(m, k+1); s = i >= q; i -= s ? q : 0
        k' = max { t <= k : U(m, t) <= i }
        i -= U(m, k');  y = +-(k - k');  k = k'

    U(m, .) is nondecreasing in its second argument (saturation keeps it
    so), so k' is a binary search on the row
    (k' = min(#{t : U(m,t) <= i} - 1, k); U(m,0) = 0 guarantees
    existence) and U(m, k+1), U(m, k') are gathers. The m == 1 tail (the
    last step of every leaf) emits all remaining pulses (y = +-k).

    Args: utab [UMAX, UMAX] int64 (the saturated u32 values); n_v, k_v,
    i_v [lanes] int64 with i_v in [0, 2^32). int64 keeps the reference's
    unsigned comparisons right.
    Returns (iy [lanes, Lb] float32, Ryy [lanes] float32) in TAIL-ALIGNED
    column order: leaf position j lives in column Lb - n_v + j (callers
    fold the shift into their scatter indices).
    """
    lanes = n_v.shape[0]
    k = k_v.clone()
    i = i_v.clone()
    ys = torch.zeros(Lb, lanes, dtype=torch.float32, device=n_v.device)
    for col, m in enumerate(range(Lb, 0, -1)):
        row = utab[m]
        active = n_v >= m
        q = row[k + 1]
        s = active & (i >= q)
        i = torch.where(s, i - q, i)
        kp = torch.minimum(torch.searchsorted(row, i, right=True) - 1, k)
        if m == 1:
            kp_out = torch.zeros_like(kp)
        else:
            kp_out = kp
            i = torch.where(active, i - row[kp], i)
        y = k - kp_out
        ys[col] = torch.where(active, torch.where(s, -y, y), 0)
        k = torch.where(active, kp_out, k)
    iy = ys.t().contiguous()                      # [lanes, Lb] tail-aligned
    return iy, (iy * iy).sum(dim=1)


def _sigma2_of(length, stride):
    """exp_rotation's stride2 (vq.c:66): smallest s2 with
    (s2*s2+s2)*stride + (stride>>2) >= length, 0 when length < 8*stride."""
    length, stride = int(length), int(stride)
    if length < 8 * stride:
        return 0
    v = 1
    while (v * v + v) * stride + (stride >> 2) < length:
        v += 1
    return v


@functools.lru_cache(maxsize=None)
def _lcg_tables_u32(nmax):
    """The LCG jump tables for frames of nmax samples, as uint32."""
    tabs = tuple(t.astype(np.uint32) for t in _lcg_tables(nmax + 1))
    for t in tabs:
        t.setflags(write=False)                   # shared by every caller
    return tabs


def _rotation_markers(tr: CeltTrace, band_off, nb):
    """Host assembly of the device rotation inputs (raw-iy traces):
    compact COO marker lists, one marker per rotation sub-segment start
    (vq.c exp_rotation splits each PVQ leaf into `stride` sub-segments)
    plus one identity marker at every other leaf start (terminating the
    previous segment). The Python spec of what the native trace emits.

    Returns (rows, cols, poslag, theta, g, sigmas), rows
    channel-interleaved (f*2+c; build_replay_arrays remaps them):
      poslag = col << 13 | sub_seg_len << 4 | lag
               (lag = 1 + sigma2 if rotating else 1; the length bounds
               the fill-forward so positions past a leaf's extent —
               theta-split collapsed sides have NO leaf — fall out of
               every segment instead of extending the previous one)
      theta  = f32 rotation angle parameter (0 = no rotation)
      g      = per-leaf final gain (1 for non-PVQ markers)
    """
    fr = tr.lf_frame.astype(np.int64)
    call = tr.lf_call.astype(np.int64)
    band = tr.lf_band.astype(np.int64)
    off = tr.lf_off.astype(np.int64)
    gcol = band_off[band] + off
    rows_all = fr * 2 + call
    is_pvq = tr.lf_type == LF_PVQ

    # non-PVQ leaves and non-rotating PVQ leaves: one identity marker
    ln = tr.lf_len.astype(np.int64)
    k = tr.lf_k.astype(np.int64)
    B = tr.lf_stride.astype(np.int64)
    spread = tr.fr_misc[:, 0].astype(np.int64)[fr]
    # ln < B (sub-segments of length 0): exp_rotation's len/=stride loop
    # body never runs -> treat as plain (also avoids B markers colliding
    # at the leaf start)
    rot = (is_pvq & (2 * k < ln) & (spread != SPREAD_NONE)
           & (ln >= np.maximum(B, 1)))
    plain = ~rot
    g_leaf = np.where(is_pvq, tr.lf_gain, 1.0).astype(np.float32)

    ln_plain = np.maximum(ln[plain], 1)
    rows = [rows_all[plain]]
    cols = [gcol[plain]]
    poslag = [(gcol[plain] << 13) | (ln_plain << 4) | 1]
    theta = [np.zeros(int(plain.sum()), np.float32)]
    g = [g_leaf[plain]]

    ri = np.nonzero(rot)[0]
    sigmas = set()
    if len(ri):
        factor = SPREAD_FACTORS[spread[ri]]
        gr = ln[ri].astype(np.float64) / (ln[ri] + factor * k[ri])
        th_r = (0.5 * gr * gr).astype(np.float32)
        # sigma2 per unique (len, stride)
        pairs = ln[ri] * 16 + B[ri]
        up, inv = np.unique(pairs, return_inverse=True)
        s2u = np.asarray(
            [_sigma2_of(p >> 4, p & 15) for p in up], np.int64)
        s2 = s2u[inv]
        sigmas.update(int(v) for v in np.unique(s2) if v > 0)
        Bi = B[ri]
        Lsub = ln[ri] // Bi
        nsub = Bi + (ln[ri] % Bi > 0).astype(np.int64)
        seg_leaf = np.repeat(np.arange(len(ri)), nsub)
        # sub-segment index within its leaf
        starts = np.cumsum(nsub) - nsub
        sub_j = np.arange(int(nsub.sum())) - np.repeat(starts, nsub)
        is_tail = sub_j >= Bi[seg_leaf]
        scol = gcol[ri][seg_leaf] + sub_j * Lsub[seg_leaf]
        lag = np.where(is_tail, 1, 1 + s2[seg_leaf])
        slen = np.maximum(
            np.where(is_tail, (ln[ri] % Bi)[seg_leaf], Lsub[seg_leaf]), 1)
        rows.append(rows_all[ri][seg_leaf])
        cols.append(scol)
        poslag.append((scol << 13) | (slen << 4) | lag)
        theta.append(np.where(is_tail, np.float32(0),
                              th_r[seg_leaf]).astype(np.float32))
        g.append(tr.lf_gain[ri][seg_leaf].astype(np.float32))

    return (np.concatenate(rows).astype(np.int32),
            np.concatenate(cols).astype(np.int32),
            np.concatenate(poslag).astype(np.int32),
            np.concatenate(theta),
            np.concatenate(g),
            tuple(sorted(sigmas)))


def _bucket(n, lo=8):
    b = lo
    while b < n:
        b *= 2
    return b


def _bucket_fine(n, lo=8):
    """Quarter-step geometric buckets (1, 1.25, 1.5, 1.75 x pow2):
    <= 14% padding where plain pow2 wastes up to 2x — used for the
    large value-heap axis where padding is real staged bytes and real
    scatter work."""
    b = _bucket(n, lo)
    for mult in (5, 6, 7):
        c = (b // 8) * mult
        if c >= n:
            return c
    return b


def _pack_pvq_leaves(tr: CeltTrace, band_off, nmax, F):
    """Bucket-pack the device-cwrsi leaves (LF_PVQ_IDX) by codeword
    length with the native packer (native/replay_pack.c): one O(n) C
    pass. Returns (pvq arrays, pvq_spec, rs_slot); rs_slot maps a global
    leaf index to its slot in the concatenated per-leaf 1/sqrt(Ryy)
    vector (marker gain fix-up), -1 elsewhere."""
    L = native.lib()
    i8p = ctypes.POINTER(ctypes.c_int8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    nleaf = len(tr.lf_type)
    rs_slot = np.full(nleaf + 1, -1, np.int64)
    edges = np.asarray(PVQ_LEN_BUCKETS, np.int32)
    counts = np.zeros(len(PVQ_LEN_BUCKETS) + 1, np.int64)
    tag = L.celt_pvq_bucket_count(
        tr.lf_type.ctypes.data_as(i8p), tr.lf_len.ctypes.data_as(i16p),
        nleaf, edges.ctypes.data_as(i32p), len(edges),
        counts.ctypes.data_as(i64p))
    if tag != LF_PVQ_IDX:
        raise RuntimeError("replay_pack.c and iy_split.py disagree on the "
                           "LF_PVQ_IDX leaf type")
    if counts[len(PVQ_LEN_BUCKETS)]:
        raise ValueError("a PVQ leaf is longer than the largest length "
                         f"bucket ({PVQ_LEN_BUCKETS[-1]})")
    bucket_base = np.zeros(len(PVQ_LEN_BUCKETS) + 1, np.int64)
    spans = []
    slot0 = 0
    for bi, ub in enumerate(PVQ_LEN_BUCKETS):
        cnt = int(counts[bi])
        bucket_base[bi] = slot0
        if not cnt:
            continue
        lanes = _bucket(cnt, 256)
        spans.append((slot0, lanes, int(ub)))
        slot0 += lanes
    total = slot0
    out_n = np.zeros(total, np.int32)
    out_k = np.zeros(total, np.int32)
    out_i = np.zeros(total, np.uint32)
    out_tgt = np.full(total, 2 * F * nmax, np.int32)
    L.celt_pvq_bucket_fill(
        tr.lf_type.ctypes.data_as(i8p), tr.lf_len.ctypes.data_as(i16p),
        tr.lf_frame.ctypes.data_as(i32p), tr.lf_call.ctypes.data_as(i8p),
        tr.lf_band.ctypes.data_as(i8p), tr.lf_off.ctypes.data_as(i16p),
        tr.lf_k.ctypes.data_as(i32p), tr.lf_seed.ctypes.data_as(u32p),
        nleaf, edges.ctypes.data_as(i32p), len(edges),
        bucket_base.ctypes.data_as(i64p), band_off.ctypes.data_as(i64p),
        nmax, F,
        out_n.ctypes.data_as(i32p), out_k.ctypes.data_as(i32p),
        out_i.ctypes.data_as(u32p), out_tgt.ctypes.data_as(i32p),
        rs_slot.ctypes.data_as(i64p))
    pvq_arrs = {}
    spec = []
    for j, (base, lanes, ub) in enumerate(spans):
        pre = f"pvq{j}"
        pvq_arrs[pre + "_n"] = out_n[base : base + lanes]
        pvq_arrs[pre + "_k"] = out_k[base : base + lanes]
        pvq_arrs[pre + "_i"] = out_i[base : base + lanes]
        pvq_arrs[pre + "_tgt"] = out_tgt[base : base + lanes]
        # U-table row width that covers the bucket (> max(k) + 1),
        # bucketed; part of the structure key
        kmax = int(out_k[base : base + lanes].max(initial=0))
        spec.append((ub, lanes, min(_bucket(kmax + 2, 32), UMAX)))
    pvq_arrs["utab"] = pvq_u_table_u32()
    return pvq_arrs, (tuple(spec), slot0), rs_slot


def build_replay_arrays(tr: CeltTrace):
    """Host assembly: trace -> flat arrays for the device + a static
    structure spec (hashable) that keys the replay function. All work
    here is vectorized NumPy on 1-D leaf arrays (and one C pass); the
    per-sample float plane never touches the host.

    Returns (arrs, None, static_key)."""
    mode = mode48000()
    nb = mode.nbEBands
    eB = np.asarray(mode.eBands, np.int64)[: nb + 1]
    F = len(tr.fsz)
    nmax = int(tr.fsz.max())
    if not (tr.fsz == nmax).all():
        raise ValueError("the frames of a replay trace must share one "
                         "frame size")
    LM = int(np.log2(nmax // mode.shortMdctSize))
    start = tr.start
    band_off = ((1 << LM) * eB).astype(np.int64)

    pvq_spec = None
    rs_slot = None
    pvq_arrs = {}
    if tr.idx_mode:
        # ---- device-cwrsi leaves (LF_PVQ_IDX): length-bucketed ----
        pvq_arrs, pvq_spec, rs_slot = _pack_pvq_leaves(
            tr, band_off, nmax, F)

    heap_spec = None
    if tr.xs_heap:
        # Compact value heap (int16, decode order) instead of the dense
        # xs plane: the device rebuilds [F*2*nmax] by position+delta —
        # within a leaf heap positions and plane columns advance
        # together, so tgt = heap_pos + (tgtbase - heap_start), with
        # the per-leaf delta filled forward along the heap axis.
        iyn = len(tr.iy_heap)
        Tpad = _bucket_fine(max(iyn, 1), 1 << 14)
        heap = np.zeros(Tpad, np.int16)
        heap[:iyn] = tr.iy_heap
        li = np.nonzero(tr.lf_iy_off >= 0)[0]
        starts = tr.lf_iy_off[li].astype(np.int64)
        # channel-major rows (c*F + f)
        rows = tr.lf_call[li].astype(np.int64) * F + tr.lf_frame[li]
        tgtbase = (rows * nmax + band_off[tr.lf_band[li].astype(np.int64)]
                   + tr.lf_off[li])
        Lh = len(li)
        Lpad = _bucket(Lh + 1, 1024)
        st_a = np.full(Lpad, Tpad, np.int32)      # pad -> dropped
        st_a[:Lh] = starts
        dl_a = np.zeros(Lpad, np.int32)
        dl_a[:Lh] = (tgtbase - starts).astype(np.int32)
        # terminator: positions past the last real value must not
        # inherit the last leaf's delta (they would scatter zeros onto
        # live plane cells) — give them an out-of-range one
        st_a[Lh] = iyn
        dl_a[Lh] = 1 << 30
        arrs = {"iyh": heap, "iyh_st": st_a, "iyh_dl": dl_a}
        arrs.update(pvq_arrs)
        heap_spec = (Tpad, Lpad)
    else:
        # dense-plane fallback: transpose host-side to channel-major
        arrs = {"xs": np.ascontiguousarray(
            tr.xs.transpose(1, 0, 2)).reshape(-1)}

    # ---- per-band chain classes + fills ----
    B_f = np.where(tr.sb > 0, tr.sb, 1).astype(np.int64)
    arrs["lcg_a"], arrs["lcg_b"] = _lcg_tables_u32(nmax)
    band_spec = []
    fills_idx = np.nonzero(
        (tr.lf_type == LF_FOLD) | (tr.lf_type == LF_NOISE))[0]
    fills_band = tr.lf_band[fills_idx]
    bkey_all = (B_f * 16)[:, None] + (tr.bd_tf.astype(np.int64) + 8)
    norm_offset = int(band_off[start])
    norm_len = max(int(band_off[nb - 1]) - norm_offset, 1)
    for i in range(start, nb):
        N = int(band_off[i + 1] - band_off[i])
        fkey = bkey_all[:, i]
        present = np.bincount(fkey, minlength=256).astype(bool)
        ukeys = np.nonzero(present)[0]
        classes = tuple((int(k) // 16, int(k) % 16 - 8) for k in ukeys)
        rank = np.zeros(256, np.int32)
        rank[ukeys] = np.arange(len(ukeys), dtype=np.int32)
        pre = f"b{i}"
        arrs[pre + "_cls"] = rank[fkey]
        li = fills_idx[fills_band == i]
        ni = len(li)
        ni_pad = _bucket(ni) if ni else 0
        if ni:
            def pad(v, fill=0, dt=None):
                out = np.full(ni_pad, fill, dt or v.dtype)
                out[:ni] = v
                return out
            arrs[pre + "_ff"] = pad(tr.lf_frame[li]).astype(np.int32)
            arrs[pre + "_fc"] = pad(tr.lf_call[li]).astype(np.int32)
            arrs[pre + "_fo"] = pad(tr.lf_off[li]).astype(np.int32)
            arrs[pre + "_fl"] = pad(tr.lf_len[li]).astype(np.int32)
            arrs[pre + "_fg"] = pad(tr.lf_gain[li].astype(np.float32))
            arrs[pre + "_fs"] = pad(tr.lf_seed[li])
            arrs[pre + "_ft"] = pad(
                (tr.lf_type[li] == LF_FOLD).astype(np.int32))
        # distinct lowband-fetch offsets per band. The device fetch here
        # is a per-row gather and does not read them; the entry and the
        # v_pad field stay so that the arrays and the key are the
        # reference package's, element for element.
        eff_i = tr.bd_eff_lb[:, i]
        act = eff_i >= 0
        uoffs = np.unique(np.clip(eff_i[act], 0,
                                  max(norm_len - N, 0)))
        if len(uoffs) == 0 or len(uoffs) > 16:
            v_pad = 0
            lbo = np.zeros(1, np.int32)
        else:
            v_pad = _bucket(len(uoffs), 1)
            lbo = np.full(v_pad, uoffs[0], np.int32)
            lbo[: len(uoffs)] = uoffs
        arrs[pre + "_lbo"] = lbo
        band_spec.append((i, N, ni_pad, classes, v_pad))

    # ---- band-level records ----
    arrs["eff_lb"] = tr.bd_eff_lb.astype(np.int32)
    arrs["mode_b"] = tr.bd_mode.astype(np.int32)
    arrs["imid"] = tr.bd_imid.astype(np.float32) * np.float32(1 / 32768)
    arrs["iside"] = tr.bd_iside.astype(np.float32) * np.float32(1 / 32768)
    arrs["inv"] = tr.bd_inv.astype(np.int32)
    arrs["sign"] = tr.bd_sign.astype(np.float32)
    arrs["cflag"] = tr.bd_cflag.astype(np.int32)
    arrs["avg_band"] = tr.fr_misc[:, 2].astype(np.int32)
    arrs["ends"] = tr.ends.astype(np.int32)
    arrs["gains"] = tr.fr_gains.astype(np.float32)
    arrs["sil"] = (tr.sil != 0)
    arrs["dup"] = ((tr.CC == 2) & (tr.chs == 1) & (tr.sil == 0))
    arrs["mixd"] = ((tr.CC == 1) & (tr.chs == 2) & (tr.sil == 0))

    # ---- anti-collapse ----
    nac = len(tr.ac_frame)
    nac_pad = _bucket(nac) if nac else 0
    if nac:
        N0s = np.diff(eB)[tr.ac_band.astype(np.int64)].astype(np.int32)
        arrs["ac_f"] = np.zeros(nac_pad, np.int32)
        arrs["ac_f"][:nac] = tr.ac_frame
        arrs["ac_base"] = np.full(nac_pad, 0, np.int32)
        arrs["ac_base"][:nac] = (
            band_off[tr.ac_band.astype(np.int64)]
            + tr.ac_k.astype(np.int64)).astype(np.int32)
        arrs["ac_c"] = np.zeros(nac_pad, np.int32)
        arrs["ac_c"][:nac] = tr.ac_c
        arrs["ac_n0"] = np.zeros(nac_pad, np.int32)
        arrs["ac_n0"][:nac] = N0s
        arrs["ac_seed"] = np.zeros(nac_pad, np.uint32)
        arrs["ac_seed"][:nac] = tr.ac_seed
        arrs["ac_r"] = np.zeros(nac_pad, np.float32)
        arrs["ac_r"][:nac] = tr.ac_r
        gkey = (tr.ac_frame.astype(np.int64) * 64
                + tr.ac_band.astype(np.int64) * 2 + tr.ac_c)
        ug = np.unique(gkey)
        nren = len(ug)
        nren_pad = _bucket(nren)
        rb = ((ug // 2) % 32).astype(np.int64)
        arrs["ren_f"] = np.zeros(nren_pad, np.int32)
        arrs["ren_f"][:nren] = (ug // 64).astype(np.int32)
        arrs["ren_c"] = np.zeros(nren_pad, np.int32)
        arrs["ren_c"][:nren] = (ug % 2).astype(np.int32)
        arrs["ren_b"] = np.zeros(nren_pad, np.int32)
        arrs["ren_b"][:nren] = rb.astype(np.int32)
        arrs["ren_on"] = np.zeros(nren_pad, bool)
        arrs["ren_on"][:nren] = True
    else:
        nren_pad = 0

    # ---- device rotation markers (raw-iy traces) ----
    rot_spec = None
    if tr.raw_iy:
        if tr.rot_rows is not None:
            # native-emitted markers (celt_bands.c emit_rot_markers,
            # identical to _rotation_markers up to order)
            rows, cols, poslag = tr.rot_rows, tr.rot_cols, tr.rot_pk
            theta, g, sigmas = tr.rot_th, tr.rot_g, tr.rot_sigmas
        else:
            rows, cols, poslag, theta, g, sigmas = _rotation_markers(
                tr, band_off, nb)
        WB = int(band_off[nb])
        nm = len(rows)
        nm_pad = _bucket(nm, 1024)
        rpad = np.full(nm_pad, F * 2, np.int32)       # pad -> dropped
        # marker sources emit channel-interleaved rows (f*2+c); remap
        # here to the device plane's channel-major rows (c*F + f)
        rpad[:nm] = (rows & 1) * F + (rows >> 1)
        cpad = np.zeros(nm_pad, np.int32)
        cpad[:nm] = cols
        pk = np.full(nm_pad, -1, np.int32)
        pk[:nm] = poslag
        th = np.zeros(nm_pad, np.float32)
        th[:nm] = theta
        gg = np.zeros(nm_pad, np.float32)
        gg[:nm] = g
        arrs["rot_rows"] = rpad
        arrs["rot_cols"] = cpad
        arrs["rot_pk"] = pk
        arrs["rot_th"] = th
        arrs["rot_g"] = gg
        if tr.idx_mode:
            # marker -> 1/sqrt(Ryy) slot: pre-gain markers (rot_leaf
            # >= 0) point at their leaf's slot in the concatenated
            # device Ryy vector; -1 = rot_g is already final
            gx = np.full(nm_pad, -1, np.int32)
            gx[:nm] = rs_slot[tr.rot_leaf]
            arrs["rot_gidx"] = gx
        rot_spec = (WB, nm_pad, sigmas)

    static_key = (F, nmax, LM, start, tr.CC, tr.CCout,
                  tuple(band_spec), nac_pad, nren_pad, rot_spec,
                  heap_spec, pvq_spec)
    return arrs, None, static_key


def replay_arrays_from_numpy(arrs: dict, device) -> dict:
    """build_replay_arrays' numpy dict as device tensors, one dtype per
    kind of entry: float arrays float32; flags bool; the value heap
    ``iyh`` int16 (widened on the device); the packed rotation markers
    ``rot_pk`` int32 (the rotation kernel's type); every other integer
    array int64 — indices, counts, and the uint32 entries (codeword
    indices ``pvq*_i``, the U table ``utab``, LCG seeds and jump tables),
    whose values are kept and whose arithmetic is masked to 32 bits where
    it must wrap."""
    dev = torch.device(device)
    out = {}
    for name, v in arrs.items():
        v = np.asarray(v)
        if v.dtype == np.bool_ or name == "iyh":
            a = v
        elif name == "rot_pk":
            a = v.astype(np.int32, copy=False)
        elif np.issubdtype(v.dtype, np.integer):
            a = v.astype(np.int64)
        else:
            a = v.astype(np.float32, copy=False)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


def _lcg_jump(A, Bc, seeds):
    """(A * seeds + Bc) mod 2^32 on int64 tensors holding u32 values. The
    product is taken in 16-bit halves of A so that it cannot pass 2^63."""
    lo = (A & 0xFFFF) * seeds
    hi = (((A >> 16) * seeds) & 0xFFFF) << 16
    return (lo + hi + Bc) & _U32


def _apply_chain_static(x, steps):
    """Apply a quant_band haar/hadamard chain with reshapes only: haar1
    -> reshape butterflies, (de)interleave_hadamard -> transpose plus a
    small row reorder. x is [..., N]."""
    Fb = tuple(x.shape[:-1])
    N = x.shape[-1]
    s = float(np.float32(np.sqrt(np.float64(0.5))))
    for step in steps:
        kind = step[0]
        if kind == "haar":
            _, n0, stride = step
            h = n0 >> 1
            L = stride * 2 * h
            if h <= 0 or L <= 0 or L > N:
                continue
            v = x[..., :L].reshape(Fb + (h, 2, stride))
            a = s * v[..., 0, :]
            b = s * v[..., 1, :]
            out = torch.stack([a + b, a - b], dim=-2).reshape(Fb + (L,))
        else:
            _, N0, stride, had = step
            L = N0 * stride
            if L <= 0 or stride <= 1 or L > N:
                continue
            seg = x[..., :L]
            if kind == "deint":
                # out[o*N0+j] = in[j*stride+i], o = ordery[i] (or i)
                t = seg.reshape(Fb + (N0, stride)).transpose(-1, -2)
                if had:
                    t = t.index_select(-2, _deint_rows_t(stride, x.device))
            else:  # "int"
                t = seg.reshape(Fb + (stride, N0))
                if had:
                    t = t.index_select(-2, _ordery_t(stride, x.device))
                t = t.transpose(-1, -2)
            out = t.reshape(Fb + (L,))
        x = out if L == N else torch.cat([out, x[..., L:]], dim=-1)
    return x


def _deint_rows(stride):
    """Row order for the deinterleave output: out_row[k] = t_row[i] with
    ordery[i] == k."""
    ordy = np.asarray(ORDERY_TABLE[stride], np.int64)
    inv = np.empty_like(ordy)
    inv[ordy] = np.arange(stride)
    return inv


def _deint_rows_t(stride, device):
    """_deint_rows(stride), resident on the device."""
    return resident(("replay_deint_rows", stride),
                    lambda: _deint_rows(stride), device)


def _ordery_t(stride, device):
    """ORDERY_TABLE[stride] (the interleave's row order), resident on the
    device."""
    return resident(("replay_ordery", stride),
                    lambda: np.asarray(ORDERY_TABLE[stride], np.int64),
                    device)


def _band_of_position(LM, start, device):
    """[band_off[nb] - band_off[start]] int64: for each position of bands
    start .. nb-1, its band's index counted from start; resident on the
    device."""
    def build():
        mode = mode48000()
        eB = np.asarray(mode.eBands, np.int64)[: mode.nbEBands + 1]
        widths = np.diff(eB[start:]) << LM
        return np.repeat(np.arange(len(widths)), widths)

    return resident(("replay_band_of_position", LM, start), build, device)


def _build_rotation_pass(rot_spec, band_off, F):
    """The device rotation + scale pass for raw-iy planes: scatter the
    compact markers into dense row-major [2F, WB] planes, beside the
    value plane as it stands, and run ops/rot.py rotate_plane over them.
    Padded markers (row 2F) land in a dump slot past the plane."""
    WB, _nm_pad, sigmas = rot_spec
    F2 = F * 2
    band_off_t = tuple(int(v) for v in band_off)

    def rotate(x, arrs, g_override=None):
        """x: the channel-major [2F, nmax] raw plane (row c*F + f)."""
        gv = arrs["rot_g"] if g_override is None else g_override
        rows = arrs["rot_rows"]
        idx = torch.where(rows >= F2, F2 * WB, rows * WB + arrs["rot_cols"])

        def plane(fill, vals):
            flat = torch.full((F2 * WB + 1,), fill, dtype=vals.dtype,
                              device=vals.device)
            flat[idx] = vals
            return flat[: F2 * WB].view(F2, WB)

        return rot_ops.rotate_plane(
            x, plane(-1, arrs["rot_pk"]), plane(0.0, arrs["rot_th"]),
            plane(0.0, gv), sigmas, band_off_t)

    return rotate


@functools.lru_cache(maxsize=64)
def _replay_builder(static_key):
    """Build the replay function for one trace structure: ``replay(arrs,
    mark=None)`` over the device dict of replay_arrays_from_numpy,
    returning freq [CCout*F, nmax] (channel c = rows [c*F, (c+1)*F)).
    ``mark``, when given, is called with a stage name at each stage's
    end (timing hooks). The key pays for itself without a compiler: the
    chain step lists per band and class are built once."""
    (F, nmax, LM, start, CC, CCout, band_spec, nac_pad,
     nren_pad, rot_spec, heap_spec, pvq_spec) = static_key
    mode = mode48000()
    nb = mode.nbEBands
    eB = np.asarray(mode.eBands, np.int64)[: nb + 1]
    band_off = ((1 << LM) * eB).astype(np.int64)
    norm_offset = int(band_off[start])
    norm_len = max(int(band_off[nb - 1]) - norm_offset, 1)
    rotate = (_build_rotation_pass(rot_spec, band_off, F)
              if rot_spec is not None else None)
    head = int(band_off[start])
    tail = nmax - int(band_off[nb])
    f32 = torch.float32
    eps = float(np.float32(EPSILON))

    # static chain step lists per band per class
    chain_sets = {
        i: [_chain(N, int(b), int(t)) for b, t in classes]
        for (i, N, _ni_pad, classes, _v_pad) in band_spec
    }

    def per_position(per_band, head_fill, tail_fill):
        """[2F, nb - start] per-band values -> [2F, nmax] per position."""
        out = per_band.index_select(
            1, _band_of_position(LM, start, per_band.device))
        parts = []
        if head > 0:
            parts.append(out.new_full((2 * F, head), head_fill))
        parts.append(out)
        if tail > 0:
            parts.append(out.new_full((2 * F, tail), tail_fill))
        return torch.cat(parts, dim=1) if len(parts) > 1 else out

    def replay(arrs, mark=None):
        A = arrs["lcg_a"]
        Bc = arrs["lcg_b"]
        dev = A.device
        BIG = F * 2 * nmax
        rot_g_eff = None
        if heap_spec is not None:
            # dense plane from the compact heap: fill the per-leaf
            # (tgtbase - heap_start) delta forward along the heap axis,
            # then scatter value[pos] -> pos + delta. Padding leaves
            # carry start = Tpad and unfilled positions keep the BIG
            # sentinel; both, and the terminator's 1 << 30, point out of
            # range and land in one dump slot past the plane (int64
            # targets, so nothing wraps).
            Tpad, _Lpad = heap_spec
            dlt0 = torch.full((Tpad + 1,), BIG, dtype=torch.int64,
                              device=dev)
            dlt0[arrs["iyh_st"]] = arrs["iyh_dl"]
            dlt0 = dlt0[:Tpad]
            pos = torch.arange(Tpad, device=dev)
            last = torch.cummax(
                torch.where(dlt0 != BIG, pos, 0), dim=0).values
            tgt = pos + dlt0[last]
            tgt = torch.where((tgt < 0) | (tgt >= BIG), BIG, tgt)
            Xf = torch.zeros(BIG + 1, dtype=f32, device=dev)
            Xf[tgt] = arrs["iyh"].to(f32)
            if mark:
                mark("heap")
            if pvq_spec is not None:
                # device cwrsi: expand LF_PVQ_IDX codeword indices to
                # pulse vectors per length bucket, scatter into the
                # plane, and fix up pre-gain markers by 1/sqrt(Ryy)
                buckets, _total = pvq_spec
                rss = []
                for bi, (Lb, _lanes, _wk) in enumerate(buckets):
                    pre = f"pvq{bi}"
                    nv = arrs[pre + "_n"]
                    iy, ryy = cwrsi_expand(
                        arrs["utab"], nv, arrs[pre + "_k"],
                        arrs[pre + "_i"], Lb)
                    # iy columns are tail-aligned (position j at column
                    # Lb - n + j); fold the shift into the scatter
                    jj = torch.arange(Lb, device=dev)[None, :]
                    t2 = torch.where(
                        jj >= (Lb - nv)[:, None],
                        arrs[pre + "_tgt"][:, None] + nv[:, None]
                        - Lb + jj, BIG)
                    Xf[t2.reshape(-1)] = iy.reshape(-1)
                    rss.append(1.0 / torch.sqrt(ryy.clamp(min=1.0)))
                rs_all = torch.cat(rss) if rss else torch.ones(
                    1, dtype=f32, device=dev)
                gi = arrs["rot_gidx"]
                rot_g_eff = arrs["rot_g"] * torch.where(
                    gi >= 0, rs_all[gi.clamp(min=0)], 1.0)
                if mark:
                    mark("cwrsi")
            X2 = Xf[:BIG].view(F * 2, nmax)
        else:
            X2 = arrs["xs"].reshape(F * 2, nmax)
        if rotate is not None:
            X2 = rotate(X2, arrs, rot_g_eff)
            if mark:
                mark("rotation")

        def two(v):  # [F] per-frame vector -> [2F] per-row (both chans)
            return torch.cat([v, v], dim=0)

        norm = torch.zeros(2 * F, norm_len, dtype=f32, device=dev)
        spec_parts = []
        if start > 0:
            spec_parts.append(torch.zeros(2 * F, head, dtype=f32,
                                          device=dev))

        for (i, N, ni_pad, _classes, _v_pad) in band_spec:
            off = int(band_off[i])
            pre = f"b{i}"
            mode_b = arrs["mode_b"][:, i]
            active = mode_b > 0
            chains = chain_sets[i]
            any_pre = any(c[0] for c in chains)
            any_post = any(c[1] for c in chains)
            cls2 = two(arrs[pre + "_cls"])

            # dual->intensity averaging
            upto = off - norm_offset
            if upto > 0:
                avg = (arrs["avg_band"] == i)[:, None]
                mixed = 0.5 * (norm[:F, :upto] + norm[F:, :upto])
                norm[:F, :upto] = torch.where(avg, mixed, norm[:F, :upto])

            # lowband fetch (a per-row window of the norm carry) + pre
            # chain
            eff = arrs["eff_lb"][:, i]
            has_lb = eff >= 0
            offs_c = two(eff.clamp(0, max(norm_len - N, 0)))
            cols = offs_c[:, None] + torch.arange(N, device=dev)
            lb = norm.gather(1, cols.clamp(max=norm_len - 1))
            lb = torch.where(two(has_lb)[:, None], lb, 0.0)
            if any_pre:
                variants = [_apply_chain_static(lb, pre_steps)
                            for pre_steps, _post in chains]
                lb = variants[0]
                for c in range(1, len(variants)):
                    lb = torch.where((cls2 == c)[:, None], variants[c], lb)

            X0 = X2[:, off : off + N]
            # fold/noise fills (row + column scatter; row = c*F + f;
            # masked positions go to a dump column)
            if ni_pad:
                fo = arrs[pre + "_fo"]
                fg = arrs[pre + "_fg"]
                ft = arrs[pre + "_ft"]
                fr = arrs[pre + "_fc"] * F + arrs[pre + "_ff"]
                jj = torch.arange(N, device=dev)[None, :]
                m = jj < arrs[pre + "_fl"][:, None]
                seeds = _lcg_jump(A[jj + 1], Bc[jj + 1],
                                  arrs[pre + "_fs"][:, None])
                cols = fo[:, None] + jj
                lbv = lb[fr[:, None], torch.where(m, cols, 0)]
                sign = torch.where((seeds & 0x8000) != 0,
                                   1.0 / 256, -1.0 / 256)
                # the seed read as a signed 32-bit value, shifted
                # arithmetically
                nval = (torch.where(seeds >= 1 << 31, seeds - (1 << 32),
                                    seeds) >> 20).to(f32)
                v = torch.where(ft[:, None] == 1, lbv + sign, nval)
                v = torch.where(m, v, 0.0)
                E = eps + (v * v).sum(dim=1)
                v = v * (fg / torch.sqrt(E))[:, None]
                X0 = torch.cat([X0, X0.new_zeros(2 * F, 1)], dim=1)
                X0[fr[:, None], torch.where(m, cols, N)] = v
                X0 = X0[:, :N]

            # post chain (static per class, frame-selected)
            if any_post:
                variants = [_apply_chain_static(X0, post_steps)
                            for _pre, post_steps in chains]
                X0 = variants[0]
                for c in range(1, len(variants)):
                    X0 = torch.where((cls2 == c)[:, None], variants[c], X0)

            # norm write (pre-merge, X-call / decoded-slot values)
            lbout = active & (i < arrs["ends"] - 1)
            cfl1 = (arrs["cflag"][:, i] == 1)[:, None]
            if 0 <= off - norm_offset and off - norm_offset + N <= norm_len:
                sq = float(np.float32(np.sqrt(np.float64(N))))
                src0 = torch.where(
                    (mode_b == 3)[:, None],
                    torch.where(cfl1, X0[F:], X0[:F]), X0[:F])
                dst = slice(off - norm_offset, off - norm_offset + N)
                norm[:F, dst] = torch.where(lbout[:, None], sq * src0,
                                            norm[:F, dst])
                wd = lbout & (mode_b == 4)
                norm[F:, dst] = torch.where(wd[:, None], sq * X0[F:],
                                            norm[F:, dst])

            # stereo finalization
            Xf0, Xf1 = X0[:F], X0[F:]
            mid = arrs["imid"][:, i]
            side = arrs["iside"][:, i]
            m2 = mode_b == 2
            xp = (Xf1 * Xf0).sum(dim=1) * mid
            se = (Xf1 * Xf1).sum(dim=1)
            El = mid * mid + se - 2 * xp
            Er = mid * mid + se + 2 * xp
            passthru = (Er < 6e-4) | (El < 6e-4)
            lg = 1.0 / torch.sqrt(torch.where(passthru, 1.0, El))
            rg = 1.0 / torch.sqrt(torch.where(passthru, 1.0, Er))
            Lm = mid[:, None] * Xf0
            mX = torch.where(passthru[:, None], Xf0,
                             lg[:, None] * (Lm - Xf1))
            mY = torch.where(passthru[:, None], Xf0,
                             rg[:, None] * (Lm + Xf1))
            if N == 2:
                m3 = mode_b == 3
                sgn = arrs["sign"][:, i]
                a = torch.where(cfl1, X0[F:], X0[:F])
                der = torch.stack([-sgn * a[:, 1], sgn * a[:, 0]], dim=1)
                Xv = torch.where(cfl1, der, a)
                Yv = torch.where(cfl1, a, der)
                bX = mid[:, None] * Xv - side[:, None] * Yv
                bY = mid[:, None] * Xv + side[:, None] * Yv
                Xf0 = torch.where(m3[:, None], bX, Xf0)
                Xf1 = torch.where(m3[:, None], bY, Xf1)
            Xf0 = torch.where(m2[:, None], mX, Xf0)
            Xf1 = torch.where(m2[:, None], mY, Xf1)
            invs = (arrs["inv"][:, i] != 0)[:, None]
            Xf1 = torch.where(invs, -Xf1, Xf1)
            spec_parts.append(torch.where(
                two(active)[:, None], torch.cat([Xf0, Xf1], dim=0), 0.0))

        # one spare column past nmax: the anti-collapse scatter's dump
        spec_parts.append(torch.zeros(2 * F, tail + 1, dtype=f32,
                                      device=dev))
        spec = torch.cat(spec_parts, dim=1)
        if mark:
            mark("bands")

        # ---- anti-collapse (row + column scatter, row = c*F + f) ----
        if nac_pad:
            n0max = 22
            ac_r = arrs["ac_c"] * F + arrs["ac_f"]
            jj = torch.arange(n0max, device=dev)[None, :]
            m = jj < arrs["ac_n0"][:, None]
            seeds = _lcg_jump(A[jj + 1], Bc[jj + 1],
                              arrs["ac_seed"][:, None])
            r = arrs["ac_r"][:, None]
            vals = torch.where((seeds & 0x8000) != 0, r, -r)
            cols = arrs["ac_base"][:, None] + (jj << LM)
            spec[ac_r[:, None], torch.where(m, cols, nmax)] = vals
            spec = spec[:, :nmax]
            # renormalise_vector per flagged (row, band): a [2F, nb]
            # flag plane (tiny scatter; padded entries go to a dump
            # row), the per-band sum of squares from static band
            # slices, and the gains broadcast back band-wise
            ren_rows = arrs["ren_c"] * F + arrs["ren_f"]
            flags = torch.zeros(2 * F + 1, nb, dtype=torch.bool, device=dev)
            # (the flag values come from the device: a Python True
            # would be a host copy)
            flags[torch.where(arrs["ren_on"], ren_rows, 2 * F),
                  arrs["ren_b"]] = arrs["ren_on"]
            ss = torch.stack(
                [spec[:, int(band_off[b]) : int(band_off[b + 1])]
                 .square().sum(dim=1) for b in range(start, nb)], dim=1)
            gb = torch.where(flags[: 2 * F, start:nb],
                             1.0 / torch.sqrt(eps + ss), 1.0)
            spec = spec * per_position(gb, 1.0, 1.0)
        else:
            spec = spec[:, :nmax]

        # ---- denormalise + mixes ----
        g2 = torch.cat([arrs["gains"][:, 0], arrs["gains"][:, 1]], dim=0)
        freq = spec * per_position(g2[:, start:nb], 0.0, 0.0)
        freq = torch.where(two(arrs["sil"])[:, None], 0.0, freq)
        if CCout == 2:
            freq[F:] = torch.where(arrs["dup"][:, None], freq[:F], freq[F:])
        if CC == 1:
            freq[:F] = torch.where(arrs["mixd"][:, None],
                                   0.5 * (freq[:F] + freq[F:]), freq[:F])
        if mark:
            mark("finish")
        # [CCout*F, nmax]: channel c is the contiguous row block
        # [c*F, (c+1)*F)
        return freq[: CCout * F]

    return replay


def replay_device(tr: CeltTrace, device=None):
    """Full device replay: trace -> freq [F, CCout, nmax] (tensor on the
    device). The replay itself is 2-D with channel-major rows
    ([CCout*F, nmax], see _replay_builder); this wrapper reshapes to the
    frame-leading shape of the native decoder's spectra."""
    dev = resolve_device(device)
    arrs, _static, static_key = build_replay_arrays(tr)
    out = _replay_builder(static_key)(replay_arrays_from_numpy(arrs, dev))
    F, nmax = len(tr.fsz), out.shape[-1]
    return out.reshape(-1, F, nmax).permute(1, 0, 2)
