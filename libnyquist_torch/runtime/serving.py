"""Multi-stream serving: batched device synthesis across concurrent streams.

The dense half of many streams runs as single device calls over a batch
axis of [stream x channel] rows; the host entropy decode stays
per-stream. Two shapes:

* the segmented path (``synthesize_streams``): streams with equal frame
  signatures — the per-frame (LM, shortBlocks) sequence — synthesize one
  (LM, shortBlocks) run at a time;
* the unified chunked path (``unified_step_row_body`` under the one step
  loop ``run_synthesis_batched``; ``synthesize_streams_unified`` is its
  K = 1 call): one step per chunk of frames, long and short blocks mixed
  by a per-frame mask, so a stream costs F/f_chunk steps instead of one
  call per run.

``run_stream_batched`` is the main path: it replays each stream's PVQ
value plane on the device from its host trace (``ops/celt_replay.py``)
into the layout ``run_synthesis_batched`` takes (rows ordered
``c*K + k``) and runs the step loop on it.

The same batching serves MP3 (``synthesize_mp3_streams``: the IMDCT and
QMF products of ``ops/mp3_synth.py`` over [S, G] granule batches),
Musepack (``synthesize_mpc_streams``: one product and the 16-tap combine
over [stream x channel] rows of requantized subband samples) and Vorbis
(``synthesize_vorbis_streams_mixed``: one IMDCT product per blocksize
over [stream x channel] rows of staged spectra, the lap windows, and the
overlap-add as two gathers planned on the host by ``vorbis_lap_plan``).
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from ..device import resolve_device
from ..formats.opus.celt_host import COMBFILTER_MINPERIOD
from ..formats import musepack
from ..formats import vorbis
from ..formats.opus.celt_tables import COMB_GAINS, mode48000
from ..ops import celt_replay as replay_ops
from ..ops import comb as comb_ops
from ..ops import imdct as imdct_ops
from ..ops import mp3_synth
from ..ops import scan_iir
from .batching import bucket_size
from .opus_pipeline import (
    CELT_SIG_SCALE,
    SynthState,
    _chunk_tensors,
    postfilter_frame_params,
)

F_CHUNK = 512  # frames per device step (~10.2 s of 20 ms frames)


def _signature(infos) -> tuple:
    return tuple((i["LM"], i["shortBlocks"]) for i in infos)


def synthesize_streams(
    infos_per_stream: List[List[dict]], channels: int, device=None,
) -> List[torch.Tensor]:
    """Batched synthesize_stream over streams with equal frame signatures.

    Args:
      infos_per_stream: per stream, the host decode's frame dicts. Shorter
        streams are padded with inert frames up to the longest; all real
        frames at the same index must share (LM, shortBlocks).
    Returns: per stream, [S_stream, channels] float32 PCM on the device.
    """
    dev = resolve_device(device)
    mode = mode48000()
    n_streams = len(infos_per_stream)
    lengths = [len(s) for s in infos_per_stream]
    F_max = max(lengths)
    ref = max(infos_per_stream, key=len)

    # pad shorter streams with inert frames matching the reference frame
    padded = []
    for s in infos_per_stream:
        if len(s) < F_max:
            pads = [
                dict(r, freq=np.zeros_like(r["freq"]),
                     postfilter_pitch=COMBFILTER_MINPERIOD,
                     postfilter_gain=0.0, postfilter_tapset=0)
                for r in ref[len(s):]
            ]
            s = list(s) + pads
        padded.append(s)
    sig = _signature(ref)
    for s in padded:
        if _signature(s) != sig:
            raise ValueError("frame signatures differ; cannot batch")

    states = [SynthState(channels=channels, device=dev)
              for _ in range(n_streams)]
    fparams = [postfilter_frame_params(s) for s in padded]

    outs = [[] for _ in range(n_streams)]
    i = 0
    while i < F_max:
        j = i
        key = sig[i]
        while j < F_max and sig[j] == key:
            j += 1
        _synth_segment_batch(padded, fparams, states, slice(i, j),
                             channels, mode, outs)
        i = j
    results = []
    for k, o in enumerate(outs):
        full = torch.cat(o, dim=0)
        real = sum(fr["N"] for fr in infos_per_stream[k])
        results.append(full[:real])
    return results


def _synth_segment_batch(padded, fparams, states, seg, CC, mode, outs):
    dev = states[0].device
    infos0 = padded[0][seg]
    LM = infos0[0]["LM"]
    shortBlocks = infos0[0]["shortBlocks"]
    N = infos0[0]["N"]
    F = len(infos0)
    n_streams = len(padded)
    rows = n_streams * CC

    if shortBlocks:
        B = shortBlocks
        Nmdct = 2 * mode.shortMdctSize
    else:
        B = 1
        Nmdct = (2 * mode.shortMdctSize) << LM

    Fb = bucket_size(F, 8)
    S = F * N

    spectra = np.zeros((rows, Fb, N), np.float32)
    for k, s in enumerate(padded):
        for f, info in enumerate(s[seg]):
            spectra[k * CC : (k + 1) * CC, f] = info["freq"]

    # One device call for the whole [streams x channels] batch.
    tails = torch.zeros(rows, mode.overlap, device=dev)
    for k in range(n_streams):
        for c in range(CC):
            t = states[k].imdct_tail[c]
            if t is not None:
                tails[k * CC + c] = t
    raw, all_tails = imdct_ops.celt_imdct_rows(
        torch.from_numpy(spectra).to(dev), Nmdct, mode.overlap, B=B,
        tails=tails,
    )
    carry = all_tails[:, F - 1]  # after the last REAL frame
    for k in range(n_streams):
        for c in range(CC):
            states[k].imdct_tail[c] = carry[k * CC + c]
    # Postfilter over the real frames only (causal: see
    # opus_pipeline.synthesize_segment).
    parts = [
        _chunk_tensors(comb_ops.build_chunk_params(
            fparams[k][seg], N, mode.window, mode.shortMdctSize), CC, dev)
        for k in range(n_streams)
    ]
    chunk_args = [torch.cat(a, dim=0) for a in zip(*parts)]
    hist = torch.cat([st.comb_hist for st in states], dim=0)
    y, new_hist = comb_ops.comb_filter(
        raw[:, :S].contiguous(), hist, *chunk_args)
    for k in range(n_streams):
        states[k].comb_hist = new_hist[k * CC : (k + 1) * CC]

    mem = torch.cat([st.deemph_mem for st in states])
    padn = (-S) % scan_iir.BLOCK
    out, _ = scan_iir.deemphasis(torch.nn.functional.pad(y, (0, padn)), mem)
    out = out[:, :S]
    for k in range(n_streams):
        states[k].deemph_mem = out[k * CC : (k + 1) * CC, S - 1].clone()

    scale = 1.0 / CELT_SIG_SCALE
    for k in range(n_streams):
        outs[k].append(out[k * CC : (k + 1) * CC].T * scale)   # [S, CC]


# ----------------------------------------------------------------------
# Unified chunked serving: one step shape for mixed long/transient
# frames. The long-block and short-block synthesis matrices have the same
# shape [N2, N2], so a per-frame 0/1 mask selects between them with two
# extra masked products instead of per-segment dispatch.
# ----------------------------------------------------------------------


def postfilter_params_arrays(short_blocks, pf_pitch, pf_gain, pf_tapset):
    """Vectorized postfilter state machine for LM>0 streams.

    For LM != 0 frames the decoder collapses the two-frame-old state to
    the previous frame's (celt_decoder_clean.c:669-685), so the segment-A
    (first shortMdctSize samples) params are simply the previous frame's
    signaled values and segment B crossfades previous -> current.
    Returns per-frame arrays (TA, gA[3], TB1, gB1[3]) where segment A uses
    (T0=T1=TA, g0=g1=gA) and segment B uses (T0=TA, T1=TB1, g0=gA, g1=gB1).
    """
    gains_tbl = np.asarray(COMB_GAINS, np.float32)           # [tapsets, 3]
    T_cur = np.maximum(np.asarray(pf_pitch, np.int32), COMBFILTER_MINPERIOD)
    g_cur = gains_tbl[np.asarray(pf_tapset, np.int64)] * np.asarray(
        pf_gain, np.float32)[:, None]
    TA = np.concatenate([[COMBFILTER_MINPERIOD], T_cur[:-1]]).astype(np.int32)
    gA = np.concatenate([np.zeros((1, 3), np.float32), g_cur[:-1]])
    return TA, gA, T_cur, g_cur


@functools.lru_cache(maxsize=None)
def _fade_pattern(N, overlap, short_mdct):
    """Per-frame crossfade pattern [chunks_per_frame, CHUNK]: w^2 ramp in
    the first `overlap` samples of each comb segment, 1.0 after — the
    same for every frame, so built once and tiled on the device."""
    mode = mode48000()
    w2 = (mode.window * mode.window).astype(np.float32)
    cpf = N // comb_ops.CHUNK
    fade = np.ones((cpf, comb_ops.CHUNK), np.float32)
    for k in range(cpf):
        pos = k * comb_ops.CHUNK
        seg = 0 if pos < short_mdct else short_mdct
        for j in range(comb_ops.CHUNK):
            r = pos - seg + j
            if r < overlap:
                fade[k, j] = w2[r]
    return fade


def expand_comb_params(TA, gA, TB1, gB1, fade_pat, N, short_mdct):
    """Per-frame comb params [R, F(, 3)] -> the per-chunk comb_filter
    arguments (T0, T1, gains0, gains1, fade), contiguous [R, F*N/12, ...].
    Segment A (the first short_mdct samples of a frame) keeps the previous
    frame's params on both sides; segment B crossfades to the current."""
    R, F = TA.shape
    cpf = N // comb_ops.CHUNK
    nch = F * cpf
    seg_a = (torch.arange(cpf, device=TA.device) * comb_ops.CHUNK
             < short_mdct)                                     # [cpf]
    T0 = TA[:, :, None].expand(R, F, cpf)
    T1 = torch.where(seg_a, TA[:, :, None], TB1[:, :, None])
    g0 = gA[:, :, None, :].expand(R, F, cpf, 3)
    g1 = torch.where(seg_a[:, None], gA[:, :, None, :], gB1[:, :, None, :])
    fade = fade_pat[None].expand(F, cpf, comb_ops.CHUNK).reshape(
        1, nch, comb_ops.CHUNK).expand(R, nch, comb_ops.CHUNK)
    return (T0.reshape(R, nch).contiguous(), T1.reshape(R, nch).contiguous(),
            g0.reshape(R, nch, 3).contiguous(),
            g1.reshape(R, nch, 3).contiguous(), fade.contiguous())


def unified_step_row_body(spec, mask_s, TA, gA, TB1, gB1, fade_pat,
                          T1m, T1p, T8m, T8p, tails, hist, mem,
                          overlap, short_mdct, *, with_comb=True,
                          with_deemph=True):
    """One serving step: [R, F, N] spectra -> [R, F*N] PCM, with PER-ROW
    comb params and short-block mask (each row may come from another
    stream).

    mask_s/TA/TB1: [R, F] (lags int32); gA/gB1: [R, F, 3];
    fade_pat: [N // CHUNK, CHUNK]; T1m/T1p/T8m/T8p: [N, N] long / short
    synthesis matrices; tails [R, overlap], hist [R, HIST], mem [R]:
    the carries. Returns (pcm, new_tails, new_hist, new_mem).

    with_comb / with_deemph switch a stage off for the per-stage time
    split; serving always runs with both on.
    """
    R, F, N = spec.shape
    mL = (1.0 - mask_s)[:, :, None]
    mS = mask_s[:, :, None]

    specL = spec * mL
    specS = spec * mS
    main = specL.reshape(-1, N) @ T1m + specS.reshape(-1, N) @ T8m
    zero = spec.new_zeros(R, 1, N)
    prevL = torch.cat([zero, specL[:, :-1]], dim=1).reshape(-1, N)
    prevS = torch.cat([zero, specS[:, :-1]], dim=1).reshape(-1, N)
    shifted = prevL @ T1p + prevS @ T8p
    raw = (main + shifted).reshape(R, F, N)
    raw[:, 0, :overlap] += tails
    new_tails = (specL[:, -1] @ T1p[:, :overlap]
                 + specS[:, -1] @ T8p[:, :overlap])

    S = F * N
    if with_comb:
        y, new_hist = comb_ops.comb_filter(
            raw.reshape(R, S), hist,
            *expand_comb_params(TA, gA, TB1, gB1, fade_pat, N, short_mdct))
    else:
        y, new_hist = raw.reshape(R, S), hist
    if with_deemph:
        pad = (-S) % scan_iir.BLOCK
        out, new_mem = scan_iir.deemphasis(
            torch.nn.functional.pad(y, (0, pad)), mem)
    else:
        out, new_mem = y, mem
    pcm = out[:, :S] * (1.0 / CELT_SIG_SCALE)
    return pcm, new_tails, new_hist, new_mem


def _synthesis_matrices_np(N, short_blocks_max):
    """(T1m, T1p, T8m, T8p) for frame size N; the short pair is zeros
    when there are no short blocks."""
    mode = mode48000()
    LM = (N // mode.shortMdctSize).bit_length() - 1
    T1m, T1p, _ = imdct_ops.celt_synthesis_matrices_paired(
        (2 * mode.shortMdctSize) << LM, mode.overlap, 1)
    if short_blocks_max:
        T8m, T8p, _ = imdct_ops.celt_synthesis_matrices_paired(
            2 * mode.shortMdctSize, mode.overlap, short_blocks_max)
    else:
        T8m, T8p = np.zeros_like(T1m), np.zeros_like(T1p)
    return T1m, T1p, T8m, T8p


def synthesize_streams_unified(
    freq, short_blocks, pf_pitch, pf_gain, pf_tapset, channels,
    f_chunk: int = F_CHUNK, device=None,
):
    """Whole-stream device synthesis without segmentation: a K = 1 call
    of run_synthesis_batched.

    Args:
      freq: [F, CC, N] float32 denormalised spectra (the native stream
        decoder's raw output layout), one stream.
      short_blocks / pf_*: per-frame arrays from the native decoder.
    Returns [S, CC] float32 PCM on the device.
    Requires every frame to share N (fixed frame size) and LM > 0.
    """
    dev = resolve_device(device)
    mode = mode48000()
    F, CC, N = freq.shape
    LM = (N // mode.shortMdctSize).bit_length() - 1
    if LM == 0:
        raise NotImplementedError(
            "2.5 ms (LM = 0) frames in the unified serving path: see "
            "ROADMAP.md, queue item 'Opus general path'")
    n_steps = -(-F // f_chunk)
    synth = synth_from_numpy(synth_tables(
        [(short_blocks, pf_pitch, pf_gain, pf_tapset)], N, n_steps,
        f_chunk), dev)
    spec = torch.from_numpy(np.ascontiguousarray(
        np.transpose(freq, (1, 0, 2)), np.float32)).to(dev)  # [CC, F, N]
    _, pcm = run_synthesis_batched(spec, synth, 1, CC, n_steps, f_chunk)
    return pcm.T


def synth_tables(streams, N, n_steps, f_chunk) -> dict:
    """The bench's synthesis tables (numpy), for K streams of frame size N.

    streams: per stream (short_blocks, pf_pitch, pf_gain, pf_tapset)
    arrays of the native decoder. Returns msk/TA/gA/TB1/gB1 as
    [K, n_steps, f_chunk(, 3)] (padding frames: T=15, zero gains, long
    blocks), the fade pattern and T1m/T1p/T8m/T8p, with the short-block
    pair built for the largest short-block count of the batch."""
    mode = mode48000()
    Fpad = n_steps * f_chunk

    def chunked(vals, fill, tail=()):
        out = np.full((Fpad,) + tail, fill, np.asarray(vals).dtype)
        out[: len(vals)] = vals
        return out.reshape((n_steps, f_chunk) + tail)

    cols = {k: [] for k in ("msk", "TA", "gA", "TB1", "gB1")}
    for sb, pfp, pfg, pft in streams:
        TA, gA, TB1, gB1 = postfilter_params_arrays(sb, pfp, pfg, pft)
        cols["msk"].append(chunked(
            (np.asarray(sb) != 0).astype(np.float32), 0.0))
        cols["TA"].append(chunked(TA, COMBFILTER_MINPERIOD))
        cols["gA"].append(chunked(gA, 0.0, (3,)))
        cols["TB1"].append(chunked(TB1, COMBFILTER_MINPERIOD))
        cols["gB1"].append(chunked(gB1, 0.0, (3,)))
    out = {k: np.stack(v) for k, v in cols.items()}
    B_short = max(int(np.max(sb, initial=0)) for sb, *_ in streams)
    T1m, T1p, T8m, T8p = _synthesis_matrices_np(N, B_short)
    out.update(fade=_fade_pattern(N, mode.overlap, mode.shortMdctSize),
               T1m=T1m, T1p=T1p, T8m=T8m, T8p=T8p)
    return out


def synth_from_numpy(synth: dict, device) -> dict:
    """The bench's synthesis-table dict (msk/TA/gA/TB1/gB1 as
    [K, n_steps, f_chunk(, 3)], fade [N//12, 12], T1m/T1p/T8m/T8p
    [N, N]) as device tensors: lags int32, everything else float32."""
    dev = torch.device(device)
    out = {}
    for name, v in synth.items():
        dt = np.int32 if name in ("TA", "TB1") else np.float32
        out[name] = torch.from_numpy(np.ascontiguousarray(v, dt)).to(dev)
    return out


def run_synthesis_batched(spec, synth, K, CC, n_steps, f_chunk, *,
                          with_comb=True, with_deemph=True):
    """The K-stream synthesis step loop (the device replay's consumer).

    Args:
      spec: [R = CC*K, F, N] spectra, rows ordered channel-major
        (``c*K + k``), F <= n_steps * f_chunk (padded here with zero
        frames).
      synth: device dict from synth_from_numpy; per-stream params are
        [K, n_steps, f_chunk(, 3)] and are tiled over channels.
    Returns (acc [K, CC] per-row PCM sums over every step, pcm [R, F*N]).
    """
    mode = mode48000()
    overlap, short_mdct = mode.overlap, mode.shortMdctSize
    R, F, N = spec.shape
    if R != K * CC:
        raise ValueError(f"spec has {R} rows, expected K*CC = {K * CC}")
    if F > n_steps * f_chunk:
        raise ValueError(f"{F} frames exceed n_steps*f_chunk")
    dev = spec.device

    def param(name, step):                   # [K, ...] -> rows (c*K + k)
        v = synth[name][:, step]
        return v.repeat((CC,) + (1,) * (v.dim() - 1))

    tails = torch.zeros(R, overlap, device=dev)
    hist = torch.zeros(R, comb_ops.HIST, device=dev)
    mem = torch.zeros(R, device=dev)
    acc = torch.zeros(R, device=dev)
    pcm_all = torch.empty(R, F * N, device=dev)
    for step in range(n_steps):
        lo = step * f_chunk
        sp = spec[:, lo : lo + f_chunk]
        if sp.shape[1] < f_chunk:
            sp = torch.nn.functional.pad(sp, (0, 0, 0, f_chunk - sp.shape[1]))
        pcm, tails, hist, mem = unified_step_row_body(
            sp, param("msk", step), param("TA", step), param("gA", step),
            param("TB1", step), param("gB1", step), synth["fade"],
            synth["T1m"], synth["T1p"], synth["T8m"], synth["T8p"],
            tails, hist, mem, overlap, short_mdct,
            with_comb=with_comb, with_deemph=with_deemph)
        acc = acc + pcm.sum(dim=1)
        n_real = max(0, min(F - lo, f_chunk)) * N
        pcm_all[:, lo * N : lo * N + n_real] = pcm[:, :n_real]
    return acc.reshape(CC, K).T, pcm_all


def replay_streams(streams, K, CC):
    """Replay K streams' PVQ value planes on the device into the
    synthesis layout.

    streams: per stream ``(arrs, static_key)``: the device dict of
    ops.celt_replay.replay_arrays_from_numpy and the structure key of
    build_replay_arrays. The streams share the frame count F and the
    frame size N but need not share a key (band classes, bucket sizes
    and sigma sets may differ): each is replayed on its own (one
    rotation-kernel launch per raw-iy stream) and written into its rows.
    Returns spec [CC*K, F, N], rows ordered channel-major (``c*K + k``).
    """
    if len(streams) != K:
        raise ValueError(f"{len(streams)} streams, expected K = {K}")
    F, N = streams[0][1][:2]
    for k, (_, key) in enumerate(streams):
        if key[:2] != (F, N):
            raise ValueError(
                f"stream {k} has (F, N) = {key[:2]}, expected {(F, N)}")
    spec = None
    for k, (arrs, key) in enumerate(streams):
        fq = replay_ops._replay_builder(key)(arrs)       # [CCout*F, N]
        if fq.shape[0] < CC * F:
            raise ValueError(f"stream {k} replays {fq.shape[0] // F} "
                             f"channels, expected CC = {CC}")
        if spec is None:
            spec = fq.new_empty(CC * K, F, N)
        for c in range(CC):
            spec[c * K + k] = fq[c * F : (c + 1) * F]
    return spec


def run_stream_batched(streams, synth, K, CC, n_steps, f_chunk, *,
                       with_synth=True, with_comb=True, with_deemph=True):
    """The K-stream serving program: device replay of every stream's
    trace, then the synthesis step loop (at K = 1, the single-stream
    program).

    Args:
      streams: per stream ``(arrs, static_key)`` (see replay_streams).
      synth: device dict from synth_from_numpy.
    Returns (acc [K, CC] per-row PCM sums, pcm [CC*K, F*N]) as
    run_synthesis_batched does. with_synth=False stops after the replay
    and returns (the per-row sums of the replayed spectra [K, CC], None);
    with_comb / with_deemph switch a synthesis stage off. The switches
    serve the per-stage time split; serving runs with all three on.
    """
    spec = replay_streams(streams, K, CC)
    if not with_synth:
        return spec.sum(dim=(1, 2)).reshape(CC, K).T, None
    return run_synthesis_batched(spec, synth, K, CC, n_steps, f_chunk,
                                 with_comb=with_comb,
                                 with_deemph=with_deemph)


# --------------------------------------------------------------------------
# MP3 and Musepack serving: batched device synthesis over streams
# --------------------------------------------------------------------------
def synthesize_mp3_streams(X, kinds, nch: int, device=None) -> torch.Tensor:
    """K-stream MP3 dense half on the device.

    Args:
      X: [S, G, C, 576] float32 frequency planes of S streams of G
        granules (each from ``formats.mp3.l3_stream_entropy``; a stream
        that resets or changes parameters is decoded per segment by
        ``load()`` instead), NumPy or tensor.
      kinds: [S, G, C, 32] int8 band kinds; they become bool masks on the
        device.
    Returns PCM [S, G * 576, nch] on the device, every stream starting
    from silence.
    """
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    kinds = torch.as_tensor(kinds, dtype=torch.int8, device=dev)
    return mp3_synth.synth_module(nch, 18, dev)(X, kinds)


def synthesize_mpc_streams(ys, device=None) -> torch.Tensor:
    """Batched whole-stream Musepack synthesis in float32, zero initial V
    state (reference: musepack/libmpcdec/synth_filter.c:356).

    Args:
      ys: [R, T, 32] requantized subband rows (T = 36 * n_frames) of R
        stream-channels (``formats.musepack.requantized_rows``), NumPy
        or tensor.
    Returns [R, T * 32] pcm on the device: one [R*T, 32] @ [32, 64]
    product plus the 16-tap sliding combine, row for row the plain
    ``formats.musepack._synth_stream``.
    """
    dev = resolve_device(device)
    return musepack.synth_rows(torch.as_tensor(ys, dtype=torch.float32,
                                               device=dev))


# --------------------------------------------------------------------------
# Vorbis serving: batched IMDCT + window + lapping over streams x packets
# (reference: libvorbis/src/mdct.c:397 mdct_backward, block.c lapping)
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def _imdct_t(n: int, device: torch.device) -> torch.Tensor:
    """The float32 [n/2, n] transpose of the float64-built IMDCT matrix."""
    m = vorbis.imdct_matrix(n).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(m.T)).to(device)


def synthesize_vorbis_streams(specs, n: int, device=None) -> torch.Tensor:
    """Batched uniform-blocksize Vorbis synthesis.

    Args:
      specs: [R, F, n//2] per-packet spectra (floor curve x residue, after
        coupling) of R stream-channels with blocksize n on every packet,
        NumPy or tensor.
    Returns [R, (F-1) * n//2] pcm on the device (Vorbis emits from the
    second packet; the first primes the lap cache): one product plus two
    shifted windowed adds.
    """
    dev = resolve_device(device)
    specs = torch.as_tensor(specs, dtype=torch.float32, device=dev)
    R, F, n2 = specs.shape
    if 2 * n2 != n:
        raise ValueError(f"spectra of {n2} bins for blocksize {n}")
    half = vorbis.vorbis_window(n2)
    wfull = torch.from_numpy(
        np.concatenate([half, half[::-1]]).astype(np.float32)).to(dev)
    tw = torch.matmul(specs, _imdct_t(n, dev)) * wfull
    return (tw[:, :-1, n2:] + tw[:, 1:, :n2]).reshape(R, -1)


def vorbis_lap_plan(frames_meta, blocksizes) -> dict:
    """The static lapping structure of a mixed-blocksize Vorbis packet
    sequence (the serving signature), on the host.

    Args:
      frames_meta: per packet (n, blockflag, long_prev, long_next).
      blocksizes: (bs0, bs1).
    Returns dict with:
      W [F, nmax] float32 — per-packet lap window, zero-padded;
      idx_prev / idx_cur [out_len] int64 — gather indices into the
        flattened windowed time-domain plane [F * nmax]: each output
        sample sums at most one previous-packet tail and one
        current-packet head value (-1: none, masked);
      out_len, nmax, ns (the per-packet blocksizes).
    """
    F = len(frames_meta)
    ns = [m[0] for m in frames_meta]
    nmax = max(ns) if ns else 0
    W = np.zeros((F, nmax), np.float32)
    windows = {}
    for f, (n, bf, lp, ln) in enumerate(frames_meta):
        key = (n, bool(bf), bool(lp), bool(ln))
        if key not in windows:
            windows[key] = vorbis._lap_window(n, blocksizes, bf, lp, ln)
        W[f, :n] = windows[key]

    # the emission of the reference's packet loop, as index spans
    out_len = 0
    prev_n = 0
    spans_prev = []   # (dst, frame, src, length): previous packet's tail
    spans_cur = []    # the current packet's head
    for f, n in enumerate(ns):
        if f > 0:
            L = prev_n // 4 + n // 4
            spans_prev.append((out_len, f - 1, prev_n // 2,
                               min(prev_n // 2, L)))
            o = prev_n // 4 - n // 4
            s0 = max(o, 0)
            length = min(L - s0, n // 2 - (s0 - o))
            if length > 0:
                spans_cur.append((out_len + s0, f, s0 - o, length))
            out_len += L
        prev_n = n
    idx_prev = np.full(out_len, -1, np.int64)
    idx_cur = np.full(out_len, -1, np.int64)
    for idx, spans in ((idx_prev, spans_prev), (idx_cur, spans_cur)):
        for dst, f, src, ln in spans:
            idx[dst : dst + ln] = f * nmax + src + np.arange(ln)
    return dict(W=W, idx_prev=idx_prev, idx_cur=idx_cur, out_len=out_len,
                nmax=nmax, ns=ns)


def _vorbis_plan_tensors(plan: dict, dev: torch.device) -> dict:
    """The plan's arrays on ``dev``, uploaded once and kept in the plan."""
    cache = plan.setdefault("_device", {})
    t = cache.get(dev)
    if t is None:
        ns = np.asarray(plan["ns"])

        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        t = dict(
            W=up(plan["W"], torch.float32),
            groups=[(int(n), up(np.nonzero(ns == n)[0], torch.int64))
                    for n in sorted(set(plan["ns"]))],
            ip=up(np.maximum(plan["idx_prev"], 0), torch.int64),
            ic=up(np.maximum(plan["idx_cur"], 0), torch.int64),
            mp=up(plan["idx_prev"] >= 0, torch.float32),
            mc=up(plan["idx_cur"] >= 0, torch.float32),
        )
        cache[dev] = t
    return t


def synthesize_vorbis_streams_mixed(specs_padded, plan: dict,
                                    device=None) -> torch.Tensor:
    """Batched mixed-blocksize Vorbis synthesis over R stream-channels.

    Args:
      specs_padded: [R, F, nmax//2] spectra zero-padded per packet, NumPy
        or tensor.
      plan: ``vorbis_lap_plan`` of the packet sequence the R rows share;
        its arrays are uploaded on the first call for a device and kept
        in the plan.
    Returns [R, out_len] pcm on the device.

    One product per distinct blocksize, written into the [R, F, nmax]
    plane by ``index_copy_`` (no second plane-sized temporary), the lap
    windows, then the overlap-add as two masked gathers with static
    indices: no per-packet control flow on the device.
    """
    dev = resolve_device(device)
    t = _vorbis_plan_tensors(plan, dev)
    specs = torch.as_tensor(specs_padded, dtype=torch.float32, device=dev)
    R, F, _ = specs.shape
    nmax = plan["nmax"]
    tw = torch.empty((R, F, nmax), dtype=torch.float32, device=dev)
    for n, sel in t["groups"]:
        td = torch.matmul(specs[:, :, : n // 2].index_select(1, sel),
                          _imdct_t(n, dev))               # [R, F_n, n]
        tw[:, :, :n].index_copy_(1, sel, td)
        if n < nmax:
            tw[:, :, n:].index_fill_(1, sel, 0.0)
        del td
    tw *= t["W"]
    flat = tw.view(R, F * nmax)
    return (flat.index_select(1, t["ip"]) * t["mp"]
            + flat.index_select(1, t["ic"]) * t["mc"])
