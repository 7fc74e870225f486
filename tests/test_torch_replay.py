"""The port's iy-split path (host trace, replay arrays, device replay,
the K-stream program) against the JAX package, on the in-repo golden
packets and on streams of the in-repo encoder.

Tolerances, each where it is used:
* traces, replay arrays, static keys, cwrsi: exact equality (integers,
  and floats produced by the same C or NumPy code);
* the port's replay against the JAX replay on the golden corpus:
  max d/(1+|ref|) < 1e-4 and at most 2e-5 of the values above 1e-5
  (float32 on both sides; the stereo merge cancels at isolated
  positions, where the two sides' different summation order shows: 2 of
  192,000 values on the idx-mode golden trace);
* either replay against the full native decode: the reference's own
  gates, max d/(1+|ref|) < 1e-3 and mean(rel > 1e-4) < 1e-5 (1e-4 for
  the encoder streams, as the reference has it);
* the two replays on the encoder streams (loud noise, values to 2e4):
  those same reference gates, max < 1e-3 and mean(rel > 1e-4) < 1e-4.
  Each float32 replay is as far from the float64 replayer there (max
  1.1e-4 and 1.7e-4, a share of 1e-3 above 1e-5) as from the other, so
  a tighter gate between them would measure rounding, not the port;
* per-row PCM sums ``acc`` against the JAX stream programs: 1e-3
  absolute (the reference's tolerance); a batch of streams with
  different structure against its single-stream runs: 1e-6;
* PCM against libopus: 1e-4.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from .test_iy_split import _frames_from_golden, _frames_from_ogg
from .test_opus_pipeline import read_case

MODES = {
    "dense": dict(),
    "raw_iy": dict(raw_iy=True),
    "xs_heap": dict(raw_iy=True, xs_heap=True),
    "idx_mode": dict(raw_iy=True, xs_heap=True, idx_mode=True),
}
SERVING = MODES["idx_mode"]


@functools.lru_cache(maxsize=None)
def _golden_feed():
    from .conftest import GOLDEN_DIR

    return _frames_from_golden(GOLDEN_DIR / "opus_packets.bin")


@functools.lru_cache(maxsize=None)
def _encoded_feed(kind, frame_ms):
    """The encoder streams of the reference's device-replay tests: half
    a second of two tones plus noise ("plain", seed 7) or plus gated
    noise bursts ("transients", seed 11), stereo at 128 kb/s."""
    from libnyquist_tpu.formats.opus.celt_encoder import encode_ogg_opus

    sr = 48000
    t = np.arange(sr // 2) / sr
    if kind == "transients":
        rng = np.random.default_rng(11)
        noise = 0.15 * (rng.standard_normal(len(t))
                        * (1 + 5 * (np.sin(2 * np.pi * 7 * t) > 0.9)))
        amp, left, right = 0.4, noise, noise
    else:
        rng = np.random.default_rng(7)
        amp = 0.5
        left = 0.2 * rng.standard_normal(len(t))
        right = 0.2 * rng.standard_normal(len(t))
    pcm = np.stack([amp * np.sin(2 * np.pi * 500 * t) + left,
                    amp * np.sin(2 * np.pi * 750 * t) + right],
                   axis=1).reshape(-1).astype(np.float32)
    return (2,) + _frames_from_ogg(encode_ogg_opus(
        pcm, 2, sr, bitrate_kbps=128, frame_ms=frame_ms))


def _traces(feed, modes, state_kw=None):
    """(JAX package's trace, port's trace, native full-decode spectra)."""
    from libnyquist_tpu.formats.opus import celt as jcelt
    from libnyquist_torch.formats.opus import iy_split as tsplit
    from libnyquist_torch.formats.opus.celt_host import CeltDecoderState

    from .test_iy_split import _trace

    ch, frames, sizes, ends, chs = feed
    kw = state_kw or {}
    freq = jcelt.celt_decode_stream_raw(
        jcelt.CeltDecoderState(channels=ch, **kw), frames, sizes, ends,
        chs)[0]
    jt = _trace(jcelt.CeltDecoderState(channels=ch, **kw), frames, sizes,
                ends, chs, **modes)
    tt = tsplit.trace_frames(CeltDecoderState(channels=ch, **kw), frames,
                             sizes, ends, chs, **modes)
    return jt, tt, freq


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref) / (1.0 + np.abs(ref))


# ------------------------- (a) the host half -------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_trace_and_replay_arrays_match_jax(mode):
    from libnyquist_tpu.ops import celt_replay as jrep
    from libnyquist_torch.ops import celt_replay as trep

    jt, tt, _ = _traces(_golden_feed(), MODES[mode])
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    ja, _, jkey = jrep.build_replay_arrays(jt)
    ta, _, tkey = trep.build_replay_arrays(tt)
    assert jkey == tkey
    assert list(ja) == list(ta)
    for k in ja:
        a, b = np.asarray(ja[k]), np.asarray(ta[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    dev = trep.replay_arrays_from_numpy(ta, "cpu")
    want = {"iyh": torch.int16, "rot_pk": torch.int32, "sil": torch.bool,
            "gains": torch.float32, "eff_lb": torch.int64,
            "lcg_a": torch.int64, "utab": torch.int64}
    for k, dt in want.items():
        if k in dev:
            assert dev[k].dtype == dt, k
    if mode == "idx_mode":
        assert int(dev["utab"].max()) == 0xFFFFFFFF     # saturated, kept


def test_rotation_markers_spec_matches_native_and_jax():
    """_rotation_markers (the Python spec) gives what the native trace
    emits, up to order, and what the JAX package's copy gives."""
    from libnyquist_tpu.ops import celt_replay as jrep
    from libnyquist_torch.formats.opus.celt_tables import mode48000
    from libnyquist_torch.ops import celt_replay as trep

    jt, tt, _ = _traces(_golden_feed(), MODES["raw_iy"])
    mode = mode48000()
    nb = mode.nbEBands
    band_off = 8 * np.asarray(mode.eBands, np.int64)[: nb + 1]
    got = trep._rotation_markers(tt, band_off, nb)
    ref = jrep._rotation_markers(jt, band_off, nb)
    assert got[5] == ref[5] == tuple(tt.rot_sigmas)
    for a, b in zip(got[:5], ref[:5]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    order = lambda r, c, p, *_: np.lexsort((p, c, r))  # noqa: E731
    native = (tt.rot_rows, tt.rot_cols, tt.rot_pk, tt.rot_th, tt.rot_g)
    ka, kb = order(*got), order(*native)
    for a, b in zip(got[:5], native):
        assert np.array_equal(a[ka], b[kb])


def test_host_helpers_match_jax():
    from libnyquist_tpu.formats.opus import iy_split as jsplit
    from libnyquist_tpu.ops import celt_replay as jrep
    from libnyquist_torch.formats.opus import iy_split as tsplit
    from libnyquist_torch.ops import celt_replay as trep

    assert np.array_equal(trep.pvq_u_table_u32(), jrep.pvq_u_table_u32())
    for a, b in zip(tsplit._lcg_tables(961), jsplit._lcg_tables(961)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for n in (1, 7, 8, 9, 300, 1025, 20000, 2 ** 20 + 1):
        assert trep._bucket(n) == jrep._bucket(n)
        assert trep._bucket_fine(n, 1 << 14) == jrep._bucket_fine(n, 1 << 14)
    for ln in (2, 8, 16, 44, 96, 176):
        for stride in (1, 2, 4, 8):
            assert trep._sigma2_of(ln, stride) == jrep._sigma2_of(ln, stride)
    for N in (8, 16, 24, 48, 176):
        for B in (1, 2, 4, 8):
            for tf in (-3, -1, 0, 1, 2):
                assert tsplit._chain(N, B, tf) == jsplit._chain(
                    N, B, tf, structural=True)


# ----------------------------- (b) cwrsi -----------------------------

def test_cwrsi_expand_matches_spec_and_jax_kernel():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from libnyquist_tpu.formats.opus.celt import cwrsi as spec, pvq_v
    from libnyquist_tpu.ops import celt_replay as jrep
    from libnyquist_torch.ops import celt_replay as trep

    rng = np.random.default_rng(7)
    cases = []
    for N in (2, 3, 4, 5, 8, 16, 22, 44, 96, 176):
        for K in (1, 2, 4, 11, 40, 128):
            V = pvq_v(N, K)
            for _ in range(4):
                cases.append((N, K, int(rng.integers(0, min(V, 1 << 32)))))
            if V <= 1 << 32:                  # codable: the last index too
                cases.append((N, K, V - 1))
    Lb = max(c[0] for c in cases)
    n_v = np.array([c[0] for c in cases], np.int32)
    k_v = np.array([c[1] for c in cases], np.int32)
    i_v = np.array([c[2] for c in cases], np.uint32)
    utab = jnp.asarray(jrep.pvq_u_table_u32())
    ref_iy, ref_ryy = jax.jit(
        lambda n, k, i: jrep.cwrsi_kernel(jnp, lax, utab, n, k, i, Lb)
    )(n_v, k_v, i_v)
    arrs = trep.replay_arrays_from_numpy(
        {"utab": trep.pvq_u_table_u32(), "n": n_v, "k": k_v, "pvq_i": i_v},
        "cpu")
    iy, ryy = trep.cwrsi_expand(arrs["utab"], arrs["n"], arrs["k"],
                                arrs["pvq_i"], Lb)
    assert iy.dtype == torch.float32 and tuple(iy.shape) == (len(cases), Lb)
    assert np.array_equal(iy.numpy(), np.asarray(ref_iy))
    assert np.array_equal(ryy.numpy(), np.asarray(ref_ryy))
    for r, (N, K, idx) in enumerate(cases):
        want = np.asarray(spec(N, K, idx), np.float32)
        # tail-aligned columns: position j at Lb - N + j, zeros before
        assert np.array_equal(iy[r, Lb - N :].numpy(), want), (N, K, idx)
        assert not iy[r, : Lb - N].any()


# ------------------------ (d) the device replay ------------------------

GOLDEN_PAIR = (1e-4, 1e-5, 2e-5)     # max, threshold, share above it
ENCODED_PAIR = (1e-3, 1e-4, 1e-4)


def _check_replays(feed, modes, pair=GOLDEN_PAIR, native_share=1e-5,
                   state_kw=None):
    """The port's replay against the JAX replay (pair = None: skip it)
    and both against the native decode. Returns the port's trace."""
    from libnyquist_tpu.ops import celt_replay as jrep
    from libnyquist_torch.ops import celt_replay as trep

    jt, tt, freq = _traces(feed, modes, state_kw)
    outs = {"port": trep.replay_device(tt, device="cpu").numpy()}
    assert outs["port"].shape == freq.shape
    if pair is not None:
        outs["jax"] = np.asarray(jrep.replay_device(jt))
        top, thresh, share = pair
        rel = _rel(outs["port"], outs["jax"])
        assert rel.max() < top, rel.max()
        assert (rel > thresh).mean() <= share
    for name, out in outs.items():
        rel = _rel(out, freq)
        assert rel.max() < 1e-3, (name, rel.max())
        assert (rel > 1e-4).mean() < native_share, name
    return tt


@pytest.mark.parametrize("mode", list(MODES))
def test_replay_device_matches_jax_golden(mode):
    tt = _check_replays(_golden_feed(), MODES[mode])
    # the corpus exercises stereo bands, fills and anti-collapse
    assert (tt.bd_mode == 2).any() and len(tt.ac_frame) > 0


@pytest.mark.parametrize("frame_ms", [5, 10, 20])
def test_replay_device_matches_jax_raw_iy_transients(frame_ms):
    """Multi-block exp_rotation sub-segments and theta-split gaps."""
    tt = _check_replays(_encoded_feed("transients", frame_ms),
                        MODES["raw_iy"], ENCODED_PAIR, native_share=1e-4)
    assert (tt.sb > 0).any()


@pytest.mark.parametrize("frame_ms", [2.5, 5, 10])
def test_replay_device_matches_jax_small_frames(frame_ms):
    """LM 0-2 geometry through the dense-plane route."""
    tt = _check_replays(_encoded_feed("plain", frame_ms), MODES["dense"],
                        ENCODED_PAIR, native_share=1e-4)
    assert int(tt.fsz[0]) == int(120 * frame_ms / 2.5)


def test_replay_device_matches_jax_noise_fills_lm0():
    """Golden case 5 (2.5 ms frames): noise fills (the LCG value read as
    a signed 32-bit number), N = 1 sign leaves and LM = 0 geometry in
    the serving trace modes."""
    from libnyquist_torch.formats.opus.iy_split import LF_N1, LF_NOISE

    ch, _, pkts, _ = read_case(5)
    tt = _check_replays(_packet_feed(ch, pkts), SERVING, ENCODED_PAIR,
                        native_share=1e-4)
    assert int(tt.fsz[0]) == 120
    assert (tt.lf_type == LF_NOISE).sum() > 10 and (tt.lf_type == LF_N1).any()


def test_replay_device_start_band_and_mono_mixes():
    """The branches the CELT-only corpus does not reach on its own: a
    decoder that starts at band 17 (zero head columns, short norm
    carry), a mono decoder fed stereo frames (CC = 1: downmix) and a
    stereo decoder fed mono frames (CCout = 2: duplicate). Held against
    the native decode of the same frames only (the JAX replay of these
    structures would cost three more compilations)."""
    feed = _golden_feed()
    tt = _check_replays(feed, SERVING, None, state_kw=dict(start=17))
    assert tt.start == 17
    ch, frames, sizes, ends, chs = feed
    tt = _check_replays((1, frames, sizes, ends, chs), SERVING, None)
    assert (tt.CC, tt.CCout) == (1, 2)
    m_ch, _, m_pkts, _ = read_case(2)
    assert m_ch == 1
    tt = _check_replays(_packet_feed(2, m_pkts), SERVING, None)
    assert (tt.CC, tt.CCout) == (2, 2) and (tt.chs == 1).all()


def _packet_feed(channels, pkts):
    from libnyquist_torch.formats.opus import _celt_frame_feed
    from libnyquist_torch.formats.opus.packet import parse_packet

    return (channels,) + _celt_frame_feed([parse_packet(p) for p in pkts])


# --------------------- (e) the K-stream program ---------------------

FC = 64


def _serving_inputs(feed):
    """One stream's host half as the serving path makes it: the port's
    replay arrays + key and the bench's synthesis tables (K = 1)."""
    from libnyquist_torch.ops import celt_replay as trep
    from libnyquist_torch.runtime import serving

    _, tt, _ = _traces(feed, SERVING)
    arrs, _, key = trep.build_replay_arrays(tt)
    F, N = len(tt.fsz), int(tt.fsz[0])
    n_steps = -(-F // FC)
    synth = serving.synth_tables([(tt.sb, tt.pfp, tt.pfg, tt.pft)], N,
                                 n_steps, FC)
    return tt, arrs, key, synth, n_steps


def _stack_synth(synths):
    out = dict(synths[0])
    for k in ("msk", "TA", "gA", "TB1", "gB1"):
        out[k] = np.concatenate([s[k] for s in synths])
    return out


def _run_port(streams, synth, K, CC, n_steps, **flags):
    from libnyquist_torch.ops import celt_replay as trep
    from libnyquist_torch.runtime import serving

    return serving.run_stream_batched(
        [(trep.replay_arrays_from_numpy(a, "cpu"), key)
         for a, key in streams],
        serving.synth_from_numpy(synth, "cpu"), K, CC, n_steps, FC, **flags)


@pytest.mark.parametrize("K", [1, 3])
def test_run_stream_batched_matches_jax_programs(K):
    """K = 1 against make_opus_stream_program, K = 3 (one trace three
    times, as the reference test broadcasts it) against
    make_opus_stream_program_batched."""
    from libnyquist_tpu.runtime import serving as jserving

    tt, arrs, key, synth1, n_steps = _serving_inputs(_golden_feed())
    F, N, CC = len(tt.fsz), int(tt.fsz[0]), tt.CC
    if K == 1:
        jsynth = {k: (v[0] if k in ("msk", "TA", "gA", "TB1", "gB1") else v)
                  for k, v in synth1.items()}
        ref = np.asarray(jserving.make_opus_stream_program(
            key, F, N, CC, n_steps, FC, 120, 120)(arrs, jsynth))[None]
    else:
        arrsK = {k: np.broadcast_to(v[None], (K,) + v.shape).copy()
                 for k, v in arrs.items()}
        ref = np.asarray(jserving.make_opus_stream_program_batched(
            key, K, F, N, CC, n_steps, FC, 120, 120)(
                arrsK, _stack_synth([synth1] * K)))
    acc, pcm = _run_port([(arrs, key)] * K, _stack_synth([synth1] * K), K,
                         CC, n_steps)
    assert tuple(acc.shape) == ref.shape == (K, CC)
    assert tuple(pcm.shape) == (K * CC, F * N)
    assert np.abs(acc.numpy() - ref).max() <= 1e-3


@pytest.mark.parametrize("flags", [
    dict(with_synth=False), dict(with_comb=False, with_deemph=False),
    dict(with_deemph=False), dict()], ids=["replay", "imdct", "comb", "all"])
def test_run_stream_batched_stage_variants(flags):
    _, arrs, key, synth1, n_steps = _serving_inputs(_golden_feed())
    K, CC = 2, 2
    synth = _stack_synth([synth1] * K)
    acc, pcm = _run_port([(arrs, key)] * K, synth, K, CC, n_steps, **flags)
    assert tuple(acc.shape) == (K, CC) and bool(torch.isfinite(acc).all())
    assert (pcm is None) == (flags.get("with_synth") is False)
    assert torch.equal(acc[0], acc[1])               # the same stream twice
    if not flags:                                    # the default program
        acc0, _ = _run_port([(arrs, key)] * K, synth, K, CC, n_steps)
        assert torch.equal(acc, acc0)


def test_run_stream_batched_mixed_structure_matches_single():
    """Two streams whose traces differ in structure (steady case 0,
    transient case 1) in one batch against each alone: 1e-6."""
    feeds = [_packet_feed(ch, pkts)
             for ch, _, pkts, _ in (read_case(0), read_case(1))]
    per = [_serving_inputs(f) for f in feeds]
    assert per[0][2] != per[1][2]                    # different static keys
    n_steps, CC = per[0][4], 2
    acc, pcm = _run_port([(p[1], p[2]) for p in per],
                         _stack_synth([p[3] for p in per]), 2, CC, n_steps)
    for k, p in enumerate(per):
        acc1, pcm1 = _run_port([(p[1], p[2])], p[3], 1, CC, n_steps)
        assert (pcm[k::2] - pcm1).abs().max().item() <= 1e-6
        scale = max(1.0, pcm1.abs().sum(dim=1).max().item())
        assert (acc[k] - acc1[0]).abs().max().item() <= 1e-6 * scale


def test_run_stream_batched_rejects_mismatched_streams():
    from libnyquist_torch.runtime import serving

    _, arrs, key, synth1, n_steps = _serving_inputs(_golden_feed())
    with pytest.raises(ValueError, match="expected K"):
        serving.run_stream_batched([(arrs, key)], synth1, 2, 2, n_steps, FC)
    other = (key[0] + 1,) + key[1:]
    with pytest.raises(ValueError, match="stream 1"):
        serving.replay_streams([(arrs, key), (arrs, other)], 2, 2)


# ------------------- (f) the trace path to libopus -------------------

@pytest.mark.parametrize("idx", [0, 1, 2, 6, 7, 13])
def test_trace_path_pcm_matches_libopus(idx):
    from libnyquist_torch.formats.opus import trace_celt_packets
    from libnyquist_torch.ops import celt_replay as trep
    from libnyquist_torch.runtime import serving

    ch, _, pkts, ref = read_case(idx)
    tr, arrs, key, seconds = trace_celt_packets(pkts, ch)
    assert tr.raw_iy and tr.xs_heap and tr.idx_mode
    F, N = len(tr.fsz), int(tr.fsz[0])
    assert seconds == pytest.approx(F * N / 48000.0)
    n_steps = -(-F // FC)
    synth = serving.synth_from_numpy(serving.synth_tables(
        [(tr.sb, tr.pfp, tr.pfg, tr.pft)], N, n_steps, FC), "cpu")
    _, pcm = serving.run_stream_batched(
        [(trep.replay_arrays_from_numpy(arrs, "cpu"), key)], synth, 1, ch,
        n_steps, FC)
    got = pcm.T.reshape(-1).numpy()
    assert got.size == ref.size
    assert np.abs(got - ref).max() < 1e-4


def test_trace_celt_ogg_matches_packet_route():
    """trace_celt_ogg on an encoder-made file: the same trace as the
    packet route, and NotImplementedError for what the scan declines."""
    from libnyquist_tpu.formats.opus.celt_encoder import encode_ogg_opus
    from libnyquist_torch.formats.opus import trace_celt_ogg
    from libnyquist_torch.formats.opus import iy_split as tsplit
    from libnyquist_torch.formats.opus.celt_host import CeltDecoderState

    from .conftest import GOLDEN_DIR

    sr = 48000
    t = np.arange(sr // 4) / sr
    pcm = np.stack([0.4 * np.sin(2 * np.pi * 440 * t),
                    0.4 * np.sin(2 * np.pi * 660 * t)],
                   axis=1).reshape(-1).astype(np.float32)
    data = encode_ogg_opus(pcm, 2, sr, bitrate_kbps=96, frame_ms=20)
    tr, arrs, key, seconds = trace_celt_ogg(data)
    frames, sizes, ends, chs = _frames_from_ogg(data)
    want = tsplit.trace_frames(CeltDecoderState(channels=2), frames, sizes,
                               ends, chs, with_heap=False, **SERVING)
    assert seconds == pytest.approx(sum(sizes) / 48000.0)
    for f in dataclasses.fields(tr):
        a, b = getattr(tr, f.name), getattr(want, f.name)
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
    assert key[0] == len(frames) and "iyh" in arrs and "pvq0_i" in arrs
    fixture = GOLDEN_DIR.parent / "fixtures" / "ms8ch.opus"
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        trace_celt_ogg(fixture.read_bytes())
