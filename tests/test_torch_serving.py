"""The port's host decode and unified serving step against the JAX
package, on spectra decoded from tests/golden/opus_packets.bin cases 0
and 1 (case 1 has transients, so the short-block matrices are live).

PCM bound: |d| <= 1e-5; carries in CELT_SIG_SCALE units are compared
relative to max(1, max|ref|).
"""

import numpy as np
import pytest
import torch

from .test_opus_pipeline import read_case

OVERLAP = SHORT_MDCT = 120
N = 960


def _close(got, ref, tol=1e-5, relative=True):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, np.abs(ref).max()) if relative else 1.0
    assert np.abs(got - ref).max() <= tol * scale


def _infos(idx, n_packets):
    from libnyquist_torch.formats.opus import decode_celt_infos

    ch, _, pkts, _ = read_case(idx)
    return decode_celt_infos(pkts[:n_packets], ch), ch


def _arrays(infos):
    """The native decoder's raw per-frame arrays from info dicts."""
    freq = np.stack([i["freq"] for i in infos]).astype(np.float32)
    get = lambda k, dt: np.asarray([i[k] for i in infos], dt)  # noqa: E731
    return (freq, get("shortBlocks", np.int32),
            get("postfilter_pitch", np.int32),
            get("postfilter_gain", np.float64),
            get("postfilter_tapset", np.int32))


def _matrices():
    from libnyquist_torch.ops import imdct

    T1m, T1p, _ = imdct.celt_synthesis_matrices_paired(2 * N, OVERLAP, 1)
    T8m, T8p, _ = imdct.celt_synthesis_matrices_paired(
        2 * SHORT_MDCT, OVERLAP, 8)
    return T1m, T1p, T8m, T8p


@pytest.mark.parametrize("idx", [0, 1])
def test_host_decode_matches_jax(idx):
    from libnyquist_tpu.formats.opus import celt as jcelt
    from libnyquist_tpu.formats.opus.decoder import _endband_for_bandwidth
    from libnyquist_tpu.formats.opus.packet import parse_packet

    ch, _, pkts, _ = read_case(idx)
    frames, sizes, ends, chs = [], [], [], []
    for p in pkts:
        pp = parse_packet(p)
        for fr in pp.frames:
            frames.append(fr)
            sizes.append(pp.frame_size)
            ends.append(_endband_for_bandwidth(pp.bandwidth))
            chs.append(pp.stream_channels)
    ref = jcelt.celt_decode_stream_native(
        jcelt.CeltDecoderState(channels=ch), frames, sizes, ends, chs)
    got, _ = _infos(idx, len(pkts))
    assert len(got) == len(ref) == len(frames)
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in a:
            if k == "freq":
                assert np.array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


def _row_inputs(K=2, F=16, seed=0):
    """R = CC*K rows (ordered c*K + k) of the first F frames of cases 0
    and 1, with nonzero carries."""
    from libnyquist_torch.runtime import serving

    per = [_arrays(_infos(idx, F)[0]) for idx in (0, 1)][:K]
    CC = per[0][0].shape[1]
    spec = np.stack([p[0][:, c] for c in range(CC) for p in per])
    cols = [[] for _ in range(5)]
    for c in range(CC):
        for freq, sb, pfp, pfg, pft in per:
            TA, gA, TB1, gB1 = serving.postfilter_params_arrays(
                sb, pfp, pfg, pft)
            for lst, v in zip(cols, ((sb != 0).astype(np.float32), TA, gA,
                                     TB1, gB1)):
                lst.append(v)
    msk, TA, gA, TB1, gB1 = (np.stack(v) for v in cols)
    rng = np.random.default_rng(seed)
    R = spec.shape[0]
    tails = (rng.standard_normal((R, OVERLAP)) * 100).astype(np.float32)
    hist = (rng.standard_normal((R, 1026)) * 100).astype(np.float32)
    mem = (rng.standard_normal(R) * 100).astype(np.float32)
    fade = serving._fade_pattern(N, OVERLAP, SHORT_MDCT)
    return (spec, msk, TA, gA, TB1, gB1, fade) + _matrices() + (
        tails, hist, mem)


@pytest.mark.parametrize("with_comb,with_deemph",
                         [(True, True), (False, True), (True, False)])
def test_unified_step_row_body_matches_jax(with_comb, with_deemph):
    import jax.numpy as jnp

    from libnyquist_tpu.runtime import serving as jserving
    from libnyquist_torch.runtime import serving

    args = _row_inputs()
    assert args[0].shape == (4, 16, N) and args[1].any()   # short blocks
    got = serving.unified_step_row_body(
        *map(torch.from_numpy, args), OVERLAP, SHORT_MDCT,
        with_comb=with_comb, with_deemph=with_deemph)
    ref = jserving.unified_step_row_body(
        *map(jnp.asarray, args), OVERLAP, SHORT_MDCT,
        with_comb=with_comb, with_deemph=with_deemph)
    _close(got[0].numpy(), ref[0], relative=False)             # pcm
    for g, r in zip(got[1:], ref[1:]):                         # carries
        _close(g.numpy(), r)


def test_postfilter_params_arrays_match_jax():
    from libnyquist_tpu.runtime import serving as jserving
    from libnyquist_torch.runtime import serving

    _, sb, pfp, pfg, pft = _arrays(_infos(1, 100)[0])
    for a, b in zip(serving.postfilter_params_arrays(sb, pfp, pfg, pft),
                    jserving.postfilter_params_arrays(sb, pfp, pfg, pft)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(serving._fade_pattern(N, OVERLAP, SHORT_MDCT),
                          jserving._fade_pattern(N, OVERLAP, SHORT_MDCT))


def _bench_synth(per_stream, n_steps, f_chunk):
    from libnyquist_torch.runtime import serving

    return serving.synth_tables([p[1:] for p in per_stream], N, n_steps,
                                f_chunk)


def _jax_step_loop(spec, synth, K, CC, n_steps, f_chunk):
    """JAX reference: the step loop of make_opus_stream_program_batched
    written out over jserving.unified_step_row_body."""
    import jax.numpy as jnp

    from libnyquist_tpu.runtime import serving as jserving

    R, F, _ = spec.shape
    sp_all = np.zeros((R, n_steps * f_chunk, N), np.float32)
    sp_all[:, :F] = spec
    tails = jnp.zeros((R, OVERLAP), jnp.float32)
    hist = jnp.zeros((R, 1026), jnp.float32)
    mem = jnp.zeros((R,), jnp.float32)
    acc = np.zeros(R, np.float64)
    pcms = []
    for step in range(n_steps):
        def param(name):
            v = synth[name][:, step]
            return jnp.asarray(np.tile(v, (CC,) + (1,) * (v.ndim - 1)))

        sp = jnp.asarray(sp_all[:, step * f_chunk : (step + 1) * f_chunk])
        pcm, tails, hist, mem = jserving.unified_step_row_body(
            sp, param("msk"), param("TA"), param("gA"), param("TB1"),
            param("gB1"), jnp.asarray(synth["fade"]),
            *(jnp.asarray(synth[k]) for k in ("T1m", "T1p", "T8m", "T8p")),
            tails, hist, mem, OVERLAP, SHORT_MDCT)
        pcm = np.asarray(pcm)
        acc += pcm.astype(np.float64).sum(axis=1)
        pcms.append(pcm)
    return acc.reshape(CC, K).T, np.concatenate(pcms, axis=1)[:, : F * N]


def test_run_synthesis_batched_and_unified_match_jax_loop():
    from libnyquist_torch.runtime import serving

    K, CC, f_chunk, F = 2, 2, 16, 40
    n_steps = -(-F // f_chunk)
    per = [_arrays(_infos(idx, F)[0]) for idx in (0, 1)]
    spec = np.stack([p[0][:, c] for c in range(CC) for p in per])
    synth = _bench_synth(per, n_steps, f_chunk)
    ref_acc, ref_pcm = _jax_step_loop(spec, synth, K, CC, n_steps, f_chunk)

    acc, pcm = serving.run_synthesis_batched(
        torch.from_numpy(spec), serving.synth_from_numpy(synth, "cpu"),
        K, CC, n_steps, f_chunk)
    _close(pcm.numpy(), ref_pcm, relative=False)
    assert acc.shape == (K, CC)
    abs_sum = np.abs(ref_pcm).sum(axis=1).reshape(CC, K).T
    assert (np.abs(acc.numpy() - ref_acc) <= 1e-5 * (abs_sum + 1)).all()

    for k, (freq, sb, pfp, pfg, pft) in enumerate(per):
        one = serving.synthesize_streams_unified(
            freq, sb, pfp, pfg, pft, CC, f_chunk=f_chunk, device="cpu")
        _close(one.numpy(), ref_pcm[k::K].T, relative=False)


def test_synth_tables_match_bench_layout():
    """synth_tables builds what bench.py's _prep_opus_device_batch builds
    with the JAX package; synth_from_numpy keeps lags int32."""
    from libnyquist_tpu.ops import imdct as jimdct
    from libnyquist_tpu.runtime import serving as jserving
    from libnyquist_torch.runtime import serving

    per = [_arrays(_infos(idx, 20)[0]) for idx in (0, 1)]
    n_steps, fc = 2, 16
    tables = _bench_synth(per, n_steps, fc)
    for k, (_, sb, pfp, pfg, pft) in enumerate(per):
        TA, gA, TB1, gB1 = jserving.postfilter_params_arrays(sb, pfp, pfg, pft)
        msk = np.zeros(n_steps * fc, np.float32)
        msk[:20] = sb != 0
        assert np.array_equal(tables["msk"][k].reshape(-1), msk)
        for name, v, fill in (("TA", TA, 15), ("TB1", TB1, 15),
                              ("gA", gA, 0.0), ("gB1", gB1, 0.0)):
            t = tables[name][k].reshape((n_steps * fc,) + v.shape[1:])
            assert t.dtype == v.dtype
            assert np.array_equal(t[:20], v) and (t[20:] == fill).all()
    assert int(max(p[1].max() for p in per)) == 8
    T8m, T8p, _ = jimdct.celt_synthesis_matrices_paired(240, OVERLAP, 8)
    assert np.array_equal(tables["T8m"], T8m)
    assert np.array_equal(tables["T8p"], T8p)
    d = serving.synth_from_numpy(_bench_synth(per[:1], 3, 8), "cpu")
    assert d["TA"].dtype == d["TB1"].dtype == torch.int32
    assert d["msk"].dtype == d["gA"].dtype == d["T1m"].dtype == torch.float32
    assert tuple(d["gB1"].shape) == (1, 3, 8, 3)
