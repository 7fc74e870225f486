"""The port's plain comb postfilter against the JAX scan, the Pallas
kernel (interpret mode) and the C reference golden; the step plan the
CUDA kernel follows and the plain filter that follows it."""

import pathlib
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

GOLDEN = pathlib.Path(__file__).parent / "golden" / "comb_filter.bin"


def _random_args(B, nch, seed):
    from libnyquist_torch.ops.comb import CHUNK, HIST

    rng = np.random.default_rng(seed)
    S = nch * CHUNK
    return (
        rng.standard_normal((B, S)).astype(np.float32) * 0.1,
        rng.standard_normal((B, HIST)).astype(np.float32) * 0.1,
        rng.integers(15, 1024, (B, nch)).astype(np.int32),
        rng.integers(15, 1024, (B, nch)).astype(np.int32),
        (rng.standard_normal((B, nch, 3)) * 0.2).astype(np.float32),
        (rng.standard_normal((B, nch, 3)) * 0.2).astype(np.float32),
        rng.uniform(0, 1, (B, nch, CHUNK)).astype(np.float32),
    )


# the shapes and seeds of tests/test_comb_pallas.py
@pytest.mark.parametrize("B,nch", [(4, 140), (8, 257)])
def test_comb_ref_matches_jax_scan_and_pallas(B, nch):
    import jax.numpy as jnp

    from libnyquist_tpu.ops.comb import comb_filter_stream
    from libnyquist_tpu.ops.comb_pallas import comb_filter_stream_pallas
    from libnyquist_torch.ops.comb import comb_filter, comb_filter_stream_ref

    args = _random_args(B, nch, B * 1000 + nch)
    y, h = comb_filter_stream_ref(*map(torch.from_numpy, args))
    y_d, h_d = comb_filter(*map(torch.from_numpy, args))   # CPU dispatch
    assert torch.equal(y, y_d) and torch.equal(h, h_d)
    jargs = [jnp.asarray(a) for a in args]
    for yj, hj in (comb_filter_stream(*jargs),
                   comb_filter_stream_pallas(*jargs, interpret=True)):
        assert np.abs(y.numpy() - np.asarray(yj)).max() < 1e-6
        assert np.abs(h.numpy() - np.asarray(hj)).max() < 1e-6


def test_comb_ref_lag_extremes_and_short_segment():
    """Lags at both ends of [15, 1024] and a segment shorter than the
    history (new_hist then still holds part of the old one)."""
    import jax.numpy as jnp

    from libnyquist_tpu.ops.comb import comb_filter_stream
    from libnyquist_torch.ops.comb import comb_filter_stream_ref

    args = list(_random_args(3, 40, 7))
    args[2][:] = np.where(np.arange(40) % 2, 15, 1024)
    args[3][:] = np.where(np.arange(40) % 3, 1024, 15)
    y, h = comb_filter_stream_ref(*map(torch.from_numpy, args))
    yj, hj = comb_filter_stream(*[jnp.asarray(a) for a in args])
    assert np.abs(y.numpy() - np.asarray(yj)).max() < 1e-6
    assert np.abs(h.numpy() - np.asarray(hj)).max() < 1e-6


def test_build_chunk_params_matches_jax():
    from libnyquist_tpu.ops import comb as jcomb
    from libnyquist_torch.formats.opus.celt_tables import mode48000
    from libnyquist_torch.ops import comb

    rng = np.random.default_rng(3)
    params = []
    for _ in range(5):
        g = rng.uniform(0, 0.8, (4, 3)).astype(np.float32)
        t = rng.integers(15, 1024, 4)
        params.append(dict(T0a=t[0], T1a=t[1], g0a=g[0], g1a=g[1],
                           T0b=t[2], T1b=t[3], g0b=g[2], g1b=g[3]))
    mode = mode48000()
    for N in (960, 480, 120):
        a = comb.build_chunk_params(params, N, mode.window,
                                    mode.shortMdctSize)
        b = jcomb.build_chunk_params(params, N, mode.window,
                                     mode.shortMdctSize)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def _golden_cases():
    raw = GOLDEN.read_bytes()
    (n,) = struct.unpack_from("<i", raw, 0)
    pos = 4
    cases = []
    for _ in range(n):
        T0, T1, N, ts0, ts1 = struct.unpack_from("<5i", raw, pos)
        g0, g1 = struct.unpack_from("<2f", raw, pos + 20)
        (total,) = struct.unpack_from("<i", raw, pos + 28)
        pos += 32
        before = np.frombuffer(raw, "<f4", total, pos)
        after = np.frombuffer(raw, "<f4", total, pos + 4 * total)
        pos += 8 * total
        cases.append((T0, T1, N, ts0, ts1, g0, g1, before, after))
    return cases


@pytest.mark.parametrize("case", range(7))
def test_comb_ref_matches_c_reference_golden(case):
    """tools/comb_golden.c runs celt.c comb_filter in place on a
    1200-sample random history plus N samples."""
    from libnyquist_torch.formats.opus.celt_tables import COMB_GAINS, mode48000
    from libnyquist_torch.ops.comb import CHUNK, HIST, comb_filter_stream_ref

    T0, T1, N, ts0, ts1, g0, g1, before, after = _golden_cases()[case]
    hist_len = 1200
    n = N // CHUNK
    w = mode48000().window
    pos = np.arange(N)
    fade = np.where(pos < len(w), (w * w)[np.minimum(pos, len(w) - 1)], 1.0)
    gains0 = np.float32(g0) * np.asarray(COMB_GAINS[ts0], np.float32)
    gains1 = np.float32(g1) * np.asarray(COMB_GAINS[ts1], np.float32)
    args = (
        before[None, hist_len:], before[None, hist_len - HIST : hist_len],
        np.full((1, n), T0, np.int32), np.full((1, n), T1, np.int32),
        np.broadcast_to(gains0, (1, n, 3)), np.broadcast_to(gains1, (1, n, 3)),
        fade.astype(np.float32).reshape(1, n, CHUNK),
    )
    y, h = comb_filter_stream_ref(
        *[torch.from_numpy(np.array(a)) for a in args])
    ref = after[hist_len:]
    assert np.abs(y[0].numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # new history: the last HIST samples of [history, y]
    assert np.array_equal(h[0].numpy(), np.concatenate(
        [before[hist_len - HIST + N : hist_len], y[0].numpy()]))


# ----------------------------------------------------------------------
# The step plan the CUDA kernel follows, and the plain filter that
# follows it (libnyquist_torch.ops.comb comb_step_plan /
# comb_filter_planned_ref).
# ----------------------------------------------------------------------

def _plan_tables(draw_lags, draw_active, n, runs):
    """[1, n] lag tables and [1, n, 3] gains from per-run draws: lags
    constant over runs of chunks as in a real stream, gains zero where
    a run is switched off."""
    T0 = np.repeat(np.asarray(draw_lags[0], np.int32), runs)[:n][None]
    T1 = np.repeat(np.asarray(draw_lags[1], np.int32), runs)[:n][None]
    on = np.repeat(np.asarray(draw_active, bool), runs)[:n]
    g = np.where(on[None, :, None], np.float32(0.3), np.float32(0.0))
    g = np.broadcast_to(g, (1, n, 3)).copy()
    return T0, T1, g, g.copy()


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_comb_step_plan_never_reads_what_it_writes(data):
    """No step of any plan reads a sample written in the same step, the
    steps tile the row in order, and none crosses a staged tile's end."""
    from libnyquist_torch.ops import comb

    runs = data.draw(st.integers(1, 12))
    n = data.draw(st.integers(1, 700))
    n_runs = -(-n // runs)
    lag = st.one_of(st.integers(15, 1024), st.integers(15, 140))
    lags = [data.draw(st.lists(lag, min_size=n_runs, max_size=n_runs))
            for _ in range(2)]
    active = data.draw(st.lists(st.booleans(), min_size=n_runs,
                                max_size=n_runs))
    T0, T1, g0, g1 = _plan_tables(lags, active, n, runs)
    (steps,) = comb.comb_step_plan(*map(torch.from_numpy, (T0, T1, g0, g1)))
    on = (g0 != 0).any(-1)[0] | (g1 != 0).any(-1)[0]
    expect = 0
    for k, m in steps:
        assert k == expect and 1 <= m <= comb.MAX_STEP
        assert k // comb.TILE == (k + m - 1) // comb.TILE
        expect = k + m
        for c in range(k, k + m):
            if on[c]:
                # newest sample chunk c reads: its last sample, the
                # shorter lag back, two taps forward
                newest = comb.CHUNK * c + comb.CHUNK - 1 - min(
                    T0[0, c], T1[0, c]) + 2
                assert newest < comb.CHUNK * k
    assert expect == n


def test_comb_step_widths_are_the_longest_legal():
    """Constant lags: the width is (T - 2) // 12 capped at MAX_STEP, a
    chunk with zero gains limits nothing, and one short lag inside
    shortens every step that would contain it."""
    from libnyquist_torch.ops import comb

    n = 40
    g = torch.full((1, n, 3), 0.2)
    for T, want in ((15, 1), (25, 1), (26, 2), (97, 7), (98, 8), (121, 9),
                    (122, 10), (1024, comb.MAX_STEP)):
        lags = torch.full((1, n), T, dtype=torch.int32)
        w = comb.comb_step_widths(lags, lags, g, g)
        assert int(w[0, 0]) == min(want, comb.MAX_STEP)
    lags = torch.full((1, n), 500, dtype=torch.int32)
    short = lags.clone()
    short[0, 7] = 15
    w = comb.comb_step_widths(lags, short, g, g)[0]
    assert w[:9].tolist() == [7, 6, 5, 4, 3, 2, 1, 1, comb.MAX_STEP]
    g_off = g.clone()
    g_off[0, 7] = 0.0                      # gains1 zero there, gains0 not
    assert int(comb.comb_step_widths(lags, short, g, g_off)[0, 0]) == 7
    g0_off = g.clone()
    g0_off[0, 7] = 0.0                     # both zero: no limit
    assert int(comb.comb_step_widths(lags, short, g0_off, g_off)[0, 0]) \
        == comb.MAX_STEP


def _stream_like_args(B, nch, seed):
    """Random inputs whose lags hold for runs of chunks and whose gains
    are switched off over some runs, so that plans mix wide and narrow
    steps."""
    x, h, T0, T1, g0, g1, f = _random_args(B, nch, seed)
    rng = np.random.default_rng(seed + 1)
    run = 10
    T0 = np.repeat(T0[:, ::run], run, axis=1)[:, :nch]
    T1 = np.repeat(T1[:, ::run], run, axis=1)[:, :nch]
    off = np.repeat(rng.random((B, -(-nch // run))) < 0.3, run,
                    axis=1)[:, :nch]
    g0 = np.where(off[..., None], np.float32(0), g0)
    g1 = np.where(off[..., None], np.float32(0), g1)
    return x, h, T0, T1, g0, g1, f


@pytest.mark.parametrize("B,nch,seed", [(3, 300, 0), (2, 257, 5), (1, 530, 9)])
def test_comb_planned_ref_matches_stream_ref_and_jax(B, nch, seed):
    """The plain filter that follows the kernel's step plan against the
    chunk-by-chunk plain version (1e-6) and, beside it, the JAX scan."""
    import jax.numpy as jnp

    from libnyquist_tpu.ops.comb import comb_filter_stream
    from libnyquist_torch.ops import comb

    args = _stream_like_args(B, nch, seed)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    plans = comb.comb_step_plan(*targs[2:6])
    assert max(m for p in plans for _, m in p) >= 8      # wide steps taken
    assert min(m for p in plans for _, m in p) == 1      # and narrow ones
    y, h = comb.comb_filter_stream_ref(*targs)
    y_p, h_p = comb.comb_filter_planned_ref(*targs)
    assert (y_p - y).abs().max() < 1e-6 and (h_p - h).abs().max() < 1e-6
    yj, hj = comb_filter_stream(*[jnp.asarray(a) for a in args])
    assert np.abs(y_p.numpy() - np.asarray(yj)).max() < 1e-6
    assert np.abs(h_p.numpy() - np.asarray(hj)).max() < 1e-6


def test_comb_planned_ref_detects_an_illegal_plan():
    """A plan that steps too wide for its lags reads samples not yet
    written and must differ: the comparison above is not vacuous."""
    from libnyquist_torch.ops import comb

    args = list(_random_args(1, 64, 3))
    args[2][:] = 20
    args[3][:] = 20
    targs = [torch.from_numpy(a) for a in args]
    y, _ = comb.comb_filter_stream_ref(*targs)
    good, _ = comb.comb_filter_planned_ref(*targs)
    bad, _ = comb.comb_filter_planned_ref(
        *targs, plans=[[(k, 4) for k in range(0, 64, 4)]])
    assert (good - y).abs().max() < 1e-6
    assert (bad - y).abs().max() > 1e-3


def test_comb_filter_cuda_rejects_cpu_tensors():
    from libnyquist_torch.ops import comb

    targs = [torch.from_numpy(a) for a in _random_args(1, 8, 1)]
    before = comb.comb_filter_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        comb.comb_filter_cuda(*targs)
    assert comb.comb_filter_cuda.launches == before
