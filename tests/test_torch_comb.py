"""The port's plain comb postfilter against the JAX scan, the Pallas
kernel (interpret mode) and the C reference golden."""

import pathlib
import struct

import numpy as np
import pytest
import torch

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
