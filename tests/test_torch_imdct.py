"""The port's synthesis products and deemphasis against the JAX package.

Tolerance: |d| <= 1e-5 * max(1, max|ref|) — both sides are float32
products, summed in a different order.
"""

import numpy as np
import pytest
import torch

OVERLAP = 120


def _close(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("N,B", [(1920, 1), (960, 1), (240, 8)])
def test_synthesis_matrices_bit_identical(N, B):
    from libnyquist_tpu.ops import imdct as jimdct
    from libnyquist_torch.ops import imdct

    for a, b in zip(imdct.celt_synthesis_matrices_paired(N, OVERLAP, B),
                    jimdct.celt_synthesis_matrices_paired(N, OVERLAP, B)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(imdct.celt_synthesis_matrix(N, OVERLAP, B),
                          jimdct.celt_synthesis_matrix(N, OVERLAP, B))


@pytest.mark.parametrize("N,B", [(1920, 1), (240, 8)])
def test_imdct_rows_matches_jax(N, B):
    import jax.numpy as jnp

    from libnyquist_tpu.ops import imdct as jimdct
    from libnyquist_torch.ops import imdct

    n2 = B * N // 2
    rng = np.random.default_rng(N + B)
    spec = (rng.standard_normal((3, 6, n2)) * 100).astype(np.float32)
    tails = (rng.standard_normal((3, OVERLAP)) * 100).astype(np.float32)
    pcm, all_tails = imdct.celt_imdct_rows(
        torch.from_numpy(spec), N, OVERLAP, B=B, tails=torch.from_numpy(tails))
    jpcm, jtails = jimdct.celt_imdct_rows(
        jnp.asarray(spec), N, OVERLAP, B=B, tails=jnp.asarray(tails))
    _close(pcm.numpy(), jpcm)
    _close(all_tails.numpy(), jtails)


@pytest.mark.parametrize("N,B", [(960, 1), (240, 4)])
def test_imdct_batch_padded_matches_jax(N, B):
    import jax.numpy as jnp

    from libnyquist_tpu.ops import imdct as jimdct
    from libnyquist_torch.ops import imdct

    n2 = B * N // 2
    rng = np.random.default_rng(7 * N + B)
    spec = (rng.standard_normal((8, n2)) * 100).astype(np.float32)
    spec[5:] = 0.0                                  # bucket padding frames
    tail = (rng.standard_normal(OVERLAP) * 100).astype(np.float32)
    out, nt = imdct.celt_imdct_batch_padded(
        torch.from_numpy(spec), 5, N, OVERLAP, B=B,
        init_tail=torch.from_numpy(tail))
    jout, jnt = jimdct.celt_imdct_batch_padded(
        jnp.asarray(spec), 5, N, OVERLAP, B=B, init_tail=jnp.asarray(tail))
    _close(out.numpy(), jout)
    _close(nt.numpy(), jnt)


@pytest.mark.parametrize("S", [128, 1920])
def test_deemphasis_matches_jax(S):
    import jax.numpy as jnp

    from libnyquist_tpu.ops import scan_iir as jscan
    from libnyquist_torch.ops import scan_iir

    rng = np.random.default_rng(S)
    x = (rng.standard_normal((3, S)) * 3000).astype(np.float32)
    mem = (rng.standard_normal(3) * 3000).astype(np.float32)
    y, m = scan_iir.deemphasis(torch.from_numpy(x), torch.from_numpy(mem))
    jy, jm = jscan.deemphasis(jnp.asarray(x), jnp.asarray(mem))
    _close(y.numpy(), jy)
    _close(m.numpy(), jm)


def test_deemphasis_matches_scalar_recurrence():
    from libnyquist_torch.ops import scan_iir

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 384)).astype(np.float32)
    mem = np.array([0.5, -2.0], np.float32)
    y, m = scan_iir.deemphasis(torch.from_numpy(x), torch.from_numpy(mem))
    ref = np.zeros_like(x, np.float64)
    prev = mem.astype(np.float64)
    for i in range(x.shape[1]):
        prev = x[:, i] + scan_iir.COEF * prev
        ref[:, i] = prev
    _close(y.numpy(), ref)
    _close(m.numpy(), ref[:, -1])
