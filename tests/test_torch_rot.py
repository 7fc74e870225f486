"""The port's spreading rotation (libnyquist_torch.ops.rot, the plain
versions of kernel K2) against the JAX package: the Pallas kernel itself
in interpret mode on a seeded plane, and the default lag-pass route on a
real raw-iy trace. The segment-wise plain version (the CUDA kernel's
algorithm) is held against the position-major one to 1e-6 of max|y|.

Bound: |d| <= 1e-5 * max|y| (float32 Givens chains of up to ~350 steps;
the two sides round cos/sin and the products in different places).
"""

import numpy as np
import pytest
import torch

from .test_iy_split import _frames_from_golden

W = 800
TOL = 1e-5


def _band_off():
    from libnyquist_torch.formats.opus.celt_tables import mode48000

    mode = mode48000()
    return [8 * int(e) for e in mode.eBands[: mode.nbEBands + 1]]


def _seeded_planes(R, seed):
    """Dense marker planes [W, R] as the replay scatters them: per row
    and band either a rotating leaf (one or two sub-segments), a plain
    leaf, a leaf shorter than its band, or nothing. Returns
    (x, pk, th, g, sigmas)."""
    from libnyquist_torch.ops.celt_replay import _sigma2_of

    rng = np.random.default_rng(seed)
    band_off = _band_off()
    x = rng.integers(-4, 5, (W, R)).astype(np.float32)
    pk = np.full((W, R), -1, np.int32)
    th = np.zeros((W, R), np.float32)
    g = np.zeros((W, R), np.float32)
    sigmas = set()
    for r in range(R):
        for b in range(len(band_off) - 1):
            col, n = band_off[b], band_off[b + 1] - band_off[b]
            kind = rng.integers(0, 5) if (b or r % 2) else 1   # col 0
            if kind == 0:
                continue                          # a gap: no leaf
            if kind == 4:
                n = max(n // 2, 1)                # leaf ends early: gap
            stride = 2 if (kind == 2 and n >= 16) else 1
            rotating = kind in (1, 2) and n in (8, 16, 32, 96, 176)
            gain = np.float32(rng.uniform(0.05, 1.0))
            theta = np.float32(rng.uniform(0.02, 0.5))
            s2 = _sigma2_of(n, stride) if rotating else 0
            if s2:
                sigmas.add(s2)
            sub = n // stride
            for j in range(stride):
                c = col + j * sub
                pk[c, r] = (c << 13) | (sub << 4) | (1 + s2)
                th[c, r] = theta if rotating else 0.0
                g[c, r] = gain
    return x, pk, th, g, tuple(sorted(sigmas))


def test_sigma_lo_col_matches_jax():
    from libnyquist_tpu.ops import rot_pallas
    from libnyquist_torch.ops import rot

    band_off = _band_off()
    for sg in range(1, 16):
        assert rot._sigma_lo_col(sg, band_off) == rot_pallas._sigma_lo_col(
            sg, band_off)


def test_rotate_plane_ref_matches_pallas_interpret():
    """R = 10 rows (the Pallas wrapper pads them to 128), a marker at
    column 0, gaps, four or more sigma classes."""
    import jax.numpy as jnp

    from libnyquist_tpu.ops.rot_pallas import rotate_plane_pallas
    from libnyquist_torch.ops import rot

    x, pk, th, g, sigmas = _seeded_planes(10, seed=3)
    assert len(sigmas) >= 3 and (pk[0] >= 0).any() and (pk[0] < 0).any()
    band_off = _band_off()
    ref = np.asarray(rotate_plane_pallas(
        jnp.asarray(x), jnp.asarray(pk), jnp.asarray(th), jnp.asarray(g),
        sigmas, tuple(band_off), interpret=True))
    # the row-major entry: [R, W] planes in, [R, W] out
    got = rot.rotate_plane(
        *(torch.from_numpy(np.ascontiguousarray(a.T)) for a in (x, pk, th, g)),
        sigmas, band_off).numpy().T
    assert got.shape == ref.shape == (W, 10)
    assert np.abs(ref - x).max() > 0.1            # the rotation acted
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_rotation_pass_matches_jax_default_route(golden_dir):
    """The port's marker scatter + rotate_plane_ref against the JAX
    package's CPU route (_build_rotation_pass rotate: associative-scan
    lag passes) on the raw-iy trace of the golden corpus."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from libnyquist_tpu.formats.opus.celt_tables import mode48000
    from libnyquist_tpu.ops import celt_replay as jrep
    from libnyquist_torch.formats.opus.celt_host import CeltDecoderState
    from libnyquist_torch.formats.opus.iy_split import trace_frames
    from libnyquist_torch.ops import celt_replay as trep

    ch, frames, sizes, ends, chs = _frames_from_golden(
        golden_dir / "opus_packets.bin")
    n = 48                                        # frames: enough classes
    tr = trace_frames(CeltDecoderState(channels=ch), frames[:n], sizes[:n],
                      ends[:n], chs[:n], raw_iy=True)
    arrs, _, key = trep.build_replay_arrays(tr)
    F, nmax, rot_spec = key[0], key[1], key[9]
    assert rot_spec is not None and len(rot_spec[2]) >= 3
    mode = mode48000()
    nb = mode.nbEBands
    band_off = 8 * np.asarray(mode.eBands, np.int64)[: nb + 1]
    x = arrs["xs"].reshape(2 * F, nmax)

    ref = np.asarray(jax.jit(jrep._build_rotation_pass(
        jnp, lax, rot_spec, band_off, nb, F, nmax))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in arrs.items()
                             if k.startswith("rot_")}))
    got = trep._build_rotation_pass(rot_spec, band_off, F)(
        torch.from_numpy(x), trep.replay_arrays_from_numpy(arrs, "cpu"))
    got = got.numpy()
    assert got.shape == ref.shape == (2 * F, nmax)
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_rotate_plane_rejects_bad_classes_and_cpu_kernel_calls():
    from libnyquist_torch.ops import rot

    z = torch.zeros(2, W)
    pk = torch.full((2, W), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="sigma"):
        rot.rotate_plane(z, pk, z, z, (1,), _band_off())
    before = rot.rotate_plane_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        rot.rotate_plane_cuda(z, pk, z, z, (3,), _band_off())
    assert rot.rotate_plane_cuda.launches == before
    # no marker anywhere: the plane comes back as it went in
    x = torch.arange(W * 2, dtype=torch.float32).reshape(2, W)
    assert torch.equal(rot.rotate_plane(x, pk, z, z, (3, 6), _band_off()), x)
    assert torch.equal(rot.rotate_rows_segments_ref(x, pk, z, z, (3, 6)), x)


SEG_TOL = 1e-6


def _rows(*planes):
    return [torch.from_numpy(np.ascontiguousarray(a.T)) for a in planes]


@pytest.mark.parametrize("seed", [3, 11])
def test_segments_ref_matches_plane_ref_seeded(seed):
    """The kernel's algorithm in plain PyTorch against the position-major
    plain version: rotating leaves of one and two sub-segments, plain
    leaves, leaves that end before their band does, gaps."""
    from libnyquist_torch.ops import rot

    x, pk, th, g, sigmas = _seeded_planes(6, seed)
    ref = rot.rotate_plane_ref(*map(torch.from_numpy, (x, pk, th, g)),
                               sigmas, _band_off())
    got = rot.rotate_rows_segments_ref(*_rows(x, pk, th, g), sigmas).T
    assert (ref - torch.from_numpy(x)).abs().max() > 0.1
    assert (got - ref).abs().max() <= SEG_TOL * ref.abs().max()


def _edge_planes():
    """Four rows [W]: markers whose sub-segment a later marker cuts
    short (one of them mid-rotation), a zero-length sub-segment, a
    sub-segment that runs past W, a marker in the last column, and a row
    with no marker at all. Every rotating marker lies at or after the
    first column its sigma class can occur in."""
    rng = np.random.default_rng(5)
    R = 4
    x = rng.integers(-4, 5, (R, W)).astype(np.float32)
    pk = np.full((R, W), -1, np.int32)
    th = np.zeros((R, W), np.float32)
    g = np.zeros((R, W), np.float32)

    def mark(r, col, ln, lag, theta, gain):
        pk[r, col] = (col << 13) | (ln << 4) | lag
        th[r, col], g[r, col] = theta, gain

    mark(0, 0, 32, 1 + 3, 0.31, 0.5)        # cut short at column 20
    mark(0, 20, 16, 1, 0.0, 0.25)
    mark(0, 36, 0, 1 + 3, 0.2, 9.0)         # zero length: acts nowhere
    mark(0, 200, 24, 1 + 4, 0.12, 0.75)     # cut short by a rotating one
    mark(0, 212, 48, 1 + 4, 0.4, 0.6)
    mark(1, 700, 176, 1 + 9, 0.27, 0.8)     # runs past W: ends at W
    mark(2, W - 1, 8, 1, 0.3, 0.5)          # last column
    mark(2, 100, 3, 1, 0.45, 2.0)           # L = 3: one backward step
    mark(2, 110, 2, 1, 0.45, 2.0)           # L = 2: forward step only
    return x, pk, th, g, (3, 4, 9)


def test_segments_ref_truncated_and_zero_length_segments():
    from libnyquist_torch.ops import rot

    x, pk, th, g, sigmas = _edge_planes()
    rows = [torch.from_numpy(a) for a in (x, pk, th, g)]
    ref = rot.rotate_plane(*rows, sigmas, _band_off())     # via plane_ref
    got = rot.rotate_rows_segments_ref(*rows, sigmas)
    assert (got - ref).abs().max() <= SEG_TOL * ref.abs().max()
    xt = torch.from_numpy(x)
    assert torch.equal(got[3], xt[3])                      # no marker
    assert torch.equal(got[0, 36:40], xt[0, 36:40])        # zero length
    assert not torch.equal(got[0, :20], xt[0, :20])
    assert torch.equal(got[1, :700], xt[1, :700])


def test_rotate_plane_passes_tail_columns_through():
    """x wider than the marker planes: columns W .. nmax come back as
    they went in, on both plain routes."""
    from libnyquist_torch.ops import rot

    x, pk, th, g, sigmas = _edge_planes()
    rng = np.random.default_rng(9)
    wide = np.concatenate(
        [x, rng.standard_normal((4, 160)).astype(np.float32)], axis=1)
    rows = [torch.from_numpy(a) for a in (wide, pk, th, g)]
    a = rot.rotate_plane(*rows, sigmas, _band_off())
    b = rot.rotate_rows_segments_ref(*rows, sigmas)
    assert a.shape == b.shape == (4, W + 160)
    assert torch.equal(a[:, W:], rows[0][:, W:])
    assert torch.equal(b[:, W:], rows[0][:, W:])
    assert (a - b).abs().max() <= SEG_TOL * a.abs().max()


def test_segments_ref_matches_plane_ref_on_real_trace(golden_dir):
    """Both plain versions on the raw-iy trace of the golden corpus, from
    the dense marker planes the replay scatters."""
    from libnyquist_torch.formats.opus.celt_host import CeltDecoderState
    from libnyquist_torch.formats.opus.iy_split import trace_frames
    from libnyquist_torch.ops import celt_replay as trep
    from libnyquist_torch.ops import rot

    ch, frames, sizes, ends, chs = _frames_from_golden(
        golden_dir / "opus_packets.bin")
    n = 24
    tr = trace_frames(CeltDecoderState(channels=ch), frames[:n], sizes[:n],
                      ends[:n], chs[:n], raw_iy=True)
    arrs, _, key = trep.build_replay_arrays(tr)
    F, nmax, (WB, _, sigmas) = key[0], key[1], key[9]
    x = torch.from_numpy(arrs["xs"].reshape(2 * F, nmax).copy())
    kept = {}
    orig = rot.rotate_plane

    def keep(*args):
        kept["args"] = args
        return orig(*args)

    rot.rotate_plane = keep
    try:
        ref = trep._build_rotation_pass(key[9], _band_off(), F)(
            x, trep.replay_arrays_from_numpy(arrs, "cpu"))
    finally:
        rot.rotate_plane = orig
    xr, pk, th, g, sg, _ = kept["args"]
    assert tuple(pk.shape) == (2 * F, WB) and (pk >= 0).sum() > 100
    # where the two plain versions part: rotate_plane_ref starts a sigma
    # class's sweeps at the first column the class can occur in, the
    # segment-wise version (and the kernel) does not look. On a real
    # trace no marker rotates before that column, nor outside the classes.
    rotating = (pk >= 0) & (th > 0)
    cols = torch.arange(WB).expand_as(pk)[rotating]
    sigma = (pk[rotating] & 15) - 1
    assert set(sigma[sigma > 0].tolist()) <= set(sg)
    for s in sg:
        assert (sigma == s).any()
        assert int(cols[sigma == s].min()) >= rot._sigma_lo_col(s, _band_off())
    got = rot.rotate_rows_segments_ref(xr, pk, th, g, sg)
    assert got.shape == ref.shape == (2 * F, nmax)
    assert (ref - x).abs().max() > 0.1
    assert (got - ref).abs().max() <= SEG_TOL * ref.abs().max()
