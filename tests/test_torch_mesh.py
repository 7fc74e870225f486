"""The port's sharded decode step (libnyquist_torch.entry and
parallel/mesh.py) on the CPU: the single-card step and world 1 against
the JAX package's, and 8 gloo ranks against world 1.

Every 8-rank case runs in one spawn of 8 workers (the module-scoped
``ranks8`` fixture): the mixed mesh (2, 2, 2) and the serving mesh
(8, 1, 1) on random spectra, and the mixed mesh on decoded content.
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _opus_stream_tool():
    spec = importlib.util.spec_from_file_location(
        "_tool_opus_stream", ROOT / "tools" / "opus_stream.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_celt_stream(path):
    """The stereo 20 ms CELT golden cases 0 and 7 joined in one Ogg Opus
    stream: 12 windows of 16 long-block frames (each case alone has 6,
    fewer than the 8 streams of rows=16 need)."""
    tool = _opus_stream_tool()
    packets, _ = tool.cycle_packets(tool.read_cases(), (0, 7), 199)
    path.write_bytes(tool.ogg_opus(packets, tool.opus_head(2), 0x4E5C0000))
    return path


def _close(got, ref, tol):
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), 1.0), err


@pytest.fixture(scope="module")
def content_path(tmp_path_factory):
    return _write_celt_stream(tmp_path_factory.mktemp("mesh") / "celt.opus")


@pytest.fixture(scope="module")
def ranks8(content_path):
    """One spawn of 8 gloo ranks running every 8-rank case."""
    from libnyquist_torch import entry

    content = entry.real_content_args(content_path, rows=16, F=16)
    assert content is not None
    cases = [dict(), dict(serving_mesh=True),
             dict(rows=16, F=16, content=content)]
    mixed, serving, real = entry.decode_cases(8, cases, device="cpu")
    return dict(mixed=mixed, serving=serving, real=real, content=content)


@pytest.fixture(scope="module")
def world1():
    from libnyquist_torch import entry

    out, mesh = entry.sharded_decode_step(1, device="cpu")
    assert mesh == (1, 1, 1)
    return out


def test_factor_mesh():
    from libnyquist_tpu.parallel.mesh import factor_mesh as jax_factor
    from libnyquist_torch.parallel.mesh import DEEMPH_HALO, factor_mesh

    assert factor_mesh(8) == (2, 2, 2)
    assert factor_mesh(4) == (1, 2, 2)
    assert factor_mesh(2) == (1, 1, 2)
    assert factor_mesh(1) == (1, 1, 1)
    for n in range(1, 17):
        assert factor_mesh(n) == jax_factor(n)
        assert factor_mesh(n, serving=True) == (n, 1, 1)
        assert np.prod(factor_mesh(n)) == n
    assert DEEMPH_HALO == 256


def test_entry_matches_jax():
    import jax

    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as g
    from libnyquist_torch import entry

    jfn, jargs = g.entry()
    ref = jax.jit(jfn)(*jargs)
    step, args = entry.entry(device="cpu")
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    got = step(*args)
    assert got[0].shape == (4, 8 * 960)
    for x, r in zip(got, ref):
        _close(x.numpy(), np.asarray(r), 1e-5)


def test_world1_matches_jax(world1):
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as g

    ref, mesh = g.sharded_decode_step(1)
    assert mesh == (1, 1, 1) and world1.shape == ref.shape == (8, 16 * 960)
    _close(world1, ref, 1e-5)


def test_mixed_mesh_matches_world1(ranks8, world1):
    from libnyquist_torch import entry

    res = ranks8["mixed"]
    assert {r["shape"] for r in res} == {(2, 2, 2)}
    assert sorted(r["coords"] for r in res) == [
        (d, s, t) for d in range(2) for s in range(2) for t in range(2)]
    out = entry.assemble(res, 8, 16)
    _close(out, world1, 1e-5)
    # the tp ranks of a block hold the same output
    by = {r["coords"]: r["out"] for r in res}
    for d in range(2):
        for s in range(2):
            assert np.array_equal(by[(d, s, 0)], by[(d, s, 1)])
    # per step: one tp sum; halos for the tail, sp postfilter passes and
    # the deemphasis carry
    for r in res:
        assert r["calls"] == {"sum": 1, "halo": 4}


def test_each_pass_halo(ranks8):
    """Pass 0 seeds the postfilter halo with the left shard's raw tail,
    pass 1 with its filtered tail (the final output cannot tell: after
    sp - 1 refinements it is exact from any seed)."""
    from libnyquist_torch.ops import comb as comb_ops
    from libnyquist_torch.ops import imdct as imdct_ops
    from libnyquist_torch.entry import _global_arrays

    g = _global_arrays(8, 16, None)
    N, ov, H = 960, 120, comb_ops.HIST
    Tm, Tp, _ = imdct_ops.celt_synthesis_matrices_paired(2 * N, ov, 1)
    spec = g["spec"].astype(np.float64)
    prev = np.concatenate([np.zeros_like(spec[:, :1]), spec[:, :-1]], 1)
    raw = (spec @ Tm + prev @ Tp).reshape(8, -1)          # float64
    y, _ = comb_ops.comb_filter_stream_ref(
        torch.from_numpy(raw.astype(np.float32)), torch.zeros(8, H),
        *(torch.from_numpy(g[k]) for k in ("T0", "T1", "g0", "g1",
                                            "fade")))
    y = y.numpy()
    half = 8 * N
    for r in ranks8["mixed"]:
        d, s, _t = r["coords"]
        assert len(r["halos"]) == 2
        if s == 0:
            assert all(not h.any() for h in r["halos"])
            continue
        rows = slice(4 * d, 4 * d + 4)
        _close(r["halos"][0], raw[rows, half - H : half], 1e-5)
        _close(r["halos"][1], y[rows, half - H : half], 1e-5)
        assert np.abs(r["halos"][0] - r["halos"][1]).max() > 1e-3


@pytest.mark.parametrize("ranks", ["gloo8", "slices dp2", "slices dp4",
                                   "slices dp8"])
def test_serving_mesh_bit_equal_and_collective_free(ranks, request):
    """The serving mesh (dp, 1, 1) bit-equal to world 1: 8 gloo ranks at
    (8, 16), and each dp slice's rows at (16, 16) through the step a
    serving rank runs, on one device with singleton axes
    (tools/mesh_nccl_check.py ``dp_slices``, phase 12 of chip_smoke.py
    on the card)."""
    from libnyquist_torch import entry

    if ranks == "gloo8":
        res = request.getfixturevalue("ranks8")["serving"]
        assert {r["shape"] for r in res} == {(8, 1, 1)}
        assert all(r["calls"] == {} for r in res)
        assert np.array_equal(entry.assemble(res, 8, 16),
                              request.getfixturevalue("world1"))
        return
    dp = int(ranks[-1])
    spec = importlib.util.spec_from_file_location(
        "_tool_mesh_nccl_check", ROOT / "tools" / "mesh_nccl_check.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.dp_slices(16, 16, (dp,), device="cpu") == {dp: (True, 0.0)}


def test_real_content_args_match_jax(content_path):
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as g
    from libnyquist_torch import entry

    ref = g.real_content_args(rows=16, F=16, path=str(content_path))
    got = entry.real_content_args(content_path, rows=16, F=16)
    assert ref is not None and got is not None
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        assert np.array_equal(got[k], ref[k]), k
    # more windows than the file has
    assert entry.real_content_args(content_path, rows=64, F=16) is None


def test_real_content_sharded_matches_world1(ranks8):
    from libnyquist_torch import entry

    content = ranks8["content"]
    assert float(np.abs(content["spec"]).max()) > 1.0
    assert int((content["g0"] != 0).sum()) > 0
    o8 = entry.assemble(ranks8["real"], 16, 16)
    o1, mesh1 = entry.sharded_decode_step(1, rows=16, F=16, content=content,
                                          device="cpu")
    assert mesh1 == (1, 1, 1)
    assert np.isfinite(o8).all()
    assert float(np.sqrt((o1 ** 2).mean())) > 1e-3
    assert float(np.abs(o8 - o1).max()) < 1e-5


def test_dp_only_serving_shard():
    """The unified serving step with per-frame parameters broadcast to
    rows, its rows split over a dp-only mesh: each shard's rows equal
    the unsharded call's."""
    from libnyquist_torch.formats.opus.celt_tables import mode48000
    from libnyquist_torch.ops import comb as comb_ops
    from libnyquist_torch.ops import imdct as imdct_ops
    from libnyquist_torch.runtime import serving

    mode = mode48000()
    N, overlap = 960, mode.overlap
    R, FC = 8, 4
    rng = np.random.default_rng(1)
    spec = rng.standard_normal((R, FC, N)).astype(np.float32)
    TA = np.full(FC, 40, np.int32)
    gA = rng.uniform(0, 0.3, (FC, 3)).astype(np.float32)
    T1m, T1p, _ = imdct_ops.celt_synthesis_matrices_paired(2 * N, overlap, 1)
    t = torch.from_numpy
    mats = (t(T1m), t(T1p), torch.zeros(N, N), torch.zeros(N, N))
    fade = t(serving._fade_pattern(N, overlap, mode.shortMdctSize))

    def step(rows):
        r = rows.stop - rows.start

        def bc(a):
            return t(np.broadcast_to(a, (r,) + a.shape).copy())

        pcm, *_ = serving.unified_step_row_body(
            t(spec[rows]), torch.zeros(r, FC), bc(TA), bc(gA), bc(TA),
            bc(gA), fade, *mats, torch.zeros(r, overlap),
            torch.zeros(r, comb_ops.HIST), torch.zeros(r), overlap,
            mode.shortMdctSize)
        return pcm.numpy()

    ref = step(slice(0, R))
    got = np.concatenate([step(slice(k, k + 1)) for k in range(R)])
    assert np.abs(ref - got).max() <= 1e-6 * max(np.abs(ref).max(), 1.0)


def test_dp_flops_per_rank():
    """Per-rank work of the dp-8 serving mesh at R = 64, FC = 16: at most
    1/8 of the single step's FLOPs (5 % slack), its rows equal."""
    from libnyquist_torch import entry
    from libnyquist_torch.utils.profiling import op_flops

    fn1, args1, mesh1 = entry.sharded_decode_step(
        1, rows=64, F=16, return_fn=True, device="cpu")
    fn8, args8, mesh8 = entry.sharded_decode_step(
        8, rows=64, F=16, return_fn=True, serving_mesh=True, device="cpu")
    assert mesh1 == (1, 1, 1) and mesh8 == (8, 1, 1)
    assert args8[0].shape == (8, 16, 960)
    f1, f8 = op_flops(fn1, *args1), op_flops(fn8, *args8)
    assert f1 > 1e9
    assert f8 <= f1 / 8 * 1.05, (f1, f8)
    _close(fn8(*args8).numpy(), fn1(*args1)[:8].numpy(), 1e-6)


def test_tp_axis_cost_tradeoff(ranks8):
    """tp = 2 halves the synthesis product's FLOPs and pays one sum of
    the whole partial output: the FLOPs saved per summed byte sit far
    below any card's compute-to-interconnect breakeven."""
    from libnyquist_torch import entry
    from libnyquist_torch.utils.profiling import op_flops

    _fn1, a1, _ = entry.sharded_decode_step(1, return_fn=True, device="cpu")
    fn2, a2, mesh2 = entry.sharded_decode_step(2, return_fn=True,
                                               device="cpu")
    assert mesh2 == (1, 1, 2)
    x1, w1 = a1[0].reshape(-1, 960), a1[6]
    x2, w2 = a2[0].reshape(-1, 480), a2[6]
    assert w2.shape == (480, 960)
    f1, f2 = op_flops(torch.matmul, x1, w1), op_flops(torch.matmul, x2, w2)
    assert f1 == 2 * x1.shape[0] * 960 * 960
    assert f2 <= f1 / 2 * 1.10
    # exactly one tp sum per step on every rank of the mixed mesh
    assert all(r["calls"]["sum"] == 1 for r in ranks8["mixed"])
    allreduce_bytes = x1.shape[0] * 960 * 4
    assert (f1 - f2) / allreduce_bytes < 600
    # rank 0's step cannot run its tp sum without the process group
    with pytest.raises(RuntimeError, match="process group"):
        fn2(*a2)


def test_world1_helpers_make_no_call(capsys):
    from libnyquist_torch import entry
    from libnyquist_torch.parallel import mesh as pm

    m = pm.make_mesh(device="cpu")
    assert m.shape == (1, 1, 1) and m.coords == (0, 0, 0)
    x = torch.arange(6.0).reshape(2, 3)[:, 1:]
    h = pm.right_halo(x, m["sp"])
    assert h.shape == (2, 2) and not h.any() and h.is_contiguous()
    assert pm.axis_sum(x, m["tp"]) is x
    assert not m.calls
    with pytest.raises(ValueError, match="ranks"):
        pm.make_mesh(4, device="cpu")
    entry.dryrun_multichip(1, device="cpu")
    assert "dryrun_multichip ok: mesh dp=1 sp=1 tp=1, out (8, 15360)" in \
        capsys.readouterr().out


def test_cuda_requests_raise_without_cards(monkeypatch):
    """A CUDA request never runs on the CPU: no card raises, and more
    ranks than cards raises before any rank starts."""
    from libnyquist_torch import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 cards"):
        entry.dryrun_multichip(2, device="cuda")
