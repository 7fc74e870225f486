"""The serving program's constant tables resident on the device, and its
two routes: the eager route (the only one on the CPU) and the CUDA graph
route's host-side pieces.

* Each resident table (``device.resident``) equals the table the replay
  and the deemphasis built at every call before it: exact equality
  (index tables and float32 values made by the same operations).
* A second serving call on a static key builds no table.
* The static key fixes the name, shape and dtype of every replay array,
  which is what lets the graph route keep static input buffers per key;
  the "auto" route captures a key on its second sighting.
* The eager route's PCM against the JAX package's trace path (its
  replay, then its unified synthesis) on the golden packets: 1e-4, the
  libopus contract of tests/test_opus_pipeline.py; each stream of a
  batch against the stream alone: 1e-6, as tests/test_serving.py holds
  batched against single.
"""

import numpy as np
import pytest
import torch

from .test_opus_pipeline import read_case
from .test_torch_replay import FC, SERVING, _golden_feed, _packet_feed, _traces

CASES = (0, 1, 6, 7, 13)          # the serving batch's golden CELT cases


# ------------------ the resident tables, table by table ------------------

def _old_deemphasis(x, mem, coef):
    """scan_iir.deemphasis as it was with its terms built at every call
    (the per-call reference for the resident ones)."""
    from libnyquist_torch.ops import scan_iir

    B, S = x.shape
    nblk = S // scan_iir.BLOCK
    T = torch.from_numpy(np.ascontiguousarray(
        scan_iir._toeplitz(coef, scan_iir.BLOCK).T))
    y0 = (x.reshape(B * nblk, scan_iir.BLOCK) @ T).reshape(B, nblk, -1)
    c32 = torch.tensor(coef, dtype=torch.float32)
    last = y0[:, :, -1]
    shifted = torch.cat([mem[:, None], last[:, :-1]], dim=1)
    carries = last + c32 ** scan_iir.BLOCK * shifted
    prev = torch.cat([mem[:, None], carries[:, :-1]], dim=1)
    powers = c32 ** torch.arange(1, scan_iir.BLOCK + 1, dtype=torch.float32)
    return (y0 + prev[:, :, None] * powers).reshape(B, S), carries[:, -1]


@pytest.mark.parametrize("stride", [2, 4, 8, 16])
def test_resident_chain_orders_equal_per_call_tables(stride):
    from libnyquist_torch.formats.opus.celt_tables import ORDERY_TABLE
    from libnyquist_torch.ops import celt_replay as trep

    assert torch.equal(trep._ordery_t(stride, "cpu"),
                       torch.as_tensor(ORDERY_TABLE[stride]))
    assert torch.equal(trep._deint_rows_t(stride, "cpu"),
                       torch.as_tensor(trep._deint_rows(stride)))
    # the chain step that reads them, against index_select on per-call
    # uploads
    x = torch.from_numpy(np.random.default_rng(stride).standard_normal(
        (3, 4 * stride)).astype(np.float32))
    for kind, table in (("deint", trep._deint_rows(stride)),
                        ("int", ORDERY_TABLE[stride])):
        got = trep._apply_chain_static(x, [(kind, 4, stride, True)])
        if kind == "deint":
            t = x.reshape(3, 4, stride).transpose(-1, -2)
            ref = t.index_select(-2, torch.as_tensor(table))
        else:
            t = x.reshape(3, stride, 4).index_select(
                -2, torch.as_tensor(table))
            ref = t.transpose(-1, -2)
        assert torch.equal(got, ref.reshape(3, -1))


@pytest.mark.parametrize("LM,start", [(0, 0), (1, 0), (2, 0), (3, 0),
                                      (3, 17)])
def test_resident_band_positions_equal_repeat_interleave(LM, start):
    """per_position's gather table against the per-call
    repeat_interleave of the band widths it replaced."""
    from libnyquist_torch.formats.opus.celt_tables import mode48000
    from libnyquist_torch.ops import celt_replay as trep

    mode = mode48000()
    nb = mode.nbEBands
    widths = [(mode.eBands[i + 1] - mode.eBands[i]) << LM
              for i in range(start, nb)]
    per_band = torch.from_numpy(np.random.default_rng(LM).standard_normal(
        (6, nb - start)).astype(np.float32))
    got = per_band.index_select(1, trep._band_of_position(LM, start, "cpu"))
    assert torch.equal(got, per_band.repeat_interleave(
        torch.as_tensor(widths), dim=1))


def test_resident_deemphasis_terms_equal_per_call_terms():
    from libnyquist_torch.ops import scan_iir

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 8 * scan_iir.BLOCK))
                         .astype(np.float32) * 1000)
    mem = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    for per_row in (False, True):
        y, m = scan_iir.deemphasis(x, mem, per_row=per_row)
        y_ref, m_ref = _old_deemphasis(x, mem, scan_iir.COEF)
        assert torch.equal(y, y_ref) and torch.equal(m, m_ref)


def test_resident_builds_once_per_key_and_device():
    from libnyquist_torch import device

    calls = []

    def build():
        calls.append(1)
        return np.arange(5)

    key = ("test_resident_builds_once", len(calls))
    a = device.resident(key, build, "cpu")
    b = device.resident(key, build, torch.device("cpu"))
    assert a is b and len(calls) == 1
    assert torch.equal(a, torch.arange(5)) and a.is_contiguous()


# ------------------ a second call on a key builds nothing ------------------

def _serving_call(arrs, key, synth_np, n_steps, CC, K=1):
    from libnyquist_torch.ops import celt_replay as trep
    from libnyquist_torch.runtime import serving

    synth = serving.synth_from_numpy(
        {k: (np.concatenate([v] * K) if k in ("msk", "TA", "gA", "TB1",
                                              "gB1") else v)
         for k, v in synth_np.items()}, "cpu")
    streams = [(trep.replay_arrays_from_numpy(arrs, "cpu"), key)] * K
    return serving.run_stream_batched(streams, synth, K, CC, n_steps, FC,
                                      route="eager")


def test_second_call_on_a_static_key_builds_no_table(monkeypatch):
    from libnyquist_torch import device
    from libnyquist_torch.formats.opus import trace_celt_packets
    from libnyquist_torch.runtime import serving

    monkeypatch.setattr(device, "_TABLES", {})
    ch, _, pkts, _ = read_case(1)                # transients: every chain
    tr, arrs, key, _ = trace_celt_packets(pkts, ch)
    F, N = len(tr.fsz), int(tr.fsz[0])
    n_steps = -(-F // FC)
    synth_np = serving.synth_tables([(tr.sb, tr.pfp, tr.pfg, tr.pft)], N,
                                    n_steps, FC)
    b0 = device.table_builds
    _, pcm1 = _serving_call(arrs, key, synth_np, n_steps, ch)
    first = device.table_builds - b0
    # the replay's index tables and the deemphasis terms
    kinds = {k[0][0] for k in device._TABLES}
    assert first == len(device._TABLES) > 0
    assert {"replay_band_of_position", "replay_ordery", "deemph_T",
            "deemph_decay", "deemph_powers"} <= kinds
    b1 = device.table_builds
    _, pcm2 = _serving_call(arrs, key, synth_np, n_steps, ch)
    assert device.table_builds == b1
    assert torch.equal(pcm1, pcm2)


# ------------------ the static key fixes every array's shape --------------

def _expected_signature(key):
    """{name: (shape, dtype)} of replay_arrays_from_numpy's dict, from
    build_replay_arrays' static key alone."""
    (F, nmax, _LM, _start, _CC, _CCout, band_spec, nac_pad, nren_pad,
     rot_spec, heap_spec, pvq_spec) = key
    i64, f32 = torch.int64, torch.float32
    nb = 21
    sig = {}
    if heap_spec is not None:
        Tpad, Lpad = heap_spec
        sig.update(iyh=((Tpad,), torch.int16), iyh_st=((Lpad,), i64),
                   iyh_dl=((Lpad,), i64))
        if pvq_spec is not None:
            for j, (_ub, lanes, _wk) in enumerate(pvq_spec[0]):
                for f in ("n", "k", "i", "tgt"):
                    sig[f"pvq{j}_{f}"] = ((lanes,), i64)
            sig["utab"] = ((243, 243), i64)
    else:
        sig["xs"] = ((F * 2 * nmax,), f32)
    sig.update(lcg_a=((nmax + 2,), i64), lcg_b=((nmax + 2,), i64))
    for i, _N, ni_pad, _classes, v_pad in band_spec:
        sig[f"b{i}_cls"] = ((F,), i64)
        if ni_pad:
            for f in ("ff", "fc", "fo", "fl", "fs", "ft"):
                sig[f"b{i}_{f}"] = ((ni_pad,), i64)
            sig[f"b{i}_fg"] = ((ni_pad,), f32)
        sig[f"b{i}_lbo"] = ((max(v_pad, 1),), i64)
    for name in ("eff_lb", "mode_b", "inv", "cflag"):
        sig[name] = ((F, nb), i64)
    for name in ("imid", "iside", "sign"):
        sig[name] = ((F, nb), f32)
    sig.update(avg_band=((F,), i64), ends=((F,), i64),
               gains=((F, 2, nb), f32), sil=((F,), torch.bool),
               dup=((F,), torch.bool), mixd=((F,), torch.bool))
    if nac_pad:
        for f in ("f", "base", "c", "n0", "seed"):
            sig[f"ac_{f}"] = ((nac_pad,), i64)
        sig["ac_r"] = ((nac_pad,), f32)
        for f in ("f", "c", "b"):
            sig[f"ren_{f}"] = ((nren_pad,), i64)
        sig["ren_on"] = ((nren_pad,), torch.bool)
    if rot_spec is not None:
        nm_pad = rot_spec[1]
        sig.update(rot_rows=((nm_pad,), i64), rot_cols=((nm_pad,), i64),
                   rot_pk=((nm_pad,), torch.int32), rot_th=((nm_pad,), f32),
                   rot_g=((nm_pad,), f32))
        if pvq_spec is not None:
            sig["rot_gidx"] = ((nm_pad,), i64)
    return sig


@pytest.mark.parametrize("mode", ["dense", "raw_iy", "xs_heap", "idx_mode"])
@pytest.mark.parametrize("case", [None, 1, 2, 3])
def test_static_key_fixes_every_replay_array(mode, case):
    from libnyquist_torch.formats.opus import iy_split as tsplit
    from libnyquist_torch.formats.opus.celt_host import CeltDecoderState
    from libnyquist_torch.ops import celt_replay as trep

    from .test_torch_replay import MODES

    if case is None:
        feed = _golden_feed()
    else:
        ch, _, pkts, _ = read_case(case)
        feed = _packet_feed(ch, pkts)
    ch, frames, sizes, ends, chs = feed
    tr = tsplit.trace_frames(CeltDecoderState(channels=ch), frames, sizes,
                             ends, chs, **MODES[mode])
    arrs, _, key = trep.build_replay_arrays(tr)
    dev = trep.replay_arrays_from_numpy(arrs, "cpu")
    got = {k: (tuple(v.shape), v.dtype) for k, v in dev.items()}
    assert got == _expected_signature(key)


# ------------------ the eager route against the JAX package ---------------

@pytest.mark.parametrize("idx", CASES)
def test_eager_route_pcm_matches_jax_trace_path(idx):
    from libnyquist_tpu.ops import celt_replay as jrep
    from libnyquist_tpu.runtime import serving as jserving
    from libnyquist_torch.ops import celt_replay as trep
    from libnyquist_torch.runtime import serving

    ch, _, pkts, _ = read_case(idx)
    jt, tt, _ = _traces(_packet_feed(ch, pkts), SERVING)
    arrs, _, key = trep.build_replay_arrays(tt)
    F, N = len(tt.fsz), int(tt.fsz[0])
    n_steps = -(-F // FC)
    synth_np = serving.synth_tables([(tt.sb, tt.pfp, tt.pfg, tt.pft)], N,
                                    n_steps, FC)
    freq = np.asarray(jrep.replay_device(jt))[:, :ch]          # [F, CC, N]
    ref = np.asarray(jserving.synthesize_streams_unified(
        freq, jt.sb, jt.pfp, jt.pfg, jt.pft, ch, f_chunk=FC))  # [S, CC]
    _, one = _serving_call(arrs, key, synth_np, n_steps, ch)
    _, two = _serving_call(arrs, key, synth_np, n_steps, ch, K=2)
    assert one.shape == (ch, F * N) and ref.shape == (F * N, ch)
    assert np.abs(one.T.numpy() - ref).max() < 1e-4
    for k in range(2):
        assert (two[k::2] - one).abs().max().item() <= 1e-6


# ------------------ the graph route's pieces on the host ------------------

def test_graph_route_refuses_the_cpu():
    from libnyquist_torch.ops import celt_replay as trep
    from libnyquist_torch.runtime import serving

    tt = _traces(_golden_feed(), SERVING)[1]
    arrs, _, key = trep.build_replay_arrays(tt)
    streams = [(trep.replay_arrays_from_numpy(arrs, "cpu"), key)]
    synth = serving.synth_from_numpy(serving.synth_tables(
        [(tt.sb, tt.pfp, tt.pfg, tt.pft)], int(tt.fsz[0]), 2, FC), "cpu")
    for route in ("graph", "auto"):
        with pytest.raises(ValueError, match="CUDA device"):
            serving.run_stream_batched(streams, synth, 1, 2, 2, FC,
                                       route=route)
    with pytest.raises(ValueError, match="route"):
        serving.run_stream_batched(streams, synth, 1, 2, 2, FC,
                                   route="compiled")


def test_auto_route_captures_a_key_on_its_second_sighting(monkeypatch):
    """The "auto" route's choice: a program key seen for the first time
    runs eagerly, its second sighting captures; sightings are kept for
    the last SIGHTINGS_KEPT keys and clear_programs forgets them."""
    from libnyquist_torch.runtime import serving

    monkeypatch.setattr(serving, "SIGHTINGS_KEPT", 3)
    serving.clear_programs()
    try:
        assert [serving.sighted_before(k) for k in "abab"] == [
            False, False, True, True]
        for k in "cd":                    # "a" is now the least recent
            assert not serving.sighted_before(k)
        assert not serving.sighted_before("a")
        assert serving.sighted_before("d")
        serving.clear_programs()
        assert not serving.sighted_before("d")
    finally:
        serving.clear_programs()


def test_copy_into_static_buffers_refuses_what_would_replay_stale():
    from libnyquist_torch.runtime import graphs

    dst = [{"a": torch.zeros(4), "b": torch.zeros(2, dtype=torch.int64)},
           (3, "key")]
    graphs.copy_into(dst, [{"a": torch.ones(4),
                            "b": torch.arange(2)}, (3, "key")])
    assert torch.equal(dst[0]["a"], torch.ones(4))
    assert torch.equal(dst[0]["b"], torch.arange(2))
    bad = [
        [{"a": torch.ones(1), "b": torch.arange(2)}, (3, "key")],   # shape
        [{"a": torch.ones(4), "b": torch.arange(2.0)}, (3, "key")],  # dtype
        [{"b": torch.arange(2), "a": torch.ones(4)}, (3, "key")],   # order
        [{"a": torch.ones(4), "b": torch.arange(2)}, (4, "key")],   # static
    ]
    for src in bad:
        with pytest.raises((ValueError, TypeError)):
            graphs.copy_into(dst, src)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.CapturedProgram(lambda t: t + 1, torch.ones(3))


def test_launch_counts_outside_a_capture_and_per_replay():
    """note_launch counts a launch where it happens; a graph's recorded
    launches count once per replay (note_replay)."""
    from libnyquist_torch import kernels

    def wrapper():
        pass

    wrapper.launches = 0
    t = torch.zeros(8)
    b0 = kernels.launch_bytes
    kernels.note_launch(wrapper, t, t)
    assert wrapper.launches == 1 and kernels.launch_bytes - b0 == 64
    kernels.note_replay({wrapper: [3, 96]})
    kernels.note_replay({wrapper: [3, 96]})
    assert wrapper.launches == 7 and kernels.launch_bytes - b0 == 256
    with kernels.recording() as rec:
        assert rec == {}
        with pytest.raises(RuntimeError, match="nest"):
            with kernels.recording():
                pass
