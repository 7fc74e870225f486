"""The port's bench (libnyquist_torch.bench) against the JAX package's
bench.py on the CPU: the same bench stream byte for byte, the same
trimmed median, the same host trace, and the headline's batch sums
against the JAX K-stream serving program on the same stream."""

import importlib.util
import json
import math
import os
import pathlib

import numpy as np
import pytest

from libnyquist_torch import bench as tb

ROOT = pathlib.Path(__file__).resolve().parents[1]
FC = 64          # synthesis frames a step at the tests' size


@pytest.fixture(scope="module")
def jbench():
    """The JAX package's bench.py, imported by its path."""
    spec = importlib.util.spec_from_file_location("_jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_reference(jbench, monkeypatch, tmp_path):
    """Both benches' reference file pointed at a missing file."""
    monkeypatch.setattr(jbench, "REF_OPUS", tmp_path / "sb-reverie.opus")
    monkeypatch.setenv("LIBNYQUIST_BENCH_REFERENCE", str(tmp_path))


def test_bench_stream_equals_bench_py(jbench, no_reference):
    data, src = tb._load_opus_stream_bytes()
    assert (data, src) == jbench._load_opus_stream_bytes()
    assert src == "golden-repeat"


@pytest.mark.parametrize("n", [1, 2, 3, 5, 10, 11, 24])
def test_trimmed_median_equals_bench_py(jbench, n):
    samples = list(np.random.default_rng(n).uniform(0.5, 2.0, n))
    assert tb._trimmed_median(samples) == jbench._trimmed_median(samples)


def test_host_trace_equals_bench_py(jbench, no_reference):
    """The port's host pass on a two-repeat stream gives bench.py's replay
    arrays and structure key."""
    data, _ = tb._load_opus_stream_bytes(2)
    _, arrs, key, audio_s = tb._host_decode_opus_iy(data)
    _, jarrs, jkey, jaudio_s = jbench._host_decode_opus_iy(data)
    assert key == jkey and audio_s == jaudio_s == 4.0
    assert list(arrs) == list(jarrs)
    for k in arrs:
        a, b = np.asarray(arrs[k]), np.asarray(jarrs[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert tb._timed_host_pass_iy(data, 2)[1] == min(2, os.cpu_count())


@pytest.fixture(scope="module")
def headline(jbench):
    """The headline at K = 2 on a one-repeat stream, on the CPU, one
    trial (golden content whatever the environment)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("LIBNYQUIST_BENCH_REFERENCE", raising=False)
        return tb.bench_e2e_opus_iy(2, "cpu", trials=1, reps=1, f_chunk=FC)


def test_headline_json_shape(headline):
    line = json.loads(json.dumps(headline))
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "config"}
    assert line["metric"] == "opus_e2e_decode_realtime_x"
    assert line["unit"] == "audio_seconds_per_second_per_chip"
    assert line["vs_baseline"] == round(line["value"] / tb.TARGET, 3)
    cfg = line["config"]
    for key in ("host_s", "dev_s", "serial_s", "pipelined_s", "gil_gap_pct",
                "staging_s", "libopus_err", "batch_vs_stream0"):
        assert math.isfinite(cfg[key]), key
    assert cfg["card"] == "cpu" and cfg["streams"] == 2
    assert cfg["host_workers"] >= 1 and cfg["n_trials"] == 1
    assert cfg["pipelined_s"] > 0 and cfg["serial_s"] == pytest.approx(
        cfg["host_s"] + cfg["dev_s"])
    assert line["value"] == round(2 * cfg["audio_s_per_stream"]
                                  / cfg["pipelined_s"], 1)
    # the device-only figures are not measured on the CPU
    for key in ("mfu_pct", "hbm_util_pct", "device_busy_pct",
                "hidden_syncs_per_batch"):
        assert cfg[key] is None, key
    assert cfg["libopus_err"] <= 1e-4 and cfg["batch_vs_stream0"] <= 1e-6


def test_headline_sums_match_jax_program(headline, jbench):
    """The batch's per-row sums against make_opus_stream_program_batched
    on the same stream's trace, at the replay tests' tolerance."""
    from libnyquist_torch.runtime import serving
    from libnyquist_tpu.runtime import serving as jserving

    K = 2
    data, _ = tb._load_opus_stream_bytes(1)
    jtr, jarrs, jkey, _ = jbench._host_decode_opus_iy(data)
    F, N, CC = len(jtr.fsz), int(jtr.fsz[0]), jtr.CC
    n_steps = -(-F // FC)
    synth = serving.synth_tables([(jtr.sb, jtr.pfp, jtr.pfg, jtr.pft)] * K,
                                 N, n_steps, FC)
    arrsK = {k: np.broadcast_to(v[None], (K,) + v.shape).copy()
             for k, v in jarrs.items()}
    ref = np.asarray(jserving.make_opus_stream_program_batched(
        jkey, K, F, N, CC, n_steps, FC, 120, 120)(arrsK, synth))
    got = np.asarray(headline["config"]["row_sums"])
    assert got.shape == ref.shape == (K, CC)
    assert np.abs(got - ref).max() <= 1e-3


def test_route_splits_on_the_cpu_read_the_eager_route(monkeypatch):
    """route_splits on the CPU: one split, the eager route's (the only
    route there), each variant run by that route, with the replay's and
    the program's seconds beside it under the route's name. (The
    program's own results are the headline tests'; here it is a stub
    that notes its flags.)"""
    import torch

    calls = []
    monkeypatch.setattr(tb, "_program", lambda prep, **flags: (
        lambda: calls.append(flags)))
    dev = torch.device("cpu")
    splits, side = tb.route_splits(2, dev, {"K": 2})
    assert {f["route"] for f in calls} == {"eager"}
    assert len(calls) == 4 * (1 + tb.SPLIT_ROUNDS)
    assert list(splits) == ["eager"] and tb._route(dev) == "eager"
    assert set(splits["eager"]) == {"replay_s", "imdct_s", "comb_s",
                                    "deemph_s", "full_s", "noise_s"}
    assert side == {"replay_s_eager": splits["eager"]["replay_s"],
                    "full_s_eager": splits["eager"]["full_s"]}
    assert all(math.isfinite(v) and v >= 0 for v in splits["eager"].values())
