"""The port's profiling helpers (libnyquist_torch.utils.profiling) and its
flag surface (libnyquist_torch.config) on the CPU, beside the JAX
package's."""

import importlib.util
import json
import pathlib
import re

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
STAGES = ["ogg scan + TOC split", "entropy decode (C)", "frame marshalling",
          "synthesis (GEMM+comb)", "gain + trim"]


@pytest.fixture(scope="module")
def celt_file(tmp_path_factory):
    """Golden CELT case 0 (stereo, 100 frames of 20 ms) as an Ogg Opus
    file."""
    spec = importlib.util.spec_from_file_location(
        "_tool_opus_stream", ROOT / "tools" / "opus_stream.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    path = tmp_path_factory.mktemp("prof") / "celt.opus"
    path.write_bytes(tool.make_case_file(0))
    return path


def test_stage_profile_report_matches_jax():
    from libnyquist_tpu.utils.profiling import StageProfile as JaxProfile
    from libnyquist_torch.utils.profiling import StageProfile

    a, b = StageProfile(), JaxProfile()
    for name, s in (("read", 0.0125), ("decode", 0.25), ("x" * 30, 1e-6)):
        a.record(name, s)
        b.record(name, s)
    assert a.report() == b.report()
    assert a.total == pytest.approx(0.262501)
    with a.time("timed"):
        pass
    assert a.stages[-1][0] == "timed" and a.stages[-1][1] >= 0.0
    lines = a.report().splitlines()
    assert lines[0].split() == ["stage", "ms", "share"]
    assert lines[-1].startswith("total") and lines[-1].endswith("100.0%")


def test_profile_opus_load_stages(celt_file):
    from libnyquist_tpu.utils.profiling import profile_opus_load as jax_prof
    from libnyquist_torch.utils.profiling import profile_opus_load

    data = celt_file.read_bytes()
    prof = profile_opus_load(data, device="cpu")
    assert [n for n, _ in prof.stages] == STAGES
    assert [n for n, _ in jax_prof(data).stages] == STAGES
    assert all(s >= 0.0 for _, s in prof.stages) and prof.total > 0.0


def test_profile_opus_load_raises_where_jax_does():
    from libnyquist_tpu.utils.profiling import profile_opus_load as jax_prof
    from libnyquist_torch.utils.profiling import profile_opus_load

    data = (FIXTURES / "ms8ch.opus").read_bytes()
    with pytest.raises(ValueError):
        jax_prof(data)
    with pytest.raises(ValueError, match="profile_load"):
        profile_opus_load(data, device="cpu")


def test_profile_load_stages():
    from libnyquist_torch.utils.profiling import profile_load

    prof = profile_load(str(FIXTURES / "sv7_stereo.mpc"), device="cpu")
    assert [n for n, _ in prof.stages] == ["read file", "decode"]


def test_op_flops_and_cost_of_a_product():
    from libnyquist_torch.utils.profiling import op_cost, op_flops

    M, K, N = 48, 32, 20
    a, b = torch.randn(M, K), torch.randn(K, N)
    assert op_flops(torch.matmul, a, b) == 2 * M * N * K
    cost = op_cost(torch.matmul, a, b)
    assert cost == {"flops": 2 * M * N * K, "bytes": 4 * (M * K + K * N
                                                         + M * N)}
    # views move nothing; elementwise ops count bytes, not flops
    assert op_cost(lambda x: x[1:].t().unsqueeze(0), a) == {"bytes": 0.0}
    assert op_cost(torch.add, a, a) == {"bytes": 3 * 4 * M * K}
    assert op_flops(torch.add, a, a) is None
    assert op_cost(lambda: None) == {}


def test_op_cost_adds_the_bytes_kernel_wrappers_report():
    """K1 and K2 launch through ctypes, out of the aten counter's sight;
    their wrappers report each launch's bytes and op_cost adds them."""
    from libnyquist_torch import kernels
    from libnyquist_torch.utils.profiling import op_cost

    x, h = torch.zeros(4, 24), torch.zeros(4, 1026, dtype=torch.int32)

    def launch(t):
        kernels.count_bytes(t, h)

    assert op_cost(launch, x) == {"bytes": 4.0 * (4 * 24 + 4 * 1026)}
    assert op_cost(lambda t: launch(t.clone()), x) == {
        "bytes": 4.0 * (3 * 4 * 24 + 4 * 1026)}


X = torch.ones(6, 10)
ALLOCATIONS = {
    # an allocation moves no byte; a fill writes its output once
    "empty_like": (lambda: torch.empty_like(X), 0),
    "empty": (lambda: torch.empty(6, 10), 0),
    "new_empty": (lambda: X.new_empty(3), 0),
    "zeros_like": (lambda: torch.zeros_like(X), X.nbytes),
    "full_like": (lambda: torch.full_like(X, 2.0), X.nbytes),
    "new_zeros": (lambda: X.new_zeros(3), 12),
    # out=: the output is written once, not also read
    "mm out=": (lambda: torch.mm(X, X.T, out=torch.empty(6, 6)),
                2 * X.nbytes + 4 * 36),
}


@pytest.mark.parametrize("name", list(ALLOCATIONS))
def test_op_cost_counts_no_allocation(name):
    from libnyquist_torch.utils.profiling import op_cost

    fn, nbytes = ALLOCATIONS[name]
    assert op_cost(fn)["bytes"] == nbytes


def test_op_cost_of_a_kernel_wrapper_is_its_bytes_and_the_copy():
    """K1's wrapper pattern (ops/comb.py comb_filter_cuda): an output
    allocated with empty_like, the launch's reported bytes, then the
    history copied out of the output. op_cost is the launch's bytes
    plus the copy read and written, as phase 12 holds K1's."""
    from libnyquist_torch import kernels
    from libnyquist_torch.utils.profiling import op_cost

    x = torch.ones(4, 2048)

    def wrapper(x):
        y = torch.empty_like(x)
        kernels.count_bytes(x, y)
        return y[:, -1026:].contiguous()

    assert op_cost(wrapper, x) == {"bytes": 2.0 * x.nbytes
                                   + 2 * 4 * 4 * 1026}


def test_device_peaks_none_on_the_cpu(monkeypatch):
    from libnyquist_torch.utils import profiling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_peak_gbps() is None
    assert profiling.device_peak_tflops() is None
    assert profiling.flops_report(None, 1.0) == "flops: n/a"


@pytest.mark.parametrize("name,gbps,tflops", [
    ("NVIDIA H100 80GB HBM3", 3350.0, 66.9),
    ("NVIDIA H100 PCIe", 2000.0, 51.0),
    ("NVIDIA H100 NVL", 3900.0, 60.0),
    ("NVIDIA A100-SXM4-80GB", None, None),
])
def test_device_peaks_by_card_name(monkeypatch, name, gbps, tflops):
    from libnyquist_torch.utils import profiling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert profiling.device_peak_gbps() == gbps
    assert profiling.device_peak_tflops() == tflops


def test_peak_overrides_and_report(monkeypatch):
    """The peaks come from the card's name alone: the JAX package's
    TPU_PEAK overrides have no counterpart, so no environment moves
    them; flops_report takes the card's peak unless given one."""
    from libnyquist_torch.utils import profiling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    for name in ("LIBNYQUIST_TPU_PEAK_GBPS", "LIBNYQUIST_TPU_PEAK_TFLOPS",
                 "LIBNYQUIST_GPU_PEAK_GBPS", "LIBNYQUIST_GPU_PEAK_TFLOPS"):
        monkeypatch.setenv(name, "10")
    assert profiling.device_peak_gbps() == 3350.0
    assert profiling.device_peak_tflops() == 66.9
    assert profiling.flops_report(2e12, 1.0) == \
        "2000.00 GFLOP, 2.000 TFLOP/s, 2.99% MFU"
    assert profiling.flops_report(2e12, 1.0, peak_tflops=40.0).endswith(
        "5.00% MFU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.flops_report(2e12, 1.0) == \
        "2000.00 GFLOP, 2.000 TFLOP/s"


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from libnyquist_torch.utils.profiling import device_trace

    with device_trace(str(tmp_path / "tr")):
        torch.randn(16, 16) @ torch.randn(16, 16)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_profiling_cli(celt_file, capsys):
    from libnyquist_torch.utils.profiling import main

    assert main([str(celt_file), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln[:24].rstrip() for ln in out[1:-1]] == STAGES
    assert main([str(FIXTURES / "sv7_stereo.mpc"), "--device", "cpu"]) == 0
    assert "decode" in capsys.readouterr().out


def test_config_reflects_the_environment(monkeypatch):
    from libnyquist_torch import config

    for name in config.FLAGS:
        monkeypatch.delenv(name, raising=False)
    c = config.current()
    assert c == config.Config(flac_md5=False, cuda_home=None)
    monkeypatch.setenv("LIBNYQUIST_FLAC_MD5", "1")
    monkeypatch.setenv("CUDA_PATH", "toolkit-b")
    c = config.current()
    assert c.flac_md5
    assert c.cuda_home == "toolkit-b"
    monkeypatch.setenv("CUDA_HOME", "toolkit-a")
    assert config.current().cuda_home == "toolkit-a"
    with pytest.raises(Exception):
        c.flac_md5 = False          # frozen


def test_config_covers_every_flag_the_port_reads():
    """Every LIBNYQUIST_* name in the port's sources (but the surface's
    own table of the JAX flags it has no counterpart for) and every
    environment name it reads is a Config field."""
    from dataclasses import fields

    from libnyquist_torch import config

    pkg = ROOT / "libnyquist_torch"
    names, reads = set(), set()
    for p in pkg.rglob("*"):
        if p.suffix not in (".py", ".c", ".h", ".cu") or p.name == "config.py":
            continue
        text = p.read_text()
        names |= set(re.findall(r"\bLIBNYQUIST_[A-Z0-9_]+", text))
        reads |= set(re.findall(r"environ\.get\(\s*[\"']([A-Z0-9_]+)", text))
    assert "LIBNYQUIST_FLAC_MD5" in names and "CUDA_HOME" in reads
    field_names = {f.name for f in fields(config.Config)}
    for name in names | reads:
        assert config.FLAGS.get(name) in field_names, name
    assert set(config.FLAGS.values()) == field_names
