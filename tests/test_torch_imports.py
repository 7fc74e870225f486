"""The PyTorch port stands alone: no JAX, nothing of the reference
package, CUDA by default, and clear errors for what it does not cover."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "libnyquist_torch"
FIXTURES = ROOT / "tests" / "fixtures"


def _port_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        parts = p.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_modules_import_without_jax():
    mods = _port_modules()
    for name in ("ops.comb", "ops.rot", "ops.celt_replay",
                 "formats.opus.iy_split", "runtime.serving", "formats.mp3",
                 "formats.musepack", "ops.mp3_synth", "formats.vorbis",
                 "formats.wav", "formats.aiff", "ops.pcm", "ops.adpcm",
                 "formats.flac", "formats.wavpack", "ops.lossless",
                 "formats.opus.decoder", "formats.opus.silk",
                 "formats.opus.silk_tables", "formats.opus.range_coder",
                 "formats.opus.celt_frame", "formats.opus.celt_plc",
                 "formats.opus.repacketizer", "encoders", "ops.src",
                 "formats.opus.celt", "formats.opus.celt_encoder",
                 "formats.opus.silk_encoder", "formats.opus.hybrid_encoder",
                 "formats.opus.analysis", "streaming", "net", "cli",
                 "parallel.mesh", "entry", "utils.profiling", "config",
                 "bench"):
        assert f"libnyquist_torch.{name}" in mods
    # Only what the port's imports add counts: an interpreter start-up hook
    # may load jax before any of them runs.
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in set(sys.modules) - before if k.split('.')[0]"
        " in ('jax', 'jaxlib', 'libnyquist_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_stream_writers_import_without_jax():
    """The seeded stream writers the tests and the card run share import
    NumPy only."""
    code = (
        "import importlib.util, sys\n"
        "before = set(sys.modules)\n"
        "for name in ('vorbis_stream', 'l3_stream', 'flac_stream',"
        " 'wv_stream', 'opus_stream'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'tools/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in set(sys.modules) - before if k.split('.')[0]"
        " in ('jax', 'jaxlib', 'libnyquist_tpu', 'libnyquist_torch',"
        " 'torch'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax():
    """The package's sources never name the reference package or JAX.
    chip_smoke.py imports neither (its kernel table names the TPU kernel
    each CUDA kernel replaces, by file and line)."""
    srcs = [p for p in PKG.rglob("*") if p.suffix in (".py", ".c", ".h", ".cu")]
    assert any(p.suffix == ".cu" for p in srcs)
    for p in srcs:
        text = p.read_text()
        assert "libnyquist_tpu" not in text, p
        assert "import jax" not in text and "from jax" not in text, p
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|libnyquist_tpu)\b",
                         smoke, re.M)


def test_load_defaults_to_cuda_and_raises_without_it(monkeypatch):
    import libnyquist_torch as nqt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        nqt.load(str(FIXTURES / "ms8ch.opus"), device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        nqt.load(str(FIXTURES / "ms8ch.opus"), device="cuda")


def _ogg_pages(data):
    pages, pos = [], 0
    while pos < len(data):
        nseg = data[pos + 26]
        size = 27 + nseg + sum(data[pos + 27 : pos + 27 + nseg])
        pages.append(data[pos : pos + size])
        pos += size
    return pages


def _inputs(name):
    """Layer III the native decode hands back (free format, a Layer II
    frame ahead of Layer III), and two general-path Opus files: a
    chained one (a second link under another serial number) and one
    with a lost page."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_tool_l3_stream", ROOT / "tools" / "l3_stream.py")
    l3 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(l3)
    opus = (FIXTURES / "ms8ch.opus").read_bytes()
    pages = _ogg_pages(opus)
    if name == "free-format Layer III":
        return l3.make_l3_stream(3, 1.0, free_format=True), "mp3"
    if name == "mixed layers":
        return ((FIXTURES / "l2_stereo_44k.mp3").read_bytes()
                + l3.make_l3_stream(3, 1.0)), "mp3"
    if name == "chained Opus":
        return opus + b"".join(p[:14] + (0x1234567).to_bytes(4, "little")
                               + p[18:] for p in pages), "opus"
    return b"".join(pages[:4] + pages[5:]), "opus"


@pytest.mark.parametrize("name", ["free-format Layer III", "mixed layers"])
def test_other_formats_name_their_roadmap_item(name):
    """Layer III outside the native decode, once a queue item, now
    decodes through the per-frame route: load() equals the JAX package
    within 1e-5 of max(|ref|, 1) (the name is kept)."""
    import libnyquist_torch as nqt
    import libnyquist_tpu as nq

    data, ext = _inputs(name)
    got = nqt.load(data, extension=ext, device="cpu")
    ref = nq.load(data, extension=ext)
    assert (got.channel_count, got.sample_rate) == (ref.channel_count,
                                                    ref.sample_rate)
    assert got.samples.shape == ref.samples.shape and got.samples.size
    err = np.abs(got.samples - ref.samples).max()
    assert err <= 1e-5 * max(1.0, np.abs(ref.samples).max()), err


@pytest.mark.parametrize("name", ["chained Opus", "lost Opus page"])
def test_general_opus_inputs_match_jax(name):
    """The general Opus path decodes what it once named as a queue item:
    load() equals the JAX package within 1e-4."""
    import libnyquist_torch as nqt
    import libnyquist_tpu as nq

    data, ext = _inputs(name)
    got = nqt.load(data, extension=ext, device="cpu")
    ref = nq.load(data, extension=ext)
    assert got.channel_count == ref.channel_count == 8
    assert got.samples.shape == ref.samples.shape
    assert np.abs(got.samples - ref.samples).max() < 1e-4


def test_unified_path_rejects_lm0():
    from libnyquist_torch.runtime import serving

    freq = np.zeros((4, 2, 120), np.float32)
    z = np.zeros(4, np.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        serving.synthesize_streams_unified(
            freq, z, z, z.astype(np.float64), z, 2, device="cpu")


def test_cuda_wrapper_refuses_cpu_tensors():
    from libnyquist_torch.ops import comb

    before = comb.comb_filter_cuda.launches
    x = torch.zeros(1, comb.CHUNK)
    with pytest.raises(ValueError, match="CUDA"):
        comb.comb_filter_cuda(
            x, torch.zeros(1, comb.HIST), torch.full((1, 1), 15, dtype=torch.int32),
            torch.full((1, 1), 15, dtype=torch.int32), torch.zeros(1, 1, 3),
            torch.zeros(1, 1, 3), torch.zeros(1, 1, comb.CHUNK))
    assert comb.comb_filter_cuda.launches == before
