"""Malformed FLAC and WavPack input through the port and the JAX package,
on the CPU (after tests/test_robustness.py: truncations and seeded byte
corruption).

The port may reject an input the JAX package decodes (its C refuses
what the JAX package's Python fallbacks accept) but never raises outside
the NyquistError hierarchy; an input both packages decode gives the same
samples bit for bit, with the same metadata.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import libnyquist_torch as nqt
import libnyquist_tpu as nq
from libnyquist_torch.errors import NyquistError
from libnyquist_tpu.errors import NyquistError as JNyquistError

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs():
    fs, ws = _tool("flac_stream"), _tool("wv_stream")
    return {
        "kitty8_dithered.oga": ((FIXTURES / "kitty8_dithered.oga").read_bytes(),
                                "ogg"),
        "flac writer": (fs.make_flac_stream(70, 0.5, blocksize=None)[0],
                        "flac"),
        "hybrid_stereo.wv": ((FIXTURES / "hybrid_stereo.wv").read_bytes(),
                             "wv"),
        "dsd_fast.wv": ((FIXTURES / "dsd_fast.wv").read_bytes(), "wv"),
        "dsd_high.wv": ((FIXTURES / "dsd_high.wv").read_bytes(), "wv"),
        "wv writer": (ws.make_wv_stream(71, 0.5, "int16_joint",
                                        block_samples=4000), "wv"),
        "wv writer float": (ws.make_wv_stream(72, 0.3, "float32_wvx",
                                              block_samples=3000), "wv"),
    }


INPUTS = _inputs()


@pytest.fixture(autouse=True)
def _jax_scalar_route(monkeypatch):
    # the JAX package's scalar WavPack passes (tests/test_torch_wavpack.py)
    monkeypatch.setenv("LIBNYQUIST_NO_WV_SIMD", "1")


def _try_both(data: bytes, ext: str):
    """(port result or None, JAX result or None); a port exception outside
    the hierarchy fails the test."""
    try:
        got = nqt.load(data, extension=ext, device="cpu")
    except NyquistError:
        got = None
    try:
        ref = nq.load(data, extension=ext)
    except JNyquistError:
        ref = None
    if got is not None and ref is not None:
        assert got.samples.shape == ref.samples.shape
        assert np.array_equal(got.samples.view(np.int32),
                              ref.samples.view(np.int32))
        assert (got.sample_rate, got.channel_count) == (ref.sample_rate,
                                                        ref.channel_count)
        assert got.source_format.name == ref.source_format.name
    return got, ref


@pytest.mark.parametrize("name", list(INPUTS))
def test_truncations(name):
    data, ext = INPUTS[name]
    n = len(data)
    for frac in (0.01, 0.1, 0.45, 0.8):
        _try_both(data[: max(4, int(n * frac))], ext)


@pytest.mark.parametrize("name", list(INPUTS))
def test_byte_corruption(name):
    data, ext = INPUTS[name]
    data = data[:65536]
    rng = np.random.default_rng(sum(name.encode()))
    for _ in range(6):
        bad = bytearray(data)
        for _ in range(8):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        _try_both(bytes(bad), ext)


@pytest.mark.parametrize("name", list(INPUTS))
def test_header_corruption(name):
    """The first 96 bytes (container, STREAMINFO or block header and the
    first metadata) one byte at a time, every eighth byte flipped."""
    data, ext = INPUTS[name]
    data = data[:65536]
    for pos in range(0, min(96, len(data)), 8):
        bad = bytearray(data)
        bad[pos] ^= 0xFF
        _try_both(bytes(bad), ext)


@pytest.mark.parametrize("name", list(INPUTS))
def test_intact_input_decodes_in_both(name):
    data, ext = INPUTS[name]
    got, ref = _try_both(data, ext)
    assert got is not None and ref is not None
