"""Malformed FLAC and WavPack input through the port and the JAX package,
on the CPU (after tests/test_robustness.py: truncations and seeded byte
corruption), and malformed input through every lazy seek reader (after
tests/test_seek.py:319 test_seek_reader_fuzz).

The port may reject an input the JAX package decodes (its C refuses
what the JAX package's Python fallbacks accept) but never raises outside
the NyquistError hierarchy; an input both packages decode gives the same
samples bit for bit, with the same metadata. Through the seek readers,
reads both packages complete give the same samples within the reader's
tolerance of tests/test_torch_streaming.py, or a longer read from the
port where the JAX reader's window missed its target, and the same read
counts (for the readers whose windows differ by design, the same counts
after open).
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


# one input per lazy reader type (tests/test_torch_streaming.py builds them)
SEEK_INPUTS = ("opus", "vorbis", "ogg flac chained", "flac", "mp3",
               "mpc sv7", "mpc sv8", "wav s16")


def _drive(seek_reader, source, ops):
    """Open, then seek and read per ``ops`` ((fraction of the total, read
    size) pairs); returns (reader outputs, read counts after each step,
    the exception that stopped the run or None)."""
    outs, counts = [], []
    try:
        r = seek_reader(source)
        total = r.pcm_total()
        counts.append((source.reads, source.bytes_read, total))
        for frac, n in ops:
            if total > 1:
                r.pcm_seek(int(frac * total))
            outs.append(r.read(n))
            counts.append((source.reads, source.bytes_read, r.pcm_tell()))
    except Exception as e:      # the caller sorts the exception out
        return outs, counts, e
    return outs, counts, None


@pytest.mark.parametrize("name", SEEK_INPUTS)
def test_seek_reader_fuzz(name):
    """12 seeded byte mutations of each lazy reader's input (1 to 10
    bytes anywhere, or in the first 2 KiB), each opened and read at 4
    seeded positions through both packages within 30 s: the port raises
    only NyquistError subclasses, and what both packages read agrees."""
    import random
    import time

    from libnyquist_torch import streaming as P
    from libnyquist_tpu import streaming as J

    from .test_torch_streaming import READERS, SAME_IO, close, content

    data = content(name)
    tol = READERS[name][1]
    rng = random.Random(5)
    both = 0
    for _ in range(12):
        mut = bytearray(data)
        region = rng.choice([len(data), min(2048, len(data))])
        for _ in range(rng.randint(1, 10)):
            mut[rng.randrange(region)] = rng.randrange(256)
        ops = [(rng.random(), rng.randrange(1, 4000)) for _ in range(4)]
        t0 = time.monotonic()
        got, gc, gerr = _drive(lambda s: P.seek_reader(s, device="cpu"),
                               P.CountingSource(bytes(mut)), ops)
        assert gerr is None or isinstance(gerr, (NyquistError, MemoryError)), (
            f"{name}: {type(gerr).__name__}: {gerr}")
        ref, rc, _ = _drive(J.seek_reader, J.CountingSource(bytes(mut)), ops)
        assert time.monotonic() - t0 < 30.0, name
        k = min(len(got), len(ref))
        for a, b in zip(got[:k], ref[:k]):
            if a.shape == b.shape:
                close(a, b, tol)
            else:   # the JAX window missed its target (ROADMAP.md fault 7)
                assert a.shape[0] > b.shape[0], (a.shape, b.shape)
        if gc and rc:               # both opened: the same reads so far
            same = k + 1 if SAME_IO[name] else 1
            assert gc[:same] == rc[:same]
        both += k
    assert both > 0, name
