"""Malformed input through every route of ``load()`` in the port and the
JAX package, on the CPU (after tests/test_robustness.py: truncations and
seeded byte corruption), and malformed input through every lazy seek
reader (after tests/test_seek.py:319 test_seek_reader_fuzz).

The inputs are tools/malformed_inputs.py's (chip_smoke.py phase 13 runs
them on the card): Ogg FLAC, FLAC, WavPack (hybrid, DSD fast and high,
integer and float writer streams), Musepack SV7 and SV8, MP3 Layer I and
II, Ogg Opus (a family-1 multistream file and a single-stream CELT-only
file, the native scan route), Vorbis floor 0 and floor 1, IMA-ADPCM WAV,
AIFF-C ima4 and CAF. The port never raises outside the NyquistError
hierarchy, and a codec's output is finite (the reference's policy,
tests/test_robustness.py:276-281; a float container passes its own bits
through). An input both packages decode gives the same metadata and the
same samples: equal bits for FLAC, WavPack and integer PCM, within
1e-5 of max(|ref|, 1) for MP3 and Musepack, 1e-4 for Opus and Vorbis
(each format's own parity test).

The port may reject an input the JAX package decodes, where the JAX
package's Python takes what the port's C or its header checks refuse:
FLAC and WavPack (the JAX package's Python fallbacks of the native
planes), Musepack (an SV8 stream header of more than two channels, of
which the JAX package synthesizes the left channel only). The port
decodes some CELT-only Opus files the JAX package's raw CELT decode
raises on (ROADMAP.md section 3). Through the seek readers, reads both
packages complete give the same samples within the reader's tolerance
of tests/test_torch_streaming.py, or a longer read from the port where
the JAX reader's window missed its target, and the same read counts
(for the readers whose windows differ by design, the same counts after
open).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import libnyquist_torch as nqt
import libnyquist_tpu as nq
from libnyquist_torch.audio_data import PCMFormat
from libnyquist_torch.errors import NyquistError
from libnyquist_tpu.errors import NyquistError as JNyquistError

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MI = _tool("malformed_inputs")
INPUTS = MI.inputs()
# formats that pass the file's own IEEE bits through, NaN and Inf included
FLOAT_CONTAINERS = (PCMFormat.PCM_FLT, PCMFormat.PCM_DBL)


@pytest.fixture(autouse=True)
def _jax_scalar_route(monkeypatch):
    # the JAX package's scalar WavPack passes (tests/test_torch_wavpack.py)
    monkeypatch.setenv("LIBNYQUIST_NO_WV_SIMD", "1")


def _try_both(data: bytes, ext: str, tol=None):
    """(port result or None, JAX result or None); a port exception outside
    the hierarchy fails the test. ``tol``: None for equal bits, else the
    share of max(|ref|, 1) the samples may differ by."""
    try:
        got = nqt.load(data, extension=ext, device="cpu")
    except NyquistError:
        got = None
    if got is not None and got.source_format not in FLOAT_CONTAINERS:
        assert np.isfinite(got.samples).all()
    try:
        ref = nq.load(data, extension=ext)
    except JNyquistError:
        ref = None
    if got is not None and ref is not None:
        assert got.samples.shape == ref.samples.shape
        if tol is None:
            assert np.array_equal(got.samples.view(np.int32),
                                  ref.samples.view(np.int32))
        elif ref.samples.size:
            err = float(np.abs(got.samples - ref.samples).max())
            assert err <= tol * max(float(np.abs(ref.samples).max()), 1.0)
        assert (got.sample_rate, got.channel_count) == (ref.sample_rate,
                                                        ref.channel_count)
        assert got.source_format.name == ref.source_format.name
    return got, ref


@pytest.mark.parametrize("name", list(INPUTS))
def test_truncations(name):
    inp = INPUTS[name]
    for data in MI.truncations(inp.data):
        _try_both(data, inp.ext, inp.tol)


@pytest.mark.parametrize("name", list(INPUTS))
def test_byte_corruption(name):
    inp = INPUTS[name]
    for data in MI.corruptions(inp.data, sum(name.encode())):
        _try_both(data, inp.ext, inp.tol)


@pytest.mark.parametrize("name", list(INPUTS))
def test_header_corruption(name):
    """The first 96 bytes (container, STREAMINFO or block header and the
    first metadata) one byte at a time, every eighth byte flipped."""
    inp = INPUTS[name]
    for data in MI.header_flips(inp.data):
        _try_both(data, inp.ext, inp.tol)


@pytest.mark.parametrize("name", list(INPUTS))
def test_intact_input_decodes_in_both(name):
    inp = INPUTS[name]
    got, ref = _try_both(inp.data, inp.ext, inp.tol)
    assert got is not None and ref is not None


def test_sv8_more_than_two_channels_raises():
    """An SV8 stream header of 15 channels: the port raises at the header
    (the JAX package synthesizes the left channel under that count)."""
    from libnyquist_torch.errors import DecodeError

    data = bytearray(INPUTS["sv8 assembled"].data)
    # the SH body (after its key and one size byte): CRC, version, two
    # bytes of total samples, one of silence, rate and max band, then
    # the channel count less one in the next byte's high nibble
    pos = data.index(b"SH") + 3 + 9
    data[pos] = (data[pos] & 0x0F) | 0xE0
    with pytest.raises(DecodeError, match="15 channels"):
        nqt.load(bytes(data), extension="mpc", device="cpu")
    assert nq.load(bytes(data), extension="mpc").channel_count == 15


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
