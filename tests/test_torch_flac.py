"""The port's FLAC decoder (native .flac and Ogg FLAC) against the JAX
package, on the CPU.

Inputs: the Ogg FLAC fixture (against its golden too) and streams of
``tools/flac_stream.py``, which returns the int samples it coded, the
round-trip oracle. Every decode is compared bit for bit, through int32
views of the float32 samples, with the same metadata.
"""

import hashlib
import importlib.util
import pathlib
import struct

import numpy as np
import pytest
import torch

import libnyquist_torch as nqt
import libnyquist_tpu as nq
from libnyquist_torch.errors import DecodeError
from libnyquist_torch.formats import flac as pflac
from libnyquist_torch.ops import lossless
from libnyquist_tpu.errors import DecodeError as JDecodeError

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
GOLDEN = ROOT / "tests" / "golden"
KITTY = FIXTURES / "kitty8_dithered.oga"


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fs = _tool("flac_stream")


def _same(a, b):
    """Both AudioData equal: samples bit for bit, rate, channels, format
    and count."""
    assert a.samples.dtype == b.samples.dtype == np.float32
    assert a.samples.shape == b.samples.shape
    assert np.array_equal(a.samples.view(np.int32), b.samples.view(np.int32))
    assert a.sample_rate == b.sample_rate
    assert a.channel_count == b.channel_count
    assert a.source_format.name == b.source_format.name
    assert a.sample_count == b.sample_count
    assert a.length_seconds == pytest.approx(b.length_seconds, rel=1e-12)


def _both(data, ext="flac"):
    return nqt.load(data, extension=ext, device="cpu"), nq.load(data,
                                                                extension=ext)


def _scaled(samples, bps):
    return samples.reshape(-1).astype(np.float32) * np.float32(
        1.0 / (1 << (bps - 1)))


def _roundtrip(data, samples, bps):
    got, ref = _both(data)
    _same(got, ref)
    assert got.channel_count == samples.shape[1]
    assert np.array_equal(got.samples.view(np.int32),
                          _scaled(samples, bps).view(np.int32))
    return got


# --------------------------------------------------------------------------
# the Ogg FLAC fixture
# --------------------------------------------------------------------------
@pytest.mark.parametrize("how", ["path", "bytes", "ogg", "oga"])
def test_ogg_flac_fixture(how):
    g = np.load(GOLDEN / "KittyPurr8_Stereo_Dithered_flac.npz")
    if how == "path":
        got, ref = (nqt.load(str(KITTY), device="cpu"), nq.load(str(KITTY)))
    else:
        data = KITTY.read_bytes()
        ext = None if how == "bytes" else how
        got = nqt.load(data, extension=ext, device="cpu")
        ref = nq.load(data, extension=ext)
    _same(got, ref)
    assert got.sample_count == int(g["count"]) == 43874
    assert got.sample_rate == int(g["rate"])
    assert got.channel_count == int(g["channels"])
    assert np.array_equal(got.samples, g["full"])


def test_ogg_flac_checks_the_mapping():
    """The Ogg mapping's version and the fLaC marker of its first packet
    are checked in both packages."""
    data = KITTY.read_bytes()
    at = data.index(b"\x7fFLAC")
    for pos, val in ((at + 5, 2), (at + 9, ord("x"))):
        bad = bytearray(data)
        bad[pos] = val
        with pytest.raises(DecodeError):
            nqt.load(bytes(bad), extension="oggflac", device="cpu")
        with pytest.raises(JDecodeError):
            nq.load(bytes(bad), extension="oggflac")


# --------------------------------------------------------------------------
# writer streams
# --------------------------------------------------------------------------
@pytest.mark.parametrize("channels", [1, 2, 6])
@pytest.mark.parametrize("bps", [8, 12, 16, 20, 24])
def test_writer_bit_depths_and_channels(bps, channels):
    data, samples = fs.make_flac_stream(bps * 10 + channels, 0.25,
                                        channels=channels, bps=bps,
                                        blocksize=1152)
    got = _roundtrip(data, samples, bps)
    assert got.source_format.name == {
        8: "PCM_S8", 12: "PCM_16", 16: "PCM_16", 20: "PCM_24",
        24: "PCM_24"}[bps]


@pytest.mark.parametrize("kind", fs.KINDS)
def test_writer_subframe_types(kind):
    """Streams of one subframe type (the constant frames stay constant
    subframes in every case)."""
    data, samples = fs.make_flac_stream(len(kind), 0.3, bps=16,
                                        kinds=(kind,), constant_share=0.1)
    _roundtrip(data, samples, 16)


@pytest.mark.parametrize("assign", fs.ASSIGNMENTS)
def test_writer_channel_assignments(assign):
    data, samples = fs.make_flac_stream(40 + len(assign), 0.3, bps=24,
                                        assignments=(assign,))
    _roundtrip(data, samples, 24)


@pytest.mark.parametrize("rate", [8000, 22050, 44100, 48000, 96000, 37800])
def test_writer_variable_blocking(rate):
    """Drawn block sizes (every blocksize code, the explicit 8- and
    16-bit ones) with UTF-8 sample numbers, and rate codes from the table,
    explicit or from STREAMINFO."""
    data, samples = fs.make_flac_stream(rate, 0.4, rate=rate, blocksize=None)
    got = _roundtrip(data, samples, 16)
    assert got.sample_rate == rate


def test_writer_covers_the_format():
    """The writer's own claims, read back by a walk of the frame and
    subframe headers: the blocksize codes (the explicit 8- and 16-bit
    ones too), the four stereo assignments, and verbatim, fixed and LPC
    subframes with and without wasted bits."""
    seen_bs, seen_assign, seen_sub = set(), set(), set()
    for seed in range(4):
        data, samples = fs.make_flac_stream(seed, 1.0, blocksize=None,
                                            wasted_share=0.4)
        pos, _ = pflac.read_metadata(data)
        frames = pflac.decode_frames(data, pos, 16, 2, 0)
        assert np.array_equal(frames, samples)
        while pos < len(data):
            assert data[pos] == 0xFF and data[pos + 1] & 0xFE == 0xF8
            seen_bs.add(data[pos + 2] >> 4)
            seen_assign.add(data[pos + 3] >> 4)
            hdr = data[pos + _header_len(data, pos)]
            kind = (hdr >> 1) & 0x3F
            seen_sub.add((1 if kind == 1 else 8 if kind < 32 else 32,
                          hdr & 1))
            pos = _next_frame(data, pos)
    assert {6, 7} <= seen_bs and len(seen_bs - {6, 7}) >= 8
    assert seen_assign == {1, 8, 9, 10}
    assert seen_sub >= {(1, 0), (8, 0), (32, 0), (8, 1), (32, 1)}


def _header_len(data, pos):
    """Bytes of the frame header at ``pos`` (through its CRC-8)."""
    bs_code, sr_code = data[pos + 2] >> 4, data[pos + 2] & 15
    lead = data[pos + 4]
    n = 5 + (0 if lead < 0x80 else (8 - (~lead & 0xFF).bit_length()) - 1)
    n += {6: 1, 7: 2}.get(bs_code, 0) + {12: 1, 13: 2, 14: 2}.get(sr_code, 0)
    return n + 1


def _next_frame(data, pos):
    """The start of the frame after ``pos``: the next sync code whose
    header CRC-8 holds."""
    p = pos + 2
    while p < len(data):
        p = data.find(b"\xff", p)
        if p < 0:
            return len(data)
        if data[p + 1] & 0xFE == 0xF8 and p + 6 < len(data):
            h = _header_len(data, p)
            if fs._crc_rows(np.frombuffer(data[p : p + h - 1], np.uint8)[None],
                            fs._CRC8, 8)[0] == data[p + h - 1]:
                return p
        p += 1
    return len(data)


def _crc(data: bytes, poly: int, width: int) -> int:
    """MSB-first CRC with initial value 0, one bit at a time."""
    crc, top, mask = 0, 1 << (width - 1), (1 << width) - 1
    for byte in data:
        crc ^= byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly if crc & top else crc << 1) & mask
    return crc


def test_writer_crcs():
    """Every frame's CRC-8 (header) and CRC-16 (frame), checked bit by bit
    (neither decoder checks them)."""
    data, _ = fs.make_flac_stream(13, 1.0, blocksize=None)
    pos, _ = pflac.read_metadata(data)
    frames = 0
    while pos < len(data):
        end = _next_frame(data, pos)
        h = _header_len(data, pos)
        assert _crc(data[pos : pos + h - 1], 0x07, 8) == data[pos + h - 1]
        assert _crc(data[pos : end - 2], 0x8005, 16) == int.from_bytes(
            data[end - 2 : end], "big")
        frames += 1
        pos = end
    assert frames >= 5


def test_writer_samples_are_what_the_md5_says():
    data, samples = fs.make_flac_stream(3, 0.2, bps=20)
    _, info = pflac.read_metadata(data)
    raw = samples.reshape(-1).astype("<i8").view(np.uint8).reshape(-1, 8)
    assert hashlib.md5(raw[:, :3].tobytes()).digest() == info["md5"]


# --------------------------------------------------------------------------
# the untrusted header total, the output growth and the MD5 check
# --------------------------------------------------------------------------
def test_resume_growth_from_a_small_first_capacity():
    """A total of 1 sample makes the first output hold 65,537 frames; the
    C call stops on the full buffer and resumes at the next frame, twice
    here, and the frames come out whole."""
    data, samples = fs.make_flac_stream(11, 4.0, bps=16, blocksize=4096)
    pos, _ = pflac.read_metadata(data)
    got = pflac.decode_frames(data, pos, 16, 2, 1)
    assert np.array_equal(got, samples)


@pytest.mark.parametrize("total", [1, 5000, (1 << 36) - 1, 0])
def test_lying_total_samples(total):
    """The 36-bit STREAMINFO total is untrusted: a small one truncates,
    a huge one allocates no more than the input bounds and decodes every
    frame, 0 means unknown. Both packages agree."""
    data, samples = fs.make_flac_stream(12, 0.5, bps=16)
    at = 8 + 10                      # STREAMINFO body + rate/ch/bps bytes
    packed = int.from_bytes(data[at : at + 8], "big")
    packed = (packed & ~((1 << 36) - 1)) | total
    data = data[:at] + packed.to_bytes(8, "big") + data[at + 8 :]
    got, ref = _both(data)
    _same(got, ref)
    keep = min(total, len(samples)) if total else len(samples)
    assert np.array_equal(got.samples.view(np.int32),
                          _scaled(samples[:keep], 16).view(np.int32))


@pytest.mark.parametrize("bps", [8, 16, 20, 24])
def test_md5_check(bps, monkeypatch):
    """With LIBNYQUIST_FLAC_MD5 set, a true STREAMINFO MD5 passes and the
    MD5 of the samples with one flipped raises, in both packages; unset,
    neither checks."""
    monkeypatch.setenv("LIBNYQUIST_FLAC_MD5", "1")
    data, samples = fs.make_flac_stream(bps, 0.2, bps=bps)
    _same(*_both(data))
    flipped = samples.copy()
    flipped[100, 1] ^= 1
    nb = (bps + 7) // 8
    raw = flipped.reshape(-1).astype("<i8").view(np.uint8).reshape(-1, 8)
    at = data.index(hashlib.md5(
        samples.reshape(-1).astype("<i8").view(np.uint8).reshape(-1, 8)
        [:, :nb].tobytes()).digest())
    bad = data[:at] + hashlib.md5(raw[:, :nb].tobytes()).digest() \
        + data[at + 16 :]
    with pytest.raises(DecodeError, match="MD5"):
        nqt.load(bad, extension="flac", device="cpu")
    with pytest.raises(JDecodeError, match="MD5"):
        nq.load(bad, extension="flac")
    monkeypatch.delenv("LIBNYQUIST_FLAC_MD5")
    _same(*_both(bad))


# --------------------------------------------------------------------------
# malformed streams
# --------------------------------------------------------------------------
def _malformed():
    data, _ = fs.make_flac_stream(21, 0.3, bps=16, blocksize=4096,
                                  kinds=("verbatim",), constant_share=0.0,
                                  wasted_share=0.0)
    pos, _ = pflac.read_metadata(data)
    sub = pos + _header_len(data, pos)       # the first subframe header
    out = {}

    def put(name, at, val):
        b = bytearray(data)
        b[at] = val
        out[name] = bytes(b)

    put("reserved channel assignment", pos + 3,
        (data[pos + 3] & 0x0F) | 0xB0)
    put("subframe padding bit", sub, 0x80 | data[sub])
    put("reserved subframe type", sub, 2 << 1)
    b = bytearray(data)
    b[sub : sub + 4] = b"\x03\x00\x00\x00"          # verbatim, 25+ wasted
    out["wasted bits beyond bps"] = bytes(b)
    out["truncated frame"] = data[: pos + 900]
    out["no frames"] = data[:pos]
    out["bad marker"] = b"fLaX" + data[4:]
    return out


@pytest.mark.parametrize("name", list(_malformed()))
def test_malformed_streams_raise_decode_error(name):
    data = _malformed()[name]
    with pytest.raises(DecodeError):
        nqt.load(data, extension="flac", device="cpu")
    with pytest.raises(JDecodeError):
        nq.load(data, extension="flac")


@pytest.mark.parametrize("assign", ["left_side", "right_side", "mid_side"])
def test_32_bit_side_channels(assign):
    """A 32-bit frame with a side channel codes a 33-bit plane. The C
    frame decode refuses it, so the port raises DecodeError; the JAX
    package's Python frame loop decodes it (ROADMAP.md, faults)."""
    data, samples = fs.make_flac_stream(7, 0.1, bps=32,
                                        assignments=(assign,))
    with pytest.raises(DecodeError):
        nqt.load(data, extension="flac", device="cpu")
    ref = nq.load(data, extension="flac")
    assert np.array_equal(ref.samples.view(np.int32),
                          _scaled(samples, 32).view(np.int32))
    data, samples = fs.make_flac_stream(7, 0.1, bps=32,
                                        assignments=("independent",))
    _roundtrip(data, samples, 32)


# --------------------------------------------------------------------------
# the device tail
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [1, 8, 12, 16, 20, 24, 32])
def test_scale_int_is_the_numpy_expression(bits):
    rng = np.random.default_rng(bits)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    x = rng.integers(lo, hi + 1, 5000).astype(np.int32)
    x[:2] = lo, hi
    if bits == 32:      # values that round to float32 either way
        x[2:6] = [2**31 - 1, 2**31 - 65, 16777217, -16777219]
    got = lossless.scale_int(torch.from_numpy(x), bits).numpy()
    ref = x.astype(np.float32) * np.float32(1.0 / (1 << (bits - 1)))
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def test_flac_module_uploads_once(monkeypatch):
    """The decoder hands the C output to the device in one copy."""
    calls = []
    real = pflac.host_to_device

    def spy(x, device):
        calls.append(x.shape)
        return real(x, device)

    monkeypatch.setattr(pflac, "host_to_device", spy)
    data, samples = fs.make_flac_stream(2, 0.2)
    nqt.load(data, extension="flac", device="cpu")
    assert calls == [(samples.size,)]


def test_streaminfo_fields():
    data, _ = fs.make_flac_stream(4, 0.2, rate=96000, channels=6, bps=24)
    pos, info = pflac.read_metadata(data)
    assert (info["rate"], info["channels"], info["bps"]) == (96000, 6, 24)
    assert info["total_samples"] == 19200
    assert struct.unpack(">H", data[8:10])[0] <= 4096
