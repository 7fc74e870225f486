"""The port's Musepack decoder against the JAX package, on the CPU.

Requantization is the same float64 NumPy: equal within 1e-12. load() of
the SV7 fixture: 1e-5 against the JAX package, 1e-4 against the
libmpcdec golden (tests/test_musepack.py's bound). The float32 serving
synthesis: 1e-4 * max(|ref|, 1) against the JAX package's, batched
against single 1e-6. SV8 streams assembled here from seeded frame bytes:
the same PCM (1e-5 * max(|ref|, 1)) or the same DecodeError.
"""

import pathlib

import numpy as np
import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
GOLDEN = pathlib.Path(__file__).parent / "golden"
SV7 = FIXTURES / "sv7_stereo.mpc"


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _jax_load(data):
    from libnyquist_tpu.audio_data import AudioData
    from libnyquist_tpu.formats import musepack

    a = AudioData()
    musepack.decode_musepack_buffer(data, a)
    return a


def _port_load(data):
    import libnyquist_torch as nqt

    return nqt.load(data, extension="mpc", device="cpu")


def test_requantize_batch_matches_jax():
    from libnyquist_torch.formats import musepack as P
    from libnyquist_tpu.formats import musepack as J

    rng = np.random.default_rng(3)
    F = 6
    q = rng.integers(-300, 300, (F, 2, 32, 36)).astype(np.int32)
    res = rng.integers(-1, 18, (F, 2, 32)).astype(np.int32)
    scf = rng.integers(-6, 121, (F, 2, 32, 3)).astype(np.int32)
    msf = rng.integers(0, 2, (F, 32)).astype(np.int32)
    for max_band in (31, 20):
        got = P._requantize_batch(q, res, scf, msf, max_band)
        ref = J._requantize_batch(q, res, scf, msf, max_band)
        for g, r in zip(got, ref):
            assert np.abs(g - r).max() <= 1e-12 * max(1.0, np.abs(r).max())


def test_synth_stream_matches_jax():
    from libnyquist_torch.formats import musepack as P
    from libnyquist_tpu.formats import musepack as J

    Y = np.random.default_rng(4).standard_normal((200, 32)) * 0.01
    _close(P._synth_stream(Y), J._synth_stream(Y), 1e-12)


def test_sv7_load_matches_jax_and_golden():
    data = SV7.read_bytes()
    got = _port_load(data)
    ref = _jax_load(data)
    g = np.load(GOLDEN / "mpc_sv7.npz")
    assert (got.channel_count, got.sample_rate) == (2, 44100)
    assert got.sample_count == ref.sample_count == int(g["count"])
    assert np.abs(got.samples - ref.samples).max() <= 1e-5
    assert np.abs(got.samples - g["full"]).max() < 1e-4
    assert got.source_format.name == "PCM_16"
    assert got.length_seconds == pytest.approx(ref.length_seconds)


def test_synthesize_mpc_streams_matches_jax():
    """Three stereo streams of the fixture's requantized rows, started at
    different frames, through the float32 serving path."""
    from libnyquist_torch.formats import musepack as P
    from libnyquist_torch.runtime import serving
    from libnyquist_tpu.runtime import serving as JS

    Y, ch, rate = P.requantized_rows(SV7.read_bytes())
    assert (ch, rate) == (2, 44100) and Y.shape[2] == 32
    T = Y.shape[1] - 72
    ys = np.concatenate([Y[:, 36 * k : 36 * k + T] for k in range(3)])
    ys = ys.astype(np.float32)                         # [6, T, 32]
    ref = np.asarray(JS.synthesize_mpc_streams(ys, use_device=True))
    got = serving.synthesize_mpc_streams(ys, device="cpu").numpy()
    _close(got, ref, 1e-4)
    one = serving.synthesize_mpc_streams(ys[2:3], device="cpu").numpy()
    _close(one[0], got[2], 1e-6)
    _close(got[0], P._synth_stream(ys[0].astype(np.float64)).reshape(-1),
           1e-4)


def _block(key: bytes, body: bytes) -> bytes:
    """One SV8 block: key, varint size (counting key and size), body."""
    n = len(body) + 3
    while True:
        size = []
        v = n
        size.append(v & 0x7F)
        v >>= 7
        while v:
            size.append(0x80 | (v & 0x7F))
            v >>= 7
        size = bytes(reversed(size))
        if 2 + len(size) + len(body) == n:
            return key + size + body
        n = 2 + len(size) + len(body)


def _sv8_stream(seed, channels=2, ms=1, max_band=20, block_pwr=1,
                n_ap=3):
    """SH (44.1 kHz, max_band, channels, ms, 2^block_pwr frames per AP),
    n_ap AP blocks of seeded bytes, SE."""
    rng = np.random.default_rng(seed)
    n_frames = n_ap << block_pwr
    total = n_frames * 1152 - 700
    sh = bytearray(b"\x00\x00\x00\x00\x08")          # CRC, version 8
    for v in (total, 0):                             # samples, silence
        sh.append(v >> 14 | 0x80) if v >> 14 else None
        sh.append((v >> 7 & 0x7F) | 0x80) if v >> 7 else None
        sh.append(v & 0x7F)
    bits = (0 << 13) | ((max_band - 1) << 8) | ((channels - 1) << 4) \
        | (ms << 3) | (block_pwr // 2)
    sh += bits.to_bytes(2, "big")
    out = b"MPCK" + _block(b"SH", bytes(sh))
    for _ in range(n_ap):
        out += _block(b"AP", rng.integers(0, 256, 2500 << block_pwr,
                                          np.uint8).tobytes())
    return out + _block(b"SE", b"")


@pytest.mark.parametrize("seed,channels,block_pwr", [
    (1, 2, 2), (2, 2, 0), (3, 1, 2), (4, 2, 4)])
def test_sv8_assembled_matches_jax(seed, channels, block_pwr):
    from libnyquist_torch.errors import DecodeError as PortDecodeError
    from libnyquist_tpu.errors import DecodeError

    data = _sv8_stream(seed, channels=channels, block_pwr=block_pwr)
    try:
        ref = _jax_load(data)
    except DecodeError:
        with pytest.raises(PortDecodeError):
            _port_load(data)
        return
    got = _port_load(data)
    assert (got.channel_count, got.sample_rate) == (channels, 44100)
    assert got.sample_count == ref.sample_count > 0
    _close(got.samples, ref.samples, 1e-5)


def test_sv8_overrun_raises_in_both():
    """An AP block two bytes long cannot hold a frame: both packages
    raise DecodeError (bitstream overrun)."""
    from libnyquist_torch.errors import DecodeError as PortDecodeError
    from libnyquist_tpu.errors import DecodeError

    data = _sv8_stream(9, block_pwr=2)
    ap = data.index(b"AP")
    data = data[:ap] + _block(b"AP", b"\xff\xff") + _block(b"SE", b"")
    with pytest.raises(DecodeError, match="overrun"):
        _jax_load(data)
    with pytest.raises(PortDecodeError, match="overrun"):
        _port_load(data)


def test_bad_magic_raises():
    from libnyquist_torch.errors import DecodeError

    with pytest.raises(DecodeError):
        _port_load(b"MPXX" + b"\x00" * 64)


@pytest.mark.parametrize("name", [
    "sv7_stereo.mpc", "l1_stereo_44k.mp3", "l2_stereo_44k.mp3",
    "l2_joint_44k.mp3", "l2_mono_44k_56k.mp3", "l2_mpeg2_22k.mp3"])
def test_buffer_sniffing(name):
    """In-memory buffers without an extension go by their magic bytes
    (MP+ / frame sync) to the same decode as the path."""
    import libnyquist_torch as nqt
    from libnyquist_torch.io import sniff_extension

    path = FIXTURES / name
    data = path.read_bytes()
    assert sniff_extension(data) == path.suffix[1:]
    a = nqt.load(data, device="cpu")
    b = nqt.load(str(path), device="cpu")
    assert a.sample_count == b.sample_count > 0
    assert np.array_equal(a.samples, b.samples)
    assert sniff_extension(b"ID3\x04" + bytes(20)) == "mp3"
    assert sniff_extension(b"MPCK" + bytes(20)) == "mpc"
