"""The port's encoders (libnyquist_torch/encoders.py) against the JAX
package's, on the CPU: WAV and AIFF, the CELT and multistream Opus
writers, the typed errors. (SILK, hybrid and automatic Opus:
tests/test_torch_opus_encoders.py.)

* WAV and AIFF bytes equal the JAX encoders for every format, mono,
  stereo and the stereo->mono mixdown, with dither off; with dither on
  (noise from a seeded torch.Generator) every sample is within 1 LSB of
  the undithered one and some differ.
* Opus: the encoders are host code copied from the JAX package, so the
  packets, their pages and granules equal the JAX package's bit for bit
  given the same 48 kHz input. Input at another rate goes through the
  resampler first, which rounds differently in the last bit at some
  ratios (tests/test_torch_src.py); those cases share the JAX package's
  resampled samples by patching the port's ``ops.src.resample``, which
  the encoders look up at call time. The one difference by design is the
  OpusTags vendor string ("libnyquist_torch").
* Each mode's stream round-trips through the port's load() above the
  JAX package's own SNR floors (tests/test_encoders.py).
"""

import numpy as np
import pytest
import torch

import libnyquist_torch as nqt
from libnyquist_torch import encoders as PE
from libnyquist_torch.audio_data import AudioData, PCMFormat
from libnyquist_tpu import audio_data as JA
from libnyquist_tpu import encoders as JE
from libnyquist_tpu.formats.ogg import parse_pages

FMTS = ["PCM_U8", "PCM_16", "PCM_24", "PCM_32", "PCM_FLT"]
LAYOUTS = [(1, 1), (2, 2), (2, 1)]          # (source channels, target)


def _audio(samples, ch, sr, jax=False):
    a = JA.AudioData() if jax else AudioData()
    a.samples = samples
    a.channel_count = ch
    a.sample_rate = sr
    a.source_format = (JA.PCMFormat if jax else PCMFormat).PCM_FLT
    return a


def _pair(samples, ch, sr):
    """The same input for both packages."""
    return _audio(samples, ch, sr), _audio(samples, ch, sr, jax=True)


def _tone(ch, sr=44100, seconds=0.25):
    t = np.arange(int(sr * seconds)) / sr
    chans = [np.sin(2 * np.pi * (440 + 100 * c) * t) * 0.5
             for c in range(ch)]
    return np.stack(chans, 1).reshape(-1).astype(np.float32)


def _hot(ch, sr=44100, seconds=0.1):
    """Full-scale content: clipped peaks, both rails, exact zeros."""
    x = np.random.default_rng(ch).uniform(-1.2, 1.2, int(sr * seconds) * ch)
    x[::97] = 0.0
    x[1::89] = 1.0
    x[2::83] = -1.0
    return x.astype(np.float32)


def speechish(seconds, sr=48000, level=0.5):
    """tests/test_encoders.py's speech-like signal."""
    t = np.arange(int(sr * seconds)) / sr
    f0 = 120 * (1 + 0.1 * np.sin(2 * np.pi * 2.5 * t))
    ph = np.cumsum(2 * np.pi * f0 / sr)
    x = sum(0.25 / np.sqrt(h) * np.sin(h * ph) for h in range(1, 9))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2
    x += 0.02 * np.random.default_rng(0).standard_normal(len(t))
    return (level * x / np.abs(x).max()).astype(np.float32)


def stereo(x):
    return np.stack([x, np.roll(x, 240) * 0.9], 1).reshape(-1)


# --------------------------------------------------------------------------
# WAV and AIFF
# --------------------------------------------------------------------------
@pytest.mark.parametrize("src_ch,ch", LAYOUTS)
@pytest.mark.parametrize("fmt", FMTS)
def test_wav_bytes_match_jax(fmt, src_ch, ch):
    for sig in (_tone(src_ch), _hot(src_ch)):
        pa, ja = _pair(sig, src_ch, 44100)
        got = PE.encode_wav_to_buffer(
            PE.EncoderParams(ch, getattr(PCMFormat, fmt)), pa, device="cpu")
        ref = JE.encode_wav_to_buffer(
            JE.EncoderParams(ch, getattr(JA.PCMFormat, fmt)), ja)
        assert got == ref


@pytest.mark.parametrize("src_ch,ch", LAYOUTS)
@pytest.mark.parametrize("fmt", FMTS[:4])
def test_aiff_bytes_match_jax(fmt, src_ch, ch):
    for sig in (_tone(src_ch), _hot(src_ch)):
        pa, ja = _pair(sig, src_ch, 22050)
        got = PE.encode_aiff_to_buffer(
            PE.EncoderParams(ch, getattr(PCMFormat, fmt)), pa, device="cpu")
        ref = JE.encode_aiff_to_buffer(
            JE.EncoderParams(ch, getattr(JA.PCMFormat, fmt)), ja)
        assert got == ref


@pytest.mark.parametrize("writer", ["wav", "aiff"])
@pytest.mark.parametrize("fmt,width,lsb", [("PCM_U8", 1, 1),
                                           ("PCM_16", 2, 1),
                                           ("PCM_24", 3, 2)])
def test_dither_within_one_lsb(writer, fmt, width, lsb):
    """TPDF dither of 1 LSB peak to peak from a seeded generator moves a
    sample by at most 1 LSB, moves some, and the same seed repeats. The
    sum is float32, as in the reference package: at 24 bits a sample of
    0.5 has a float32 spacing of half an LSB, so the rounded sum can move
    it by 2; at 32 bits the LSB lies below float32's resolution."""
    enc = getattr(PE, f"encode_{writer}_to_buffer")
    a = _audio(_tone(2), 2, 44100)
    off = enc(PE.EncoderParams(2, getattr(PCMFormat, fmt)), a, device="cpu")

    def dithered(seed):
        gen = torch.Generator().manual_seed(seed)
        return enc(PE.EncoderParams(2, getattr(PCMFormat, fmt),
                                    PE.DitherType.DITHER_TRIANGLE),
                   a, device="cpu", generator=gen)

    on = dithered(7)
    assert on == dithered(7) and on != dithered(8)
    head = len(off) - a.samples.size * width
    order = "big" if writer == "aiff" else "little"

    def ints(buf):
        b = np.frombuffer(buf, np.uint8, offset=head).reshape(-1, width)
        if order == "big":
            b = b[:, ::-1]
        return sum(b[:, k].astype(np.int64) << (8 * k) for k in range(width))

    m = 1 << (8 * width)                # the difference modulo the width
    d = (ints(on) - ints(off) + m // 2) % m - m // 2
    assert np.abs(d).max() <= lsb and np.count_nonzero(d) > d.size // 10


def test_encoder_error_codes(tmp_path):
    """tests/test_encoders.py:79's codes, and the other refusals, in both
    packages."""
    E = PE.EncoderError
    empty = _audio(np.zeros(0, np.float32), 2, 44100)
    tone = _audio(_tone(2), 2, 44100)
    p = PE.EncoderParams(2, PCMFormat.PCM_16)
    path = str(tmp_path / "x.wav")
    assert PE.encode_wav_to_disk(p, empty, path, device="cpu") == int(
        E.InsufficientSampleData)
    assert PE.encode_wav_to_disk(PE.EncoderParams(5, PCMFormat.PCM_16),
                                 tone, path, device="cpu") == int(
        E.UnsupportedChannelMix)
    assert PE.encode_wav_to_disk(PE.EncoderParams(9, PCMFormat.PCM_16),
                                 tone, path, device="cpu") == int(
        E.UnsupportedChannelConfiguration)
    assert PE.encode_wav_to_disk(PE.EncoderParams(2, PCMFormat.PCM_DBL),
                                 tone, path, device="cpu") == int(
        E.UnsupportedBitdepth)
    assert PE.encode_aiff_to_disk(PE.EncoderParams(2, PCMFormat.PCM_FLT),
                                  tone, path, device="cpu") == int(
        E.UnsupportedBitdepth)
    assert PE.encode_aiff_to_disk(p, _audio(_tone(2), 2, 0), path,
                                  device="cpu") == int(E.UnsupportedSamplerate)
    assert PE.encode_wav_to_disk(p, tone, str(tmp_path / "no" / "x.wav"),
                                 device="cpu") == int(E.FileIOError)
    ok = str(tmp_path / "ok.wav")
    assert PE.encode_wav_to_disk(p, tone, ok, device="cpu") == int(E.NoError)
    back = nqt.load(ok, device="cpu")
    assert back.sample_count == tone.samples.size
    ja = _audio(_tone(2), 2, 44100, jax=True)
    assert JE.encode_wav_to_disk(JE.EncoderParams(5, JA.PCMFormat.PCM_16),
                                 ja, path) == int(E.UnsupportedChannelMix)


def test_encoders_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _audio(_tone(2), 2, 44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        PE.encode_wav_to_buffer(PE.EncoderParams(2, PCMFormat.PCM_16), a)
    with pytest.raises(RuntimeError, match="CUDA"):
        PE.encode_opus_to_buffer(PE.EncoderParams(2, PCMFormat.PCM_FLT), a)


# --------------------------------------------------------------------------
# Opus: helpers shared with tests/test_torch_opus_encoders.py
# --------------------------------------------------------------------------
@pytest.fixture
def shared_resample(monkeypatch):
    """The port's encoders resample with the JAX package's output."""
    from libnyquist_torch.ops import src as psrc
    from libnyquist_tpu.ops.src import resample as jres

    def resample(x, sr_in, sr_out, taps_per_phase=24, beta=8.6,
                 device=None):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return torch.from_numpy(
            np.array(jres(x, sr_in, sr_out, taps_per_phase, beta)))

    monkeypatch.setattr(psrc, "resample", resample)


def assert_same_ogg(got: bytes, ref: bytes):
    """Equal pages (granules, serials, sequence, flags, packets) but the
    OpusTags page, whose vendor string names each package."""
    gp, rp = list(parse_pages(got)), list(parse_pages(ref))
    assert len(gp) == len(rp) > 2
    for i, (a, b) in enumerate(zip(gp, rp)):
        if i == 1:
            assert a.segments[0].startswith(b"OpusTags")
            assert b"libnyquist_torch" in a.segments[0]
            continue
        assert (a.granule_pos, a.serial, a.page_seq, a.header_type,
                a.segments) == (b.granule_pos, b.serial, b.page_seq,
                                b.header_type, b.segments), i
    from libnyquist_torch.formats.ogg import _ogg_crc

    pos = 0
    for _ in gp:
        nseg = got[pos + 26]
        size = 27 + nseg + sum(got[pos + 27:pos + 27 + nseg])
        page = got[pos:pos + size]
        crc = int.from_bytes(page[22:26], "little")
        assert _ogg_crc(page[:22] + b"\0\0\0\0" + page[26:]) == crc
        pos += size
    assert pos == len(got)


def encode_both(sig, ch, sr, multistream=False, **kw):
    pa, ja = _pair(sig, ch, sr)
    if multistream:
        got = PE.encode_opus_multistream_to_buffer(
            PE.EncoderParams(ch, PCMFormat.PCM_FLT), pa, device="cpu", **kw)
        ref = JE.encode_opus_multistream_to_buffer(
            JE.EncoderParams(ch, JA.PCMFormat.PCM_FLT), ja, **kw)
    else:
        got = PE.encode_opus_to_buffer(
            PE.EncoderParams(ch, PCMFormat.PCM_FLT), pa, device="cpu", **kw)
        ref = JE.encode_opus_to_buffer(
            JE.EncoderParams(ch, JA.PCMFormat.PCM_FLT), ja, **kw)
    assert_same_ogg(got, ref)
    return got


def load(buf):
    return nqt.load(buf, extension="opus", device="cpu")


def snr_db(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    e = out - ref
    return 10 * np.log10(np.dot(ref.ravel(), ref.ravel())
                         / max(np.dot(e.ravel(), e.ravel()), 1e-30))


def aligned_snr_db(ref, out, skip=960):
    """tests/test_encoders.py's SILK and hybrid measure: the best lag in
    0..199 and a least-squares gain (the resampler chain delays)."""
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    n = min(len(ref), len(out))
    ref, out = ref[:n], out[:n]
    lag = max(range(200), key=lambda k: float(np.dot(ref[:n - k],
                                                       out[k:])))
    m = n - lag - skip
    o, r = out[lag:lag + m], ref[:m]
    g = float(np.dot(r, o) / max(np.dot(o, o), 1e-12))
    return snr_db(r, g * o)


# --------------------------------------------------------------------------
# CELT and multistream
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("frame_ms", [2.5, 5, 10, 20])
def test_celt_bytes_match_jax(frame_ms, ch):
    sig = speechish(0.2) if ch == 1 else stereo(speechish(0.2))
    encode_both(sig, ch, 48000, frame_ms=frame_ms, bitrate_kbps=64)


@pytest.mark.parametrize("ch", [1, 2])
def test_celt_dtx_bytes_match_jax(ch):
    sig = speechish(1.2)
    sig[int(0.2 * 48000):int(1.0 * 48000)] = 0.0
    if ch == 2:
        sig = stereo(sig)
    buf = encode_both(sig, ch, 48000, dtx=True)
    sizes = [len(p.segments[0]) for p in parse_pages(buf)][2:]
    assert buf and sizes


def test_celt_from_44k_bytes_match_jax(shared_resample):
    sig = _tone(2, 44100, 0.3)
    buf = encode_both(sig, 2, 44100, bitrate_kbps=160)
    back = load(buf)
    assert back.sample_rate == 48000
    assert abs(back.sample_count - round(sig.size * 48 / 44.1)) <= 2


@pytest.mark.parametrize("ch", [3, 6])
def test_multistream_bytes_match_jax(ch):
    t = np.arange(int(48000 * 0.3)) / 48000
    sig = np.stack([0.4 * np.sin(2 * np.pi * 220 * (c + 1) * t)
                    for c in range(ch)], 1).reshape(-1).astype(np.float32)
    encode_both(sig, ch, 48000, multistream=True)


@pytest.mark.parametrize("mode", ["celt", "silk", "hybrid", "auto"])
def test_opus_nonfinite_input_typed_error(mode):
    for bad in (np.nan, np.inf):
        a = _audio(np.full(4800, bad, np.float32), 1, 48000)
        with pytest.raises(ValueError, match="InsufficientSampleData"):
            PE.encode_opus_to_buffer(PE.EncoderParams(1, PCMFormat.PCM_FLT),
                                     a, 64, mode=mode, device="cpu")
    with pytest.raises(ValueError, match="InsufficientSampleData"):
        PE.encode_opus_multistream_to_buffer(
            PE.EncoderParams(3, PCMFormat.PCM_FLT),
            _audio(np.full(4800 * 3, np.nan, np.float32), 3, 48000),
            device="cpu")
    with pytest.raises(ValueError, match="UnsupportedChannelMix"):
        PE.encode_opus_to_buffer(PE.EncoderParams(1, PCMFormat.PCM_FLT),
                                 _audio(np.zeros(30, np.float32), 3, 48000),
                                 mode=mode, device="cpu")


@pytest.mark.parametrize("ch,kbps", [(1, 96), (2, 160)])
def test_celt_round_trip(ch, kbps):
    """tests/test_encoders.py:115's sine through the port: above 40 dB."""
    t = np.arange(int(48000 * 0.6)) / 48000
    sig = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    if ch == 2:
        sig = np.stack([sig, 0.8 * np.sin(2 * np.pi * 660 * t)],
                       1).reshape(-1).astype(np.float32)
    buf = PE.encode_opus_to_buffer(PE.EncoderParams(ch, PCMFormat.PCM_FLT),
                                   _audio(sig, ch, 48000), kbps,
                                   device="cpu")
    back = load(buf)
    assert back.channel_count == ch and back.sample_count == sig.size
    assert snr_db(sig, back.samples) > 40.0


def test_multistream_round_trip():
    """tests/test_encoders.py:411 at 3 channels: above 12 dB a channel."""
    ch = 3
    t = np.arange(48000 // 2) / 48000
    sig = np.stack([0.4 * np.sin(2 * np.pi * 220 * (c + 1) * t)
                    for c in range(ch)], 1).reshape(-1).astype(np.float32)
    buf = PE.encode_opus_multistream_to_buffer(
        PE.EncoderParams(ch, PCMFormat.PCM_FLT), _audio(sig, ch, 48000),
        device="cpu")
    back = load(buf)
    assert back.channel_count == ch and back.sample_count == sig.size
    out = back.samples.reshape(-1, ch)
    ref = sig.reshape(-1, ch)
    for c in range(ch):
        assert snr_db(ref[:, c], out[:, c]) > 12.0, c
