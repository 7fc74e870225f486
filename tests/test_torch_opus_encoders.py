"""The port's SILK, hybrid and automatic Opus encoders against the JAX
package's, on the CPU (the helpers, and what "equal" means, are those of
tests/test_torch_encoders.py).

SILK resamples its 48 kHz input to its internal rate, and the decimating
resampler rounds differently in the last bit from the JAX one
(tests/test_torch_src.py). SILK quantizes to int16, so one flipped
sample changes every later byte: the byte comparisons share the JAX
package's resampled samples (``shared_resample``). Round trips run the
port's own resampler and load() against the JAX package's SNR floors
(tests/test_encoders.py:149, :442; tests/test_analysis.py:100).
"""

import numpy as np
import pytest

from libnyquist_torch import encoders as PE
from libnyquist_torch.audio_data import PCMFormat

from .test_torch_encoders import (  # noqa: F401  (shared_resample: fixture)
    _audio,
    aligned_snr_db,
    encode_both,
    load,
    shared_resample,
    snr_db,
    speechish,
    stereo,
)

SR = 48000


@pytest.mark.parametrize("ch,bandwidth,frame_ms", [
    (1, "nb", 20), (1, "mb", 20), (1, "wb", 20), (2, "wb", 20),
    (1, "wb", 10), (1, "nb", 40), (2, "mb", 40), (1, "wb", 60)])
def test_silk_bytes_match_jax(shared_resample, ch, bandwidth, frame_ms):
    sig = speechish(0.24)
    encode_both(sig if ch == 1 else stereo(sig), ch, SR, mode="silk",
                bandwidth=bandwidth, frame_ms=frame_ms)


@pytest.mark.parametrize("ch", [1, 2])
def test_silk_lbrr_bytes_match_jax(shared_resample, ch):
    sig = speechish(0.24)
    buf = encode_both(sig if ch == 1 else stereo(sig), ch, SR, mode="silk",
                      fec=True)
    assert load(buf).channel_count == ch


def test_silk_dtx_bytes_match_jax(shared_resample):
    sig = speechish(1.0)
    sig[int(0.2 * SR):int(0.9 * SR)] = 0.0
    buf = encode_both(sig, 1, SR, mode="silk", dtx=True)
    back = load(buf)
    assert back.sample_count == sig.size


@pytest.mark.parametrize("ch,bandwidth,frame_ms", [
    (1, "fb", 20), (1, "swb", 20), (1, "fb", 10), (2, "swb", 10)])
def test_hybrid_bytes_match_jax(shared_resample, ch, bandwidth, frame_ms):
    sig = speechish(0.16)
    t = np.arange(sig.size) / SR
    sig = sig + (0.1 * np.sin(2 * np.pi * 10500 * t)).astype(np.float32)
    encode_both(sig if ch == 1 else stereo(sig), ch, SR, mode="hybrid",
                bandwidth=bandwidth, frame_ms=frame_ms, bitrate_kbps=64)


def _musicish(seconds):
    t = np.arange(int(SR * seconds)) / SR
    chord = sum(np.sin(2 * np.pi * f * t)
                for f in (220.0, 277.2, 329.6, 440.0))
    return (0.2 * chord).astype(np.float32)


def _talk(seconds, hiss):
    """tests/test_analysis.py's speech-like content; hiss drives the
    hybrid branch (energy above SILK's 8 kHz ceiling)."""
    rng = np.random.default_rng(0)
    t = np.arange(int(SR * seconds)) / SR
    env = np.clip(np.sin(2 * np.pi * 3.1 * t), 0, None) ** 2
    f0 = 120 * (1 + 0.25 * np.sin(2 * np.pi * 0.7 * t))
    ph = 2 * np.pi * np.cumsum(f0) / SR
    buzz = sum(np.sin(k * ph) / k for k in range(1, 9))
    noise = rng.standard_normal(len(t)) * hiss
    return (env * (0.5 * buzz + noise)).astype(np.float32) * 0.4


def _families(buf):
    from libnyquist_tpu.formats.ogg import demux

    st = next(iter(demux(buf).values()))
    cfgs = [q.data[0] >> 3 for q in st.packets[2:]]
    return {"silk" if c < 12 else "hybrid" if c < 16 else "celt"
            for c in cfgs}


@pytest.mark.parametrize("kbps,hiss,want,min_snr", [
    (24, 0.1, {"celt", "silk"}, 15.0),
    (40, 0.35, {"celt", "hybrid"}, 8.0),
])
def test_auto_bytes_and_round_trip(shared_resample, kbps, hiss, want,
                                   min_snr):
    """Music, speech, music: the automatic encoder picks the JAX
    package's segments and bytes, and the port's load() of them keeps the
    exact length and tests/test_analysis.py:100's floors."""
    x = np.concatenate([_musicish(0.6), _talk(0.8, hiss), _musicish(0.6)])
    buf = encode_both(x, 1, SR, mode="auto", bitrate_kbps=kbps)
    assert _families(buf) == want
    back = load(buf)
    assert back.sample_count == x.size
    assert snr_db(x, back.samples) > min_snr
    tail = SR // 2                      # the music after two switches
    assert snr_db(x[-tail:], back.samples[-tail:]) > 15.0


@pytest.mark.parametrize("ch", [1, 2])
def test_silk_round_trip(ch):
    """The JAX package's floors through the port's own resampler and
    load(): 17 dB mono (tests/test_encoders.py:149), 15 dB a channel
    stereo (:570)."""
    sig = speechish(0.6)
    x = sig if ch == 1 else stereo(sig)
    buf = PE.encode_opus_to_buffer(PE.EncoderParams(ch, PCMFormat.PCM_FLT),
                                   _audio(x, ch, SR), mode="silk",
                                   device="cpu")
    back = load(buf)
    assert back.channel_count == ch and back.sample_rate == SR
    out = back.samples.reshape(-1, ch)
    ref = x.reshape(-1, ch)
    for c in range(ch):
        assert aligned_snr_db(ref[:, c], out[:, c]) > (17.0, 15.0)[ch - 1], c


def test_hybrid_round_trip():
    """tests/test_encoders.py:442: above 11 dB, and the 10.5 kHz tone
    (above SILK's band) survives through the CELT half."""
    sig = speechish(0.6)
    t = np.arange(sig.size) / SR
    sig = sig + (0.1 * np.sin(2 * np.pi * 10500 * t)).astype(np.float32)
    buf = PE.encode_opus_to_buffer(PE.EncoderParams(1, PCMFormat.PCM_FLT),
                                   _audio(sig, 1, SR), 64, mode="hybrid",
                                   device="cpu")
    out = load(buf).samples
    assert aligned_snr_db(sig, out) > 11.0
    n = min(out.size, sig.size) // 2 * 2
    f = np.fft.rfftfreq(n, 1 / SR)
    band = (f > 10400) & (f < 10600)
    got = np.abs(np.fft.rfft(out[:n]))[band].max()
    want = np.abs(np.fft.rfft(sig[:n]))[band].max()
    assert got > 0.5 * want
