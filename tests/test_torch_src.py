"""The port's resamplers (libnyquist_torch/ops/src.py) against the JAX
package's, on the CPU.

The polyphase resampler is a strided conv1d with the JAX package's
float32 weights: upsampling equals it bit for bit, decimation within
1e-6 of max(|ref|, 1) (the products sum in another order; 1.8e-7
measured). The tone SNR cases are tests/test_src.py's (above 80 dB);
batched equals single within 1e-6; equal rates pass through exactly; the
zero-filled tail of a decimation that runs out of cycles is kept, as the
reference's output. The reference's linear and Hermite resamplers equal
the JAX package's float32 arithmetic within 1e-6.
"""

import numpy as np
import pytest
import torch

from libnyquist_torch.ops import src as P
from libnyquist_tpu.ops import src as J

PAIRS = [(44100, 48000), (22050, 48000), (48000, 16000), (48000, 12000),
         (48000, 8000), (16000, 48000), (48000, 44100), (32000, 48000)]


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("sr_in,sr_out", PAIRS)
def test_resample_matches_jax(sr_in, sr_out):
    rng = np.random.default_rng(sr_in + sr_out)
    x = (rng.standard_normal((2, sr_in // 5 + 7)) * 0.3).astype(np.float32)
    got = P.resample(x, sr_in, sr_out, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    ref = np.asarray(J.resample(x, sr_in, sr_out))
    _close(got.numpy(), ref, 1e-6)
    if sr_out > sr_in:
        assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize(
    "sr_in,sr_out,freq",
    [
        (48000, 44100, 440.0), (48000, 44100, 15000.0),
        (44100, 48000, 1000.0), (48000, 16000, 6000.0),
        (16000, 48000, 5000.0), (48000, 24000, 9000.0),
    ],
)
def test_src_tone_snr(sr_in, sr_out, freq):
    t = np.arange(int(sr_in * 1.5)) / sr_in
    x = np.sin(2 * np.pi * freq * t).astype(np.float32)
    y = P.resample(x, sr_in, sr_out, device="cpu").numpy()
    n = len(y)
    assert n == round(int(sr_in * 1.5) * sr_out / sr_in)
    ideal = np.sin(2 * np.pi * freq * np.arange(n) / sr_out)
    sl = slice(3000, n - 3000)
    err = y[sl] - ideal[sl]
    snr = 10 * np.log10(np.mean(ideal[sl] ** 2) / np.mean(err ** 2))
    assert snr > 80.0, f"SNR {snr:.1f} dB"


@pytest.mark.parametrize("sr_in,sr_out", [(48000, 44100), (48000, 16000)])
def test_src_batched_matches_single(sr_in, sr_out):
    x = np.random.default_rng(0).standard_normal((3, 9600)).astype(np.float32)
    yb = P.resample(x, sr_in, sr_out, device="cpu").numpy()
    for i in range(3):
        yi = P.resample(x[i], sr_in, sr_out, device="cpu").numpy()
        assert np.abs(yb[i] - yi).max() < 1e-6


def test_src_passthrough():
    x = np.random.default_rng(1).standard_normal(1000).astype(np.float32)
    y = P.resample(torch.from_numpy(x), 48000, 48000, device="cpu")
    assert np.array_equal(x, y.numpy())


def test_src_keeps_the_zero_tail_of_decimation():
    """48 -> 16 kHz on 88,200 samples: the strided convolution covers
    29,389 samples past the delay and the rounded length is 29,400; both
    packages fill the last 11 with zeros."""
    x = (np.random.default_rng(2).standard_normal(88200) * 0.3).astype(
        np.float32)
    got = P.resample(x, 48000, 16000, device="cpu").numpy()
    ref = np.asarray(J.resample(x, 48000, 16000))
    assert got.shape == ref.shape == (29400,)
    _, _, delay = P.polyphase_weights(1, 3)
    filled = P._resample_poly(torch.from_numpy(x)[None], 1, 3, 24, 8.6
                              ).shape[1] - delay
    assert filled == 29389
    assert not got[filled:].any() and not ref[filled:].any()
    assert np.abs(got[filled - 100:filled]).min() > 0
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("n_out", [1000, 4410, 20000])
def test_naive_resamplers_match_jax(n_out):
    x = np.random.default_rng(n_out).standard_normal((2, 8820)).astype(
        np.float32)
    for pf, jf in ((P.linear_resample, J.linear_resample),
                   (P.hermite_resample, J.hermite_resample)):
        got = pf(x, n_out, device="cpu").numpy()
        _close(got, np.asarray(jf(x, n_out)), 1e-6)


def test_naive_resamplers():
    t = np.arange(4800) / 48000
    x = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    for fn, tol in ((P.linear_resample, 5e-3), (P.hermite_resample, 1e-3)):
        y = fn(x, 4410, device="cpu").numpy()
        ideal = np.sin(2 * np.pi * 440 * np.arange(4410) / 44100)
        assert np.abs(y[:-2] - ideal[:-2]).max() < tol


def test_resample_defaults_to_cuda(monkeypatch):
    import libnyquist_torch as nqt

    assert nqt.resample is P.resample
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        nqt.resample(np.zeros(100, np.float32), 44100, 48000)
