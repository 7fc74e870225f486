"""The port's MP3 decoder against the JAX package, on the CPU.

Synthesis (plain NumPy forms and the device module) on seeded granules
with the seven block-type cases of tests/test_serving.py, mono and
stereo: |d| <= 1e-5 * max(|ref|, 1). The Layer III host half is the
same C on the same tables: equal element for element. load() of the
Layer I/II fixtures: 1e-5 against the JAX package, 1e-4 against the
minimp3 goldens (tests/test_mp3_l12.py's bound); of generated Layer III
streams (tools/l3_stream.py), free-format ones through the per-frame
route included: 1e-5 against the JAX package.
"""

import pathlib

import numpy as np
import pytest
import torch

from tools.l3_stream import make_l3_stream

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
GOLDEN = pathlib.Path(__file__).parent / "golden"
L12 = ["l2_stereo_44k", "l2_joint_44k", "l2_mono_44k_56k", "l1_stereo_44k",
       "l2_mpeg2_22k"]
# (block_type, n_long_bands) per granule: tests/test_serving.py:95
CASES = [(0, 0), (2, 0), (2, 2), (3, 0), (1, 0), (2, 4), (0, 0)]


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _granules(seed, nch, S=1):
    """S streams of the seven cases' granules: X [S, 7, 2, 576] and kinds
    [S, 7, 2, 32] (mono streams carry a second plane, unused)."""
    from libnyquist_torch.ops import mp3_synth as P

    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((S, len(CASES), 2, 576)) * 0.3).astype(np.float32)
    kinds = np.stack([np.stack([P.band_kinds(bt, nl) for _ in range(2)])
                      for bt, nl in CASES])
    return X, np.broadcast_to(kinds, (S,) + kinds.shape).copy()


def _jax_audio(data):
    from libnyquist_tpu.audio_data import AudioData
    from libnyquist_tpu.formats import mp3

    a = AudioData()
    mp3.decode_mp3_buffer(data, a)
    return a


def _port_audio(data):
    import libnyquist_torch as nqt

    return nqt.load(data, extension="mp3", device="cpu")


@pytest.mark.parametrize("nch", [1, 2])
def test_imdct_granules_stream_matches_jax(nch):
    from libnyquist_torch.ops import mp3_synth as P
    from libnyquist_tpu.ops import mp3_synth as J

    X, kinds = _granules(5, nch)
    ref = J.imdct_granules_stream(X[0, :, :nch], kinds[0, :, :nch])
    _close(P.imdct_granules_stream(X[0, :, :nch], kinds[0, :, :nch]), ref,
           1e-5)
    assert set(np.unique(kinds)) == {0, 1, 2}


@pytest.mark.parametrize("nbands,nch", [(18, 1), (18, 2), (12, 2)])
def test_synth_granules_stream_matches_jax(nbands, nch):
    from libnyquist_torch.ops import mp3_synth as P
    from libnyquist_tpu.ops import mp3_synth as J

    X, _ = _granules(6, nch)
    ref = J.synth_granules_stream(X[0], nbands, nch)
    _close(P.synth_granules_stream(X[0], nbands, nch), ref, 1e-5)
    # the float64 form (the chip run's reference) agrees as well
    _close(P.synth_granules_stream(X[0], nbands, nch, np.float64), ref, 1e-5)


@pytest.mark.parametrize("nch", [1, 2])
def test_device_synth_matches_jax(nch):
    """Mp3Synth on the CPU against make_mp3_device_synth jitted on the
    CPU, two streams in one batch; each stream alone gives the same."""
    import jax

    from libnyquist_torch.ops import mp3_synth as P
    from libnyquist_tpu.ops import mp3_synth as J

    X, kinds = _granules(7, nch, S=2)
    ref = np.asarray(jax.jit(J.make_mp3_device_synth(nch))(X, kinds))
    from libnyquist_torch.runtime import serving

    mod = P.Mp3Synth(nch, device="cpu")
    got = mod(torch.from_numpy(X), torch.from_numpy(kinds)).numpy()
    assert got.shape == (2, len(CASES) * 576, nch)
    _close(got, ref, 1e-5)
    served = serving.synthesize_mp3_streams(X, kinds, nch, device="cpu")
    assert np.array_equal(served.numpy(), got)
    for s in range(2):
        one = mod(torch.from_numpy(X[s : s + 1]),
                  torch.from_numpy(kinds[s : s + 1])).numpy()
        _close(one[0], got[s], 1e-6)


def test_device_synth_time_domain_matches_plain():
    """Layer I/II's form: no IMDCT, nbands = 12."""
    from libnyquist_torch.ops import mp3_synth as P

    X, _ = _granules(8, 2)
    got = P.Mp3Synth(2, 12, "cpu")(torch.from_numpy(X)).numpy()
    _close(got[0], P.synth_granules_stream(X[0], 12, 2, np.float64), 1e-5)


@pytest.mark.parametrize("channels", [1, 2])
def test_l3_stream_entropy_equals_jax(channels):
    from libnyquist_torch.formats import mp3 as P
    from libnyquist_tpu.formats import mp3 as J

    data = make_l3_stream(11 + channels, 1.0, channels=channels)
    X, kinds, nch, hz = P.l3_stream_entropy(data)
    Xj, kj, nchj, hzj = J.l3_stream_entropy(data)
    assert (nch, hz) == (nchj, hzj) == (channels, 44100)
    assert X.shape == Xj.shape and kinds.shape == kj.shape
    assert np.array_equal(X, Xj) and np.array_equal(kinds, kj)
    assert set(np.unique(kinds)) == {0, 1, 2}
    assert np.abs(X).max() > 0


@pytest.mark.parametrize("name", L12)
def test_load_l12_fixtures(name):
    data = (FIXTURES / f"{name}.mp3").read_bytes()
    got = _port_audio(data)
    ref = _jax_audio(data)
    g = np.load(GOLDEN / f"{name}.npz")
    assert (got.channel_count, got.sample_rate) == (ref.channel_count,
                                                   ref.sample_rate)
    assert got.channel_count == int(g["channels"])
    assert got.sample_count == int(g["count"]) == ref.sample_count
    assert np.abs(got.samples - ref.samples).max() <= 1e-5
    assert np.abs(got.samples - g["full"]).max() < 1e-4
    assert got.length_seconds == pytest.approx(ref.length_seconds)
    assert got.source_format.name == "PCM_FLT"


@pytest.mark.parametrize("channels", [1, 2])
def test_load_generated_l3_matches_jax(channels):
    data = make_l3_stream(21 + channels, 1.5, channels=channels)
    got = _port_audio(data)
    ref = _jax_audio(data)
    assert (got.channel_count, got.sample_rate) == (channels, 44100)
    assert got.sample_count == ref.sample_count
    _close(got.samples, ref.samples, 1e-5)
    assert 0.01 < np.abs(got.samples).max() < 8.0


@pytest.mark.parametrize("channels", [1, 2])
def test_load_segmented_l3_matches_jax(channels):
    """A resync (junk between two streams) ends a segment: the next
    starts the synthesis from silence, not fused into one batch row."""
    a = make_l3_stream(31, 0.6, channels=channels)
    b = make_l3_stream(32, 0.6, channels=channels)
    data = a + bytes(range(7)) * 3 + b
    got = _port_audio(data)
    ref = _jax_audio(data)
    assert got.sample_count == ref.sample_count
    _close(got.samples, ref.samples, 1e-5)
    # b's segment starts from silence: it is b decoded on its own
    alone = _port_audio(b).samples
    _close(got.samples[-alone.size:], alone, 1e-6)


def test_channel_change_raises_as_jax():
    """Stereo then mono: the native decode flushes at the change (flag 2);
    interleaved PCM has one channel count, so both packages refuse it."""
    from libnyquist_torch.errors import DecodeError

    data = make_l3_stream(33, 0.4, channels=2) + make_l3_stream(
        34, 0.4, channels=1)
    with pytest.raises(DecodeError):
        _port_audio(data)
    with pytest.raises(ValueError):
        _jax_audio(data)


def test_free_format_l3_raises():
    """Free-format Layer III, which the native stream decode hands back,
    decodes through the per-frame route: load() equals the JAX package
    within 1e-5 (the name is kept from when the port raised here)."""
    data = make_l3_stream(41, 0.5, free_format=True)
    got = _port_audio(data)
    ref = _jax_audio(data)
    assert (got.channel_count, got.sample_rate) == (ref.channel_count,
                                                    ref.sample_rate)
    assert got.sample_count == ref.sample_count > 0
    _close(got.samples, ref.samples, 1e-5)


def test_l3_stream_entropy_refuses_segmented_streams():
    from libnyquist_torch.errors import DecodeError
    from libnyquist_torch.formats import mp3 as P

    data = make_l3_stream(51, 0.3) + b"\x00" * 9 + make_l3_stream(52, 0.3)
    with pytest.raises(DecodeError):
        P.l3_stream_entropy(data)
