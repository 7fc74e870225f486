"""The port's load() dispatch and facade against the JAX package's, on
the CPU: an explicit extension is taken at its word unless it is ogg, oga
or opus (then the first Ogg page decides, so an .ogg holding FLAC reaches
Ogg FLAC), the same extensions are registered, and the same names and
errors are exported."""

import importlib.util
import pathlib

import numpy as np
import pytest

import libnyquist_torch as nqt
import libnyquist_tpu as nq

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
KITTY = FIXTURES / "kitty8_dithered.oga"


def _vorbis_stream():
    spec = importlib.util.spec_from_file_location(
        "_tool_vorbis_stream", ROOT / "tools" / "vorbis_stream.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_vorbis_stream(3, 0.3)


def _raises_in_both(data, ext, name):
    with pytest.raises(getattr(nqt, name)):
        nqt.load(data, extension=ext, device="cpu")
    with pytest.raises(getattr(nq, name)):
        nq.load(data, extension=ext)


def test_explicit_extension_is_honoured():
    """An Ogg container under a non-Ogg extension goes to that extension's
    decoder, which rejects it, in both packages."""
    _raises_in_both((FIXTURES / "ms8ch.opus").read_bytes(), "wav",
                    "DecodeError")
    _raises_in_both(_vorbis_stream(), "mp3", "DecodeError")
    _raises_in_both(KITTY.read_bytes(), "wv", "DecodeError")


def test_vorbis_is_no_extension():
    _raises_in_both(_vorbis_stream(), "vorbis", "UnsupportedExtensionError")
    _raises_in_both(b"\0" * 64, None, "UnsupportedExtensionError")


@pytest.mark.parametrize("ext", ["ogg", "oga", "opus", None])
def test_ogg_extensions_defer_to_the_first_page(ext):
    """Under ogg, oga, opus or none, the Ogg FLAC fixture decodes as Ogg
    FLAC and a Vorbis stream as Vorbis, in both packages."""
    g = np.load(ROOT / "tests" / "golden" /
                "KittyPurr8_Stereo_Dithered_flac.npz")
    got = nqt.load(KITTY.read_bytes(), extension=ext, device="cpu")
    ref = nq.load(KITTY.read_bytes(), extension=ext)
    assert np.array_equal(got.samples, g["full"])
    assert np.array_equal(ref.samples, g["full"])
    data = _vorbis_stream()
    got = nqt.load(data, extension=ext, device="cpu")
    ref = nq.load(data, extension=ext)
    assert got.sample_count == ref.sample_count > 0
    assert np.abs(got.samples - ref.samples).max() < 1e-4


def test_ogg_flac_by_path_and_by_magic_bytes():
    g = np.load(ROOT / "tests" / "golden" /
                "KittyPurr8_Stereo_Dithered_flac.npz")
    for got in (nqt.load(str(KITTY), device="cpu"),
                nqt.load(KITTY.read_bytes(), device="cpu"),
                nqt.load(str(KITTY), extension="ogg", device="cpu")):
        assert np.array_equal(got.samples, g["full"])


@pytest.mark.parametrize("path", [
    "a.wav", "a.WAVE", "b.ambix", "c.aiff", "c.aif", "c.aifc", "d.caf",
    "e.flac", "f.oggflac", "g.mp3", "h.ogg", "h.oga", "i.opus", "j.wv",
    "k.mpc", "l.vorbis", "m.m4a", "noext", "dir.d/x", "x.FLAC"])
def test_is_file_supported_and_extension_parsing(path):
    from libnyquist_torch.io import parse_path_for_extension
    from libnyquist_tpu.io import parse_path_for_extension as jparse

    assert parse_path_for_extension(path) == jparse(path)
    assert nqt.is_file_supported(path) == nq.is_file_supported(path)


def test_nyquist_io_and_exports():
    got = nqt.NyquistIO().load(str(KITTY), device="cpu")
    assert np.array_equal(got.samples, nqt.load(str(KITTY),
                                                device="cpu").samples)
    # every export of the JAX package is in the port but the modules not
    # ported yet (streaming, URL loading, resampling: ROADMAP.md)
    later = {"StreamReader", "OggSeekReader", "ChainedOggSeekReader",
             "Mp3SeekReader", "FlacSeekReader", "seek_reader", "open_url",
             "load_url", "resample"}
    assert set(nqt.__all__) == set(nq.__all__) - later
    for name in ("NyquistError", "DecodeError", "TruncatedDataError",
                 "UnsupportedExtensionError", "LoadPathNotImplementedError",
                 "LoadBufferNotImplementedError"):
        mine, theirs = getattr(nqt, name), getattr(nq, name)
        assert [c.__name__ for c in mine.__mro__] == [
            c.__name__ for c in theirs.__mro__]
