"""The port's WavPack decoder against the JAX package, on the CPU.

Inputs: the six in-repo fixtures (hybrid and DSD, with libwavpack
goldens), streams of ``tools/wv_stream.py`` (structurally valid blocks
with seeded random entropy payloads: both packages must agree bit for
bit, which holds the copied C and the Python around it, not the words
against a spec-level oracle), and the native entries called directly on
seeded inputs, the port's library against the JAX package's.

The JAX package runs on its scalar decorrelation route here
(``LIBNYQUIST_NO_WV_SIMD``). Its eight-lane route, built with
``-march=native`` by gcc 12 on a host with AVX-512, leaves the weights of
the negative-term passes unmoved and so differs from its own scalar
passes; the port's copy of that C is repaired and equals the scalar
passes on every host (ROADMAP.md, faults). On streams without those
terms both JAX routes agree and the port equals either.
"""

import ctypes
import importlib.util
import pathlib
import struct
import types

import numpy as np
import pytest
import torch

import libnyquist_torch as nqt
import libnyquist_tpu as nq
from libnyquist_torch.errors import DecodeError
from libnyquist_torch.formats import wavpack as pwv
from libnyquist_torch.ops import lossless
from libnyquist_torch.runtime import native as pnative
from libnyquist_tpu.errors import DecodeError as JDecodeError
from libnyquist_tpu.formats import wavpack as jwv
from libnyquist_tpu.runtime import native as jnative

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
GOLDEN = ROOT / "tests" / "golden"
FIXTURE_NAMES = ["hybrid_mono", "hybrid_shape", "hybrid_stereo",
                 "dsd_fast", "dsd_high", "dsd_raw"]
I32P = ctypes.POINTER(ctypes.c_int32)
U32P = ctypes.POINTER(ctypes.c_uint32)
U8P = ctypes.POINTER(ctypes.c_uint8)
VPP = ctypes.POINTER(ctypes.c_void_p)
ENTRIES = ("wv_words_lossless", "wv_words_hybrid", "wv_decorr_mono",
           "wv_decorr_stereo", "wv_decode_block", "wv_float_values",
           "wv_float_nowvx", "wv_decorr_simd8", "wv_dsd_decode")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ws = _tool("wv_stream")


def _same(a, b):
    assert a.samples.dtype == b.samples.dtype == np.float32
    assert a.samples.shape == b.samples.shape
    assert np.array_equal(a.samples.view(np.int32), b.samples.view(np.int32))
    assert a.sample_rate == b.sample_rate
    assert a.channel_count == b.channel_count
    assert a.source_format.name == b.source_format.name
    assert a.sample_count == b.sample_count
    assert a.length_seconds == pytest.approx(b.length_seconds, rel=1e-12)


@pytest.fixture(autouse=True)
def _jax_scalar_route(monkeypatch):
    monkeypatch.setenv("LIBNYQUIST_NO_WV_SIMD", "1")


def _both(data):
    return nqt.load(data, extension="wv", device="cpu"), nq.load(
        data, extension="wv")


@pytest.fixture(scope="module")
def libs():
    """(port library, the JAX package's library re-bound with the port's
    full argtypes on a handle of its own)."""
    P = pnative.codec_lib()
    J = ctypes.CDLL(jnative.lib()._name)
    for name in ENTRIES:
        src, dst = getattr(P, name), getattr(J, name)
        dst.argtypes, dst.restype = src.argtypes, src.restype
    return P, J


def _ptr(a, t=I32P):
    return a.ctypes.data_as(t)


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_against_golden_and_jax(name):
    path = str(FIXTURES / f"{name}.wv")
    got, ref = nqt.load(path, device="cpu"), nq.load(path)
    _same(got, ref)
    g = np.load(GOLDEN / f"{name}_wv.npz")
    assert got.sample_count == int(g["count"])
    assert got.channel_count == int(g["channels"])
    assert got.sample_rate == int(g["rate"])
    assert np.array_equal(got.samples, g["full"])


# --------------------------------------------------------------------------
# writer streams
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", list(ws.KINDS))
def test_writer_block_kinds(kind):
    data = ws.make_wv_stream(len(kind), 1.2, kind, block_samples=6000)
    got, ref = _both(data)
    _same(got, ref)
    spec = ws.KINDS[kind]
    assert got.channel_count == (1 if spec["mode"] == "mono" else 2)
    assert got.sample_count == int(round(1.2 * 44100)) * got.channel_count


@pytest.mark.parametrize("variant", [
    "total unknown", "total short", "no lead block", "custom rate",
    "small blocks", "three blocks", "48 kHz"])
def test_writer_stream_variants(variant):
    kw = {"total unknown": dict(total=None),
          "total short": dict(total=12345),
          "no lead block": dict(lead_block=False),
          "custom rate": dict(rate=37800),
          "small blocks": dict(block_samples=997),
          "three blocks": dict(block_samples=20000),
          "48 kHz": dict(rate=48000)}[variant]
    data = ws.make_wv_stream(7, 1.0, "int16_joint", **kw)
    got, ref = _both(data)
    _same(got, ref)
    if variant == "total short":
        assert got.sample_count == 2 * 12345
    if variant == "custom rate":
        assert got.sample_rate == 44100        # index 15 reads as 44.1 kHz


def test_mixed_float_and_integer_blocks():
    """A float stream followed by an integer one: the first block sets
    the stream's type, each block normalizes by its own FLOAT_INFO."""
    data = ws.make_wv_stream(1, 0.5, "float32", block_samples=5000) \
        + ws.make_wv_stream(2, 0.5, "int16", block_samples=5000)
    _same(*_both(data))
    data = ws.make_wv_stream(2, 0.5, "int16", block_samples=5000) \
        + ws.make_wv_stream(3, 0.5, "float32_wvx", block_samples=5000)
    _same(*_both(data))


def _dsd_block_at(data):
    """Offset of the DSD metadata body (its power byte) in the first
    block that holds samples."""
    pos = 0
    while True:
        pos = data.index(b"wvpk", pos)
        cksize, = struct.unpack_from("<I", data, pos + 4)
        if struct.unpack_from("<I", data, pos + 20)[0]:
            break
        pos += 8 + cksize
    p = pos + 32
    while True:
        mid, length = data[p], data[p + 1] << 1
        head = 2
        if mid & pwv.ID_LARGE:
            length += (data[p + 2] << 9) + (data[p + 3] << 17)
            head = 4
        if mid & 0x3F == pwv.ID_DSD_BLOCK:
            return p + head
        p += head + length


def _first_block_at(data):
    return data.index(b"wvpk", 1)          # past the metadata-only block


@pytest.mark.parametrize("what", ["megasample block", "multichannel",
                                  "mixed DSD and PCM", "no blocks",
                                  "words run out", "DSD power"])
def test_malformed_streams_raise_decode_error(what, monkeypatch):
    if what == "words run out":
        monkeypatch.setattr(ws, "WORD_BITS", 1)
    data = bytearray(ws.make_wv_stream(5, 0.3, "int16", block_samples=4000))
    at = _first_block_at(bytes(data))
    if what == "megasample block":
        struct.pack_into("<I", data, at + 20, (1 << 20) + 1)
    elif what == "multichannel":
        flags = struct.unpack_from("<I", data, at + 24)[0]
        struct.pack_into("<I", data, at + 24, flags & ~ws.FINAL_BLOCK)
    elif what == "mixed DSD and PCM":
        data += (FIXTURES / "dsd_raw.wv").read_bytes()
    elif what == "no blocks":
        data = bytearray(b"not wavpack data at all" * 4)
    elif what == "DSD power":
        data = bytearray((FIXTURES / "dsd_fast.wv").read_bytes())
        data[_dsd_block_at(bytes(data))] = 15
    with pytest.raises(DecodeError):
        nqt.load(bytes(data), extension="wv", device="cpu")
    with pytest.raises(JDecodeError):
        nq.load(bytes(data), extension="wv")


# --------------------------------------------------------------------------
# the cross-block SIMD passes and their scalar route
# --------------------------------------------------------------------------
class _NoSimd:
    """The codec library with wv_decorr_simd8 declining, as on a CPU
    without AVX2."""

    def __init__(self, lib):
        self._lib = lib
        self.declined = 0

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def wv_decorr_simd8(self, *args):
        self.declined += 1
        return 0


@pytest.mark.parametrize("kind", ["int16_joint", "int24_mono", "hybrid",
                                  "float32_wvx", "false_stereo"])
def test_simd_declined_runs_the_scalar_passes(kind, monkeypatch):
    data = ws.make_wv_stream(30, 1.5, kind, block_samples=3000)
    want = nqt.load(data, extension="wv", device="cpu")
    proxy = _NoSimd(pnative.codec_lib())
    monkeypatch.setattr(pnative, "codec_lib", lambda: proxy)
    got = nqt.load(data, extension="wv", device="cpu")
    assert proxy.declined > 0
    _same(got, want)


def test_fused_and_grouped_routes_agree():
    """Fewer than four blocks take the fused call per block; more take
    the words per block and the passes in lanes: the same values."""
    data = ws.make_wv_stream(31, 1.5, "int16_joint", block_samples=3000)
    _, chunks = pwv.read_blocks(data)
    grouped = pwv.decode_pcm_blocks(chunks)
    _, chunks = pwv.read_blocks(data)
    fused = [b.decode() for b in chunks]
    assert len(grouped) == len(fused) >= 8
    for g, f in zip(grouped, fused):
        assert np.array_equal(g, f)


@pytest.mark.parametrize("pool", ["all", "positive"])
@pytest.mark.parametrize("mono,joint", [(0, 0), (0, 1), (1, 0)])
def test_simd8_lanes_equal_scalar_passes(libs, mono, joint, pool):
    """Eight lanes of one term sequence through wv_decorr_simd8 equal each
    lane through the scalar passes (and the joint-stereo undo), in both
    libraries' scalar entries, values that wrap int32 included. The JAX
    package's lanes are held where they are right on every host: terms 1
    to 8 and 17, and 18 in stereo."""
    P, J = libs
    rng = np.random.default_rng(8 + mono * 2 + joint + 5 * (pool == "all"))
    terms_pool = (ws.MONO_TERMS if mono else ws.STEREO_TERMS)
    if pool == "positive":
        terms_pool = [t for t in terms_pool if t > 0 and (t != 18 or not mono)]
    terms = rng.choice(terms_pool, 12).astype(np.int32)
    n = 1500
    nch = 1 if mono else 2
    res = rng.integers(-30000, 30000, (8, n * nch)).astype(np.int32)
    deltas = rng.integers(0, 8, (12, 8)).astype(np.int32)
    weights = rng.integers(-1024, 1025, (12, 2, 8)).astype(np.int32)
    sa = rng.integers(-5000, 5000, (12, 8, 8)).astype(np.int32)
    sb = rng.integers(-5000, 5000, (12, 8, 8)).astype(np.int32)
    for S in (P, J):
        want = res.copy()
        for ln in range(8):
            for p in range(12):
                w = np.ascontiguousarray(weights[p, :, ln])
                a = np.ascontiguousarray(sa[p, :, ln])
                b = np.ascontiguousarray(sb[p, :, ln])
                if mono:
                    S.wv_decorr_mono(int(terms[p]), int(deltas[p, ln]),
                                     _ptr(w), _ptr(a), _ptr(want[ln]), n)
                else:
                    S.wv_decorr_stereo(int(terms[p]), int(deltas[p, ln]),
                                       _ptr(w), _ptr(a), _ptr(b),
                                       _ptr(want[ln]), n)
            if joint:
                left, right = want[ln, 0::2], want[ln, 1::2]
                right -= left >> 1
                left += right
        for L in (P, J) if pool == "positive" else (P,):
            lanes = res.copy()
            addr = np.array([lanes[i].ctypes.data for i in range(8)],
                            np.uint64)
            rc = L.wv_decorr_simd8(12, _ptr(terms), _ptr(deltas),
                                   _ptr(weights.copy()), _ptr(sa.copy()),
                                   _ptr(sb.copy()), _ptr(addr, VPP), n,
                                   mono, joint)
            if not rc:
                pytest.skip("the CPU lacks AVX2: the lanes decline")
            assert np.array_equal(lanes, want)


@pytest.mark.parametrize("kind", ["int16_joint", "int24_mono", "hybrid",
                                  "float32_wvx"])
def test_jax_default_route_on_positive_terms(kind, monkeypatch):
    """With terms 1 to 8 and 17 only, the JAX package's eight-lane route
    is its scalar one on every host: the port equals its default load()."""
    monkeypatch.delenv("LIBNYQUIST_NO_WV_SIMD")
    data = ws.make_wv_stream(60, 1.0, kind, block_samples=2500,
                             terms=(1, 2, 3, 4, 5, 6, 7, 8, 17))
    _same(*_both(data))


# --------------------------------------------------------------------------
# native entries: the port's library against the JAX package's
# --------------------------------------------------------------------------
def _call_both(libs, name, make_args, outs):
    """Call entry ``name`` in both libraries on fresh copies of the same
    arrays; the return values and every array in ``outs`` must agree."""
    res = []
    for L in libs:
        arrays = {k: v.copy() for k, v in outs.items()}
        ret = getattr(L, name)(*make_args(arrays))
        res.append((ret, arrays))
    (r0, a0), (r1, a1) = res
    assert r0 == r1
    for k in outs:
        assert np.array_equal(a0[k], a1[k]), k
    return r0, a0


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mono", [0, 1])
def test_entry_words_lossless(libs, seed, mono):
    rng = np.random.default_rng(seed)
    buf = rng.bytes(6000) + b"\xff" * 8
    outs = {"out": np.zeros(4000, np.int32),
            "med": rng.integers(0, 1 << (seed * 4 + 2), 6).astype(np.uint32),
            "st": np.array([seed & 1, seed >> 1 & 1, seed, 0], np.uint32)}
    _call_both(libs, "wv_words_lossless", lambda a: (
        buf, 6000 * 8 - seed * 3, seed * 5, _ptr(a["out"]), 4000,
        _ptr(a["med"], U32P), _ptr(a["st"], U32P), mono), outs)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("flg", [0, 1, 2, 3, 4, 5])
def test_entry_words_hybrid(libs, seed, flg):
    rng = np.random.default_rng(seed * 8 + flg)
    buf = rng.bytes(5000) + b"\xff" * 8
    outs = {"out": np.zeros(3000, np.int32),
            "med": rng.integers(0, 4000, 6).astype(np.uint32),
            "st": np.array([0, 0, 0, 0], np.uint32),
            "hs": np.array([rng.integers(0, 3000), rng.integers(0, 3000),
                            rng.integers(0, 1 << 28), rng.integers(0, 1 << 28),
                            rng.integers(-2000, 2000),
                            rng.integers(-2000, 2000)], np.int32)}
    _call_both(libs, "wv_words_hybrid", lambda a: (
        buf, 5000 * 8, seed, _ptr(a["out"]), 3000, _ptr(a["med"], U32P),
        _ptr(a["st"], U32P), _ptr(a["hs"]), flg), outs)


@pytest.mark.parametrize("term", [1, 2, 5, 8, 17, 18, -1, -2, -3])
def test_entry_decorr_passes(libs, term):
    rng = np.random.default_rng(abs(term) * 3 + (term < 0))
    n = 900
    for mono in ((0, 1) if term > 0 else (0,)):
        outs = {"w": rng.integers(-1100, 1100, 2).astype(np.int32),
                "a": rng.integers(-1 << 20, 1 << 20, 8).astype(np.int32),
                "b": rng.integers(-1 << 20, 1 << 20, 8).astype(np.int32),
                "buf": rng.integers(-1 << 24, 1 << 24,
                                    n * (2 - mono)).astype(np.int32)}
        delta = int(rng.integers(0, 8))
        if mono:
            _call_both(libs, "wv_decorr_mono", lambda a: (
                term, delta, _ptr(a["w"]), _ptr(a["a"]), _ptr(a["buf"]), n),
                outs)
        else:
            _call_both(libs, "wv_decorr_stereo", lambda a: (
                term, delta, _ptr(a["w"]), _ptr(a["a"]), _ptr(a["b"]),
                _ptr(a["buf"]), n), outs)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mono,joint,hybrid", [(0, 1, 0), (0, 0, 1),
                                               (1, 0, 0), (1, 0, 1)])
def test_entry_decode_block(libs, seed, mono, joint, hybrid):
    rng = np.random.default_rng(seed * 16 + mono * 4 + joint * 2 + hybrid)
    n = 1500
    nv = n * (2 - mono)
    payload = ws._payload(rng, nv * 4) + b"\xff" * 8
    terms = rng.choice(ws.MONO_TERMS if mono else ws.STEREO_TERMS,
                       6).astype(np.int32)
    deltas = rng.integers(0, 8, 6).astype(np.int32)
    outs = {"out": np.zeros(nv, np.int32),
            "med": rng.integers(2, 3000, 6).astype(np.uint32),
            "st": np.zeros(4, np.uint32),
            "hyb": np.array([0, 0, 1 << 16, 1 << 16, 0, 0], np.int32),
            "w": rng.integers(-1024, 1025, (6, 2)).astype(np.int32),
            "sa": rng.integers(-3000, 3000, (6, 8)).astype(np.int32),
            "sb": rng.integers(-3000, 3000, (6, 8)).astype(np.int32)}
    _, got = _call_both(libs, "wv_decode_block", lambda a: (
        payload, (len(payload) - 8) * 8, _ptr(a["out"]), nv,
        _ptr(a["med"], U32P), _ptr(a["st"], U32P), _ptr(a["hyb"]),
        4 * mono, hybrid, 6, _ptr(terms), _ptr(deltas), _ptr(a["w"]),
        _ptr(a["sa"]), _ptr(a["sb"]), mono, joint, n), outs)
    assert got["st"][3] == nv


@pytest.mark.parametrize("flags", [0, 1, 2, 4, 8, 0x18, 0x1F])
@pytest.mark.parametrize("max_exp", [0, 24, 25, 126, 127])
def test_entry_float_restores(libs, flags, max_exp):
    rng = np.random.default_rng(flags * 256 + max_exp)
    n = 2000
    vals = rng.integers(-(1 << 24), 1 << 24, n).astype(np.int32)
    vals[::7] = 0
    vals[1::13] = 1 << 24
    vals[2::13] = -(1 << 24)
    vals[3::11] = rng.integers(-300, 300, len(vals[3::11]))
    shift = int(rng.integers(0, 6))
    wvx = rng.bytes(n * 5) + b"\0" * 8
    _call_both(libs, "wv_float_values", lambda a: (
        _ptr(a["v"]), n, wvx, (len(wvx) - 8) * 8, flags, shift, max_exp,
        _ptr(a["out"], U32P)), {"v": vals, "out": np.zeros(n, np.uint32)})
    small = vals >> 3
    _call_both(libs, "wv_float_nowvx", lambda a: (
        _ptr(a["v"]), n, flags, shift, max_exp, _ptr(a["out"], U32P)),
        {"v": small, "out": np.zeros(n, np.uint32)})


def _dsd_payloads():
    """(mode, stereo, frames, payload) of every DSD block of the three
    fixtures."""
    out = []
    for name in ("dsd_fast", "dsd_high", "dsd_raw"):
        data = (FIXTURES / f"{name}.wv").read_bytes()
        pos = 0
        while (pos := data.find(b"wvpk", pos)) >= 0:
            cksize, = struct.unpack_from("<I", data, pos + 4)
            count, flags = struct.unpack_from("<II", data, pos + 20)
            body = data[pos + 32 : pos + 8 + cksize]
            for mid, blob in pwv._metadata(body):
                if mid == pwv.ID_DSD_BLOCK and count:
                    out.append((blob[1], int(not flags & pwv.MONO_DATA),
                                count, blob[2:]))
            pos += 8 + cksize
    return out


def test_entry_dsd_decode(libs):
    rng = np.random.default_rng(0)
    cases = _dsd_payloads()
    assert {c[0] for c in cases} == {0, 1, 3}
    for mode, stereo, count, payload in list(cases):
        bad = bytearray(payload)
        for _ in range(6):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        cases.append((mode, stereo, count, bytes(bad)))
        cases.append((mode, stereo, count, payload[: len(payload) // 2]))
    for mode, stereo, count, payload in cases:
        _call_both(libs, "wv_dsd_decode", lambda a: (
            payload, len(payload), mode, stereo, count, _ptr(a["out"], U8P)),
            {"out": np.zeros(count * (1 + stereo), np.uint8)})


# --------------------------------------------------------------------------
# the device tail against the JAX package's NumPy
# --------------------------------------------------------------------------
def _float_bits(rng, n):
    bits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    exps = np.array([0, 1, 2, 50, 100, 126, 127, 128, 200, 253, 254, 255],
                    np.uint32)
    pick = rng.integers(0, exps.size, n)
    return (bits & np.uint32(0x807FFFFF)) | (exps[pick] << 23)


@pytest.mark.parametrize("norm_exp", [0, 1, 50, 100, 126, 127, 128, 200,
                                      254, 255])
def test_normalize_float_bits(norm_exp):
    bits = _float_bits(np.random.default_rng(norm_exp), 5000)
    ref = jwv._Block._normalize_float_bits(
        types.SimpleNamespace(float_norm_exp=norm_exp), bits.copy())
    t = torch.from_numpy(bits.view(np.int32).copy())
    got = lossless.normalize_float_bits(t, norm_exp).numpy()
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    per = lossless.normalize_float_bits(
        t, torch.full_like(t, norm_exp)).numpy()
    assert np.array_equal(per.view(np.int32), ref.view(np.int32))


def test_normalize_float_bits_per_block():
    """One norm exponent a block, as a stream of mixed blocks gives."""
    rng = np.random.default_rng(3)
    parts, norms = [], []
    for ne in (127, 100, 150, 127, 1):
        b = _float_bits(rng, 700)
        parts.append(jwv._Block._normalize_float_bits(
            types.SimpleNamespace(float_norm_exp=ne), b.copy()))
        norms.append((b, ne))
    t = torch.from_numpy(np.concatenate([b for b, _ in norms]).view(np.int32))
    ne = torch.from_numpy(np.repeat([n for _, n in norms], 700).astype(
        np.int32))
    got = lossless.normalize_float_bits(t, ne).numpy()
    assert np.array_equal(got.view(np.int32),
                          np.concatenate(parts).view(np.int32))


@pytest.mark.parametrize("channels", [1, 2])
def test_dsd_decimate(channels):
    rng = np.random.default_rng(channels)
    dsd = rng.integers(0, 256, (4099, channels), dtype=np.uint8)
    dsd[:40] = 0x55
    dsd[40:80] = 0xFF
    ref_i = np.stack([jwv._dsd_decimate(dsd[:, c]) for c in range(channels)],
                     1)
    got_i = lossless.dsd_decimate_int(torch.from_numpy(dsd)).numpy()
    assert np.array_equal(got_i, ref_i)
    ref = (ref_i.astype(np.float32) * np.float32(1.0 / (1 << 23)))
    got = lossless.dsd_decimate(torch.from_numpy(dsd)).numpy()
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def test_dsd_table_is_the_reference_filter():
    jwv._dsd_decimate(np.zeros(8, np.uint8))            # builds its table
    assert np.array_equal(lossless.dsd_table(), jwv._DSD_LUT)
    assert lossless.DSD_DECM_FILTER == jwv._DSD_DECM_FILTER
