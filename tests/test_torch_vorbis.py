"""The port's Ogg Vorbis decoder against the JAX package, on the CPU.

Inputs are seeded floor-1 streams from tools/vorbis_stream.py (1-2 s) and
the floor-0 fixture. The host entropy is the same C on the same setup
parse: the staged spectra equal the JAX package's element for element.
load() runs the synthesis in float32 against the JAX package's float64
host loop: |d| <= 1e-4 * max(|ref|, 1), the gate of tests/test_vorbis.py.
The serving products are float32 on both sides: 1e-5 * max(|ref|, 1);
batched against single: 1e-6 * max(|ref|, 1).
"""

import pathlib

import numpy as np
import pytest

from tools.vorbis_stream import floor_values_legal, make_vorbis_stream, ogg_crc

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
GOLDEN = pathlib.Path(__file__).parent / "golden"


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _jax_load(data):
    import libnyquist_tpu as nq

    return nq.load(data, extension="ogg")


def _port_load(data):
    import libnyquist_torch as nqt

    return nqt.load(data, extension="ogg", device="cpu")


def _entropy(pkg, data):
    vorbis = pkg.formats.vorbis
    st = vorbis._collect_stream_native(data)
    if st is None:
        st = pkg.formats.ogg.first_stream_matching(
            pkg.formats.ogg.demux(data), b"\x01vorbis")
    if pkg.__name__ == "libnyquist_tpu":
        return vorbis._decode_stream_packets(st, return_entropy=True)
    return vorbis._decode_stream_packets(st)


def _packages():
    import libnyquist_torch.formats.vorbis  # noqa: F401
    import libnyquist_tpu.formats.vorbis  # noqa: F401
    import libnyquist_torch
    import libnyquist_tpu

    return libnyquist_tpu, libnyquist_torch


@pytest.mark.parametrize("channels", [1, 2])
def test_writer_streams_decode_through_jax_with_legal_floors(channels):
    """The writer's streams decode through the JAX package, and every
    floor Y the JAX package's Python floor decode reads reconstructs to
    [0, range) in step 2; the writer's own record of what it wrote agrees."""
    from libnyquist_tpu.formats import ogg, vorbis as jv

    data, posts = make_vorbis_stream(11 + channels, 1.5, channels=channels,
                                     return_posts=True)
    a = _jax_load(data)
    assert a.channel_count == channels and a.sample_count > 0
    st = ogg.first_stream_matching(ogg.demux(data, verify_crc=True),
                                   b"\x01vorbis")
    staged, _, _, _, _ = jv._decode_stream_packets(st, return_entropy=True)
    books, floors, _, mappings, modes = jv._SETUP_CACHE[
        (hash(st.packets[2].data), channels)]
    read = {0: [], 1: []}
    for pkt in st.packets[3:]:
        bits = jv.LsbBits(pkt.data)
        bits.read1()
        bf, mi = modes[bits.read(2)]
        if bf:
            bits.read(2)
        mp = mappings[mi]
        try:
            for c in range(channels):
                ys = floors[mp.submap_floor[mp.mux[c]]].decode(bits, books)
                if ys is not None:
                    read[bf].append(ys)
        except jv.EndOfPacket:
            pass
    for bf in (0, 1):
        fl = floors[bf]
        assert isinstance(fl, jv.Floor1)
        rng = fl.RANGES[fl.mult - 1]
        assert len(read[bf]) > 10
        assert floor_values_legal(fl.xlist, rng, np.asarray(read[bf]))
        assert floor_values_legal(fl.xlist, rng, posts[bf])
    # what the streams reach: both blocksizes, all three modes' window
    # transitions, unused floors beside used ones
    kinds = {(n, bf, lp, ln) for _, n, bf, lp, ln, _ in staged}
    assert {(256, 0, 1, 1), (2048, 1, 1, 0), (2048, 1, 0, 1)} <= {
        (n, int(bf), int(lp), int(ln)) for n, bf, lp, ln in kinds}
    if channels == 2:
        assert any(nz[0] != nz[1] for *_, nz in staged)


def test_writer_pages_carry_ogg_crcs():
    """Every page's CRC is the one the JAX package's Ogg module computes;
    its demux with CRC checks on reads the same packets as without."""
    from libnyquist_tpu.formats import ogg

    data = make_vorbis_stream(5, 1.0)
    pos = 0
    pages = 0
    while pos < len(data):
        assert data[pos : pos + 4] == b"OggS"
        nseg = data[pos + 26]
        size = 27 + nseg + sum(data[pos + 27 : pos + 27 + nseg])
        page = bytearray(data[pos : pos + size])
        crc = int.from_bytes(page[22:26], "little")
        page[22:26] = b"\0\0\0\0"
        assert crc == ogg._ogg_crc(bytes(page)) == ogg_crc(bytes(page))
        pos += size
        pages += 1
    assert pages > 3
    a = ogg.demux(data, verify_crc=True)
    b = ogg.demux(data)
    assert [p.data for s in a.values() for p in s.packets] == [
        p.data for s in b.values() for p in s.packets]


@pytest.mark.parametrize("channels", [1, 2, 9])
def test_host_entropy_equals_jax(channels):
    """The staged (specs, n, blockflag, long_prev, long_next, nonzero)
    tuples equal the JAX package's, element for element; more than 8
    channels takes the per-packet route in both."""
    jx, pt = _packages()
    data = make_vorbis_stream(20 + channels, 1.0, channels=channels)
    a, bss_a, ch_a, rate_a, end_a = _entropy(jx, data)
    b, bss_b, ch_b, rate_b, end_b = _entropy(pt, data)
    assert (bss_a, ch_a, rate_a, end_a) == (bss_b, ch_b, rate_b, end_b)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x[0].dtype == y[0].dtype
        assert np.array_equal(x[0], y[0])
        assert x[1:5] == y[1:5] and list(x[5]) == list(y[5])
    st = pt.formats.vorbis._collect_stream_native(data)
    key = (hash(st.packets[2].data), channels)
    ctx = pt.formats.vorbis._SETUP_CACHE[(key, "ctx")]
    assert (ctx is None) == (channels > 8)


@pytest.mark.parametrize("channels,seconds", [(1, 1.0), (2, 2.0)])
def test_load_matches_jax(channels, seconds):
    data = make_vorbis_stream(30 + channels, seconds, channels=channels)
    a = _jax_load(data)
    b = _port_load(data)
    assert (b.channel_count, b.sample_rate) == (a.channel_count,
                                                a.sample_rate)
    assert b.sample_count == a.sample_count
    _close(b.samples, a.samples, 1e-4)
    assert b.samples.dtype == np.float32


def test_load_cuts_at_the_end_granule():
    """The writer trims the last packet by its end granule; load() stops
    there, as the reference's ov_read_float does."""
    from libnyquist_torch.formats import vorbis

    data = make_vorbis_stream(41, 1.0)
    st = vorbis._collect_stream_native(data)
    staged, *_ = vorbis._decode_stream_packets(st)
    full = sum(p[1] // 4 + n // 4 for p, (_, n, *_r) in zip(staged, staged[1:]))
    b = _port_load(data)
    assert b.sample_count // 2 == st.last_granule < full


def test_more_than_8_channels_load():
    data = make_vorbis_stream(50, 0.5, channels=9)
    a = _jax_load(data)
    b = _port_load(data)
    assert b.channel_count == 9 and b.sample_count == a.sample_count
    _close(b.samples, a.samples, 1e-4)


def test_floor0_fixture_against_golden_and_jax():
    """The floor-0 fixture takes the per-packet route (Python LSP floor):
    1e-3 against its libvorbis golden (tests/test_vorbis.py:77), 1e-5 of
    the peak against the JAX package."""
    data = (FIXTURES / "floor0_mono8k.ogg").read_bytes()
    g = np.load(GOLDEN / "floor0_mono8k.npz")
    b = _port_load(data)
    assert (b.channel_count, b.sample_rate) == (1, 8000)
    assert b.sample_count == int(g["count"])
    assert np.abs(b.samples - g["full"]).max() < 1e-3
    a = _jax_load(data)
    peak = np.abs(a.samples).max()
    assert np.abs(b.samples - a.samples).max() <= 1e-5 * peak


def test_chained_links_concatenate():
    """Chained links decode link by link and concatenate
    (tests/test_vorbis.py:43); a later link with another channel count
    ends the decode there, as in the JAX package."""
    da = make_vorbis_stream(60, 0.7)
    db = make_vorbis_stream(61, 0.5, block_seed=3)
    a, b = _port_load(da), _port_load(db)
    ab = _port_load(da + db)
    assert ab.sample_count == a.sample_count + b.sample_count
    assert np.array_equal(ab.samples[: a.sample_count], a.samples)
    assert np.array_equal(ab.samples[a.sample_count :], b.samples)
    _close(ab.samples, _jax_load(da + db).samples, 1e-4)
    mono = make_vorbis_stream(62, 0.5, channels=1)
    am = _port_load(da + mono)
    assert am.channel_count == 2 and np.array_equal(am.samples, a.samples)
    assert _jax_load(da + mono).sample_count == am.sample_count


def test_id_header_blocksize_bounds():
    """vorbis_unpack_info bounds (info.c:217-219), as
    tests/test_vorbis.py:81: both blocksize exponents 2^15 raise."""
    import time

    from libnyquist_torch.errors import DecodeError

    data = bytearray((FIXTURES / "floor0_mono8k.ogg").read_bytes())
    data[56] = 0xFF
    t0 = time.monotonic()
    with pytest.raises(DecodeError):
        _port_load(bytes(data))
    assert time.monotonic() - t0 < 5.0
    stream = bytearray(make_vorbis_stream(63, 0.3))
    stream[56] = 0x6B          # bs0 2^11 > bs1 2^6
    with pytest.raises(DecodeError, match="blocksizes"):
        _port_load(bytes(stream))


def test_synthesize_vorbis_streams_matches_jax():
    """Uniform blocks on the shapes of tests/test_serving.py:119."""
    from libnyquist_torch.runtime import serving as ps
    from libnyquist_tpu.runtime import serving as js

    rng = np.random.default_rng(7)
    for R, F, n in ((3, 6, 256), (2, 5, 2048)):
        specs = rng.standard_normal((R, F, n // 2)).astype(np.float32)
        ref = np.asarray(js.synthesize_vorbis_streams(specs, n,
                                                      use_device=True))
        got = ps.synthesize_vorbis_streams(specs, n, device="cpu")
        assert got.shape == (R, (F - 1) * n // 2)
        _close(got.numpy(), ref, 1e-5)


def _padded(staged, channels, nmax2):
    specs = np.zeros((channels, len(staged), nmax2), np.float32)
    for f, (s, n, *_r) in enumerate(staged):
        specs[:, f, : n // 2] = s
    return specs


def test_lap_plan_and_mixed_synthesis_match_jax():
    """The lap plan equals the JAX package's; the mixed-block synthesis of
    a writer stream's staged spectra agrees with its float32 host path."""
    from libnyquist_torch.formats import vorbis as pv
    from libnyquist_torch.runtime import serving as ps
    from libnyquist_tpu.runtime import serving as js

    data = make_vorbis_stream(70, 1.5)
    staged, bss, ch, _, _ = pv._decode_stream_packets(
        pv._collect_stream_native(data))
    meta = [(n, bf, lp, ln) for (_s, n, bf, lp, ln, _nz) in staged]
    pa, pb = js.vorbis_lap_plan(meta, bss), ps.vorbis_lap_plan(meta, bss)
    for k in ("W", "idx_prev", "idx_cur"):
        assert np.array_equal(pa[k], pb[k]), k
    assert (pa["out_len"], pa["nmax"], list(pa["ns"])) == (
        pb["out_len"], pb["nmax"], list(pb["ns"]))
    specs = _padded(staged, ch, pb["nmax"] // 2)
    ref = np.asarray(js.synthesize_vorbis_streams_mixed(specs, pa,
                                                        use_device=False))
    got = ps.synthesize_vorbis_streams_mixed(specs, pb, device="cpu")
    _close(got.numpy(), ref, 1e-5)
    assert pv.staged_specs(staged, ch, pb["nmax"] // 2).shape == specs.shape


def test_mixed_batched_matches_single():
    """Streams of one block_seed share a lap plan: synthesized as one
    batch of [stream x channel] rows they equal each stream alone."""
    from libnyquist_torch.formats import vorbis as pv
    from libnyquist_torch.runtime import serving as ps

    rows, plan = [], None
    for seed in (80, 81, 82):
        staged, bss, ch, _, _ = pv._decode_stream_packets(
            pv._collect_stream_native(make_vorbis_stream(seed, 1.0,
                                                         block_seed=9)))
        meta = [(n, bf, lp, ln) for (_s, n, bf, lp, ln, _nz) in staged]
        p = ps.vorbis_lap_plan(meta, bss)
        if plan is None:
            plan = p
        assert np.array_equal(p["idx_cur"], plan["idx_cur"])
        rows.append(pv.staged_specs(staged, ch, plan["nmax"] // 2))
    batch = ps.synthesize_vorbis_streams_mixed(np.concatenate(rows), plan,
                                               device="cpu")
    scale = max(1.0, batch.abs().max().item())
    for k, r in enumerate(rows):
        one = ps.synthesize_vorbis_streams_mixed(r, plan, device="cpu")
        assert (one - batch[2 * k : 2 * k + 2]).abs().max().item() <= (
            1e-6 * scale)


def test_packet_entry_equals_stream_entry():
    """native/vorbis_res.c vorbis_packet_decode, called packet by packet
    through its binding, stages what the whole-stream entry staged."""
    import ctypes

    from libnyquist_torch.formats import vorbis as pv
    from libnyquist_torch.runtime import native

    data = make_vorbis_stream(90, 1.0)
    st = pv._collect_stream_native(data)
    staged, (bs0, bs1), ch, _, _ = pv._decode_stream_packets(st)
    ctx = pv._SETUP_CACHE[((hash(st.packets[2].data), ch), "ctx")]
    L = native.codec_lib()
    got = []
    for pkt in st.materialize()[3:]:
        specs = np.zeros(ch * bs1 // 2, np.float32)
        info = np.zeros(12, np.int32)
        rc = L.vorbis_packet_decode(
            pkt.data, len(pkt.data), *ctx["args"],
            specs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        assert rc in (0, 1)
        if rc:
            n2 = int(info[0]) // 2
            got.append((specs[: ch * n2].reshape(ch, n2), info.copy()))
    assert len(got) == len(staged)
    for (specs, info), (s, n, bf, lp, ln, nz) in zip(got, staged):
        assert np.array_equal(specs, s)
        assert list(info[:4]) == [n, bf, lp, ln]
        assert [bool(v) for v in info[4 : 4 + ch]] == nz
