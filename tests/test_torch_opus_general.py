"""The port's general Opus path (SILK, hybrid, mode switches, loss
concealment, lost pages, chained links, multistream) against libopus PCM
and the JAX package, on the CPU: the plain versions run, no kernel.

Content: the golden libopus packets (tests/golden/opus_packets.bin), the
reference's own SILK concealment (tests/golden/opus_plc.bin), the
repacketizer oracle, and Ogg files cut from the golden packets by
tools/opus_stream.py."""

import functools
import importlib.util
import pathlib
import struct

import numpy as np
import pytest
import torch

from libnyquist_torch.errors import NyquistError
from libnyquist_torch.formats.opus.decoder import OpusDecoder
from libnyquist_tpu.formats.opus.decoder import OpusDecoder as JOpusDecoder

from .test_opus_packets import CASES, HYBRID_CASES, SILK_CASES

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"


def _tool():
    spec = importlib.util.spec_from_file_location(
        "_tool_opus_stream", ROOT / "tools" / "opus_stream.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


os_ = _tool()


def _port(packets, ch):
    d = OpusDecoder(ch, device="cpu")
    for p in packets:
        d.push_packet(p)
    return d.flush().numpy(), d


def _jax(packets, ch):
    d = JOpusDecoder(ch)
    return np.concatenate([d.decode_packet(p) for p in packets], axis=0)


@pytest.mark.parametrize("idx", SILK_CASES + HYBRID_CASES)
def test_golden_case_matches_libopus_and_jax(idx):
    case = CASES[idx]
    got, _ = _port(case["packets"], case["ch"])
    assert got.dtype == np.float32 and got.shape[1] == case["ch"]
    assert got.size == case["pcm"].size
    assert np.abs(got.reshape(-1) - case["pcm"]).max() < 1e-4
    ref = _jax(case["packets"], case["ch"])
    if idx in SILK_CASES:       # the same native SILK: equal samples
        assert np.array_equal(got, ref.astype(np.float32))
    else:
        assert np.abs(got - ref).max() < 1e-4


def _plc_cases():
    blob = (GOLDEN / "opus_plc.bin").read_bytes()
    (n,) = struct.unpack_from("<i", blob, 0)
    p = 4
    out = []
    for _ in range(n):
        ci, ch, npk, _frame = struct.unpack_from("<4i", blob, p)
        p += 16
        lost = np.frombuffer(blob, np.uint8, npk, p)
        p += npk
        (total,) = struct.unpack_from("<q", blob, p)
        p += 8
        out.append((ci, ch, lost, np.frombuffer(blob, np.float32, total, p)))
        p += total * 4
    return out


@pytest.mark.parametrize("k", range(6))
def test_silk_concealment_is_the_reference_s(k):
    """The reference's own SILK concealment, bit for bit, concealed and
    recovery frames included (as tests/test_robustness.py holds the JAX
    package)."""
    ci, ch, lost, ref = _plc_cases()[k]
    pkts = CASES[ci]["packets"]
    got, _ = _port([None if lost[i] else pkts[i] for i in range(len(lost))],
                   ch)
    assert np.array_equal(got.reshape(-1), ref)


def _switching(lossy):
    seq = []
    for ci, n in ((9, 24), (12, 24), (0, 24), (9, 24), (12, 12), (0, 12),
                  (12, 12)):
        seq += list(CASES[ci]["packets"][:n])
    if lossy:   # losses in every mode, one a run of six CELT packets
        for i in (5, 30, 31, 55, 80, 100, 110):
            seq[i] = None
        for i in range(60, 66):
            seq[i] = None
    return seq


@pytest.mark.parametrize("lossy", [False, True])
def test_mode_switches_and_losses_match_jax(lossy):
    seq = _switching(lossy)
    ref = _jax(seq, 2)
    got, dec = _port(seq, 2)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-4
    # packet by packet (a flush per packet) gives the same samples
    d = OpusDecoder(2, device="cpu")
    each = np.concatenate([d.decode_packet(p).numpy() for p in seq])
    assert np.abs(each - ref).max() < 1e-4
    assert dec.stats["mixes"] < len(seq) // 4


def _load_both(data):
    import libnyquist_torch as nqt
    import libnyquist_tpu as nq

    got = nqt.load(data, extension="opus", device="cpu")
    ref = nq.load(data, extension="opus")
    assert got.channel_count == ref.channel_count
    assert got.samples.shape == ref.samples.shape
    return got, ref


@pytest.mark.parametrize("what", ["multistream", "lost pages",
                                  "lost packets", "chained"])
def test_ogg_general_path_matches_jax(what):
    cases = os_.read_cases()
    if what == "multistream":
        data = os_.make_opus_multistream(60, cases=cases)
    elif what == "lost pages":         # pages of one packet: the granule
        data, info = os_.make_opus_stream(2, 160, cases)   # jump sizes it
        assert info["lost_pages"]
    elif what == "lost packets":       # pages of ten packets
        data, info = os_.make_opus_stream(6, 220, cases)
        assert info["lost_pages"]
    else:
        data, info = os_.make_opus_stream(3, 160, cases)
        assert info["links"] == 2
    got, ref = _load_both(data)
    assert np.abs(got.samples - ref.samples).max() < 1e-4


@pytest.mark.parametrize("idx", [9, 12])
def test_case_file_load_matches_libopus(idx):
    import libnyquist_torch as nqt

    c = CASES[idx]
    got = nqt.load(os_.make_case_file(idx), extension="opus", device="cpu")
    ref = c["pcm"][os_.PRE_SKIP * c["ch"]:]
    assert got.samples.shape == ref.shape
    assert np.abs(got.samples - ref).max() < 1e-4


def test_loss_free_hybrid_flushes_once():
    """A loss-free hybrid stream synthesizes in one flush: the state
    machine needs no samples before its end."""
    c = CASES[12]
    _, dec = _port(c["packets"], c["ch"])
    assert dec.stats["flushes"] == 1 and dec.stats["mixes"] == 1
    assert dec.stats["segments"] < len(c["packets"]) // 2
    assert dec.stats["syncs"] == 0


FEC_LOST = 40


def _snr(ref, got):
    g = float((ref * got).sum() / max((got ** 2).sum(), 1e-12))
    err = ref - g * got
    return 10 * np.log10((ref ** 2).sum() / max((err ** 2).sum(), 1e-9))


@functools.lru_cache(maxsize=2)
def _fec_packets(ch):
    """Packets of the JAX SILK encoder with in-band FEC (LBRR), 1 s of
    the speech-like signal of tests/test_encoders.py."""
    from libnyquist_tpu.audio_data import AudioData, PCMFormat
    from libnyquist_tpu.encoders import EncoderParams, encode_opus_to_buffer
    from libnyquist_tpu.formats.ogg import demux

    from .test_encoders import _speechish

    sig = _speechish(seconds=1.0)
    if ch == 2:
        sig = np.stack([sig, np.roll(sig, 240) * 0.9], 1).reshape(-1)
    a = AudioData()
    a.samples, a.channel_count, a.sample_rate = sig, ch, 48000
    a.source_format = PCMFormat.PCM_FLT
    buf = encode_opus_to_buffer(EncoderParams(ch, PCMFormat.PCM_FLT), a,
                                mode="silk", fec=True)
    return tuple(q.data for q in next(iter(demux(buf).values())).packets[2:])


@pytest.mark.parametrize("ch", [1, 2])
def test_fec_names_its_roadmap_item(ch, monkeypatch):
    """In-band FEC, once a queue item: decode_packet(next, fec=True)
    recovers the dropped packet from next's LBRR frame on the stream's
    own SILK state. It equals the JAX package's Python-only SILK route
    (its own test holds that route to libopus decode_fec=1) bit for bit,
    recovers the lost frame above 12 dB, and the stream decodes on
    equal to that route. (The name is kept from when the port raised.)"""
    from libnyquist_tpu.formats.opus import silk as jsilk

    pkts = _fec_packets(ch)
    monkeypatch.setattr(jsilk, "_native_silk", lambda: None)
    clean = JOpusDecoder(ch).decode_packet
    clean = [clean(q) for q in pkts[: FEC_LOST + 1]][FEC_LOST]
    jd = JOpusDecoder(ch)
    pd = OpusDecoder(ch, device="cpu")
    for q in pkts[:FEC_LOST]:
        jd.decode_packet(q)
        pd.push_packet(q)
    pd.flush()
    ref = jd.decode_packet(pkts[FEC_LOST + 1], fec=True)
    got = pd.decode_packet(pkts[FEC_LOST + 1], fec=True).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == clean.shape
    assert np.array_equal(got, ref.astype(np.float32))
    assert _snr(clean, got) > 12.0
    for q in pkts[FEC_LOST + 1: FEC_LOST + 4]:
        assert np.array_equal(pd.decode_packet(q).numpy(),
                              jd.decode_packet(q).astype(np.float32))


@pytest.mark.parametrize("ch", [1, 2])
def test_fec_jax_default_route_starts_fresh(ch):
    """The JAX package's default route recovers on a fresh Python SILK
    decoder (its native plane's state is opaque to it), dropping the
    channel history; the port recovers on the stream's state, so it
    differs from that route and recovers the lost frame better (on this
    signal 18.7 / 16.7 dB against 11.1 / 12.7, mono / stereo)."""
    pkts = _fec_packets(ch)
    clean = JOpusDecoder(ch).decode_packet
    clean = [clean(q) for q in pkts[: FEC_LOST + 1]][FEC_LOST]
    jd = JOpusDecoder(ch)
    pd = OpusDecoder(ch, device="cpu")
    for q in pkts[:FEC_LOST]:
        jd.decode_packet(q)
        pd.push_packet(q)
    pd.flush()
    fresh = jd.decode_packet(pkts[FEC_LOST + 1], fec=True)
    got = pd.decode_packet(pkts[FEC_LOST + 1], fec=True).numpy()
    assert np.abs(got - fresh).max() > 0.01
    assert _snr(clean, got) > _snr(clean, fresh) + 3.0


def test_fec_typed_errors():
    """No next packet, a non-SILK packet and a packet without LBRR data
    raise DecodeError in both packages."""
    from libnyquist_torch.errors import DecodeError
    from libnyquist_tpu.errors import DecodeError as JDecodeError

    no_lbrr = CASES[8]["packets"][1]        # a libopus SILK packet
    for data in (None, CASES[0]["packets"][1], no_lbrr):
        with pytest.raises(DecodeError):
            OpusDecoder(1, device="cpu").decode_packet(data, fec=True)
    for data in (None, CASES[0]["packets"][1]):
        with pytest.raises(JDecodeError):
            JOpusDecoder(1).decode_packet(data, fec=True)


def test_decoder_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OpusDecoder(2)


# --------------------------------------------------------------------------
# the pieces: the lazy mix and the lane's host round trip
# --------------------------------------------------------------------------
def test_mix_composition_is_the_numpy_expression():
    from libnyquist_torch.runtime.opus_pipeline import HOST, Mix, \
        mix_on_device

    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((300, 2)), rng.standard_normal((300, 2))
    w = rng.random(40)
    m = Mix(200)
    m.add(Mix.of(HOST, 0, 180))                    # a[:180]
    m.add(Mix.of(HOST, 300, 200).scale(0.5))       # 0.5 * b[:200]
    m.weight(30, w)
    m.clear(150, 160)
    m.add(Mix.of(HOST, 20, 40).weight(0, 1.0 - w), 100)
    ref = np.zeros((200, 2))
    ref[:180] += a[:180]
    ref += 0.5 * b[:200]
    ref[30:70] *= w[:, None]
    ref[150:160] = 0.0
    ref[100:140] += (1.0 - w)[:, None] * a[20:60]
    got = mix_on_device([m.clip(0, 200), Mix.of(HOST, 5, 7)], [], [a, b],
                        2, "cpu").numpy()
    assert got.shape == (207, 2)
    assert np.abs(got[:200] - ref).max() < 1e-6
    assert np.abs(got[200:] - a[5:12]).max() < 1e-6


def test_lane_history_round_trip_keeps_the_synthesis():
    """Bringing a lane's state to the host and back (what pitch
    concealment does) leaves the following frames' samples as they
    were."""
    from libnyquist_torch.formats.opus import decode_celt_infos
    from libnyquist_torch.runtime.opus_pipeline import CeltLane, \
        PostfilterCarry, postfilter_step

    infos = decode_celt_infos(CASES[1]["packets"][:12], 2)
    outs = []
    for round_trip in (False, True):
        stats = dict(flushes=0, segments=0, syncs=0)
        lane = CeltLane(2, torch.device("cpu"), stats)
        carry = PostfilterCarry()
        for i, info in enumerate(infos):
            lane.push(dict(info), postfilter_step(carry, info))
            if i == 5 and round_trip:
                mem, pre = lane.history()
                lane.restore(mem, pre)
        lane.synthesize()
        outs.append(torch.cat([t for _, t in lane.done]).numpy())
    assert np.abs(outs[0] - outs[1]).max() < 1e-6


# --------------------------------------------------------------------------
# the repacketizer
# --------------------------------------------------------------------------
def _oracle():
    text = (GOLDEN / "repacketizer_oracle.txt").read_text()
    return dict(line.split(None, 1) for line in text.splitlines() if line)


@pytest.mark.parametrize("what", ["merge0", "merge3", "merge6", "merge9",
                                  "pad0", "range13"])
def test_repacketizer_matches_reference_and_jax(what):
    from libnyquist_torch.formats.opus import (Repacketizer, packet_pad,
                                               packet_unpad)
    from libnyquist_tpu.formats.opus import repacketizer as jrp

    pkts = CASES[0]["packets"][:24]
    oracle = _oracle()
    if what.startswith("merge"):
        g = int(what[5:])
        outs = []
        for R in (Repacketizer, jrp.Repacketizer):
            rp = R()
            for i in range(3):
                rp.cat(pkts[g + i])
            outs.append(rp.out())
    elif what == "pad0":
        outs = [packet_pad(pkts[0], len(pkts[0]) + 37),
                jrp.packet_pad(pkts[0], len(pkts[0]) + 37)]
        assert packet_unpad(outs[0]).hex() == oracle["unpad0"].strip()
    else:
        outs = []
        for R in (Repacketizer, jrp.Repacketizer):
            rp = R()
            for i in range(3):
                rp.cat(pkts[i])
            outs.append(rp.out(1, 3))
    assert outs[0] == outs[1]
    assert outs[0].hex() == oracle[what].strip()


# --------------------------------------------------------------------------
# malformed input
# --------------------------------------------------------------------------
def test_malformed_general_path_files():
    """Truncations and byte flips of general-path files: the port raises
    a NyquistError or decodes; where both packages decode, they agree
    within 1e-4 of max(|ref|, 1) (float32 against float64 on samples a
    corrupt energy blew up)."""
    import libnyquist_torch as nqt
    import libnyquist_tpu as nq

    cases = os_.read_cases()
    rng = np.random.default_rng(11)
    for data in (os_.make_opus_stream(1, 40, cases)[0],
                 os_.make_opus_multistream(30, cases=cases)):
        muts = [data[: int(len(data) * f)] for f in (0.2, 0.55, 0.9)]
        muts.append(data[:40])                  # inside the OpusHead page
        for at in (37, 46):                     # channels, mapping family
            b = bytearray(data)
            b[at] ^= 0x7F
            muts.append(bytes(b))
        for _ in range(3):
            b = bytearray(data)
            for pos in rng.integers(200, len(b), 3):
                b[pos] ^= int(rng.integers(1, 256))
            muts.append(bytes(b))
        for m in muts:
            try:
                got = nqt.load(m, extension="opus", device="cpu")
            except NyquistError:
                continue
            try:
                ref = nq.load(m, extension="opus")
            except Exception:
                continue
            assert got.samples.shape == ref.samples.shape
            if got.samples.size:    # corrupt energies reach |x| ~ 1e3
                scale = max(1.0, float(np.abs(ref.samples).max()))
                assert np.abs(got.samples - ref.samples).max() < 1e-4 * scale


def test_pipeline_imports_first():
    """runtime/opus_pipeline.py and the decoder import each other's
    packages: either may be imported first, in a fresh process."""
    import subprocess
    import sys

    for mod in ("libnyquist_torch.runtime.opus_pipeline",
                "libnyquist_torch.formats.opus.decoder"):
        proc = subprocess.run([sys.executable, "-c", f"import {mod}"],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
