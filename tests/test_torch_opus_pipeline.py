"""The port's segment pipeline and load() against libopus PCM, the
reference-oracle golden and the JAX package (all on the CPU)."""

import pathlib

import numpy as np
import pytest

from .helpers import assert_matches_golden
from .test_opus_pipeline import read_case

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


# The contract of tests/test_opus_pipeline.py: case 1 has transients,
# case 0 is steady, case 3 is 10 ms; case 2 adds mono and case 5 2.5 ms
# (LM = 0) frames.
@pytest.mark.parametrize("idx", [0, 1, 2, 3, 5])
def test_synthesize_stream_matches_libopus(idx):
    from libnyquist_torch.formats.opus import decode_celt_packets

    ch, _, pkts, ref = read_case(idx)
    out = decode_celt_packets(pkts[:40], ch, device="cpu").numpy()
    assert out.shape[1] == ch and out.dtype == np.float32
    err = np.abs(out.reshape(-1) - ref[: out.size]).max()
    assert err < 1e-4, f"pipeline err {err}"


def test_batched_streams_match_single():
    from libnyquist_torch.formats.opus import decode_celt_infos
    from libnyquist_torch.runtime import opus_pipeline, serving

    ch, _, pkts, _ = read_case(1)
    infos = decode_celt_infos(pkts[:40], ch)
    # full, full and a truncated stream (exercises the inert padding)
    streams = [infos, infos, infos[:17]]
    batched = serving.synthesize_streams(streams, ch, device="cpu")
    for s, got in zip(streams, batched):
        ref = opus_pipeline.synthesize_stream(list(s), ch, device="cpu")
        assert got.shape == ref.shape
        assert (got - ref).abs().max() < 1e-6


def test_batched_signature_mismatch_raises():
    from libnyquist_torch.formats.opus import decode_celt_infos
    from libnyquist_torch.runtime import serving

    ch, _, pkts, _ = read_case(0)
    infos = decode_celt_infos(pkts[:4], ch)
    a, b = list(infos), list(infos)
    b[1] = dict(b[1], LM=b[1]["LM"] - 1)
    with pytest.raises(ValueError):
        serving.synthesize_streams([a, b], ch, device="cpu")


def test_segment_with_carried_state_matches_jax():
    """Both packages start a segment from the same numpy state (through
    SynthState.from_numpy) and must agree on PCM and on the carries."""
    from libnyquist_tpu.runtime import opus_pipeline as jpipe
    from libnyquist_torch.formats.opus import decode_celt_infos
    from libnyquist_torch.runtime import opus_pipeline

    ch, _, pkts, _ = read_case(0)
    infos = decode_celt_infos(pkts[:12], ch)   # one (LM, shortBlocks) run
    key = (infos[0]["LM"], infos[0]["shortBlocks"])
    seg = infos[: next((j for j, i in enumerate(infos)
                        if (i["LM"], i["shortBlocks"]) != key), len(infos))]
    fparams = opus_pipeline.postfilter_frame_params(seg)
    rng = np.random.default_rng(11)
    tails = (rng.standard_normal((ch, 120)) * 100).astype(np.float32)
    hist = (rng.standard_normal((ch, 1026)) * 100).astype(np.float32)
    mem = (rng.standard_normal(ch) * 100).astype(np.float32)

    jst = jpipe.SynthState(channels=ch, imdct_tail=list(tails),
                           comb_hist=hist.copy(), deemph_mem=mem.copy())
    ref = jpipe.synthesize_segment(seg, jst, fparams)
    st = opus_pipeline.SynthState.from_numpy(tails, hist, mem, "cpu")
    got = opus_pipeline.synthesize_segment(seg, st, fparams)
    assert np.abs(got.numpy() - ref).max() <= 1e-5

    def close(a, b):     # carries in CELT_SIG_SCALE units
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * max(1.0, np.abs(b).max())

    close(st.comb_hist, jst.comb_hist)
    close(st.deemph_mem, jst.deemph_mem)
    for c in range(ch):
        close(st.imdct_tail[c], jst.imdct_tail[c])


def test_load_ms8ch_matches_golden():
    """8-channel family-1 Ogg Opus (4 coupled CELT streams) through
    load() on the CPU, against the reference-oracle decode."""
    import libnyquist_torch as nqt

    audio = nqt.load(str(FIXTURES / "ms8ch.opus"), device="cpu")
    assert audio.channel_count == 8 and audio.sample_rate == 48000
    assert_matches_golden(audio, "ms8ch", tol=1e-4)


@pytest.mark.parametrize("family", [0, 1])
def test_load_single_stream_matches_jax_and_libopus(tmp_path, family):
    """A single-stream Ogg Opus file muxed from case 1's packets: mapping
    family 0 goes through the native-scan route, family 1 (one coupled
    stream) through the demux route. Pre-skip and end trim as in the JAX
    package, PCM within 1e-4 of libopus."""
    from libnyquist_tpu import load as jload
    from libnyquist_tpu.formats.ogg import write_page_multi
    import libnyquist_torch as nqt

    ch, frame, pkts, ref = read_case(1)
    pkts = pkts[:30]
    pre_skip, serial = 312, 0x5EED
    head = (b"OpusHead" + bytes([1, ch]) + pre_skip.to_bytes(2, "little")
            + (48000).to_bytes(4, "little") + b"\0\0" + bytes([family]))
    if family:
        head += bytes([1, ch - 1]) + bytes(range(ch))
    tags = b"OpusTags" + (4).to_bytes(4, "little") + b"test" + b"\0" * 4
    end = 30 * frame - 100                    # trims the last 100 samples
    data = (write_page_multi([head], 0, serial, 0, bos=True)
            + write_page_multi([tags], 0, serial, 1)
            + write_page_multi(pkts[:15], 15 * frame, serial, 2)
            + write_page_multi(pkts[15:], end, serial, 3, eos=True))
    path = tmp_path / "case1.opus"
    path.write_bytes(data)

    got = nqt.load(str(path), device="cpu")
    want = jload(str(path))
    assert got.channel_count == want.channel_count == ch
    assert got.sample_count == want.sample_count == (end - pre_skip) * ch
    assert np.abs(got.samples - want.samples).max() < 1e-4
    lib = ref[pre_skip * ch : end * ch]
    assert np.abs(got.samples - lib).max() < 1e-4
