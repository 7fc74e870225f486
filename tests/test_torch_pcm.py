"""The port's PCM conversion, IMA-ADPCM scans and WAV/AIFF/CAF readers
against the JAX package, on the CPU, at a few thousand frames.

Integer formats convert bit for bit (the same float32 product by the same
float32 reciprocal). The ADPCM scans are integer: exactly equal, rails
included. Files written by the JAX package's encoders, and WAV IMA-ADPCM,
AIFF-C and CAF files built here from seeded bytes, load to the same
samples and metadata through both packages. PCM_64 divides in float64:
the JAX package runs without 64-bit mode, so it first wraps int64 to
int32 and divides in float32; against it the port is held within 1 ulp
where the values fit in int32, and against the float64 formula exactly
over the whole range.
"""

import struct

import numpy as np
import pytest
import torch

import libnyquist_torch as nqt
import libnyquist_tpu as nq
from libnyquist_torch.audio_data import PCMFormat as PF
from libnyquist_torch.ops import adpcm as padpcm
from libnyquist_torch.ops import pcm as ppcm
from libnyquist_tpu.audio_data import PCMFormat as JF
from libnyquist_tpu.ops import adpcm as jadpcm
from libnyquist_tpu.ops import pcm as jpcm

FORMATS = ["u8", "s8", "s16", "s24", "s32", "f32", "f64"]


def _jnp(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def _raw_bytes(fmt, n, seed):
    rng = np.random.default_rng(seed)
    if fmt == "f32":
        return (rng.standard_normal(n) * 0.5).astype("<f4").tobytes()
    if fmt == "f64":
        return (rng.standard_normal(n) * 0.5).astype("<f8").tobytes()
    width = {"u8": 1, "s8": 1, "s16": 2, "s24": 3, "s32": 4, "s64": 8}[fmt]
    raw = rng.integers(0, 256, n * width, dtype=np.uint8)
    # the rails of every width: the most negative and most positive codes
    top = np.full(width, 0xFF, np.uint8)
    top[-1] = 0x7F
    bot = np.zeros(width, np.uint8)
    bot[-1] = 0x80
    raw[:width], raw[width : 2 * width] = top, bot
    return raw.tobytes()


@pytest.mark.parametrize("fmt", FORMATS)
def test_pcm_to_float32_bit_equal(fmt):
    data = _raw_bytes(fmt, 4099, FORMATS.index(fmt))
    ref = np.asarray(jpcm.pcm_to_float32(
        _jnp(jpcm.bytes_to_int_array(data, JF(fmt))), JF(fmt)))
    raw = torch.from_numpy(ppcm.bytes_to_int_array(data, PF(fmt)).copy())
    got = ppcm.pcm_to_float32(raw, PF(fmt)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    buf = ppcm.convert_buffer_to_float32(data, PF(fmt), "cpu").numpy()
    assert np.array_equal(buf, np.asarray(
        jpcm.convert_buffer_to_float32(data, JF(fmt))))


def test_pcm64_divides_in_float64():
    rng = np.random.default_rng(64)
    full = rng.integers(-(2**63), 2**63 - 1, 2000, dtype=np.int64)
    got = ppcm.pcm_to_float32(torch.from_numpy(full), PF.PCM_64).numpy()
    assert np.array_equal(got, (full / 9223372036854775807.0).astype(
        np.float32))
    small = rng.integers(-(2**31), 2**31 - 1, 2000).astype(np.int64)
    got = ppcm.convert_buffer_to_float32(small.tobytes(), PF.PCM_64,
                                         "cpu").numpy()
    ref = np.asarray(jpcm.pcm_to_float32(_jnp(small), JF.PCM_64))
    assert np.all(np.abs(got.view(np.int32).astype(np.int64)
                         - ref.view(np.int32)) <= 1)


def _x(seed, n=5000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, n).astype(np.float32)
    x[:6] = [1.0, -1.0, 0.0, 0.5 / 32767, -0.5 / 32767, 2.5 / 127]
    return x


@pytest.mark.parametrize("fmt", ["u8", "s8", "s16", "s24", "s32", "f32",
                                 "f64"])
def test_float32_to_pcm_exact_without_dither(fmt):
    x = _x(1)
    ref = np.asarray(jpcm.float32_to_pcm(_jnp(x), JF(fmt)))
    got = ppcm.float32_to_pcm(torch.from_numpy(x), PF(fmt)).numpy()
    assert got.shape == ref.shape
    assert np.array_equal(got.astype(np.float64), ref.astype(np.float64))
    if fmt not in ("f32", "f64"):
        assert got.dtype == ref.dtype


@pytest.mark.parametrize("fmt", ["u8", "s16", "s24"])
def test_float32_to_pcm_dither_bounds_and_seed(fmt):
    """TPDF dither of 1 LSB peak to peak: the codes are the reference
    formula's on the generator's noise, the same from one generator seed
    and other from another; each lies within one LSB of the undithered
    code (two at 24 bits, where the float32 product y * scale itself
    rounds to a step of about one code), with the error statistics of a
    triangular density (mean 0, variance 1/6 + 1/12 LSB^2 with the
    rounding)."""
    x = torch.from_numpy(_x(2, 200_000).clip(-0.99, 0.99))
    plain = ppcm.float32_to_pcm(x, PF(fmt)).to(torch.int64)

    def dith(seed):
        g = torch.Generator().manual_seed(seed)
        return ppcm.float32_to_pcm(x, PF(fmt), dither=True,
                                   generator=g).to(torch.int64)

    a, b, c = dith(5), dith(5), dith(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    scale = {"u8": 127.0, "s16": 32767.0, "s24": 8388607.0}[fmt]
    off = 128 if fmt == "u8" else 0
    u = torch.rand((2,) + tuple(x.shape),
                   generator=torch.Generator().manual_seed(5)).numpy()
    y = x.numpy() + (u[0] + u[1] - np.float32(1.0)) / np.float32(scale)
    want = np.round(np.clip(y, -1, 1) * np.float32(scale)) + off
    assert np.array_equal(a.numpy(), want.astype(np.int64))
    lsb = 2 if fmt == "s24" else 1
    assert int((a - plain).abs().max()) <= lsb
    jref = np.asarray(jpcm.float32_to_pcm(_jnp(x.numpy()), JF(fmt),
                                          dither=True, seed=5)).astype(
        np.int64)
    assert np.abs(jref - plain.numpy()).max() <= lsb
    if fmt != "s24":
        err = (a - off).double() - x.double() * scale
        assert abs(err.mean().item()) < 0.01
        assert abs(err.var().item() - 0.25) < 0.01


def _scalar_ima(nibbles, pred, step, saturate):
    """The serial IMA decoder of the spec (reference WavDecoder.cpp:75-134),
    predictor wrapping as int16 (WAV) or saturating (Apple ima4)."""
    out = np.empty(len(nibbles), np.int64)
    for i, nb in enumerate(nibbles):
        s = int(jadpcm.IMA_STEP_TABLE[step])
        diff = (s >> 3) + (s if nb & 4 else 0) + (s >> 1 if nb & 2 else 0) \
            + (s >> 2 if nb & 1 else 0)
        pred = pred - diff if nb & 8 else pred + diff
        pred = (min(max(pred, -32768), 32767) if saturate
                else ((pred + 0x8000) & 0xFFFF) - 0x8000)
        step = min(max(step + int(jadpcm.IMA_INDEX_TABLE[nb]), 0), 88)
        out[i] = pred
    return out


def _nibble_rows(seed, B=48, S=2040):
    """Random nibbles with rows that ride the rails: runs of 7 / 15 drive
    the step index to 88 and the predictor to +-32767, runs of 0 to 0."""
    rng = np.random.default_rng(seed)
    nib = rng.integers(0, 16, (B, S)).astype(np.int32)
    nib[0] = 7
    nib[1] = 15
    nib[2, : S // 2] = 7
    nib[2, S // 2 :] = 8
    nib[3] = 0
    preds = rng.integers(-32768, 32768, B).astype(np.int32)
    preds[:4] = [32767, -32768, 0, -32768]
    steps = rng.integers(0, 89, B).astype(np.int32)
    steps[:4] = [88, 88, 0, 0]
    return nib, preds, steps


def test_ima_scans_equal_jax_and_the_scalar_decoder():
    nib, preds, steps = _nibble_rows(3)
    t = [torch.from_numpy(a) for a in (nib, preds, steps)]
    for jfn, pfn, sat in ((jadpcm.decode_ima_nibbles,
                           padpcm.decode_ima_nibbles, False),
                          (jadpcm.decode_ima4_nibbles,
                           padpcm.decode_ima4_nibbles, True)):
        ref = np.asarray(jfn(_jnp(nib), _jnp(preds), _jnp(steps)))
        got = pfn(*t).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, ref)
        for r in (0, 1, 2, 3, 7):
            assert np.array_equal(got[r], _scalar_ima(nib[r], int(preds[r]),
                                                      int(steps[r]), sat))
    assert got[0].max() == 32767 and got[1].min() == -32768


def test_ima_header_step_past_the_table_as_jax():
    """A WAV block header's step byte above 88 reads the JAX package's
    out-of-bounds gather fill for its first nibble; the port gives the
    same samples (and never indexes out of bounds)."""
    nib, preds, _ = _nibble_rows(4, B=6, S=64)
    steps = np.array([89, 120, 255, 0, 88, 200], np.int32)
    ref = np.asarray(jadpcm.decode_ima_nibbles(_jnp(nib), _jnp(preds),
                                               _jnp(steps)))
    got = padpcm.decode_ima_nibbles(*(torch.from_numpy(a)
                                      for a in (nib, preds, steps)))
    assert np.array_equal(got.numpy(), ref)


def test_clip_compose_scan_matches_sequential():
    rng = np.random.default_rng(9)
    a = rng.integers(-9, 10, (5, 300)).astype(np.int32)
    s0 = rng.integers(0, 89, 5)
    sa, slo, shi = padpcm.clip_compose_scan(
        torch.from_numpy(a), torch.zeros(5, 300, dtype=torch.int32),
        torch.full((5, 300), 88, dtype=torch.int32))
    got = torch.clamp(torch.from_numpy(s0)[:, None] + sa, slo, shi).numpy()
    for r in range(5):
        s = int(s0[r])
        for i in range(300):
            s = min(max(s + int(a[r, i]), 0), 88)
            assert got[r, i] == s


def test_interleave_helpers_match_jax():
    rng = np.random.default_rng(10)
    ch = rng.standard_normal((3, 101)).astype(np.float32)
    st = rng.standard_normal(202).astype(np.float32)
    pairs = [
        (ppcm.interleave(torch.from_numpy(ch)), jpcm.interleave(_jnp(ch))),
        (ppcm.deinterleave(torch.from_numpy(ch.reshape(-1)), 3),
         jpcm.deinterleave(_jnp(ch.reshape(-1)), 3)),
        (ppcm.stereo_to_mono(torch.from_numpy(st)),
         jpcm.stereo_to_mono(_jnp(st))),
        (ppcm.mono_to_stereo(torch.from_numpy(st)),
         jpcm.mono_to_stereo(_jnp(st))),
    ]
    for got, ref in pairs:
        assert np.array_equal(got.numpy(), np.asarray(ref))


# --------------------------------------------------------------------------
# containers
# --------------------------------------------------------------------------
def _same(data, ext):
    a = nq.load(data, extension=ext)
    b = nqt.load(data, extension=ext, device="cpu")
    assert (b.channel_count, b.sample_rate, b.frame_size) == (
        a.channel_count, a.sample_rate, a.frame_size)
    assert b.source_format.value == a.source_format.value
    assert b.samples.dtype == np.float32
    assert np.array_equal(b.samples, np.asarray(a.samples, np.float32))
    assert b.length_seconds == pytest.approx(a.length_seconds)
    return b


def _audio(ch, frames, seed):
    from libnyquist_tpu.audio_data import AudioData

    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal(ch * frames) * 0.4, -1, 1)
    x[:4] = [1.0, -1.0, 0.0, 1.0]
    return AudioData(samples=x.astype(np.float32), channel_count=ch,
                     sample_rate=44100)


@pytest.mark.parametrize("fmt", ["u8", "s16", "s24", "s32", "f32"])
@pytest.mark.parametrize("ch", [1, 2])
def test_wav_from_jax_encoder(fmt, ch):
    from libnyquist_tpu.encoders import EncoderParams, encode_wav_to_buffer

    data = encode_wav_to_buffer(EncoderParams(ch, JF(fmt)),
                                _audio(ch, 3001, 11))
    _same(data, "wav")


@pytest.mark.parametrize("fmt", ["u8", "s16", "s24", "s32"])
def test_aiff_from_jax_encoder(fmt):
    from libnyquist_tpu.encoders import EncoderParams, encode_aiff_to_buffer

    data = encode_aiff_to_buffer(EncoderParams(2, JF(fmt)),
                                 _audio(2, 2999, 12))
    _same(data, "aiff")


def wav_bytes(fmt_code, ch, rate, bits, payload, block_align=None,
              fact=None, extra=b""):
    """A RIFF/WAVE file around ``payload``."""
    ba = block_align or ch * bits // 8
    body = b"WAVE" + b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_code, ch, rate, rate * ba, ba, bits)
    if fact is not None:
        body += b"fact" + struct.pack("<II", 4, fact)
    body += extra + b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        body += b"\0"
    return b"RIFF" + struct.pack("<I", len(body)) + body


def ima_blocks(ch, n_blocks, block_align, seed):
    """Seeded IMA-ADPCM blocks with legal headers (reserved byte 0, step
    index 0..88)."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n_blocks, block_align), dtype=np.uint8)
    hdr = blocks[:, : 4 * ch].reshape(n_blocks, ch, 4)
    hdr[:, :, 2] = rng.integers(0, 89, (n_blocks, ch))
    hdr[:, :, 3] = 0
    return blocks.tobytes()


@pytest.mark.parametrize("ch,block_align,fact_extra", [
    (2, 2048, 0), (1, 512, -100), (2, 1024, 5000)])
def test_wav_ima_adpcm(ch, block_align, fact_extra):
    """Stereo with block align 2,048 as the card run uses; a fact length
    short of the payload cuts it; one past it gives the zeros of the JAX
    package's bucket-padded decode."""
    n_blocks = 5
    per_block = (block_align - 4 * ch) * 2 // ch
    payload = ima_blocks(ch, n_blocks, block_align, 20 + ch)
    data = wav_bytes(0x11, ch, 22050, 4, payload, block_align,
                     fact=n_blocks * per_block + fact_extra)
    b = _same(data, "wav")
    assert b.sample_count == ch * (n_blocks * per_block + fact_extra)


def aifc_bytes(comp, ch, bits, payload, frames, rate=44100):
    """An AIFF-C file (FORM AIFC, COMM with a compression type, SSND)."""
    exp = rate.bit_length() - 1
    f80 = struct.pack(">HQ", 16383 + exp, rate << (63 - exp))
    comm = struct.pack(">hIh", ch, frames, bits) + f80 + comp + b"\x00\x00"
    body = b"AIFC" + b"COMM" + struct.pack(">I", len(comm)) + comm
    body += b"SSND" + struct.pack(">III", len(payload) + 8, 0, 0) + payload
    if len(payload) & 1:
        body += b"\0"
    return b"FORM" + struct.pack(">I", len(body)) + body


def ima4_packets(ch, groups, seed):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 256, (groups * ch, 34), dtype=np.uint8)
    return pk.tobytes()


@pytest.mark.parametrize("comp,bits,width", [
    (b"NONE", 16, 2), (b"twos", 24, 3), (b"twos", 8, 1), (b"NONE", 32, 4),
    (b"sowt", 16, 2), (b"raw ", 8, 1), (b"fl32", 32, 4), (b"fl64", 64, 8),
    (b"ulaw", 16, 1), (b"alaw", 16, 1), (b"ima4", 16, None)])
def test_aifc_compression_types(comp, bits, width):
    rng = np.random.default_rng(len(comp) + bits)
    ch, frames = 2, 1500
    if comp == b"ima4":
        payload = ima4_packets(ch, 24, 7)
        frames = 24 * 64 - 10            # a sub-packet trim of the tail
    elif comp in (b"fl32", b"fl64"):
        payload = (rng.standard_normal(ch * frames) * 0.3).astype(
            ">f4" if bits == 32 else ">f8").tobytes()
    else:
        payload = rng.integers(0, 256, ch * frames * width,
                               dtype=np.uint8).tobytes()
    b = _same(aifc_bytes(comp, ch, bits, payload, frames), "aifc")
    assert b.sample_count == ch * frames


def caf_bytes(fid, flags, bpp, fpp, ch, bpc, payload, rate=48000.0,
              size=None):
    desc = struct.pack(">d4sIIIII", rate, fid, flags, bpp, fpp, ch, bpc)
    out = b"caff\x00\x01\x00\x00" + b"desc" + struct.pack(">q", len(desc))
    out += desc + b"data" + struct.pack(
        ">q", len(payload) + 4 if size is None else size)
    return out + b"\0\0\0\0" + payload


@pytest.mark.parametrize("kind", [
    "le16", "le24", "le32", "be16", "be24", "lef32", "bef32", "lef64",
    "ima4", "ulaw", "alaw"])
def test_caf(kind):
    rng = np.random.default_rng(len(kind))
    ch, frames = 2, 1200
    if kind == "ima4":
        args = (b"ima4", 0, 34 * ch, 64, ch, 0, ima4_packets(ch, 19, 8))
    elif kind in ("ulaw", "alaw"):
        args = (kind.encode(), 0, ch, 1, ch, 8,
                rng.integers(0, 256, ch * frames, dtype=np.uint8).tobytes())
    elif "f" in kind:
        k = 8 if kind.endswith("64") else 4
        x = (rng.standard_normal(ch * frames) * 0.3).astype(
            ("<" if kind.startswith("le") else ">") + f"f{k}")
        args = (b"lpcm", 1 | (2 if kind.startswith("le") else 0), k * ch, 1,
                ch, 8 * k, x.tobytes())
    else:
        w = int(kind[2:]) // 8
        args = (b"lpcm", 2 if kind.startswith("le") else 0, w * ch, 1, ch,
                8 * w, rng.integers(0, 256, ch * frames * w,
                                    dtype=np.uint8).tobytes())
    _same(caf_bytes(*args), "caf")
    _same(caf_bytes(*args, size=-1), "caf")


def _corruptions():
    """(name, bytes, extension): malformed inputs."""
    good = wav_bytes(1, 2, 44100, 16, bytes(4000))
    ima = wav_bytes(0x11, 2, 22050, 4, ima_blocks(2, 2, 512, 1), 512,
                    fact=100)
    bad_res = bytearray(ima)
    bad_res[ima.index(b"data") + 8 + 3] = 1
    aif = aifc_bytes(b"NONE", 2, 16, bytes(400), 100)
    caf = caf_bytes(b"lpcm", 2, 4, 1, 2, 16, bytes(400))

    def patch(buf, off, new):
        b = bytearray(buf)
        b[off : off + len(new)] = new
        return bytes(b)

    fmt_at = good.index(b"fmt ")
    comm_at = aif.index(b"COMM")
    return [
        ("short", good[:10], "wav"),
        ("rifx", b"RIFX" + good[4:], "wav"),
        ("not wave", patch(good, 8, b"WAVX"), "wav"),
        ("size", patch(good, 4, struct.pack("<I", 9)), "wav"),
        ("no fmt", patch(good, fmt_at, b"fmx "), "wav"),
        ("fmt small", patch(good, fmt_at + 4, struct.pack("<I", 8)), "wav"),
        ("depth 12", patch(good, fmt_at + 22, struct.pack("<H", 12)), "wav"),
        ("format 0", patch(good, fmt_at + 8, struct.pack("<H", 0)), "wav"),
        ("no data", patch(good, good.index(b"data"), b"dat "), "wav"),
        ("adpcm align 0", patch(ima, ima.index(b"fmt ") + 20, b"\0\0"),
         "wav"),
        ("adpcm reserved", bytes(bad_res), "wav"),
        ("not form", b"FORX" + aif[4:], "aiff"),
        ("not aiff", patch(aif, 8, b"AIFX"), "aiff"),
        ("short comm", patch(aif, comm_at + 4, struct.pack(">I", 10)),
         "aiff"),
        ("no comm", patch(aif, comm_at, b"COMX"), "aiff"),
        ("no ssnd", patch(aif, aif.index(b"SSND"), b"SSNX"), "aiff"),
        ("sowt 8", aifc_bytes(b"sowt", 2, 8, bytes(40), 20), "aiff"),
        ("unknown comp", aifc_bytes(b"zzzz", 2, 16, bytes(40), 10), "aiff"),
        ("odd twos", aifc_bytes(b"twos", 1, 16, bytes(41), 20), "aiff"),
        ("depth 20", aifc_bytes(b"NONE", 1, 20, bytes(40), 10), "aiff"),
        ("not caff", b"cafx" + caf[4:], "caf"),
        ("short desc", caf[:8] + b"desc" + struct.pack(">q", 8) + bytes(8),
         "caf"),
        ("no data", patch(caf, caf.index(b"data"), b"datx"), "caf"),
        ("caf format", caf_bytes(b"aac ", 0, 4, 1, 2, 16, bytes(40)), "caf"),
        ("caf depth 8", caf_bytes(b"lpcm", 2, 2, 1, 2, 8, bytes(40)), "caf"),
        ("caf odd f32", caf_bytes(b"lpcm", 3, 8, 1, 2, 32, bytes(42)), "caf"),
    ]


@pytest.mark.parametrize("name,data,ext", _corruptions(),
                         ids=[c[0] for c in _corruptions()])
def test_malformed_headers_raise_where_jax_raises(name, data, ext):
    from libnyquist_tpu.errors import DecodeError as JDecodeError

    with pytest.raises(JDecodeError):
        nq.load(data, extension=ext)
    with pytest.raises(nqt.DecodeError):
        nqt.load(data, extension=ext, device="cpu")
