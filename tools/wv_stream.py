"""Seeded WavPack streams for tests and chip runs (NumPy only).

    from tools.wv_stream import make_wv_stream
    data = make_wv_stream(seed=0, seconds=2.0, kind="int16_joint")

Writes a stream of structurally valid WavPack 4 blocks whose entropy
payloads are seeded random bytes. The headers and the metadata are what
an encoder writes; the words are not the coding of any signal, so the
stream holds two decoders of the same bitstream rules against each
other bit for bit, not against a spec-level oracle of the lossless
words. Each block has:

* a 32-byte header: version 0x402 to 0x410, the sample rate index (or
  15, "custom", with an ID_SAMPLE_RATE block), BYTES_STORED, the shift,
  the block index and the stream's 40-bit total (or "unknown");
* decorrelation terms (1 to 8, 17 and 18; -1 to -3 in stereo), each with
  a delta, weights and history samples, drawn from one of the stream's
  two term sequences so that blocks share them as an encoder's do;
* entropy variables (medians), now and then below 2 so that the
  zero-run path runs;
* ID_HYBRID_PROFILE for hybrid blocks, FLOAT_INFO for float blocks,
  INT32_INFO for 32-bit integer blocks, with or without the wvx side
  stream (ID_WVX_BITSTREAM);
* the audio bitstream (ID_WV_BITSTREAM), sized so the words never run
  out: every 16th bit is a zero, so no unary run reaches the decoder's
  end-of-data escape, and there are 32 bits for each value (random
  words take about 16 at the block sizes drawn here);
* now and then an unknown or a large (ID_LARGE) metadata id and an odd
  size (ID_ODD_SIZE), and a metadata-only block (no samples) first.

The last block is short. ``KINDS`` lists the block kinds.
"""

from __future__ import annotations

import struct

import numpy as np

MONO_FLAG = 4
HYBRID_FLAG = 8
JOINT_STEREO = 0x10
CROSS_DECORR = 0x20
HYBRID_SHAPE = 0x40
FLOAT_DATA = 0x80
INT32_DATA = 0x100
HYBRID_BITRATE = 0x200
HYBRID_BALANCE = 0x400
INITIAL_BLOCK = 0x800
FINAL_BLOCK = 0x1000
SHIFT_LSB = 13
SRATE_LSB = 23
FALSE_STEREO = 0x40000000

ID_DECORR_TERMS = 0x2
ID_DECORR_WEIGHTS = 0x3
ID_DECORR_SAMPLES = 0x4
ID_ENTROPY_VARS = 0x5
ID_HYBRID_PROFILE = 0x6
ID_FLOAT_INFO = 0x8
ID_INT32_INFO = 0x9
ID_WV_BITSTREAM = 0xA
ID_WVX_BITSTREAM = 0xC
ID_RIFF_HEADER = 0x21
ID_SAMPLE_RATE = 0x27
ID_ODD_SIZE = 0x40
ID_LARGE = 0x80

SAMPLE_RATES = [6000, 8000, 9600, 11025, 12000, 16000, 22050, 24000,
                32000, 44100, 48000, 64000, 88200, 96000, 192000]

# kind -> bytes stored, channel mode (stereo, mono or false stereo) and
# the block's other flags
KINDS = {
    "int16_joint": dict(nbytes=2, mode="stereo", joint=True),
    "int16": dict(nbytes=2, mode="stereo"),
    "int8_mono": dict(nbytes=1, mode="mono"),
    "int24": dict(nbytes=3, mode="stereo", joint=True),
    "int24_mono": dict(nbytes=3, mode="mono"),
    "int16_shift": dict(nbytes=2, mode="stereo", shift=True),
    "false_stereo": dict(nbytes=2, mode="false_stereo"),
    "hybrid": dict(nbytes=2, mode="stereo", joint=True, hybrid=True),
    "hybrid_mono": dict(nbytes=2, mode="mono", hybrid=True),
    "float32": dict(nbytes=4, mode="stereo", float=True),
    "float32_wvx": dict(nbytes=4, mode="stereo", float=True, wvx=True),
    "float32_mono_wvx": dict(nbytes=4, mode="mono", float=True, wvx=True),
    "int32_info": dict(nbytes=4, mode="stereo", int32=True),
    "int32_info_wvx": dict(nbytes=4, mode="stereo", int32=True, wvx=True),
}
STEREO_TERMS = (1, 2, 3, 4, 5, 6, 7, 8, 17, 18, -1, -2, -3)
MONO_TERMS = (1, 2, 3, 4, 5, 6, 7, 8, 17, 18)
WORD_BITS = 32                  # payload bits written for each value


def _sub_block(mid: int, body: bytes, large: bool = False) -> bytes:
    """One metadata sub-block: id (ID_ODD_SIZE for an odd body,
    ID_LARGE for a 24-bit word count), the word count, the body padded
    to even."""
    if len(body) & 1:
        mid |= ID_ODD_SIZE
        body += b"\0"
    words = len(body) >> 1
    if large or words > 255:
        return bytes([mid | ID_LARGE, words & 0xFF, (words >> 8) & 0xFF,
                      words >> 16]) + body
    return bytes([mid, words]) + body


def _payload(rng, nbytes: int) -> bytes:
    """Seeded random bytes with every 16th bit (LSB first) a zero, so no
    run of ones reaches 16."""
    raw = rng.integers(0, 1 << 16, (nbytes + 1) // 2, dtype=np.uint16)
    return (raw & np.uint16(0x7FFF)).astype("<u2").tobytes()[:nbytes]


def _term_sequence(rng, pool) -> list:
    n = int(rng.integers(0, 17))
    return [int(t) for t in rng.choice(pool, n)]


def _decorr_metadata(rng, terms: list, mono: bool) -> bytes:
    """Terms, weights and history samples of one block (the decoder
    reads weights and samples from the last term backwards)."""
    body = bytes(((t + 5) & 0x1F) | (int(rng.integers(0, 8)) << 5)
                 for t in reversed(terms))
    out = _sub_block(ID_DECORR_TERMS, body)
    nch = 1 if mono else 2
    nw = int(rng.integers(0, len(terms) + 1))
    out += _sub_block(ID_DECORR_WEIGHTS,
                      rng.integers(0, 256, nw * nch, dtype=np.uint8).tobytes())
    nwords = 0
    for t in terms[::-1][: int(rng.integers(0, len(terms) + 1))]:
        nwords += 2 * nch if t > 8 else 2 if t < 0 else t * nch
    logs = rng.integers(-2600, 2600, nwords).astype("<i2")
    out += _sub_block(ID_DECORR_SAMPLES, logs.tobytes())
    return out


def _block(rng, spec: dict, flags: int, n: int, terms: list) -> bytes:
    """The metadata of one block of ``n`` samples."""
    mono = spec["mode"] != "stereo"
    nch = 1 if mono else 2
    nvalues = n * nch
    meta = _decorr_metadata(rng, terms, mono)
    if rng.random() < 0.1:
        med = rng.integers(0, 256, 3 * nch)            # medians below 2
    else:
        med = rng.integers(256, 3000, 3 * nch)
    meta += _sub_block(ID_ENTROPY_VARS, med.astype("<u2").tobytes())
    if spec.get("hybrid"):
        prof = b""
        if flags & HYBRID_BITRATE:
            prof += rng.integers(0, 3000, nch).astype("<i2").tobytes()
        prof += rng.integers(0, 1 << 12, nch).astype("<u2").tobytes()
        if rng.random() < 0.7:
            prof += rng.integers(-300, 300, nch).astype("<i2").tobytes()
        meta += _sub_block(ID_HYBRID_PROFILE, prof)
    if spec.get("float"):
        meta += _sub_block(ID_FLOAT_INFO, bytes([
            int(rng.integers(0, 32)), int(rng.integers(0, 9)),
            int(rng.choice([0, 24, 25, 30, 126, 127, 140])),
            int(rng.choice([127, 127, 100, 150, 1]))]))
    sent = 0
    if spec.get("int32"):
        what = int(rng.integers(0, 4))
        info = [0, 0, 0, 0]
        info[what] = int(rng.integers(1, 9))
        sent = info[0]
        meta += _sub_block(ID_INT32_INFO, bytes(info))
    if rng.random() < 0.15:
        meta += _sub_block(ID_RIFF_HEADER,
                           rng.integers(0, 256, int(rng.integers(1, 40)),
                                        dtype=np.uint8).tobytes(),
                           large=bool(rng.random() < 0.5))
    meta += _sub_block(ID_WV_BITSTREAM,
                       _payload(rng, nvalues * WORD_BITS // 8 + 64))
    if spec.get("wvx"):
        # crc_x, then the side stream: 23 + 8 + 1 bits a float value at
        # most, ``sent`` bits an int32 value
        side = nvalues * (sent if spec.get("int32") else 32) // 8 + 16
        meta += _sub_block(ID_WVX_BITSTREAM,
                           b"\0\0\0\0" + rng.bytes(side))
    return meta


def make_wv_stream(seed: int, seconds: float = 1.0, kind: str = "int16_joint",
                   rate: int = 44100, block_samples=None,
                   total="exact", lead_block: bool = True,
                   terms=None) -> bytes:
    """Bytes of a WavPack stream of about ``seconds`` of ``kind`` blocks.
    ``block_samples`` None draws a size per stream in [4,096, 24,000];
    the last block is short. ``total`` is the headers' sample count: the
    true one ("exact"), None for "unknown", or any int. ``terms`` is the
    pool the term sequences are drawn from (default: every term the
    channel mode takes)."""
    spec = KINDS[kind]
    rng = np.random.default_rng(seed)
    n = max(1, int(round(seconds * rate)))
    bsz = int(block_samples or rng.integers(4096, 24001))
    sizes = [bsz] * (n // bsz) + ([n % bsz] if n % bsz else [])
    mono = spec["mode"] != "stereo"
    pool = terms or (MONO_TERMS if mono else STEREO_TERMS)
    seqs = [_term_sequence(rng, pool) for _ in range(2)]
    srate = SAMPLE_RATES.index(rate) if rate in SAMPLE_RATES else 15
    shift = int(rng.integers(1, 6)) if spec.get("shift") else 0
    flags = (spec["nbytes"] - 1) | INITIAL_BLOCK | FINAL_BLOCK \
        | (shift << SHIFT_LSB) | (srate << SRATE_LSB)
    if spec["mode"] == "mono":
        flags |= MONO_FLAG
    elif spec["mode"] == "false_stereo":
        flags |= MONO_FLAG | FALSE_STEREO
    if spec.get("joint"):
        flags |= JOINT_STEREO | (CROSS_DECORR if rng.random() < 0.5 else 0)
    if spec.get("float"):
        flags |= FLOAT_DATA
    if spec.get("int32"):
        flags |= INT32_DATA
    if spec.get("hybrid"):
        flags |= HYBRID_FLAG | HYBRID_BITRATE * int(rng.integers(0, 2))
        if not mono:
            flags |= HYBRID_BALANCE * int(rng.integers(0, 2))
        flags |= HYBRID_SHAPE * int(rng.integers(0, 2))
    if total == "exact":
        total = n
    total_lo = 0xFFFFFFFF if total is None else total & 0xFFFFFFFF
    total_hi = 0 if total is None else total >> 32
    out = bytearray()

    def header(body_len, index, count, blk_flags, version):
        return b"wvpk" + struct.pack(
            "<IHBBIIIII", body_len + 24, version, index >> 32, total_hi,
            total_lo, index & 0xFFFFFFFF, count, blk_flags, 0)

    if lead_block:
        body = _sub_block(ID_RIFF_HEADER, b"RIFF....WAVEfmt ")
        out += header(len(body), 0, 0, flags, 0x410) + body
    index = 0
    for count in sizes:
        version = int(rng.integers(0x402, 0x411))
        terms = seqs[int(rng.random() < 0.2)]
        body = _block(rng, spec, flags, count, terms)
        if srate == 15:
            body += _sub_block(ID_SAMPLE_RATE, struct.pack("<I", rate)[:3])
        out += header(len(body), index, count, flags, version) + body
        index += count
    return bytes(out)
