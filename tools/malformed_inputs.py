"""The inputs of the malformed-input passes through ``load()``: one or
more valid files for every route of the decoder facade, small enough to
decode many mutations of each.

    inputs = malformed_inputs.inputs()   # {name: Input}

Each ``Input`` holds the file's bytes, the extension ``load()`` is
given, the route (the decode plane the file reaches) and the tolerance
two decodes of it are held to: ``None`` for equal bits (integer PCM,
FLAC, WavPack), else a share of max(|ref|, 1). Fixtures are read from
tests/fixtures; the other streams come from this directory's writers
(NumPy and struct only), the struct writers below (chip_smoke.py's PCM
phases take them too) and tests/test_torch_streaming.py's SV8 assembly.
tests/test_torch_robustness.py holds the port against the JAX package
over them on the CPU; chip_smoke.py phase 13 holds the card against the
CPU.
"""

from __future__ import annotations

import importlib.util
import pathlib
import struct
from typing import NamedTuple

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
CAP = 65536                   # bytes of an input the mutations cover
# The Opus inputs are cut to their first pages: the port's plain
# postfilter on the CPU loops over 12-sample chunks.
OPUS_CAP = 16384


class Input(NamedTuple):
    data: bytes
    ext: str
    route: str
    tol: float | None


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def wav_file(fmt_code, ch, rate, bits, payload, block_align=None, fact=None):
    """A RIFF/WAVE file around ``payload`` (fmt, optional fact, data)."""
    ba = block_align or ch * bits // 8
    body = b"WAVE" + b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_code, ch, rate, rate * ba, ba, bits)
    if fact is not None:
        body += b"fact" + struct.pack("<II", 4, fact)
    body += b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        body += b"\0"
    return b"RIFF" + struct.pack("<I", len(body)) + body


def aifc_file(comp, ch, bits, payload, frames, rate=44100):
    """An AIFF-C file: FORM AIFC, COMM with a compression type, SSND."""
    exp = rate.bit_length() - 1
    f80 = struct.pack(">HQ", 16383 + exp, rate << (63 - exp))
    comm = struct.pack(">hIh", ch, frames, bits) + f80 + comp + b"\0\0"
    body = b"AIFC" + b"COMM" + struct.pack(">I", len(comm)) + comm
    body += b"SSND" + struct.pack(">III", len(payload) + 8, 0, 0) + payload
    if len(payload) & 1:
        body += b"\0"
    return b"FORM" + struct.pack(">I", len(body)) + body


def caf_file(fid, flags, bpp, fpp, ch, bpc, payload, rate=44100.0):
    """A CAF file: caff header, desc, data (edit count, then samples)."""
    desc = struct.pack(">d4sIIIII", rate, fid, flags, bpp, fpp, ch, bpc)
    return (b"caff\x00\x01\x00\x00" + b"desc" + struct.pack(">q", len(desc))
            + desc + b"data" + struct.pack(">q", len(payload) + 4)
            + b"\0\0\0\0" + payload)


def _streaming_builders():
    """tests/test_torch_streaming.py's content builders (NumPy and the
    writers only), as chip_smoke.py loads them."""
    spec = importlib.util.spec_from_file_location(
        "_seek_builders", ROOT / "tests" / "test_torch_streaming.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pcm_inputs(rng) -> dict:
    """IMA-ADPCM WAV, AIFF-C ima4 and CAF big-endian lpcm, stereo, with
    legal headers around seeded payloads (chip_smoke.py phase 7's
    layouts at a fraction of a second)."""
    block, frames = 512, 4 * (512 - 8)         # 4 blocks of 504 frames
    blocks = rng.integers(0, 256, (4, block), dtype=np.uint8)
    hdr = blocks[:, :8].reshape(4, 2, 4)
    hdr[:, :, 2] = rng.integers(0, 89, (4, 2))    # step index
    hdr[:, :, 3] = 0
    groups = 64
    ima4 = rng.integers(0, 256, (groups * 2, 34), dtype=np.uint8)
    ima4[:, 1] = (ima4[:, 1] & 0x80) | rng.integers(0, 89, groups * 2)
    lpcm = rng.integers(0, 256, 4 * 4000, dtype=np.uint8).tobytes()
    return {
        "wav ima-adpcm": Input(wav_file(0x11, 2, 44100, 4, blocks.tobytes(),
                                        block, fact=frames), "wav",
                               "ima-adpcm wav", None),
        "aifc ima4": Input(aifc_file(b"ima4", 2, 16, ima4.tobytes(),
                                     groups * 64), "aifc", "aiff-c ima4",
                           None),
        "caf lpcm": Input(caf_file(b"lpcm", 0, 4, 1, 2, 16, lpcm), "caf",
                          "caf", None),
    }


def inputs() -> dict:
    """{name: Input} over every route of ``load()``."""
    fs, ws = _tool("flac_stream"), _tool("wv_stream")
    op, vs = _tool("opus_stream"), _tool("vorbis_stream")

    def fixture(name, ext, route, tol):
        return Input((FIXTURES / name).read_bytes(), ext, route, tol)

    return {
        "kitty8_dithered.oga": fixture("kitty8_dithered.oga", "ogg",
                                       "ogg flac", None),
        "flac writer": Input(fs.make_flac_stream(70, 0.5, blocksize=None)[0],
                             "flac", "flac", None),
        "hybrid_stereo.wv": fixture("hybrid_stereo.wv", "wv", "wavpack",
                                    None),
        "dsd_fast.wv": fixture("dsd_fast.wv", "wv", "wavpack", None),
        "dsd_high.wv": fixture("dsd_high.wv", "wv", "wavpack", None),
        "wv writer": Input(ws.make_wv_stream(71, 0.5, "int16_joint",
                                             block_samples=4000), "wv",
                           "wavpack", None),
        "wv writer float": Input(ws.make_wv_stream(72, 0.3, "float32_wvx",
                                                   block_samples=3000), "wv",
                                 "wavpack", None),
        "sv7_stereo.mpc": fixture("sv7_stereo.mpc", "mpc", "musepack", 1e-5),
        "sv8 assembled": Input(
            _streaming_builders().sv8_with_seek_table(11, block_pwr=2,
                                                      n_ap=3),
            "mpc", "musepack", 1e-5),
        "l2_stereo_44k.mp3": fixture("l2_stereo_44k.mp3", "mp3",
                                     "mp3 layer I/II", 1e-5),
        "l1_stereo_44k.mp3": fixture("l1_stereo_44k.mp3", "mp3",
                                     "mp3 layer I/II", 1e-5),
        "ms8ch.opus": Input(
            (FIXTURES / "ms8ch.opus").read_bytes()[:OPUS_CAP], "opus",
            "opus multistream", 1e-4),
        "celt case 0": Input(op.make_case_file(0)[:OPUS_CAP], "opus",
                             "opus celt scan", 1e-4),
        "floor0_mono8k.ogg": fixture("floor0_mono8k.ogg", "ogg", "vorbis",
                                     1e-4),
        "vorbis writer": Input(vs.make_vorbis_stream(73, 0.5), "ogg",
                               "vorbis", 1e-4),
        **_pcm_inputs(np.random.default_rng(74)),
    }


def truncations(data: bytes) -> list:
    """The truncated copies of tests/test_robustness.py and more."""
    n = len(data)
    return [data[: max(4, int(n * frac))] for frac in (0.01, 0.1, 0.45, 0.8)]


def corruptions(data: bytes, seed: int, n: int = 6) -> list:
    """``n`` copies of the first CAP bytes with 8 seeded bytes replaced."""
    data = data[:CAP]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bad = bytearray(data)
        for _ in range(8):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        out.append(bytes(bad))
    return out


def header_flips(data: bytes) -> list:
    """Every eighth byte of the first 96 flipped, one at a time."""
    data = data[:CAP]
    out = []
    for pos in range(0, min(96, len(data)), 8):
        bad = bytearray(data)
        bad[pos] ^= 0xFF
        out.append(bytes(bad))
    return out
