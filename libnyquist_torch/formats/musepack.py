"""Musepack decoder: SV8 (MPCK container) and SV7 (MP+).

The libmpcdec decode path (reference: third_party/musepack/libmpcdec):

* container demux (mpc_demux.c:579 mpc_demux_decode_inner: byte-aligned
  tagged blocks, 2^block_pwr frames per AP block, the first a key
  frame), stream headers (streaminfo.c:187 SV8, :108 SV7);
* the frame entropy decode (mpc_decoder.c:499 SV8, :346 SV7) runs in C
  (``native/mpc_frame.c``); there is no Python frame reader;
* requantization (mpc_decoder.c:188: Cc[Res] * SCF per 12-sample third,
  inverse MS) on the host in float64, over all frames at once;
* the 32-band synthesis filter (synth_filter.c:90 mpc_compute_new_V +
  Di_opt windowing) on the device: mpc_compute_new_V is a fixed linear
  map of the 32 subband samples, materialized once as a 64x32 matrix
  (row 16 is zero: the C code never writes V[16]), so a whole stream is
  one product plus a 16-tap sliding combine (``synth_rows``). ``load()``
  runs it in float64, the serving path in float32.

Normative tables (huffman codebooks, Cc/Dc requant constants, Di_opt
window) are data (``data/mpc_tables.npz``). Float build semantics:
MPC_SHL/SHR are no-ops, the MPC_*_CONST macros are plain multiplies
(mpcdec_math.h:120-127), output is -1..1.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading

import numpy as np
import torch

from ..audio_data import AudioData, PCMFormat
from ..errors import DecodeError

_DATA = pathlib.Path(__file__).resolve().parents[1] / "data" / "mpc_tables.npz"

FRAME_LENGTH = 36 * 32  # samples per mpc frame (mpcdec.h:50)
SYNTH_DELAY = 481       # mpcdec.h:52

_SAMPLE_FREQS = [44100, 48000, 37800, 32000, 0, 0, 0, 0]


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

class _Can:
    """Canonical-huffman table: sorted (code, length, value) rows + symbol
    map (mpc_bits_reader.h:80 mpc_bits_can_dec)."""

    __slots__ = ("rows", "sym")

    def __init__(self, rows: np.ndarray, sym: np.ndarray):
        self.rows = [(int(c), int(l), int(v)) for c, l, v in rows]
        self.sym = [int(s) for s in sym]


@functools.lru_cache(maxsize=1)
def _load_tables() -> dict:
    z = np.load(_DATA)

    def can(name):
        return _Can(z[f"huff_mpc_huff_{name}"], z[f"sym_mpc_sym_{name}"])

    t = {
        "Bands": can("Bands"),
        "SCFI": [can("SCFI_1"), can("SCFI_2")],
        "DSCF": [can("DSCF_1"), can("DSCF_2")],
        "Res": [can("Res_1"), can("Res_2")],
        "Q1": can("Q1"),
        "Q9up": can("Q9up"),
        "Q": [
            [can("Q2_1"), can("Q2_2")],
            [can("Q3"), can("Q4")],
            [can("Q5_1"), can("Q5_2")],
            [can("Q6_1"), can("Q6_2")],
            [can("Q7_1"), can("Q7_2")],
            [can("Q8_1"), can("Q8_2")],
        ],
    }
    # __Cc is stored /2^14 by the extractor (fixed-point form); the float
    # build uses the raw constants (MAKE_MPC_SAMPLE_EX is identity).
    t["Cc"] = (z["Cc"] * float(1 << 14)).tolist()   # index by Res+1
    t["Dc"] = z["Dc"].tolist()                       # index by Res+1
    t["Res_bit"] = z["Res_bit"].tolist()             # index by Res (SV7)
    t["Di"] = np.asarray(z["Di_opt"], np.float64)    # [32][16], /65536 baked

    # SV7 lut-style tables (huffman.c mpc_table_*): rows of
    # (Code, Length, Value), decoded by first-row-with-peek>=Code scan
    # (mpc_bits_reader.h:67 mpc_bits_huff_dec).
    def lut(name):
        rows = z[f"huff_mpc_table_{name}"]
        if rows.ndim == 3:
            return [[(int(c), int(l), int(v)) for c, l, v in tab]
                    for tab in rows]
        return [(int(c), int(l), int(v)) for c, l, v in rows]

    t["Hdr7"] = lut("HuffHdr")
    t["SCFI7"] = lut("HuffSCFI")
    t["DSCF7"] = lut("HuffDSCF")
    t["Q7"] = [lut(f"HuffQ{i}") for i in range(1, 8)]
    return t


# ---------------------------------------------------------------------------
# the native frame reader (native/mpc_frame.c)
# ---------------------------------------------------------------------------
_NATIVE_LOCK = threading.Lock()
_NATIVE_MPC = None


def _native_mpc():
    """(library, table blobs): mpc_set_tables writes C globals, so it runs
    once, under a lock; the blobs stay alive with the library handle."""
    global _NATIVE_MPC
    with _NATIVE_LOCK:
        if _NATIVE_MPC is not None:
            return _NATIVE_MPC
        from ..runtime.native import codec_lib

        L = codec_lib()
        T = _load_tables()
        cans = [T["Bands"], T["SCFI"][0], T["SCFI"][1], T["DSCF"][0],
                T["DSCF"][1], T["Res"][0], T["Res"][1], T["Q1"], T["Q9up"],
                T["Q"][0][0], T["Q"][0][1], T["Q"][1][0], T["Q"][1][1],
                T["Q"][2][0], T["Q"][2][1], T["Q"][3][0], T["Q"][3][1],
                T["Q"][4][0], T["Q"][4][1], T["Q"][5][0], T["Q"][5][1]]
        luts = [T["Hdr7"], T["SCFI7"], T["DSCF7"]]
        for pair in T["Q7"]:
            luts.extend(pair)

        can_rows, can_syms, can_meta = [], [], []
        row_off = sym_off = 0
        for c in cans:
            can_meta.extend([row_off, len(c.rows), sym_off])
            can_rows.append(np.asarray(c.rows, np.int32).reshape(-1, 3))
            can_syms.append(np.asarray(c.sym, np.int8))
            row_off += len(c.rows)
            sym_off += len(c.sym)
        lut_rows, lut_meta = [], []
        row_off = 0
        for rows in luts:
            lut_meta.extend([row_off, len(rows)])
            lut_rows.append(np.asarray(rows, np.int32).reshape(-1, 3))
            row_off += len(rows)

        keep = dict(
            can_rows=np.concatenate(can_rows).astype(np.int32),
            can_syms=np.concatenate(can_syms).astype(np.int8),
            can_meta=np.asarray(can_meta, np.int64),
            lut_rows=np.concatenate(lut_rows).astype(np.int32),
            lut_meta=np.asarray(lut_meta, np.int64),
            dc=np.asarray(T["Dc"], np.int32),
            res_bit=np.asarray(T["Res_bit"], np.int32),
        )
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        L.mpc_set_tables(
            keep["can_rows"].ctypes.data_as(i32p),
            keep["can_syms"].ctypes.data_as(ctypes.c_char_p),
            keep["can_meta"].ctypes.data_as(i64p),
            keep["lut_rows"].ctypes.data_as(i32p),
            keep["lut_meta"].ctypes.data_as(i64p),
            keep["dc"].ctypes.data_as(i32p),
            keep["res_bit"].ctypes.data_as(i32p),
        )
        _NATIVE_MPC = (L, keep)
        return _NATIVE_MPC


# SCF factor table (requant.c:95 mpc_decoder_scale_output with
# scale_factor=1, float mode: factor = 1/2^(16-1)).
def _build_scf() -> np.ndarray:
    scf = np.zeros(256, np.float64)
    factor = 1.0 / 32768.0
    scf[1] = factor
    f1 = factor * 0.83298066476582673961
    f2 = factor / 0.83298066476582673961
    for n in range(1, 129):
        scf[(1 + n) & 0xFF] = np.float32(f1)
        scf[(1 - n) & 0xFF] = np.float32(f2)
        f1 *= 0.83298066476582673961
        f2 /= 0.83298066476582673961
    scf[1] = np.float32(factor)
    return scf


_SCF = _build_scf()


# ---------------------------------------------------------------------------
# bit reader
# ---------------------------------------------------------------------------

class _Bits:
    """MSB-first bit reader; peeks past the end read as zero bits (the
    buffer carries 8 zero bytes, which the native reader relies on)."""

    __slots__ = ("buf", "pos", "limit")

    def __init__(self, buf: bytes):
        self.buf = buf + b"\x00" * 8
        self.pos = 0
        self.limit = len(buf) * 8

    def read(self, n: int) -> int:
        if n <= 0:
            return 0
        p = self.pos
        self.pos = p + n
        first = p >> 3
        last = (p + n - 1) >> 3
        chunk = int.from_bytes(self.buf[first : last + 1], "big")
        chunk >>= ((last + 1) << 3) - (p + n)
        return chunk & ((1 << n) - 1)


# ---------------------------------------------------------------------------
# synthesis filter as a 64x32 matrix (mpc_compute_new_V is linear)
# ---------------------------------------------------------------------------

def _compute_new_v(s: np.ndarray) -> np.ndarray:
    """Float transcription of synth_filter.c:90 mpc_compute_new_V."""
    v = np.zeros(64, np.float64)
    a = [s[i] + s[31 - i] for i in range(16)]
    b = [0.0] * 16
    for i in range(8):
        b[i] = a[i] + a[15 - i]
    consts1 = [0.5024192929, 0.5224986076, 0.5669440627, 0.6468217969,
               0.7881546021, 1.0606776476, 1.7224471569, 5.1011486053]
    for i in range(8):
        b[8 + i] = (a[i] - a[15 - i]) * consts1[i]
    consts2 = [0.5097956061, 0.6013448834, 0.8999761939, 2.5629155636]
    a = [0.0] * 16
    for i in range(4):
        a[i] = b[i] + b[7 - i]
        a[4 + i] = (b[i] - b[7 - i]) * consts2[i]
        a[8 + i] = b[8 + i] + b[15 - i]
        a[12 + i] = (b[8 + i] - b[15 - i]) * consts2[i]
    b = [0.0] * 16
    for g in range(4):
        b[4 * g + 0] = a[4 * g] + a[4 * g + 3]
        b[4 * g + 1] = a[4 * g + 1] + a[4 * g + 2]
        b[4 * g + 2] = (a[4 * g] - a[4 * g + 3]) * 0.5411961079
        b[4 * g + 3] = (a[4 * g + 1] - a[4 * g + 2]) * 1.3065630198
    a = [0.0] * 16
    for g in range(8):
        a[2 * g] = b[2 * g] + b[2 * g + 1]
        a[2 * g + 1] = (b[2 * g] - b[2 * g + 1]) * 0.7071067691

    v[48] = -a[0]
    v[0] = a[1]
    v[8] = a[3]
    v[40] = -a[2] - v[8]
    v[12] = a[7]
    v[4] = a[5] + v[12]
    v[36] = -(v[4] + a[6])
    v[44] = -a[4] - a[6] - a[7]
    v[14] = a[15]
    v[10] = a[11] + v[14]
    v[6] = v[10] + a[13]
    v[2] = a[9] + a[13] + a[15]
    v[34] = -v[2] - a[14]
    v[38] = v[34] + a[9] - a[10] - a[11]
    tmp = -(a[12] + a[14] + a[15])
    v[46] = tmp - a[8]
    v[42] = tmp - a[10] - a[11]

    consts0 = [0.5006030202, 0.5054709315, 0.5154473186, 0.5310425758,
               0.5531039238, 0.5829349756, 0.6225041151, 0.6748083234,
               0.7445362806, 0.8393496275, 0.9725682139, 1.1694399118,
               1.4841645956, 2.0577809811, 3.4076085091, 10.1900081635]
    a = [(s[i] - s[31 - i]) * consts0[i] for i in range(16)]
    b = [0.0] * 16
    for i in range(8):
        b[i] = a[i] + a[15 - i]
        b[8 + i] = (a[i] - a[15 - i]) * consts1[i]
    a = [0.0] * 16
    for i in range(4):
        a[i] = b[i] + b[7 - i]
        a[4 + i] = (b[i] - b[7 - i]) * consts2[i]
        a[8 + i] = b[8 + i] + b[15 - i]
        a[12 + i] = (b[8 + i] - b[15 - i]) * consts2[i]
    b = [0.0] * 16
    for g in range(4):
        b[4 * g + 0] = a[4 * g] + a[4 * g + 3]
        b[4 * g + 1] = a[4 * g + 1] + a[4 * g + 2]
        b[4 * g + 2] = (a[4 * g] - a[4 * g + 3]) * 0.5411961079
        b[4 * g + 3] = (a[4 * g + 1] - a[4 * g + 2]) * 1.3065630198
    a = [0.0] * 16
    for g in range(8):
        a[2 * g] = b[2 * g] + b[2 * g + 1]
        a[2 * g + 1] = (b[2 * g] - b[2 * g + 1]) * 0.7071067691

    v[15] = a[15]
    v[13] = a[7] + v[15]
    v[11] = v[13] + a[11]
    v[5] = v[11] + a[5] + a[13]
    v[9] = a[3] + a[11] + a[15]
    v[7] = v[9] + a[13]
    v[1] = a[1] + a[9] + a[13] + a[15]
    v[33] = -v[1] - a[14]
    v[3] = a[5] + a[7] + a[9] + a[13] + a[15]
    v[35] = -v[3] - a[6] - a[14]
    tmp = -(a[10] + a[11] + a[13] + a[14] + a[15])
    v[37] = tmp - a[5] - a[6] - a[7]
    v[39] = tmp - a[2] - a[3]
    tmp += a[13] - a[12]
    v[41] = tmp - a[2] - a[3]
    v[43] = tmp - a[4] - a[6] - a[7]
    tmp2 = -(a[8] + a[12] + a[14] + a[15])
    v[47] = tmp2 - a[0]
    v[45] = tmp2 - a[4] - a[6] - a[7]

    # mirrors (synth_filter.c:297-328); v[16] is never written and stays 0
    for i in range(17, 33):
        v[i] = -v[32 - i]
    for i in range(49, 64):
        v[i] = v[96 - i]
    return v


@functools.lru_cache(maxsize=1)
def _build_synth_matrix() -> np.ndarray:
    """mpc_compute_new_V as a [64, 32] float64 matrix."""
    m = np.zeros((64, 32), np.float64)
    for i in range(32):
        e = np.zeros(32, np.float64)
        e[i] = 1.0
        m[:, i] = _compute_new_v(e)
    m.setflags(write=False)
    return m


def _synth_stream(Y: np.ndarray) -> np.ndarray:
    """The plain version: Y [T, 32] requantized rows in time order ->
    [T, 32] pcm in float64, zero initial V state.

    Equivalent to running synth_filter.c frame by frame: step t's V block
    only feeds steps t..t+15, so the sliding read collapses to one
    product plus a 16-tap combine over the block sequence whose tap
    columns are fixed slices (even taps read V[k], odd taps V[k + 32])."""
    T = Y.shape[0]
    blocks = Y @ _build_synth_matrix().T                 # [T, 64]
    bpad = np.vstack([np.zeros((15, 64), blocks.dtype), blocks])
    di = _load_tables()["Di"]                            # [32, 16]
    a = bpad[:, :32]
    b = bpad[:, 32:64]
    out = np.zeros((T, 32), np.float64)
    for j in range(0, 16, 2):
        out += a[15 - j : 15 - j + T] * di[:, j]
        out += b[14 - j : 14 - j + T] * di[:, j + 1]
    return out


@functools.lru_cache(maxsize=8)
def _synth_consts(device: torch.device, dtype: torch.dtype):
    return (torch.tensor(_build_synth_matrix().T, dtype=dtype, device=device),
            torch.tensor(_load_tables()["Di"], dtype=dtype, device=device))


def synth_rows(ys: torch.Tensor) -> torch.Tensor:
    """The synthesis on ys's device in ys's dtype: [R, T, 32] requantized
    rows of R stream-channels -> [R, T * 32] pcm, zero initial V state.
    One [R*T, 32] @ [32, 64] product, then the 16-tap sliding combine of
    ``_synth_stream``, batched over rows."""
    R, T, _ = ys.shape
    Mt, di = _synth_consts(ys.device, ys.dtype)
    blocks = ys @ Mt                                     # [R, T, 64]
    bpad = torch.cat([blocks.new_zeros(R, 15, 64), blocks], dim=1)
    del blocks
    a = bpad[:, :, :32]
    b = bpad[:, :, 32:64]
    out = ys.new_zeros(R, T, 32)
    for j in range(0, 16, 2):
        out += a[:, 15 - j : 15 - j + T] * di[:, j]
        out += b[:, 14 - j : 14 - j + T] * di[:, j + 1]
    return out.reshape(R, T * 32)


# ---------------------------------------------------------------------------
# frame decoder state
# ---------------------------------------------------------------------------

class MusepackDecoder:
    """Frame decoder state (mirrors struct mpc_decoder, decoder.h:60); the
    frame reads run in native/mpc_frame.c on these arrays."""

    def __init__(self, max_band: int, ms: bool, channels: int):
        self.max_band = max_band
        self.ms = ms
        self.channels = channels
        self.last_max_band = 0
        self.res = [np.zeros(32, np.int32), np.zeros(32, np.int32)]
        self.scfi = [np.zeros(32, np.int32), np.zeros(32, np.int32)]
        self.scf_index = [np.zeros((32, 3), np.int32),
                          np.zeros((32, 3), np.int32)]
        self.dscf_flag = [np.ones(32, np.int32), np.ones(32, np.int32)]
        self.ms_flag = np.zeros(32, np.int32)
        self.q = [np.zeros((32, 36), np.int32), np.zeros((32, 36), np.int32)]
        self.r1 = 1         # random generator state (synth_filter.c:414)
        self.r2 = 1
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._io = np.zeros(4, np.int64)
        self._io_p = self._io.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        self._ptrs = tuple(a.ctypes.data_as(i32p) for a in (
            self.res[0], self.res[1], self.scfi[0], self.scfi[1],
            self.scf_index[0], self.scf_index[1], self.dscf_flag[0],
            self.dscf_flag[1], self.ms_flag, self.q[0], self.q[1]))

    def _io_in(self, br: _Bits) -> None:
        self._io[:] = (br.pos, self.r1, self.r2, self.last_max_band)

    def _io_out(self, br: _Bits, rc: int) -> None:
        if rc < 0:
            raise DecodeError("mpc: bad huffman code")
        br.pos, self.r1, self.r2, self.last_max_band = (
            int(v) for v in self._io)

    def _native_read(self, br: _Bits, is_key_frame: bool, sv7: bool) -> None:
        """One frame's entropy decode in C, into the state arrays."""
        L = _native_mpc()[0]
        self._io_in(br)
        rc = L.mpc_read_frame(
            br.buf, len(br.buf), self._io_p, int(sv7), int(is_key_frame),
            int(self.max_band), int(self.ms), *self._ptrs)
        self._io_out(br, rc)

    def read_block_native(self, br: _Bits, n_frames: int, key_first: bool):
        """Decode n_frames SV8 frames in one native call; returns per-frame
        (q, res, scf, ms) snapshot arrays for batched requantization."""
        L = _native_mpc()[0]
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._io_in(br)
        q = np.empty((n_frames, 2, 32, 36), np.int32)
        res = np.empty((n_frames, 2, 32), np.int32)
        scf = np.empty((n_frames, 2, 32, 3), np.int32)
        msf = np.empty((n_frames, 32), np.int32)
        rc = L.mpc_read_frames_sv8(
            br.buf, len(br.buf), self._io_p, int(n_frames),
            int(bool(key_first)), int(self.max_band), int(self.ms),
            *self._ptrs, q.ctypes.data_as(i32p), res.ctypes.data_as(i32p),
            scf.ctypes.data_as(i32p), msf.ctypes.data_as(i32p))
        self._io_out(br, rc)
        return q, res, scf, msf

    def read_frame_sv7(self, br: _Bits) -> None:
        """mpc_decoder.c:346 mpc_decoder_read_bitstream_sv7."""
        self._native_read(br, False, sv7=True)

    def requantize(self) -> tuple[np.ndarray, np.ndarray]:
        """mpc_decoder.c:188 mpc_decoder_requantisierung -> Y_L, Y_R
        [36,32] float64 (vectorized over bands; same per-element math)."""
        nb = self.max_band + 1
        cc = np.asarray(_load_tables()["Cc"], np.float64)
        q = np.stack([self.q[0][:nb], self.q[1][:nb]]).astype(np.float64)
        res = np.stack([self.res[0][:nb], self.res[1][:nb]]).astype(np.int64)
        scf = np.stack([self.scf_index[0][:nb],
                        self.scf_index[1][:nb]]) & 0xFF
        fac = cc[res + 1][..., None] * _SCF[scf]          # [2, nb, 3]
        v = np.repeat(fac, 12, axis=2) * q                # [2, nb, 36]
        v *= (res != 0)[..., None]
        ms = self.ms_flag[:nb].astype(bool)[:, None]
        yl = np.zeros((36, 32), np.float64)
        yr = np.zeros((36, 32), np.float64)
        yl[:, :nb] = np.where(ms, v[0] + v[1], v[0]).T
        yr[:, :nb] = np.where(ms, v[0] - v[1], v[1]).T
        return yl, yr


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------

def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    size = 0
    while True:
        if pos >= len(data):
            raise DecodeError("mpc: truncated varint")
        b = data[pos]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not (b & 0x80):
            return size, pos


def _requantize_batch(q, res, scf, msf, max_band):
    """Vectorized requantize over all frames at once: q [F,2,32,36],
    res [F,2,32], scf [F,2,32,3], msf [F,32] -> (YL, YR) [F,36,32]."""
    F = q.shape[0]
    nb = max_band + 1
    cc = np.asarray(_load_tables()["Cc"], np.float64)
    qq = q[:, :, :nb].astype(np.float64)
    rr = res[:, :, :nb].astype(np.int64)
    sc = scf[:, :, :nb] & 0xFF
    fac = cc[rr + 1][..., None] * _SCF[sc]             # [F,2,nb,3]
    v = np.repeat(fac, 12, axis=3) * qq                # [F,2,nb,36]
    v *= (rr != 0)[..., None]
    ms_b = msf[:, None, :nb].astype(bool)              # [F,1,nb]
    v0 = v[:, 0].transpose(0, 2, 1)                    # [F,36,nb]
    v1 = v[:, 1].transpose(0, 2, 1)
    YL = np.zeros((F, 36, 32), np.float64)
    YR = np.zeros((F, 36, 32), np.float64)
    YL[:, :, :nb] = np.where(ms_b, v0 + v1, v0)
    YR[:, :, :nb] = np.where(ms_b, v0 - v1, v1)
    return YL, YR


def _rows(ys, max_band: int, channels: int) -> np.ndarray:
    """The requantized rows of a stream, [channels, F * 36, 32] float64.
    ys entries are (yl, yr) pairs (SV7, per-frame requantize) or raw
    (q, res, scf, ms) snapshots (SV8 block decode), which requantize here
    in one pass."""
    F = len(ys)
    if ys and len(ys[0]) == 4:
        YL, YR = _requantize_batch(*(np.stack([y[i] for y in ys])
                                     for i in range(4)), max_band)
    else:
        YL = np.stack([y[0] for y in ys]).reshape(F, 36, 32)
        YR = np.stack([y[1] for y in ys]).reshape(F, 36, 32)
    Y = np.stack([YL, YR])[:channels]
    return Y.reshape(channels, F * 36, 32)


def _finish_batched(audio: AudioData, ys, spans, dec, channels,
                    sample_rate, device) -> None:
    """Run the whole-stream synthesis on ``device`` in float64 and
    assemble the trimmed pcm (one copy back to the host)."""
    chunks: list[np.ndarray] = []
    if ys:
        F = len(ys)
        Y = torch.from_numpy(_rows(ys, dec.max_band, channels)).to(device)
        pcm = synth_rows(Y)                              # [C, F * 1152]
        frames = (pcm.reshape(channels, F, FRAME_LENGTH).permute(1, 2, 0)
                  .reshape(F, FRAME_LENGTH * channels).cpu().numpy())
        for fidx, start, stop in spans:
            chunks.append(frames[fidx][start * channels : stop * channels])
    _finish(audio, chunks, channels, sample_rate)


def _finish(audio: AudioData, chunks, channels, sample_rate) -> None:
    pcm = (np.concatenate(chunks) if chunks
           else np.zeros(0, np.float64)).astype(np.float32)
    audio.samples = pcm
    audio.channel_count = channels
    audio.sample_rate = sample_rate
    audio.source_format = PCMFormat.PCM_16
    audio.length_seconds = (
        len(pcm) / channels / sample_rate if sample_rate else 0.0
    )


def _span(samples_left, samples_to_skip):
    """(n_out, start, samples_to_skip') of one decoded frame."""
    n_out = min(max(samples_left, 0), FRAME_LENGTH)
    start = 0
    if samples_to_skip:
        if n_out <= samples_to_skip:
            samples_to_skip -= n_out
            n_out = 0
        else:
            n_out -= samples_to_skip
            start = samples_to_skip
            samples_to_skip = 0
    return n_out, start, samples_to_skip


def _decode_sv7(data: bytes):
    """SV7 stream (streaminfo.c:108 read_header_sv7, mpc_demux.c:621
    20-bit frame sizes, mpc_decoder.c:162 last-frame length fixup).
    The payload is byte-swapped 32-bit words (MPC_BUFFER_SWAP).
    Returns (ys, spans, decoder, channels, sample_rate)."""
    if (data[3] & 15) != 7:
        raise DecodeError(f"unsupported MPC SV{data[3] & 15} stream")
    body = data[4:]
    body += b"\x00" * ((-len(body)) % 4)
    arr = np.frombuffer(body, np.uint8).reshape(-1, 4)[:, ::-1]
    br = _Bits(arr.tobytes())

    frames = (br.read(16) << 16) | br.read(16)
    br.read(1)  # intensity stereo (should be 0)
    ms = bool(br.read(1))
    max_band = br.read(6)
    if max_band > 31:
        # the state arrays are 32 bands wide; corrupt headers can encode
        # up to 63
        raise DecodeError("mpc: max_band out of range")
    br.read(4)  # profile
    br.read(2)  # link
    sample_rate = _SAMPLE_FREQS[br.read(2)]
    for _ in range(5):
        br.read(16)  # peak/gain fields
    is_true_gapless = br.read(1)
    last_frame_samples = br.read(11)
    br.read(1)  # fast seek
    br.read(19)
    br.read(8)  # encoder version
    channels = 2

    if last_frame_samples == 0:
        last_frame_samples = FRAME_LENGTH
    si_samples = frames * FRAME_LENGTH
    if is_true_gapless:
        si_samples -= FRAME_LENGTH - last_frame_samples
    else:
        si_samples -= SYNTH_DELAY

    # mpc_decoder_set_streaminfo (mpc_decoder.c:102)
    if is_true_gapless:
        d_samples = ((si_samples + FRAME_LENGTH - 1)
                     // FRAME_LENGTH) * FRAME_LENGTH
    else:
        d_samples = si_samples
    samples_to_skip = SYNTH_DELAY

    dec = MusepackDecoder(max_band, ms, channels)
    decoded = 0
    ys: list = []
    spans: list = []
    while decoded < d_samples and br.pos + 20 <= br.limit:
        br.read(20)  # frame bit size (trusted; consistency not enforced)
        samples_left = d_samples - decoded + SYNTH_DELAY
        if samples_left <= 0 and d_samples != 0:
            break
        dec.read_frame_sv7(br)
        fidx = None
        if samples_to_skip < FRAME_LENGTH + SYNTH_DELAY:
            fidx = len(ys)
            ys.append(dec.requantize())
        decoded += FRAME_LENGTH
        # C compares uint64: true only once decoded >= samples (last frame)
        if 0 <= decoded - d_samples < FRAME_LENGTH:
            lfs = br.read(11)
            if decoded == d_samples:
                if lfs == 0:
                    lfs = FRAME_LENGTH
                d_samples += lfs - FRAME_LENGTH
                samples_left += lfs - FRAME_LENGTH
        n_out, start, samples_to_skip = _span(samples_left, samples_to_skip)
        if n_out and fidx is not None:
            spans.append((fidx, start, start + n_out))
        if br.pos > br.limit:
            raise DecodeError("MPC SV7 bitstream overrun")
    return ys, spans, dec, channels, sample_rate


def _decode_sv8(data: bytes):
    """SV8 stream (MPCK): tagged blocks, native block decode per AP block.
    Returns (ys, spans, decoder, channels, sample_rate)."""
    pos = 4
    dec = None
    sample_rate = channels = 0
    block_pwr = samples_to_skip = decoded_samples = stream_samples = 0
    ys: list = []
    spans: list = []
    done = False

    while pos + 3 <= len(data) and not done:
        key = data[pos : pos + 2]
        size, hdr_end = _read_varint(data, pos + 2)
        if size < hdr_end - pos:
            # block size includes its own header: anything smaller
            # (notably 0 from a corrupt varint) cannot advance
            raise DecodeError("mpc: bad block size")
        body = data[hdr_end : pos + size]
        pos += size

        if key == b"SH":
            # streaminfo.c:187 streaminfo_read_header_sv8
            br = _Bits(body)
            br.read(32)  # CRC (not verified)
            version = br.read(8)
            if version != 8:
                raise DecodeError(f"unsupported MPC stream version {version}")
            total_samples, p = _read_varint(body, (br.pos // 8))
            beg_silence, p = _read_varint(body, p)
            br.pos = p * 8
            sample_rate = _SAMPLE_FREQS[br.read(3)]
            max_band = br.read(5) + 1
            if max_band > 31:
                raise DecodeError("mpc: max_band out of range")
            channels = br.read(4) + 1
            ms = bool(br.read(1))
            block_pwr = br.read(3) * 2
            dec = MusepackDecoder(max_band, ms, channels)
            samples_to_skip = SYNTH_DELAY + beg_silence
            stream_samples = total_samples
        elif key == b"AP":
            if dec is None:
                raise DecodeError("MPC audio block before stream header")
            br = _Bits(body)
            n_block = 1 << block_pwr
            n_eff = n_block
            if stream_samples:
                rem = stream_samples - decoded_samples + SYNTH_DELAY
                n_eff = min(n_block, -(-rem // FRAME_LENGTH)) if rem > 0 else 0
            if n_eff == 0:
                done = True
                continue
            q_s, res_s, scf_s, ms_s = dec.read_block_native(br, n_eff, True)
            for f in range(n_eff):
                samples_left = stream_samples - decoded_samples + SYNTH_DELAY
                fidx = None
                if samples_to_skip < FRAME_LENGTH + SYNTH_DELAY:
                    fidx = len(ys)
                    ys.append((q_s[f], res_s[f], scf_s[f], ms_s[f]))
                decoded_samples += FRAME_LENGTH
                n_out, start, samples_to_skip = _span(samples_left,
                                                      samples_to_skip)
                if n_out and fidx is not None:
                    spans.append((fidx, start, start + n_out))
            if br.pos > br.limit:
                raise DecodeError("MPC bitstream overrun")
            if n_eff < n_block:
                done = True
        elif key == b"SE":
            done = True
        # other blocks (RG, EI, ST, SO, CT) are metadata: skipped

    if dec is None:
        raise DecodeError("no MPC stream header found")
    return ys, spans, dec, channels, sample_rate


def _decode_entropy(data: bytes):
    if data[:4] == b"MPCK":
        return _decode_sv8(data)
    if data[:3] == b"MP+":
        return _decode_sv7(data)
    raise DecodeError("bad musepack magic")


def requantized_rows(data: bytes):
    """The host half of a Musepack stream: (rows [channels, F * 36, 32]
    float64, channels, sample_rate), the input of the serving path's
    ``runtime.serving.synthesize_mpc_streams``."""
    ys, _, dec, channels, rate = _decode_entropy(data)
    if not ys:
        raise DecodeError("no MPC frames decoded")
    return _rows(ys, dec.max_band, channels), channels, rate


def decode_musepack_buffer(data: bytes, audio: AudioData, device) -> None:
    """Decode a whole SV7 or SV8 stream into ``audio``: host entropy
    decode and requantization, then the synthesis on ``device``."""
    ys, spans, dec, channels, rate = _decode_entropy(data)
    _finish_batched(audio, ys, spans, dec, channels, rate, device)
