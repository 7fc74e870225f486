"""CELT host half: whole-stream native entropy decode to spectra.

The port's copy of the native-decode subset of the reference package's
CELT module. Everything here is byte-serial, branchy integer work (range
decoding, bit allocation, PVQ index decoding) that runs in C on the host
(``native/celt_bands.c``, ``native/ogg_opus.c``). The outputs are
per-frame denormalised MDCT spectra plus postfilter parameters, which
feed the batched device synthesis (``runtime/opus_pipeline.py``,
``runtime/serving.py``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from ...runtime import native
from .celt_tables import mode48000

COMBFILTER_MINPERIOD = 15


@dataclass
class CeltDecoderState:
    """Decoder state the native stream decode reads and updates in place
    (energy memories and the range-coder seed). A stream needs a fresh
    state: feeding a second stream through a used one decodes it wrong.

    The general path's per-frame decode (``celt_frame.py``) also reads
    the coded channels, the band range and the postfilter parameters
    carried from frame to frame, and loss concealment the pitch and LPC
    it found at the first loss (reference: celt_decoder.c
    last_pitch_index, lpc). The synthesis state (decode history,
    overlap tail, deemphasis memory) lives on the card in ``lane``
    (``runtime/opus_pipeline.py`` ``CeltLane``)."""
    channels: int
    stream_channels: int = 0
    start: int = 0
    end: int = 0
    downsample: int = 1
    rng: int = 0
    oldEBands: np.ndarray = None
    oldLogE: np.ndarray = None
    oldLogE2: np.ndarray = None
    backgroundLogE: np.ndarray = None
    postfilter_period: int = 0
    postfilter_gain: float = 0.0
    postfilter_tapset: int = 0
    postfilter_period_old: int = 0
    postfilter_gain_old: float = 0.0
    postfilter_tapset_old: int = 0
    last_pitch_index: int = 0
    plc_lpc: np.ndarray = None
    lane: object = None

    def __post_init__(self):
        mode = mode48000()
        nb = mode.nbEBands
        if self.stream_channels == 0:
            self.stream_channels = self.channels
        self.end = mode.effEBands
        self.oldEBands = np.zeros((2, nb))
        self.oldLogE = np.full(2 * nb, -28.0)
        self.oldLogE2 = np.full(2 * nb, -28.0)
        self.backgroundLogE = np.zeros(2 * nb)


def _native_celt():
    """The native CELT host library (built on first use; raises)."""
    return native.lib()


_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)
_F32P = ctypes.POINTER(ctypes.c_float)

_MODE_PTRS = {}


def _mode_ptrs(mode):
    """Per-mode ctypes pointers to the static tables (built once; the
    arrays are kept alive in the cache entry)."""
    p = _MODE_PTRS.get(id(mode))
    if p is not None:
        return p
    i16p = ctypes.POINTER(ctypes.c_int16)
    eb = np.ascontiguousarray(mode.eBands, np.int16)
    ln = np.ascontiguousarray(mode.logN, np.int16)
    ci = np.ascontiguousarray(mode.cache_index, np.int16)
    em = np.ascontiguousarray(mode.eMeans, np.float64)
    pmf = np.ascontiguousarray(
        np.asarray(mode.e_prob_model, np.int32).reshape(-1), np.int32)
    p = dict(
        eb=eb, ln=ln, ci=ci, em=em, pmf=pmf,
        cb=np.ascontiguousarray(mode.cache_bits, np.uint8).tobytes(),
        av=np.ascontiguousarray(mode.allocVectors, np.uint8).tobytes(),
        ccaps=np.ascontiguousarray(mode.cache_caps, np.uint8).tobytes(),
        eb_p=eb.ctypes.data_as(i16p),
        ln_p=ln.ctypes.data_as(i16p),
        ci_p=ci.ctypes.data_as(i16p),
        em_p=em.ctypes.data_as(_F64P),
        pmf_p=pmf.ctypes.data_as(_I32P),
    )
    _MODE_PTRS[id(mode)] = p
    return p


def celt_decode_stream_native(
    st: CeltDecoderState, frames, frame_sizes, ends, stream_chs,
):
    """Whole-stream entropy decode: ONE native call for every frame
    (native/celt_bands.c celt_decode_stream, mirroring the per-frame
    orchestration of celt_decoder_clean.c:353-724). Returns the list of
    per-frame info dicts."""
    return _raw_to_infos(
        st, celt_decode_stream_raw(st, frames, frame_sizes, ends,
                                   stream_chs))


def _raw_to_infos(st: CeltDecoderState, raw):
    """Wrap the array-form stream decode into per-frame info dicts (the
    synthesize_stream* input format)."""
    if not raw:
        return []
    freq, fsz, cha, sb, pfp, pfg, pft, sil = raw
    mode = mode48000()
    CC = st.channels
    infos = []
    for i in range(len(fsz)):
        N = int(fsz[i])
        C = int(cha[i])
        LM = (N // mode.shortMdctSize).bit_length() - 1
        infos.append({
            "freq": freq[i, : max(CC, C), :N],
            "N": N,
            "LM": LM,
            "C": C,
            "CC": CC,
            "shortBlocks": int(sb[i]),
            "postfilter_pitch": int(pfp[i]),
            "postfilter_gain": float(pfg[i]),
            "postfilter_tapset": int(pft[i]),
            "silence": int(sil[i]),
        })
    return infos


def celt_scan_ogg_native(data: bytes):
    """Native one-pass Ogg demux + Opus TOC split (native/ogg_opus.c):
    returns (payload, offs, lens, fsz, ends, chs, info) numpy arrays for
    the first CELT-only Opus stream, or None when the stream needs the
    general path (SILK/hybrid packets, multistream mapping, lost pages,
    no Opus stream).

    info: [channels, preskip, input_rate, gain_q8, mapping_family,
    serial, n_packets, last_granule_lo31]."""
    L = _native_celt()
    n = len(data)
    payload = np.empty(n, np.uint8)
    # 1 + n // 8 frames covers 20 ms frames of >= 8 bytes with a big
    # margin, and the scan errors out (-2) rather than overruns.
    cap = 4096 + n // 4
    offs = np.empty(cap, np.int64)
    lens = np.empty(cap, np.int64)
    fsz = np.empty(cap, np.int32)
    ends = np.empty(cap, np.int32)
    chs = np.empty(cap, np.int32)
    info = np.zeros(8, np.int32)
    rc = L.ogg_opus_celt_scan(
        data, n,
        payload.ctypes.data_as(ctypes.c_char_p), n,
        offs.ctypes.data_as(_I64P), lens.ctypes.data_as(_I64P),
        fsz.ctypes.data_as(_I32P), ends.ctypes.data_as(_I32P),
        chs.ctypes.data_as(_I32P), cap, info.ctypes.data_as(_I32P),
    )
    if rc < 0:
        if rc in (-1, -4):
            return None  # not a plain CELT Opus stream: general path
        raise ValueError(f"ogg_opus_celt_scan failed: {rc}")
    k = int(rc)
    return (payload, offs[:k], lens[:k], fsz[:k], ends[:k], chs[:k], info)


def celt_decode_ogg_raw(st: CeltDecoderState, data: bytes):
    """Whole-file fast path: native Ogg scan + native whole-stream CELT
    decode, no per-packet Python. Returns the celt_decode_stream_raw
    tuple plus the scan info array, or None for the general path."""
    scan = celt_scan_ogg_native(data)
    if scan is None:
        return None
    payload, offs, lens, fsz, ends, chs, info = scan
    if st.channels != int(info[0]):
        raise ValueError("decoder channels != OpusHead channels")
    pay_p = payload.ctypes.data_as(ctypes.c_char_p)
    out = _celt_decode_stream_arrays(st, pay_p, offs, lens, fsz, ends, chs)
    del pay_p  # payload kept alive by this frame for the call's duration
    if not out:
        return None
    return out + (info,)


def _celt_decode_stream_arrays(
    st: CeltDecoderState, payload, offs, lens, fsz, enda, cha,
):
    """Array-form core of celt_decode_stream_raw (no Python frame list).
    Updates ``st`` in place."""
    L = _native_celt()
    mode = mode48000()
    nb = mode.nbEBands
    n = len(offs)
    if n == 0:
        return ()
    fsz = np.ascontiguousarray(fsz, np.int32)
    enda = np.ascontiguousarray(enda, np.int32)
    cha = np.ascontiguousarray(cha, np.int32)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    CC = st.channels
    CCout = max(CC, int(cha.max()))
    nmax = int(fsz.max())
    freq = np.zeros((n, CCout, nmax), np.float32)
    sb = np.zeros(n, np.int32)
    pfp = np.zeros(n, np.int32)
    pfg = np.zeros(n, np.float64)
    pft = np.zeros(n, np.int32)
    sil = np.zeros(n, np.int32)
    old = np.ascontiguousarray(st.oldEBands, np.float64)
    ole = np.ascontiguousarray(st.oldLogE, np.float64)
    ole2 = np.ascontiguousarray(st.oldLogE2, np.float64)
    bg = np.ascontiguousarray(st.backgroundLogE, np.float64)
    rng = np.array([st.rng], np.int64)
    mp = _mode_ptrs(mode)

    rc = L.celt_decode_stream(
        payload, offs.ctypes.data_as(_I64P), lens.ctypes.data_as(_I64P),
        fsz.ctypes.data_as(_I32P), enda.ctypes.data_as(_I32P),
        cha.ctypes.data_as(_I32P), n,
        mp["eb_p"], nb, mp["ln_p"], mp["ci_p"], mp["cb"], mp["ccaps"],
        mp["av"], int(mode.nbAllocVectors), mp["em_p"], mp["pmf_p"],
        int(mode.shortMdctSize), int(mode.effEBands),
        old.ctypes.data_as(_F64P), ole.ctypes.data_as(_F64P),
        ole2.ctypes.data_as(_F64P), bg.ctypes.data_as(_F64P),
        rng.ctypes.data_as(_I64P),
        int(CC), int(CCout), int(st.downsample), int(st.start),
        nmax, freq.ctypes.data_as(_F32P),
        sb.ctypes.data_as(_I32P), pfp.ctypes.data_as(_I32P),
        pfg.ctypes.data_as(_F64P), pft.ctypes.data_as(_I32P),
        sil.ctypes.data_as(_I32P),
    )
    if rc != 0:
        raise ValueError(f"celt_decode_stream failed at frame {rc - 1}")
    st.oldEBands[:, :] = old
    st.oldLogE[:] = ole
    st.oldLogE2[:] = ole2
    st.backgroundLogE[:] = bg
    st.rng = int(rng[0])
    return freq, fsz, cha, sb, pfp, pfg, pft, sil


def celt_decode_stream_raw(
    st: CeltDecoderState, frames, frame_sizes, ends, stream_chs,
):
    """celt_decode_stream_native without the per-frame dict layer: returns
    (freq [n, CCout, nmax] float32, frame_sizes, stream_chs, short_blocks,
    pf_pitch, pf_gain, pf_tapset, silence) arrays (empty for no frames).
    The array form feeds the batched serving path with no reshuffling."""
    n = len(frames)
    if n == 0:
        return ()
    payload = b"".join(frames)
    lens = np.fromiter((len(fr) for fr in frames), np.int64, n)
    offs = np.concatenate(([0], np.cumsum(lens[:-1])))
    return _celt_decode_stream_arrays(
        st, payload, offs, lens, frame_sizes, ends, stream_chs)
