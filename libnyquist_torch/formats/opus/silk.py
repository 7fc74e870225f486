"""SILK decoder (host side): the native fixed-point decode to 48 kHz int16.

The SILK half of SILK-only and hybrid Opus frames and its loss
concealment run in C (``native/silk_dec.c``, in ``libcelthost.so``;
reference: silk/ dec_API.c, decode_frame.c, decode_core.c, PLC.c,
CNG.c). SILK is specified in integer arithmetic, so the decode is
bit-exact with the reference. Only the range decoder's state crosses
the boundary (``celt_frame.ec_pack``); the decoder state lives behind an
opaque C handle. The port keeps no Python SILK decoder: in-band FEC
(which needs one) is a ROADMAP.md item.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ...errors import DecodeError
from ...runtime import native
from . import silk_tables as ST
from .celt_frame import ec_pack, ec_unpack

_NATIVE = None          # (lib, keepalive-dict) once initialised
_LOCK = threading.Lock()
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I16P = ctypes.POINTER(ctypes.c_int16)

# Table order contracts with native/silk_dec.c (enum TU8_* / T32_*).
_U8_TABLES = [
    "type_offset_VAD_iCDF", "type_offset_no_VAD_iCDF", "gain_iCDF",
    "delta_gain_iCDF", "uniform3_iCDF", "uniform4_iCDF", "uniform5_iCDF",
    "uniform6_iCDF", "uniform8_iCDF", "NLSF_interp_iCDF", "NLSF_EXT_iCDF",
    "pitch_delta_iCDF", "pitch_lag_iCDF", "pitch_contour_iCDF",
    "pitch_contour_10ms_iCDF", "pitch_contour_NB_iCDF",
    "pitch_contour_10ms_NB_iCDF", "LTP_per_index_iCDF",
    "LTP_gain_iCDF_0", "LTP_gain_iCDF_1", "LTP_gain_iCDF_2",
    "LTPscale_iCDF", "LBRR_flags_2_iCDF", "LBRR_flags_3_iCDF",
    "rate_levels_iCDF", "pulses_per_block_iCDF", "lsb_iCDF", "sign_iCDF",
    "shell_code_table0", "shell_code_table1", "shell_code_table2",
    "shell_code_table3", "stereo_pred_joint_iCDF",
    "stereo_only_code_mid_iCDF",
]
_I32_TABLES = [
    "LTPScales_table_Q14", "LTP_vq_Q7_0", "LTP_vq_Q7_1", "LTP_vq_Q7_2",
    "CB_lags_stage2", "CB_lags_stage2_10ms", "CB_lags_stage3",
    "CB_lags_stage3_10ms", "Quantization_Offsets_Q10",
    "stereo_pred_quant_Q13", "LSFCosTab_FIX_Q12",
]


def _native_silk():
    """The host library with the normative tables handed over once
    (locked: silk_set_tables writes C globals)."""
    global _NATIVE
    with _LOCK:
        if _NATIVE is not None:
            return _NATIVE
        L = native.lib()
        t = ST.tables()
        u8_parts = [np.ascontiguousarray(t[n], np.uint8).ravel()
                    for n in _U8_TABLES]
        cbs = (ST.nlsf_cb_wb(), ST.nlsf_cb_nb_mb())
        for cb in cbs:
            u8_parts.append(np.ascontiguousarray(cb.CB1_iCDF, np.uint8).ravel())
            u8_parts.append(np.ascontiguousarray(cb.ec_iCDF, np.uint8).ravel())
        i32_parts = [np.ascontiguousarray(t[n], np.int32).ravel()
                     for n in _I32_TABLES]
        for cb in cbs:
            i32_parts.append(np.array(
                [cb.nVectors, cb.order, cb.quantStepSize_Q16,
                 cb.invQuantStepSize_Q6], np.int32))
            for a in (cb.CB1_NLSF_Q8, cb.pred_Q8, cb.ec_sel,
                      cb.deltaMin_Q15):
                i32_parts.append(np.ascontiguousarray(a, np.int32).ravel())
        for n in ("shell_code_table_offsets", "resampler_up2_hq_0",
                  "resampler_up2_hq_1", "resampler_frac_FIR_12"):
            i32_parts.append(np.ascontiguousarray(t[n], np.int32).ravel())

        def blob(parts, dtype):
            offs = np.cumsum([0] + [p.size for p in parts[:-1]])
            return (np.concatenate(parts).astype(dtype),
                    np.asarray(offs, np.int64))

        u8_blob, u8_offs = blob(u8_parts, np.uint8)
        i32_blob, i32_offs = blob(i32_parts, np.int32)
        L.silk_set_tables(
            u8_blob.ctypes.data_as(ctypes.c_char_p),
            u8_offs.ctypes.data_as(_I64P), len(u8_parts),
            i32_blob.ctypes.data_as(_I32P),
            i32_offs.ctypes.data_as(_I64P), len(i32_parts),
        )
        # The C side keeps raw pointers: the blobs must outlive the library.
        _NATIVE = (L, dict(u8=u8_blob, i32=i32_blob,
                           u8o=u8_offs, i32o=i32_offs))
        return _NATIVE


class NativeSilkDecoder:
    """One stream's SILK decoder state behind a native handle."""

    def __init__(self, channels: int):
        self._L = _native_silk()[0]
        self.nChannelsAPI = channels
        self._h = self._L.silk_create(channels)
        if not self._h:
            raise MemoryError("silk_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._L.silk_free(h)
            self._h = None

    def decode(self, dec, n_channels_internal, internal_rate, payload_ms):
        """Decode the SILK frames of one Opus frame from the shared range
        decoder ``dec`` (advanced in place). Returns int16-valued float64
        [samples, channels] at 48 kHz."""
        ch = self.nChannelsAPI
        out = np.zeros(payload_ms * 48 * ch, np.int16)
        ec = ec_pack(dec)
        n = self._L.silk_decode(
            self._h, dec.buf, dec.storage, ec.ctypes.data_as(_I64P),
            int(n_channels_internal), int(internal_rate), int(payload_ms),
            out.ctypes.data_as(_I16P),
        )
        if n < 0:
            raise DecodeError("native SILK decode failed")
        ec_unpack(dec, ec)
        return out[: n * ch].reshape(n, ch).astype(np.float64)

    def conceal(self, n_channels_internal, internal_rate, payload_ms):
        """Concealment for one lost packet duration (reference silk/PLC.c
        + CNG.c); the caller passes the last good packet's
        configuration."""
        ch = self.nChannelsAPI
        out = np.zeros(payload_ms * 48 * ch, np.int16)
        n = self._L.silk_decode_lost(
            self._h, int(n_channels_internal), int(internal_rate),
            int(payload_ms), out.ctypes.data_as(_I16P),
        )
        if n < 0:
            raise DecodeError("native SILK conceal failed")
        return out[: n * ch].reshape(n, ch).astype(np.float64)
