"""SILK normative constant tables, loaded from data/silk.tbl.

RFC 6716 §4.2 constants (reference: silk/tables_*.c, resampler_rom.c),
dumped from the reference build. The port keeps its own copy of the blob
under libnyquist_torch/data/; the native SILK decoder
(``native/silk_dec.c``) takes them once through ``silk_set_tables``.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

from .celt_tables import _load_tables

_DATA = pathlib.Path(__file__).resolve().parents[2] / "data" / "silk.tbl"


@functools.lru_cache(maxsize=1)
def tables() -> dict:
    t = dict(_load_tables(_DATA))
    t["gain_iCDF"] = t["gain_iCDF"].reshape(3, 8)
    t["pulses_per_block_iCDF"] = t["pulses_per_block_iCDF"].reshape(10, 18)
    t["rate_levels_iCDF"] = t["rate_levels_iCDF"].reshape(2, 9)
    t["Quantization_Offsets_Q10"] = t["Quantization_Offsets_Q10"].reshape(2, 2)
    return t


class NLSFCodebook:
    def __init__(self, t, prefix):
        s = t[f"{prefix}_scalars"]
        self.nVectors = int(s[0])
        self.order = int(s[1])
        self.quantStepSize_Q16 = int(s[2])
        self.invQuantStepSize_Q6 = int(s[3])
        self.CB1_NLSF_Q8 = t[f"{prefix}_CB1_NLSF_Q8"].reshape(
            self.nVectors, self.order
        ).astype(np.int64)
        self.CB1_iCDF = t[f"{prefix}_CB1_iCDF"].reshape(2, self.nVectors)
        self.pred_Q8 = t[f"{prefix}_pred_Q8"].astype(np.int64)
        self.ec_sel = t[f"{prefix}_ec_sel"].reshape(
            self.nVectors, self.order // 2
        )
        self.ec_iCDF = t[f"{prefix}_ec_iCDF"].reshape(8, 9)
        self.deltaMin_Q15 = t[f"{prefix}_deltaMin_Q15"].astype(np.int64)


@functools.lru_cache(maxsize=1)
def nlsf_cb_wb() -> NLSFCodebook:
    return NLSFCodebook(tables(), "NLSF_CB_WB")


@functools.lru_cache(maxsize=1)
def nlsf_cb_nb_mb() -> NLSFCodebook:
    return NLSFCodebook(tables(), "NLSF_CB_NB_MB")


# Constants (silk/define.h, gain_quant.c, stereo)
SHELL_FRAME = 16
MAX_PULSES = 16
N_RATE_LEVELS = 10
QUANT_LEVEL_ADJUST_Q10 = 80
MIN_DELTA_GAIN_QUANT = -4
MAX_DELTA_GAIN_QUANT = 36
N_LEVELS_QGAIN = 64
GAIN_OFFSET = ((2 * 128) // 6) + 16 * 128          # (MIN_QGAIN_DB*128)/6+16*128
GAIN_INV_SCALE_Q16 = (65536 * (((88 - 2) * 128) // 6)) // (N_LEVELS_QGAIN - 1)
NLSF_QUANT_MAX_AMPLITUDE = 4
NLSF_QUANT_LEVEL_ADJ_Q10 = 102                      # 0.1 in Q10 (FIX_CONST)
NLSF_W_Q = 2
STEREO_INTERP_LEN_MS = 8
