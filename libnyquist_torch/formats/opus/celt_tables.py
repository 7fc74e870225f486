"""CELT 48 kHz mode constants, loaded from data/celt48k.tbl.

The table blob is generated by tools/celt_tables_dump.c from the reference
build's static mode (reference: celt/static_modes_float.h:577-593,
celt/quant_bands.c:44-77) — normative RFC 6716 constants extracted as data.
The port keeps its own copy of the blob under libnyquist_torch/data/.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

_DATA = pathlib.Path(__file__).resolve().parents[2] / "data" / "celt48k.tbl"


def _load_tables(path=_DATA):
    out = {}
    raw = path.read_bytes()
    pos = 0

    def line():
        nonlocal pos
        end = raw.index(b"\n", pos)
        s = raw[pos:end].decode()
        pos = end + 1
        return s

    while pos < len(raw):
        name = line()
        dtype = line()
        ndims = int(line())
        dims = [int(line()) for _ in range(ndims)]
        count = int(np.prod(dims))
        itemsize = np.dtype(dtype).itemsize
        arr = np.frombuffer(raw, dtype=dtype, count=count, offset=pos)
        pos += count * itemsize + 1  # +1 for trailing newline
        out[name] = arr.reshape(dims)
    return out


class CeltMode:
    """The static 48 kHz CELT mode (mode48000_960_120)."""

    def __init__(self):
        t = _load_tables()
        s = t["scalars"]
        self.Fs = int(s[0])
        self.overlap = int(s[1])             # 120
        self.nbEBands = int(s[2])            # 21
        self.effEBands = int(s[3])
        self.maxLM = int(s[4])               # 3
        self.nbShortMdcts = int(s[5])        # 8
        self.shortMdctSize = int(s[6])       # 120
        self.nbAllocVectors = int(s[7])      # 11
        self.preemph = t["preemph"].astype(np.float64)
        self.eBands = t["eBands"].astype(np.int32)
        self.allocVectors = t["allocVectors"].astype(np.int32)
        self.logN = t["logN"].astype(np.int32)
        self.window = t["window"].astype(np.float64)
        self.cache_index = t["cache_index"].astype(np.int32)
        self.cache_bits = t["cache_bits"].astype(np.int32)
        self.cache_caps = t["cache_caps"].astype(np.int32)
        self.eMeans = t["eMeans"].astype(np.float64)
        self.e_prob_model = t["e_prob_model"].astype(np.int32)


@functools.lru_cache(maxsize=1)
def mode48000() -> CeltMode:
    return CeltMode()


# Postfilter tap gains per tapset (reference: celt/celt.c comb_filter gains).
COMB_GAINS = [
    [0.3066406250, 0.2170410156, 0.1296386719],
    [0.4638671875, 0.2680664062, 0.0],
    [0.7998046875, 0.1000976562, 0.0],
]

# Hadamard (de)interleave row order per stride (reference: celt/bands.c
# ordery_table).
ORDERY_TABLE = {
    2: [1, 0],
    4: [3, 0, 2, 1],
    8: [7, 0, 4, 3, 6, 1, 5, 2],
    16: [15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5],
}
