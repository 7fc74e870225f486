#!/usr/bin/env python3
"""The sharded decode step over NCCL ranks, one card a rank, against
world 1 on card 0.

    python3 tools/mesh_nccl_check.py

Needs two or more CUDA cards on one machine (nvcc for K1, as
chip_smoke.py). Uses the largest power of two of them, up to 8. For
(rows, F) = (16, 16) and (16, 512), on the mixed mesh (factor_mesh) and
the serving mesh (n, 1, 1): the assembled output against world 1 (1e-5
of max(|ref|, 1)), each rank's collective calls (the serving mesh makes
none) and its K1 launches (sp a step), and the case's wall time, the
ranks' spawn and NCCL set-up included. Then dryrun_multichip over the
cards, and a request for one rank more than there are cards, which must
raise. One JSON line a case; the last line is "MESH NCCL OK".

chip_smoke.py phase 12 runs ``run_case`` (the mixed mesh at (16, 16))
where a machine has two or more cards, and ``check_too_many_ranks`` on
every machine; a failed check raises.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ((16, 16), (16, 512))


def ranks_for(cards: int) -> int:
    """The largest power of two of the cards, up to 8."""
    return 8 if cards >= 8 else 4 if cards >= 4 else 2


def run_case(n: int, rows: int, F: int, serving: bool) -> dict:
    """One sharded step on n NCCL ranks against world 1 on card 0; a
    JSON-able row. Raises when a check fails."""
    from libnyquist_torch import entry

    one, _ = entry.sharded_decode_step(1, rows=rows, F=F, device="cuda")
    scale = max(float(np.abs(one).max()), 1.0)
    t0 = time.perf_counter()
    res = entry.decode_cases(
        n, [dict(rows=rows, F=F, serving_mesh=serving)], "cuda")[0]
    wall = time.perf_counter() - t0
    out = entry.assemble(res, rows, F)
    err = float(np.abs(out - one).max()) / scale
    shape = res[0]["shape"]
    row = dict(rows=rows, F=F, ranks=n, mesh=shape, err=err,
               bit_equal=bool(np.array_equal(out, one)), wall_s=wall,
               calls=[r["calls"] for r in res],
               k1_launches=[r["comb_launches"] for r in res])
    if err > 1e-5:
        raise RuntimeError(f"{n} NCCL ranks {shape} vs world 1: {err:.3e}")
    if row["k1_launches"] != [shape[1]] * n:
        raise RuntimeError(f"K1 launches a rank {row['k1_launches']} "
                           f"differ from sp = {shape[1]}")
    if serving and any(row["calls"]):
        raise RuntimeError(f"the serving mesh made collective calls "
                           f"{row['calls']}")
    return row


def check_too_many_ranks(cards: int) -> str:
    """dryrun_multichip on CUDA with more ranks than cards (at least 2)
    must raise before it starts a rank; returns the line to print."""
    from libnyquist_torch import entry

    want = max(2, cards + 1)
    try:
        entry.dryrun_multichip(want, device="cuda")
    except RuntimeError as e:
        if "need" not in str(e):
            raise
        return f"dryrun_multichip({want}, device='cuda') on {cards} " \
               f"card(s) raised: {e}"
    raise RuntimeError(f"dryrun_multichip({want}) ran on {cards} card(s)")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from libnyquist_torch import entry, kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"FAIL: {cards} card(s); NCCL ranks need two or more",
              file=sys.stderr)
        return 1
    n = ranks_for(cards)
    kernels.load("comb")          # built once here, not by every rank
    for rows, F in SHAPES:
        for serving in (False, True):
            row = run_case(n, rows, F, serving)
            print(json.dumps({**row, "card": smi[0]}), flush=True)
    entry.dryrun_multichip(n, device="cuda")
    print(check_too_many_ranks(cards), flush=True)
    print("MESH NCCL OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
