#!/usr/bin/env python3
"""The sharded decode step over NCCL ranks, one card a rank, against
world 1 on card 0.

    python3 tools/mesh_nccl_check.py [--one-card] [--root DIR]
    python3 tools/mesh_nccl_check.py --scaling [--dp-only] [--serving]
        [--json] [--device cpu]

Needs two or more CUDA cards on one machine (nvcc for K1, as
chip_smoke.py), and uses the largest power of two of them, up to 8. For
(rows, F) = (16, 16) and (16, 512), on the mixed mesh (factor_mesh) and
the serving mesh (n, 1, 1): the assembled output against world 1, each
rank's collective calls (the serving mesh makes none) and its K1
launches (sp a step), and the case's wall time, the ranks' spawn and
NCCL set-up included. The mixed mesh is held within 1e-5 of max(|ref|,
1); the serving mesh is held to bit equality, as the JAX package holds
its (n, 1, 1) mesh (tests/test_mesh.py). Then dryrun_multichip over the
cards, and a request for one rank more than there are cards, which must
raise. One JSON line a case (``bit_equal`` in each); the last line is
"MESH NCCL OK".

``--one-card`` needs one card and runs no collective: per shape,
``dp_slices``, ``other_layouts`` and world 1's step time.

``--scaling`` prints the per-rank scaling table, the counterpart of the
JAX package's tools/mesh_scaling.py: for worlds 1, 2, 4 and 8 (those the
cards, or on the CPU the cores, allow), on the mixed mesh (factor_mesh)
and the serving mesh (n, 1, 1) (``--dp-only``: that one alone), each
rank's GFLOP (op_flops: its products) and GB (op_cost) of its step, its
collective calls by kind and its step ms (CUDA events in the rank,
median of 5 after a warm-up; the spawn and NCCL set-up excluded), at
(rows, F) = (8, 16) of random spectra, or with ``--serving`` (16, 96)
of the bench stream's content (libnyquist_torch.bench,
entry.real_content_args). The serving mesh must make no collective call.
``--json`` also prints the rows as one JSON line. ``--device cpu`` runs
gloo ranks (step ms on the host clock).
``--root DIR`` imports libnyquist_torch from another checkout (a
parent's, to compare on the same card).

``dp_slices`` is the serving mesh's check on one device and without a
collective: each dp slice's rows through the step a serving rank runs,
against world 1's rows. ``other_layouts`` shows on the library alone
why the step's products run one per stream row: a flat product and a
batched one both pick their reduction order by the row or batch count.

chip_smoke.py phase 12 runs ``dp_slices`` and ``other_layouts`` on card
0, ``run_case`` (the
mixed and the serving mesh at (16, 16)) where a machine has two or more
cards, and ``check_too_many_ranks`` on every machine; a failed check
raises.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ((16, 16), (16, 512))
SCALING = (8, 16)              # the JAX tool's ROWS, F
# its --serving shape on real content: 16 rows x 96 frames, since the
# bench stream's long-block runs are 99 frames (a transient opens each
# repeat of golden case 0), where the JAX tool took 128 of sb-reverie
SCALING_SERVING = (16, 96)
SCALING_REPS = 5


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
    if serving and not row["bit_equal"]:
        raise RuntimeError(f"the serving mesh {shape} is {err:.3e} off "
                           f"world 1, not bit-equal")
    if row["k1_launches"] != [shape[1]] * n:
        raise RuntimeError(f"K1 launches a rank {row['k1_launches']} "
                           f"differ from sp = {shape[1]}")
    if serving and any(row["calls"]):
        raise RuntimeError(f"the serving mesh made collective calls "
                           f"{row['calls']}")
    return row


def dp_slices(rows: int, F: int, dps=(2, 4, 8), device="cuda") -> dict:
    """Each dp slice of the serving mesh (dp, 1, 1), its rows run through
    entry._local_step on one device with singleton axes (what that
    serving rank runs; it makes no collective), against world 1's rows
    on the same device. Returns {dp: (bit_equal over the slices, max abs
    error)}."""
    from libnyquist_torch import entry
    from libnyquist_torch.parallel.mesh import local_mesh

    def run(dp, d):
        mesh = local_mesh((dp, 1, 1), device)
        mesh["dp"].index = d
        return entry._local_step(mesh, *entry._shard_args(mesh, rows, F,
                                                          None))

    one = run(1, 0)
    out = {}
    for dp in dps:
        r, equal, err = rows // dp, True, 0.0
        for d in range(dp):
            got, ref = run(dp, d), one[d * r : (d + 1) * r]
            equal = equal and torch.equal(got, ref)
            err = max(err, float((got - ref).abs().max()))
        out[dp] = (equal, err)
    return out


def other_layouts(rows: int, F: int, dp: int, device="cuda") -> dict:
    """The two product layouts that do not hold the serving mesh
    bit-equal, checked on the library alone: the first 1/dp of the
    step's stream rows times the main synthesis matrix as one flat
    product ("flat mm", the layout before per-row products) and as one
    batched product of a matrix a row ("bmm"), each against the same
    rows of the product over all rows. Returns {layout: (bit_equal,
    max abs error)}."""
    from libnyquist_torch import entry
    from libnyquist_torch.parallel.mesh import local_mesh

    args = entry._shard_args(local_mesh((1, 1, 1), device), rows, F, None)
    spec, Tm = args[0], args[6]
    q = rows // dp

    def flat(x):
        return (x.reshape(-1, x.shape[-1]) @ Tm).view(x.shape[0], F, -1)

    def bmm(x):
        return torch.bmm(x, Tm.expand(x.shape[0], *Tm.shape))

    out = {}
    for name, f in (("flat mm", flat), ("bmm", bmm)):
        got, ref = f(spec[:q].clone()), f(spec)[:q]
        out[name] = (torch.equal(got, ref), float((got - ref).abs().max()))
    return out


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


def one_card(smi_line: str) -> int:
    """Card 0 alone, per shape: dp_slices, other_layouts at dp 4 and
    world 1's local step in ms by CUDA events (median of 7). Returns 1
    when a dp slice is not bit-equal."""
    from libnyquist_torch import entry

    bad = 0
    for rows, F in SHAPES:
        fn, args, _ = entry.sharded_decode_step(1, rows=rows, F=F,
                                                return_fn=True, device="cuda")
        times = []
        for i in range(8):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            if i:
                times.append(a.elapsed_time(b))
        slices = dp_slices(rows, F)
        bad += not all(eq for eq, _ in slices.values())
        print(json.dumps(dict(
            rows=rows, F=F, card=smi_line, dp_slices=slices,
            other_layouts=other_layouts(rows, F, 4),
            step_ms=sorted(times)[len(times) // 2])), flush=True)
    return int(bad > 0)


def bench_content(rows: int, F: int) -> dict:
    """entry.real_content_args on the bench stream of
    libnyquist_torch.bench (golden case 0 repeated to 100 s)."""
    from libnyquist_torch import bench, entry

    data, _ = bench._load_opus_stream_bytes()
    with tempfile.TemporaryDirectory(prefix="nq_scaling_") as tmp:
        path = pathlib.Path(tmp) / "bench.opus"
        path.write_bytes(data)
        content = entry.real_content_args(path, rows=rows, F=F)
    if content is None:
        raise RuntimeError(f"the bench stream has no {rows // 2} windows of "
                           f"{F} long-block frames")
    return content


def scaling_rows(worlds, rows: int, F: int, content=None,
                 meshes=("mixed", "serving"), device="cuda",
                 reps: int = SCALING_REPS) -> list:
    """The scaling table's rows: per world and mesh, each rank's GFLOP
    and GB of its step, collective calls and step ms, and the output's
    error against world 1 of the same mesh. All meshes of a world run in
    one set of ranks (entry.decode_cases). Raises when the serving mesh
    makes a collective call."""
    from libnyquist_torch import entry

    out, ref = [], {}
    for n in worlds:
        cases = [dict(rows=rows, F=F, content=content, measure=reps,
                      serving_mesh=(m == "serving")) for m in meshes]
        for m, res in zip(meshes, entry.decode_cases(n, cases, device)):
            got = entry.assemble(res, rows, F)
            ref.setdefault(m, got)
            row = dict(
                n=n, mesh=m, shape=list(res[0]["shape"]), rows=rows, F=F,
                gflops_per_rank=[r["flops"] / 1e9 for r in res],
                gb_per_rank=[r["bytes"] / 1e9 for r in res],
                collectives=[r["calls"] for r in res],
                step_ms=[r["step_ms"] for r in res],
                k1_launches=[r["comb_launches"] for r in res],
                err_vs_world1=float(np.abs(got - ref[m]).max()))
            if m == "serving" and any(row["collectives"]):
                raise RuntimeError(f"the serving mesh {row['shape']} made "
                                   f"collective calls {row['collectives']}")
            out.append(row)
    return out


def scaling_table(rows: list, label: str) -> str:
    """The JAX tool's markdown table, one per mesh, with the device's
    name in place of "virtual CPU" (the slowest rank's figures; --json
    has every rank's)."""
    lines = []
    for mesh in dict.fromkeys(r["mesh"] for r in rows):
        sel = [r for r in rows if r["mesh"] == mesh]
        base = max(sel[0]["gflops_per_rank"])
        lines += [f"fused CELT device step, rows={sel[0]['rows']} x "
                  f"F={sel[0]['F']} frames (global shapes fixed), {mesh} "
                  f"mesh:",
                  "| devices | mesh (dp,sp,tp) | GFLOP/device | GB/device |"
                  f" collectives | step ms ({label}) |",
                  "|---|---|---|---|---|---|"]
        for r in sel:
            calls = {}
            for c in r["collectives"]:
                for k, v in c.items():
                    calls[k] = max(calls.get(k, 0), v)
            cl = ", ".join(f"{k} x{v}" for k, v in calls.items()) or "none"
            g = max(r["gflops_per_rank"])
            lines.append(
                f"| {r['n']} | ({','.join(map(str, r['shape']))}) | {g:.3f} "
                f"({base / g:.1f}x less) | {max(r['gb_per_rank']):.3f} | "
                f"{cl} | {max(r['step_ms']):.3f} |")
    return "\n".join(lines)


def scaling_main(args) -> int:
    """--scaling: the table for the worlds the devices allow."""
    device = args[args.index("--device") + 1] if "--device" in args \
        else "cuda"
    if device == "cuda":
        from libnyquist_torch import kernels

        label = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(label, flush=True)
        kernels.load("comb")      # built once here, not by every rank
        have = torch.cuda.device_count()
    else:
        label, have = "CPU, gloo ranks", os.cpu_count() or 1
    worlds = [n for n in (1, 2, 4, 8) if n <= have]
    meshes = ("serving",) if "--dp-only" in args else ("mixed", "serving")
    if "--serving" in args:
        rows, F = SCALING_SERVING
        content = bench_content(rows, F)
    else:
        (rows, F), content = SCALING, None
    table = scaling_rows(worlds, rows, F, content, meshes, device)
    print(scaling_table(table, label), flush=True)
    if "--json" in args:
        print(json.dumps([{**r, "device": label} for r in table]))
    return 0


def main() -> int:
    args = sys.argv[1:]
    # --root DIR: the libnyquist_torch of another checkout (a parent's)
    root = pathlib.Path(args[args.index("--root") + 1]).resolve() \
        if "--root" in args else ROOT
    sys.path.insert(0, str(root))
    if "--scaling" in args:
        return scaling_main(args)
    from libnyquist_torch import entry, kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    kernels.load("comb")          # built once here, not by every rank
    if "--one-card" in args:
        return one_card(smi[0])
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"FAIL: {cards} card(s); NCCL ranks need two or more",
              file=sys.stderr)
        return 1
    n = ranks_for(cards)
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
