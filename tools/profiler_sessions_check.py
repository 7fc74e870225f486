#!/usr/bin/env python3
"""Device kernel records that torch.profiler sessions keep as a process
ages, with and without device_trace's warm-up.

    python3 tools/profiler_sessions_check.py

Needs a CUDA card. For each environment variant (as is, TEARDOWN_CUPTI=0,
DISABLE_CUPTI_LAZY_REINIT=1: what Kineto reads when a session ends or
begins), a fresh process runs rounds for 90 s: 2 s of host work, 2 s of
products on the card, then four sessions around a product (4 kernels)
and around 400 small kernels and the product (404): a plain
torch.profiler session, and utils.profiling.device_trace, which opens
its window with WARMUP_KERNELS empty kernels. Each session's kernels are
counted in its Chrome trace, the warm-up's apart. One JSON line a
round, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

VARIANTS = {
    "as_is": {},
    "teardown0": {"TEARDOWN_CUPTI": "0"},
    "no_lazy_reinit": {"DISABLE_CUPTI_LAZY_REINIT": "1"},
}


def session(kind: str, n_small: int) -> list:
    """[kernels of the block kept, warm-up kernels kept] of one session
    of ``kind`` ("plain" or "device_trace") around a product after
    n_small small kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from libnyquist_torch.utils.profiling import device_trace

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="trace_"))

    def work():
        a = torch.randn(256, 256, device="cuda")
        for _ in range(n_small):
            a.mul_(1.0)
        (a @ a).sum().item()

    if kind == "plain":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
        prof.export_chrome_trace(str(tmp / "trace_plain.json"))
    else:
        with device_trace(str(tmp)):
            work()
    (f,) = tmp.glob("trace_*.json")
    events = json.loads(f.read_text()).get("traceEvents", [])
    kern = [e for e in events if e.get("cat") == "kernel"]
    spin = sum(1 for e in kern if "spin" in e.get("name", ""))
    return [len(kern) - spin, spin]


def rounds(name: str, seconds: float = 90.0) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    rnd = 0
    while time.perf_counter() - t_start < seconds:
        t0 = time.perf_counter()
        m = np.random.default_rng(rnd).standard_normal((400, 400))
        while time.perf_counter() - t0 < 2.0:
            m = np.tanh(m @ m.T / 400.0)
        b = torch.randn(4096, 4096, device="cuda")
        while time.perf_counter() - t0 < 4.0:
            b = torch.tanh(b @ b / 64.0)
            torch.cuda.synchronize()
        print(json.dumps({"variant": name, "round": rnd,
                          "t_s": round(time.perf_counter() - t_start, 1),
                          "plain": session("plain", 0),
                          "plain_long": session("plain", 400),
                          "device_trace": session("device_trace", 0),
                          "device_trace_long": session("device_trace",
                                                       400)}), flush=True)
        rnd += 1


def main() -> int:
    ok = True
    for name, env in VARIANTS.items():
        proc = subprocess.run(
            [sys.executable, __file__, "--rounds", name],
            env={**os.environ, **env}, capture_output=True, text=True,
            timeout=300)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            ok = False
            sys.stderr.write(proc.stderr[-4000:])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rounds":
        rounds(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
