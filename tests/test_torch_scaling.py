"""The per-rank scaling table of tools/mesh_nccl_check.py --scaling (the
counterpart of the JAX package's tools/mesh_scaling.py) on gloo ranks on
the CPU, worlds 1 and 2 at the JAX tool's (rows, F) = (8, 16): each
rank's operations, bytes, collective calls and step time, taken inside
the rank by entry.decode_cases. The ranks are spawned once for the
module."""

import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = ("mixed", "serving")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "_tool_mesh_nccl_check", ROOT / "tools" / "mesh_nccl_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _tool()


@pytest.fixture(scope="module")
def table(tool):
    rows, F = tool.SCALING
    return {(r["n"], r["mesh"]): r for r in tool.scaling_rows(
        (1, 2), rows, F, None, MESHES, "cpu", reps=2)}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("n", [1, 2])
def test_every_rank_reports_its_cost_and_time(table, n, mesh):
    row = table[(n, mesh)]
    assert (row["rows"], row["F"]) == (8, 16)
    assert int(np.prod(row["shape"])) == n
    for key in ("gflops_per_rank", "gb_per_rank", "step_ms", "collectives",
                "k1_launches"):
        assert len(row[key]) == n, key
    for key in ("gflops_per_rank", "gb_per_rank", "step_ms"):
        assert all(math.isfinite(v) and v > 0 for v in row[key]), key
    assert row["k1_launches"] == [0] * n          # the plain version here
    json.dumps(row)


def test_serving_mesh_splits_the_products_and_makes_no_collective(table):
    one, two = table[(1, "serving")], table[(2, "serving")]
    assert two["shape"] == [2, 1, 1]
    assert two["collectives"] == [{}, {}] and one["collectives"] == [{}]
    for g in two["gflops_per_rank"]:
        assert abs(g * 2 / one["gflops_per_rank"][0] - 1) <= 0.05
    assert two["err_vs_world1"] == 0.0            # bit-equal to world 1


def test_mixed_mesh_sums_over_tp(table):
    two = table[(2, "mixed")]
    assert two["shape"] == [1, 1, 2]
    assert two["collectives"] == [{"sum": 1}, {"sum": 1}]
    assert max(two["gflops_per_rank"]) < table[(1, "mixed")][
        "gflops_per_rank"][0]
    assert two["err_vs_world1"] <= 1e-5


def test_scaling_table_prints_every_row(tool, table):
    text = tool.scaling_table(list(table.values()), "CPU, gloo ranks")
    lines = text.splitlines()
    assert sum(ln.startswith("| devices |") for ln in lines) == 2
    assert sum(ln.startswith("| 2 |") for ln in lines) == 2
    assert "(2,1,1)" in text and "(1,1,2)" in text and "sum x1" in text
    assert "step ms (CPU, gloo ranks)" in text


def test_serving_mesh_collective_raises(tool, monkeypatch):
    """A collective call on the serving mesh fails the table."""
    from libnyquist_torch import entry

    real = entry.decode_cases

    def with_call(n, cases, device=None):
        out = real(n, cases, device)
        out[-1][0]["calls"] = {"halo": 1}
        return out

    monkeypatch.setattr(entry, "decode_cases", with_call)
    with pytest.raises(RuntimeError, match="collective"):
        tool.scaling_rows((1,), 8, 16, None, ("serving",), "cpu", reps=1)
