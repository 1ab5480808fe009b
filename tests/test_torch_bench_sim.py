"""The port's twins of ``benchmarks/sim_bench.py``, ``lm_dse_bench.py`` and
``roofline_report.py`` (``benchmarks_torch/``), on the CPU.

``sim`` and ``lm_dse`` are host code copied to the port: for the same
arguments their payloads equal the JAX scripts' bit for bit, apart from
wall-clock fields (the JAX side writes into a temporary ``RESULTS_DIR``,
the port into the same directory by ``out_dir``). ``lm_dse``'s >= 10x
speed gate reads the host's clock, which a loaded test machine can miss:
its sections are compared here and the gate runs on fixed rows (the card's
``chip_smoke.py`` runs it for real). ``roofline`` reads one cell that the
port's dry run runs on the ``fake`` backend (in a process of its own, cut
to one layer): its row is the record, collective term and collectives by
op included."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import benchmarks.common as jcommon  # noqa: E402
from benchmarks import lm_dse_bench as jlm_dse  # noqa: E402
from benchmarks import sim_bench as jsim  # noqa: E402
from benchmarks_torch import lm_dse_bench, roofline_report, sim_bench  # noqa: E402
from _bench_util import (experiments_untouched, jsonable, load,  # noqa: E402,F401
                         without)

torch.set_num_threads(2)


def test_sim_bench_payload_equals_the_jax_script_bit_for_bit(
        monkeypatch, tmp_path):
    monkeypatch.setattr(jcommon, "RESULTS_DIR", str(tmp_path))
    want = jsim.run(smoke=True)
    got = sim_bench.run(smoke=True, device="cpu", out_dir=str(tmp_path))
    assert got == want
    assert load(tmp_path / "sim_bench_cpu.json") == \
        load(tmp_path / "sim_bench.json")
    assert len(got["agreement"]) == 6
    assert got["worst_agreement_err"] <= got["sim_tol"]
    assert got["slo"]["slo"]["p99"] < got["slo"]["maxmin"]["p99"]
    assert len(got["latency"]["rows"]) == 6


def test_sparse_lm_stack_is_the_jax_scripts():
    for reduced in (True, False):
        a = sim_bench._sparse_lm("qwen3-0.6b", 3, reduced=reduced)
        b = jsim._sparse_lm("qwen3-0.6b", 3, reduced=reduced)
        assert [(l.name, l.s_w, l.s_w_tile, l.macs) for l in a] == \
            [(l.name, l.s_w, l.s_w_tile, l.macs) for l in b]


def _lm_dse_sections(mod) -> dict:
    """``run(smoke=True)``'s three sections, the DSE timed once."""
    return {"stacks": mod.bench_stacks(),
            "dse": mod.bench_dse(mod.DSE_MODELS[:1], dse_iters=120, reps=1),
            "partitions": mod.bench_partitions(
                mod.PART_MODELS[:1], (1, 4), dse_iters=120, max_cuts=8)}


@pytest.fixture(scope="module")
def lm_dse_sections():
    return _lm_dse_sections(jlm_dse), _lm_dse_sections(lm_dse_bench)


def test_lm_dse_bench_sections_equal_the_jax_script_but_for_wall_clock(
        lm_dse_sections):
    want, got = lm_dse_sections
    assert without(got, lm_dse_bench.WALL_CLOCK) == \
        without(want, lm_dse_bench.WALL_CLOCK)
    assert len(got["stacks"]) == 10
    assert {r["objective"] for r in got["partitions"]} == \
        {"sum", "maxmin"}
    assert all(set(a) == set(b) for a, b in zip(got["dse"], want["dse"]))


@pytest.mark.parametrize("speedup", [10.0, 9.9])
def test_lm_dse_bench_run_writes_its_sections_and_gates_at_10x(
        monkeypatch, tmp_path, lm_dse_sections, speedup):
    _, got = lm_dse_sections
    rows = [dict(r, speedup=speedup) for r in got["dse"]]
    monkeypatch.setattr(lm_dse_bench, "bench_dse",
                        lambda models, dse_iters, reps: rows)
    if speedup < 10.0:
        with pytest.raises(AssertionError, match="speedup regressed"):
            lm_dse_bench.run(smoke=True, device="cpu", out_dir=str(tmp_path))
        out = None
    else:
        out = lm_dse_bench.run(smoke=True, device="cpu",
                               out_dir=str(tmp_path))
    written = load(tmp_path / "lm_dse_bench_cpu.json")
    assert without(written, ("wall_s",)) == without(jsonable(
        dict(got, dse=rows, smoke=True, worst_speedup=speedup)), ("wall_s",))
    if out is not None:
        assert without(out, ("wall_s",)) == without(
            dict(got, dse=rows), ("wall_s",))


DRYRUN_CELL = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("qwen3-0.6b", "train_4k", False, verbose=False,
                          layers=1)
    with open(sys.argv[1], "w") as f:
        json.dump({rec["key"]: rec}, f)
""")


def test_roofline_report_rows_are_the_dry_run_records(tmp_path, capsys):
    path = tmp_path / "dryrun_torch.json"
    out = subprocess.run(
        [sys.executable, "-c", DRYRUN_CELL, str(path)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = load(path)
    (key, rec), = res.items()
    assert rec["status"] == "ok" and rec["mesh"] == "pod16x16"
    assert rec["ran"] and rec["collective_s"] > 0
    # a cell of the other mesh and one that did not lay out are not rows
    res["x|train_4k|pod2x16x16"] = dict(rec, mesh="pod2x16x16")
    res["y|train_4k|pod16x16"] = {"key": "y", "status": "skipped"}
    with open(path, "w") as f:
        json.dump(res, f)
    capsys.readouterr()
    rows = roofline_report.run(path=str(path), device="cpu",
                               out_dir=str(tmp_path))
    assert rows == [rec]
    printed = capsys.readouterr().out.splitlines()
    line = next(l for l in printed if l.startswith("qwen3-0.6b"))
    cols = line.split()
    assert cols[:2] == ["qwen3-0.6b", "train_4k"]
    assert float(cols[2]) == pytest.approx(rec["compute_s"], rel=1e-3)
    assert float(cols[3]) == pytest.approx(rec["memory_s"], rel=1e-3)
    assert float(cols[4]) == pytest.approx(rec["collective_s"], rel=1e-3)
    assert cols[5] == rec["dominant"]
    ops = printed[printed.index(line) + 1]
    assert ops.startswith("  collectives: ")
    for op, (c, b) in rec["coll_by_op"].items():
        assert f"{op} {c} x {b:.3e} B" in ops
    assert "roofline.cells,0.0,n=1 mesh=pod16x16" in printed
    assert roofline_report.run(mesh="pod2x16x16", path=str(path),
                               device="cpu", out_dir=str(tmp_path)) == \
        [res["x|train_4k|pod2x16x16"]]


def test_roofline_report_without_a_dry_run(tmp_path, capsys):
    assert roofline_report.run(path=str(tmp_path / "none.json"),
                               device="cpu", out_dir=str(tmp_path)) == []
    assert "no dry-run results yet; run python -m repro_torch.launch." \
        "dryrun --all" in capsys.readouterr().out
    assert os.path.basename(roofline_report.DRYRUN_PATH) == \
        "dryrun_torch.json"
    with pytest.raises(ValueError, match="out_dir"):
        roofline_report.run(path=str(tmp_path / "none.json"), device="cpu")

