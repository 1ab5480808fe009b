"""The host-only benchmark twins of ``benchmarks_torch/`` (Fig. 4, Fig. 6 and
the DSE gate) against the JAX package's scripts in ``benchmarks/``: the same
arguments give the same payload, bit for bit, apart from wall-clock fields
(the DSE gate's payload section by section; its >= 10x gate on fixed rows).
The JAX side writes into a temporary ``RESULTS_DIR`` and the port into the
same directory by ``out_dir``; nothing under ``experiments/`` changes. Also
the search-bench sections at a small size on the CPU, the sparsity-pattern
gate end to end on the CPU (payload keys as in the file its JAX script wrote,
``experiments/sparsity_bench.json``; the decode factors and the ``meas_term``
section equal to the JAX script's sections run on the same modeled table),
and where a run of the port may write."""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import benchmarks.common as jcommon  # noqa: E402
from benchmarks import dse_bench as jdse_bench  # noqa: E402
from benchmarks import fig4_dse_allocation as jfig4  # noqa: E402
from benchmarks import fig6_speedup as jfig6  # noqa: E402
from benchmarks_torch import (common, dse_bench,  # noqa: E402
                              fig4_dse_allocation, fig6_speedup, search_bench,
                              sparsity_bench)
from _bench_util import experiments_untouched  # noqa: E402,F401
from _bench_util import load as _load  # noqa: E402
from _bench_util import without as _without  # noqa: E402

# several test processes run side by side: a few threads each
torch.set_num_threads(2)

@pytest.mark.parametrize("jmod,tmod,name,kw", [
    (jfig4, fig4_dse_allocation, "fig4", {}),
    (jfig4, fig4_dse_allocation, "fig4", {"budget": 4096, "seed": 3}),
    (jfig6, fig6_speedup, "fig6", {}),
    (jfig6, fig6_speedup, "fig6", {"s_w": 0.8, "s_a": 0.2}),
], ids=["fig4", "fig4-budget4096-seed3", "fig6", "fig6-sw0.8-sa0.2"])
def test_host_twin_payload_equals_the_jax_script_bit_for_bit(
        monkeypatch, tmp_path, jmod, tmod, name, kw):
    monkeypatch.setattr(jcommon, "RESULTS_DIR", str(tmp_path))
    want = jmod.run(**kw)
    got = tmod.run(**kw, device="cpu", out_dir=str(tmp_path))
    assert got == want
    assert _load(tmp_path / f"{name}_cpu.json") == \
        _load(tmp_path / f"{name}.json")


def _dse_sections(mod) -> dict:
    """A DSE script's three sections on its own arguments: the payload its
    ``run`` writes, but for the two speedup summaries."""
    return {"rows": mod.bench_dse(reps=1),
            "partition": mod.bench_partition(),
            "engine_trials_per_s": mod.bench_search_engine()}


@pytest.fixture(scope="module")
def dse_sections():
    """(the JAX script's sections, the port's): each ``run`` ends in the
    >= 10x speedup gate, a reading of the host's clock that a loaded test
    machine can miss, so the payloads are compared section by section and
    the gate on fixed rows below."""
    return _dse_sections(jdse_bench), _dse_sections(dse_bench)


def test_dse_bench_payload_equals_the_jax_script_but_for_wall_clock(
        dse_sections):
    want, got = dse_sections
    assert _without(got, dse_bench.WALL_CLOCK) == \
        _without(want, dse_bench.WALL_CLOCK)
    assert len(got["rows"]) == 10
    assert {r["model"] for r in got["rows"]} == \
        {n for n, _ in dse_bench.PAPER_CNNS}


@pytest.mark.parametrize("speedup", [10.0, 9.9])
def test_dse_bench_run_writes_its_sections_and_gates_at_10x(
        monkeypatch, tmp_path, dse_sections, speedup):
    """``run`` writes the sections with their speedup summaries, and fails
    when a workload's vectorized DSE is less than 10x its scalar
    reference."""
    _, got = dse_sections
    rows = [dict(r, speedup=12.5) for r in got["rows"]]
    rows[3]["speedup"] = speedup
    monkeypatch.setattr(dse_bench, "bench_dse", lambda reps: rows)
    monkeypatch.setattr(dse_bench, "bench_partition",
                        lambda: got["partition"])
    monkeypatch.setattr(dse_bench, "bench_search_engine",
                        lambda: got["engine_trials_per_s"])
    if speedup < 10.0:
        with pytest.raises(AssertionError, match="speedup regressed"):
            dse_bench.run(device="cpu", out_dir=str(tmp_path))
    else:
        assert dse_bench.run(device="cpu", out_dir=str(tmp_path)) == rows
    written = _load(tmp_path / "dse_bench_cpu.json")
    assert written == json.loads(json.dumps(
        dict(got, rows=rows, worst_speedup=speedup,
             mean_speedup=round((9 * 12.5 + speedup) / 10, 1))))


def test_a_cpu_run_needs_an_out_dir_and_never_names_a_jax_file(tmp_path):
    with pytest.raises(ValueError, match="out_dir"):
        fig6_speedup.run(device="cpu")
    with pytest.raises(ValueError, match="out_dir"):
        common.target("cpu")
    for dev in (torch.device("cpu"), torch.device("cuda")):
        for name in ("fig4", "fig5", "dse_bench", "kernel_costs",
                     "bench_summary"):
            p = common.results_path(name, dev, str(tmp_path))
            assert os.path.basename(p) != f"{name}.json"
            assert os.path.basename(p).startswith(name + "_")
    dev, out = common.target("cpu", str(tmp_path))
    assert dev.type == "cpu" and out == str(tmp_path)
    path = common.save_json("x", {"a": 1}, dev, out)
    assert _load(path) == {"a": 1}             # no card on the host


def test_timed_returns_the_result_and_microseconds():
    out, us = common.timed(lambda a, b: a + b, 2, 3, repeat=4)
    assert out == 5 and us >= 0.0


def test_search_bench_sections_keep_their_identities_on_the_cpu():
    """The search gate's sections at a small size: the seed path and the
    acceleration subsystem give the same trials, the batched DSE the same
    trials as per-proposal dispatch, the shared-cache sweep the same
    partitions; the speed gates are only collected here."""
    gates = []
    row, ev, res = search_bench.bench_cnn(2, gates, device="cpu")
    assert row["iters"] == 2 and len(gates) == 1
    lm_rows, best = search_bench.bench_lm(["qwen3-0.6b"], 8, gates)
    assert lm_rows[0]["iters"] == 8 and len(gates) == 2
    batch = search_bench.bench_batch(8, 2.0, gates, reps=1)
    assert batch["engine"] in ("compiled", "lockstep")
    assert all(isinstance(h, bool) and m for h, m in gates)
    lm_ev, lm_res = best["qwen3-0.6b"]
    stacks = [("resnet18", ev.sparse_layers(res.best_x), None)]
    sweep = search_bench.bench_sweep(stacks, (1, 2), (32,), dse_iters=100)
    assert sweep[0]["plans"] == 3 and sweep[0]["cold_reduction"] >= 1.0
    sens = search_bench.bench_sensitivity(lm_ev, lm_res.best_x)
    assert sens["probes"] == 2 * lm_ev.n_search
    liar = search_bench.bench_liar(["qwen3-0.6b"], iters=6)
    assert np.isfinite(liar[0]["liar"]) and np.isfinite(liar[0]["independent"])


def _jax_sparsity_sections(monkeypatch, tmp_path):
    """The JAX script's ``kernel_costs`` section, its table measured with
    no lowering available (the reference's modeled fallback, the port's
    CPU table) into ``tmp_path``, and its ``meas_term`` section on those
    factors."""
    import jax
    from benchmarks import sparsity_bench as jsparsity
    monkeypatch.setattr(jcommon, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(jsparsity, "COSTS_PATH",
                        str(tmp_path / "kernel_costs.json"))
    with monkeypatch.context() as m:
        def no_backend(*a, **k):
            raise RuntimeError("no backend")
        m.setattr(jax, "jit", no_backend)
        costs = jsparsity.bench_kernel_costs()
    return costs, jsparsity.bench_meas_term(costs["factors"])


def test_sparsity_bench_end_to_end_on_the_cpu(monkeypatch, tmp_path):
    sparsity_bench.run(smoke=True, device="cpu", out_dir=str(tmp_path))
    got = _load(tmp_path / "sparsity_bench_cpu.json")
    want = _load(os.path.join(ROOT, "experiments", "sparsity_bench.json"))
    assert set(got) == set(want)
    for k in ("kernel_costs", "meas_term"):
        assert set(got[k]) == set(want[k]), k
    for k in ("default_identity", "pattern_win", "executed"):
        assert set(got[k][0]) == set(want[k][0]), k
    # the modeled CPU table, beside the results, never the JAX file
    assert got["kernel_costs"]["dense_mode"] == "modeled"
    assert os.path.basename(got["kernel_costs"]["path"]) == \
        "kernel_costs_cpu.json"
    assert all(r["kernel_ok"] for r in got["executed"])
    # the decode factors and the Eq. 6 meas section equal the JAX script's
    jcosts, jmeas = _jax_sparsity_sections(monkeypatch, tmp_path)
    assert got["kernel_costs"]["factors"] == jcosts["factors"]
    assert got["kernel_costs"]["dense_mode"] == jcosts["dense_mode"]
    assert got["meas_term"] == jmeas
