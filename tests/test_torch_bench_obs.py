"""The port's twin of ``benchmarks/obs_bench.py`` (``benchmarks_torch/``),
and ``tools/trace_report.py`` on the port's flight-recorder runs, on the
CPU.

The JAX script's ``identity``, ``trace`` and ``report`` sections run at
``smoke=True`` (their files in a temporary directory) and the port's
``run(smoke=True, device="cpu")`` writes into another; the two agree
section for section, apart from wall-clock fields, where the trace was
written and the trace's count of events (the port's search opens a
``search`` span and a ``record`` span a trial besides). The ``overhead``
section's < 3 % gate reads the host's clock, which a loaded test machine
can miss: here its two arms' transcripts are held bit-identical at a
smaller size and the gate runs on fixed ratios
(``chip_smoke.py`` runs it for real). ``tools/trace_report.py`` is
stdlib-only and reads the recorder's JSONL format, which the port keeps:
run as a script on the port's recordings it summarises them as it does
the JAX package's, and its diff finds no divergence between a port run
and a JAX run of the same search."""
import io
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import benchmarks.common as jcommon  # noqa: E402
from benchmarks import obs_bench as jobs  # noqa: E402
from benchmarks_torch import obs_bench  # noqa: E402
from _bench_util import (experiments_untouched, jsonable, load,  # noqa: E402,F401
                         without)

torch.set_num_threads(2)

ITERS, DSE_ITERS = 24, 300             # run(smoke=True)'s


@pytest.fixture(scope="module")
def obs_jax(tmp_path_factory):
    """The JAX script's sections, its trace and its recorder files in a
    directory of their own (the script writes fixed names into the
    system's temporary directory)."""
    tmp = tmp_path_factory.mktemp("obs_jax")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jcommon, "RESULTS_DIR", str(tmp))
        m.setattr(jobs, "RESULTS_DIR", str(tmp))
        m.setattr(jobs.tempfile, "gettempdir", lambda: str(tmp))
        row, tr, rec_path = jobs.bench_identity(ITERS, DSE_ITERS)
        os.remove(rec_path)
        return {"identity": row, "trace": jobs.bench_trace(tr, ITERS),
                "report": jobs.bench_report(ITERS, DSE_ITERS)}


def test_obs_bench_payload_equals_the_jax_script_but_for_wall_clock(
        monkeypatch, tmp_path, obs_jax):
    ratios = [1.004, 0.998, 1.011]
    monkeypatch.setattr(obs_bench, "overhead_ratios",
                        lambda *a: (ratios, 1.5, 1.6))
    got = obs_bench.run(smoke=True, device="cpu", out_dir=str(tmp_path))
    assert load(tmp_path / "obs_bench_cpu.json") == jsonable(got)
    # the port's serial search adds to the JAX package's four spans a
    # trial (trial, propose, evaluate, tell) a ``record`` span a trial and
    # one ``search`` span: every other number is the JAX script's
    jax_trace = obs_jax["trace"]
    assert got["trace"]["events"] == jax_trace["events"] + ITERS + 1
    assert without(got, obs_bench.WALL_CLOCK + ("events",)) == dict(
        without(obs_jax, obs_bench.WALL_CLOCK + ("events",)), smoke=True,
        overhead_gate_pct=3.0,
        overhead={"iters": 400, "reps": 3, "gate_pct": 3.0})
    assert got["overhead"]["overhead_pct"] == -0.2
    assert got["trace"]["path"] == "obs_trace_cpu.json"
    assert os.path.exists(tmp_path / "obs_trace_cpu.json")
    assert got["report"] == {"same_seed_divergence": 0,
                             "cross_seed_divergence": ITERS}
    assert sorted(os.listdir(tmp_path)) == ["obs_bench_cpu.json",
                                           "obs_trace_cpu.json"]


def test_obs_overhead_arms_are_bit_identical():
    ratios, t_off, t_on = obs_bench.overhead_ratios(16, DSE_ITERS, 2)
    assert len(ratios) == 2 and t_off > 0 and t_on > 0


@pytest.mark.parametrize("worst", [1.0299, 1.03])
def test_obs_overhead_gates_at_3_percent(monkeypatch, worst):
    monkeypatch.setattr(obs_bench, "overhead_ratios",
                        lambda *a: ([1.2, worst], 1.0, 1.03))
    if worst - 1.0 >= obs_bench.OVERHEAD_GATE:
        with pytest.raises(AssertionError, match="tracer overhead"):
            obs_bench.bench_overhead(400, DSE_ITERS, 2)
    else:
        row = obs_bench.bench_overhead(400, DSE_ITERS, 2)
        assert row["overhead_pct"] == 2.99 and row["gate_pct"] == 3.0


def _record(pkg, path, seed=0, iters=8):
    """One recorded ``hass_search`` of the obs gate's LM evaluator, by the
    JAX package or the port."""
    if pkg == "jax":
        from repro.configs import get_config
        from repro.core.hass import LMEvaluator, hass_search
        from repro.core.perf_model import TPUModel
        from repro.obs import FlightRecorder
    else:
        from repro_torch.configs import get_config
        from repro_torch.core.hass import LMEvaluator, hass_search
        from repro_torch.core.perf_model import TPUModel
        from repro_torch.obs import FlightRecorder
    tpu = TPUModel()
    ev = LMEvaluator(get_config("qwen3-0.6b"), tpu, tpu.chip_budget,
                     dse_iters=DSE_ITERS)
    with FlightRecorder(str(path)) as rec:
        res = hass_search(ev, ev.n_search, iters=iters, seed=seed,
                          include_act=False, recorder=rec)
    return res


def _report(*args) -> str:
    """``tools/trace_report.py`` as a script, with no PYTHONPATH."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "trace_report.py"),
         *map(str, args)], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _untimed(text: str) -> list:
    """The report's lines that read no clock."""
    return [l for l in text.splitlines()
            if l.split(":")[0].strip() in ("search", "config", "trials",
                                           "best", "cache", "engine")]


def test_trace_report_reads_the_ports_recorder_runs(tmp_path):
    from repro_torch.obs import load_run
    from tools import trace_report
    a, b, c, j = (tmp_path / f"{t}.jsonl" for t in "abcj")
    res = _record("port", a)
    _record("port", b)
    _record("port", c, seed=1)
    _record("jax", j)
    # the tool's own parser reads what the port's parser reads
    run = load_run(str(a))
    assert trace_report.load_run(str(a)) == run
    assert trace_report.totals_of(run) == run["footer"]["totals"]
    summary = _report("summary", a, "--top", 3)
    assert "trials   : 8" in summary
    assert f"best     : {res.best_score:.6g}" in summary
    assert "slowest 3 trials:" in summary and "phases   :" in summary
    assert _untimed(summary) == _untimed(_report("summary", j, "--top", 3))
    assert "diverge  : 0 trials" in _report("diff", a, b)
    # the port's search is the JAX package's, proposal for proposal
    assert "diverge  : 0 trials" in _report("diff", a, j)
    cross = _report("diff", a, c)
    assert "diverge  : 8 trials differ, first at #0" in cross
    assert "phase deltas (b - a):" in cross
    out = io.StringIO()
    assert trace_report.diff_runs(run, trace_report.load_run(str(j)),
                                  out=out) == 0
