"""The harness: found by names in BENCHMARK.json (a new configuration,
traffic mix, cell and metric need no edit of a file that is there), the
probe between search and evaluator, the refusal without a card, and what
the benchmark's process may import."""
import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from hassbench import harness

ROOT = harness.ROOT
HASSBENCH = os.path.join(ROOT, "hassbench")


def _env(extra_path=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [*extra_path, os.path.join(ROOT, "src"), ROOT])
    return env


def test_every_cell_metric_and_file_of_the_benchmark_is_found():
    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        for key in ("trials", "batch_size", "warmup_trials"):
            assert key in cell.traffic
        assert set(cell.check["limits"]) == {"s_w_mismatch", "acc_mismatch",
                                             "s_a_apart", "s_a_layer_apart",
                                             "hw_gap"}
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
    for m in bench["per_layer"]:
        mod = harness.metric_reader(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == \
            (m["unit"], m["layer"], m["moves"])


def test_a_new_configuration_traffic_cell_and_metric_need_no_edit(tmp_path):
    """In a copy of the benchmark, add files and entries only, and find
    them by name."""
    shutil.copytree(HASSBENCH, tmp_path / "hassbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    hb = tmp_path / "hassbench"
    conf = json.loads((hb / "configs" / "resnet18.json").read_text())
    conf["name"] = "resnet18_copy"
    (hb / "configs" / "resnet18_copy.json").write_text(json.dumps(conf))
    (hb / "traffic" / "search.b4.json").write_text(json.dumps(
        {"trials": 48, "batch_size": 4, "liar": "min",
         "hardware_aware": True, "warmup_trials": 8}))
    (hb / "workloads" / "resnet18_copy.search.b4.json").write_text(
        json.dumps({"sample": 16, "limits": {"s_w_mismatch": 0}}))
    (hb / "metrics" / "rounds_per_search.py").write_text(textwrap.dedent('''
        UNIT = "rounds"
        LAYER = "search loop"
        MOVES = "trials_per_s"


        def read(view):
            return len(view.window.round_s) / max(view.window.searches, 1)
        '''))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "resnet18_copy", "source": "x",
                             "file": "hassbench/configs/resnet18_copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "resnet18_copy.search.b4",
                               "config": "resnet18_copy",
                               "traffic": "search.b4", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "rounds_per_search", "unit": "rounds",
                               "better": "higher", "source": "host_clock",
                               "layer": "search loop", "moves": "trials_per_s",
                               "workloads": ["resnet18_copy.search.b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    edited = [p for p in before if before[p] != after[p]]
    assert [p.name for p in edited] == ["BENCHMARK.json"]
    code = textwrap.dedent('''
        import json, sys
        from hassbench import harness
        cell = harness.find_cell("resnet18_copy.search.b4", root=sys.argv[1])
        mod = harness.metric_reader("rounds_per_search")
        other = harness.find_cell("resnet18.search.b8", root=sys.argv[1])
        print(json.dumps([cell.config["name"], cell.traffic["batch_size"],
                          [m["name"] for m in cell.per_layer], mod.UNIT,
                          [m["name"] for m in other.per_layer]]))
        ''')
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path,
                         env=_env([str(tmp_path)]), timeout=120)
    assert out.returncode == 0, out.stderr
    name, b, metrics, unit, others = json.loads(out.stdout.splitlines()[-1])
    assert (name, b, unit) == ("resnet18_copy", 4, "rounds")
    assert metrics[-1] == "rounds_per_search"
    assert "rounds_per_search" not in others


class _Evaluator:
    """Stands in for ``CNNEvaluator``: one pass per call, rows of zeros."""

    def __init__(self, L=3):
        self.L = L
        self.lambdas = "seed"
        self.calls = 0

    def _pass(self, s_w, s_a, codes, n_real):
        B = s_w.shape[0]
        z = np.zeros((B, self.L), np.float32)
        return np.ones(B, np.float32), z, z + 0.5, z

    def evaluate_batch(self, xs):
        self.calls += 1
        self._pass(np.zeros((len(xs), self.L)), None, None, len(xs))
        return [{"acc": 1.0} for _ in xs]


def test_probe_passes_attributes_through_and_stamps_rounds():
    ev = _Evaluator()
    t = iter([0.0, 1.0, 2.5, 4.0, 9.0])
    probe = harness.Probe(ev, clock=lambda: next(t))
    assert probe.lambdas == "seed"
    probe.lambdas = "search"
    assert ev.lambdas == "search"
    assert probe.open_window(5.0) == 0.0
    xs = [np.zeros(6), np.ones(6)]
    assert probe.evaluate_batch(xs) == [{"acc": 1.0}] * 2
    probe.evaluate_batch(xs)
    probe.evaluate_batch(xs)
    with pytest.raises(harness.WindowClosed):
        probe.evaluate_batch(xs)
    assert ev.calls == 3
    assert probe.stamps == [1.0, 2.5, 4.0] and probe.closed_at == 9.0
    r = probe.rounds[0]
    assert len(r.xs) == 2 and r.s_a.shape == (2, 3) and r.acc.tolist() == [1, 1]


def test_run_refuses_without_a_card_and_prints_no_result():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, os.path.join(HASSBENCH, "run.py"), "--workload",
         "resnet18.search.b8", "--seed", str(2 ** 33 + 1), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_fails_where_only_the_benchmark_is_there(tmp_path):
    """A checkout with BENCHMARK.json and hassbench/ alone: the program is
    missing, so no result."""
    shutil.copytree(HASSBENCH, tmp_path / "hassbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "hassbench/run.py", "--workload",
         "mobilenetv3l.search.b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        env=env, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "repro"}
    for dirpath, _, files in os.walk(HASSBENCH):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, f)):
                    assert mod.split(".")[0] not in bad, (f, mod)


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(HASSBENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".")[0] in {"__future__", "contextlib",
                                             "importlib", "math", "typing",
                                             "dataclasses", "numpy", "torch",
                                             "hassbench"}, (f, mod)
    code = ("import sys, hassbench.reference.forward, "
            "hassbench.reference.hardware, hassbench.reference.compare, "
            "hassbench.reference.arch_resnet18, "
            "hassbench.reference.arch_mobilenetv3l\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    tops = json.loads(out.stdout.replace("'", '"'))
    assert "repro_torch" not in tops and "repro" not in tops


def test_a_whole_run_loads_no_jax_nor_the_jax_package():
    """The process that runs a cell (on the CPU here, at a small image
    size) holds no module whose top-level name is jax, jaxlib, flax or
    repro once the window has closed; repro_torch, whose name begins with
    repro, is not one of them."""
    code = textwrap.dedent('''
        import json, time
        from hassbench import harness
        cell = harness.find_cell("mobilenetv3l.search.b8")
        out = harness.run(cell, 3, 1.0, True, time.perf_counter(),
                          device="cpu", img_res=32)
        import sys
        print(json.dumps([harness.loaded_forbidden(),
                          "repro_torch" in sys.modules, out["correct"]]))
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=_env(), timeout=600)
    assert out.returncode == 0, out.stderr
    forbidden, has_port, correct = json.loads(out.stdout.splitlines()[-1])
    assert forbidden == [] and has_port and correct


def test_search_mfu_reads_only_the_untraced_searches():
    """The flops of the searches from ``untraced_from`` on, over the time
    from the first of them's start to the window's end; none such, no
    reading."""
    from hassbench import yardstick
    from hassbench.metrics import search_mfu
    from hassbench.reference.layers import load
    cell = harness.find_cell("resnet18.search.b8")
    layers = load("resnet18", 224, 1000)

    def rnd(k):
        return harness.Round([np.zeros(2)] * 8, None, None, None, [], k)
    w = harness.Window(0.0, 10.0, 3, [rnd(0), rnd(1), rnd(2), rnd(2)],
                       [], search_t0=[0.0, 4.0, 6.0], untraced_from=2)
    view = harness.RunView(cell, layers, w, None, [])
    want = 100.0 * yardstick.forward_flops(layers, 8, 16) / 4.0 / \
        yardstick.FP32_FLOPS
    assert search_mfu.read(view) == pytest.approx(want, rel=1e-12)
    w.untraced_from = 3
    assert search_mfu.read(view) is None
