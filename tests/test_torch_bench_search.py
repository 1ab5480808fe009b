"""The search-driven benchmark twins of ``benchmarks_torch/`` against the JAX
package's scripts in ``benchmarks/``, on the CPU.

One JAX ``CNNEvaluator`` is built for the file, as ``benchmarks/
table2_models.py`` builds one, on a reduced MobileNetV3-S (published widths,
32 x 32, 11 classes; C_l from the full 224 x 224 config); the port's
evaluator gets the same JAX-initialised parameters
(``convert.params_from_jax``) and the same numpy images. Then Table II's
``row`` against the JAX script's dense columns, and every search-driven twin
(fig1, fig5, table2, kernels_bench) end to end with ``device="cpu"`` into
a temporary directory at tiny iteration counts: its payload keys are the JAX
script's (the JAX scripts run with their evaluator and training patched to
this file's evaluator, so that they cost nothing to compile), and Fig. 5's
multi-chip partition equals the JAX script's on the same measurements.
``sparsity_bench`` runs end to end in ``test_torch_bench_host.py``, which
builds no JAX evaluator."""
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import benchmarks.common as jcommon  # noqa: E402
from benchmarks import fig1_frontier as jfig1  # noqa: E402
from benchmarks import fig5_search_compare as jfig5  # noqa: E402
from benchmarks import kernels_bench as jkernels_bench  # noqa: E402
from benchmarks import table2_models as jtable2  # noqa: E402
from benchmarks_torch import (fig1_frontier, fig5_search_compare,  # noqa: E402
                              kernels_bench, table2_models)
from repro.configs import reduce_config as jreduce  # noqa: E402
from repro.configs.paper_cnns import MOBILENETV3S as JMOBILENETV3S  # noqa: E402
from repro.core import hass as jhass, perf_model as jpm  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.configs import reduce_config  # noqa: E402
from repro_torch.configs.paper_cnns import MOBILENETV3S, PAPER_CNNS  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import hass as thass, perf_model as tpm  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.search_run import execute_winner, trained_cnn  # noqa: E402

# several test processes run side by side: a few threads each
torch.set_num_threads(2)

BUDGET = table2_models.BUDGETS["mobilenetv3s"]
L = 25                                   # MobileNetV3-S's prunable layers


@functools.lru_cache(maxsize=None)
def _inputs():
    jcfg, cfg = jreduce(JMOBILENETV3S), reduce_config(MOBILENETV3S)
    jparams = jcnn.init_params(jcfg, jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    images = np.random.default_rng(0).normal(
        size=(8, cfg.img_res, cfg.img_res, 3)).astype(np.float32)
    return jcfg, cfg, jparams, params_np, images


@functools.lru_cache(maxsize=None)
def _jax_ev():
    jcfg, _, jparams, _, images = _inputs()
    return jhass.CNNEvaluator(jcfg, jparams, jax.numpy.asarray(images),
                              jpm.FPGAModel(), budget=BUDGET, dse_iters=800,
                              cost_cfg=JMOBILENETV3S)


@functools.lru_cache(maxsize=None)
def _ev():
    _, cfg, _, params_np, images = _inputs()
    return thass.CNNEvaluator(cfg, params_from_jax(params_np),
                              torch.from_numpy(images), tpm.FPGAModel(),
                              budget=BUDGET, dse_iters=800,
                              cost_cfg=MOBILENETV3S)


def _proposal(k):
    """A uniform proposal, a seeded random one, a harsh one with some layers
    left dense."""
    if k == 0:
        return np.full(2 * L, 0.4)
    rng = np.random.default_rng(20 + k)
    x = rng.uniform(0.0, 0.9 if k == 2 else 0.7, size=2 * L)
    if k == 2:
        x[::5] = 0.0
    return x


def _jax_run(mod, tmp, **kw):
    """A JAX benchmark script's ``run`` on this file's JAX evaluator (its
    training and evaluator construction patched out), writing into
    ``tmp``."""
    _, _, jparams, _, _ = _inputs()
    jev = _jax_ev()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(jcommon, "RESULTS_DIR",
                                              str(tmp)))
        stack.enter_context(mock.patch.object(mod, "trained_cnn",
                                              lambda *a, **k: jparams))
        stack.enter_context(mock.patch.object(mod, "CNNEvaluator",
                                              lambda *a, **k: jev))
        if hasattr(mod, "PAPER_CNNS"):
            stack.enter_context(mock.patch.object(mod, "PAPER_CNNS",
                                                  (JMOBILENETV3S,)))
        return mod.run(**kw)


@functools.lru_cache(maxsize=None)
def _jax_payloads(tmp: str) -> dict:
    """fig1, fig5 (with the multi-chip partition) and table2 of the JAX
    scripts, each as the JSON it wrote, and under ``fig5_partitioned_x``
    the proposal whose layers fig5 partitioned."""
    jev = _jax_ev()
    partitioned = []

    def sparse_layers(x, _orig=jev.sparse_layers):
        partitioned.append(np.array(x))
        return _orig(x)

    _jax_run(jfig1, tmp, iters=2, img_res=32)
    with mock.patch.object(jev, "sparse_layers", sparse_layers):
        _jax_run(jfig5, tmp, iters=2, img_res=32, batch_size=0, chips=2)
    _jax_run(jtable2, tmp, iters=2, img_res=32)
    out = {"fig5_partitioned_x": partitioned[0]}
    for name in ("fig1", "fig5", "table2"):
        with open(os.path.join(tmp, f"{name}.json")) as f:
            out[name] = json.load(f)
    return out


@pytest.fixture(scope="module")
def jax_payloads(tmp_path_factory):
    return _jax_payloads(str(tmp_path_factory.mktemp("jax_bench")))


def _load(path):
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------------------ #
# the evaluator on MobileNetV3-S against the JAX package's
# ------------------------------------------------------------------------ #
def test_mobilenetv3s_evaluator_set_up_matches_jax():
    jev, ev = _jax_ev(), _ev()
    assert ev.names == jev.names and len(ev.prunable) == L
    assert ev.dense_thr == jev.dense_thr
    np.testing.assert_allclose(ev.dense_logits, jev.dense_logits,
                               rtol=2e-4, atol=2e-4)
    assert np.array_equal(ev.dense_pred.numpy(), np.asarray(jev.dense_pred))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_mobilenetv3s_measured_sparsities_match_jax(k):
    jev, ev = _jax_ev(), _ev()
    x = _proposal(k)
    jacc, jsw, jsa, jswt, _ = jev._eval_any(x)
    acc, sw, sa, swt, _ = ev._eval_any(x)
    assert sw.shape == sa.shape == (L,)
    np.testing.assert_allclose(sw, jsw, atol=1e-6, rtol=0)
    np.testing.assert_allclose(sa, jsa, atol=1e-3, rtol=0)
    assert np.array_equal(swt, jswt)
    assert abs(float(acc) - float(jacc)) <= 1.0 / 8 + 1e-6


@pytest.mark.parametrize("k", [0, 1, 2])
def test_mobilenetv3s_metrics_fed_jax_measurements_equal_jax_exactly(k):
    jev, ev = _jax_ev(), _ev()
    jacc, jsw, jsa, _, _ = jev._eval_any(_proposal(k))
    assert ev._metrics(float(jacc), jsw, jsa) == \
        jev._metrics(float(jacc), jsw, jsa)


def test_execute_winner_takes_fc_input_from_fc2_on_mobilenetv3():
    """MobileNetV3's classifier reads fc2's output, not the pooled
    features: the second fc product runs on that real input."""
    ev = _ev()
    rows = execute_winner(ev, _proposal(1), max_m=512)
    assert [r["layer"] for r in rows] == ev.names + ["fc"]
    assert [r["x"] for r in rows[-2:]] == ["seeded", "fc2"]
    assert rows[-1]["K"] == 1024 and rows[-1]["M"] == 8
    assert all(r["ok"] for r in rows)
    # single-tile products, whose only tile a proposal may zero
    assert {(27, 16), (16, 16)} <= {(r["K"], r["N"]) for r in rows}


# ------------------------------------------------------------------------ #
# Table II's row against the JAX script
# ------------------------------------------------------------------------ #
def test_table2_row_dense_columns_equal_the_jax_script(jax_payloads):
    want = jax_payloads["table2"]["mobilenetv3s"]
    _, cfg, _, params_np, images = _inputs()
    before = launch_counts()
    r, ev, res = table2_models.row(cfg, params_from_jax(params_np),
                                   torch.from_numpy(images), BUDGET, 2,
                                   cost_cfg=MOBILENETV3S)
    for k in ("dense_images_s", "dense_res", "dense_eff_e9"):
        assert r[k] == want[k], k
    assert set(r) == set(want)
    assert len(res.trials) == 2 and ev.stats_forwards == 2
    assert r["eff_ratio"] > 0 and 0.0 <= r["acc_proxy"] <= 1.0
    assert launch_counts() == before          # the CPU takes plain versions


# ------------------------------------------------------------------------ #
# every search-driven twin end to end on the CPU
# ------------------------------------------------------------------------ #
def test_fig1_end_to_end_on_the_cpu(tmp_path, jax_payloads):
    pts = fig1_frontier.run(iters=2, img_res=32, device="cpu",
                            out_dir=str(tmp_path))
    got = _load(tmp_path / "fig1_cpu.json")
    want = jax_payloads["fig1"]
    assert set(got) == set(want)
    assert set(got["points"][0]) == set(want["points"][0])
    assert len(pts) == 2 and got["points"] == pts


def test_fig5_end_to_end_on_the_cpu(tmp_path, jax_payloads):
    p = fig5_search_compare.run(iters=2, img_res=32, batch_size=2, chips=2,
                                device="cpu", out_dir=str(tmp_path))
    got = _load(tmp_path / "fig5_cpu.json")
    want = jax_payloads["fig5"]
    assert set(got) == set(want) == set(p)
    assert set(got["multi_chip"]) == set(want["multi_chip"])
    assert set(got["hw_best"]) == set(want["hw_best"])
    assert len(got["hw_eff_curve"]) == len(got["sw_eff_curve"]) == 2
    assert got["multi_chip"]["parts"] == len(got["multi_chip"]["cuts"]) + 1


def test_fig5_multi_chip_equals_the_jax_script_on_the_same_measurements(
        jax_payloads):
    """The port's ``multi_chip`` on the layer stack of the proposal the JAX
    script partitioned, built from the JAX evaluator's measurements of it,
    gives the JAX script's ``multi_chip`` payload value for value."""
    jev, ev = _jax_ev(), _ev()
    _, sw, sa, swt, codes = jev._eval_any(jax_payloads["fig5_partitioned_x"])
    layers = ev._sparse_layers(np.asarray(sw), np.asarray(sa),
                               np.asarray(swt) if ev.tiled else None,
                               codes=codes)[0]
    got = json.loads(json.dumps(fig5_search_compare.multi_chip(layers, 2)))
    assert got == jax_payloads["fig5"]["multi_chip"]
    assert got["parts"] == 2 and got["imgs_per_s"] > 0


def test_table2_end_to_end_on_the_cpu(tmp_path, jax_payloads):
    # two SGD steps per model instead of 20: the run's path is the same
    with mock.patch.object(table2_models, "trained_cnn",
                           lambda cfg, steps, device: trained_cnn(
                               cfg, steps=2, device=device)):
        rows = table2_models.run(iters=2, img_res=32, device="cpu",
                                 out_dir=str(tmp_path))
    got = _load(tmp_path / "table2_cpu.json")
    want = jax_payloads["table2"]
    assert set(got) == {c.name for c in PAPER_CNNS} == set(rows)
    for name in got:
        assert set(got[name]) == set(want["mobilenetv3s"]), name
        assert got[name]["eff_ratio"] > 0


def test_kernels_bench_grid_steps_equal_the_jax_script(tmp_path, capsys):
    jkernels_bench.run()
    want = [int(m) for m in re.findall(r"grid_steps=(\d+)/",
                                       capsys.readouterr().out)]
    p = kernels_bench.run(device="cpu", out_dir=str(tmp_path))
    assert [r["grid_steps"] for r in p["bsmm"]] == want and len(want) == 3
    assert [r["dense_steps"] for r in p["bsmm"]] == [8, 8, 8]
    assert all(r["max_abs_err"] <= 1e-4 for r in p["bsmm"])
    assert _load(tmp_path / "kernels_bench_cpu.json")["timer"] == "host clock"


def test_runner_lists_a_subset_of_the_jax_runner():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    lists = []
    for mod in ("benchmarks.run", "benchmarks_torch.run"):
        out = subprocess.run([sys.executable, "-m", mod, "--list"], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        lists.append(out.stdout.split())
    jax_jobs, port_jobs = lists
    assert port_jobs and set(port_jobs) <= set(jax_jobs)
    assert [j for j in jax_jobs if j in port_jobs] == port_jobs
    # every job of the JAX runner has its twin, in the same order
    assert port_jobs == jax_jobs and len(jax_jobs) == 15


def test_runner_on_the_cpu_writes_its_summary(tmp_path):
    from benchmarks_torch import run
    run.main(["--device", "cpu", "--out-dir", str(tmp_path),
              "--only", "fig4,fig6"])
    s = _load(tmp_path / "bench_summary_cpu.json")
    assert [j["job"] for j in s["jobs"]] == ["fig4", "fig6"]
    assert all(j["ok"] and j["launches"] == {"act_clip_count": 0,
                                              "act_clip_count_batched": 0,
                                              "block_sparse_matmul": 0,
                                              "conv_igemm": 0}
               for j in s["jobs"])
    assert s["failures"] == 0 and s["img_res"] == 64
    with pytest.raises(SystemExit):
        run.main(["--device", "cpu", "--out-dir", str(tmp_path),
                  "--only", "nope"])
