"""The port's numeric core (numpy / C: perf model, DSE, partitioning, TPE,
the analytic LM evaluator, configs, obs) against the JAX package's: the same
inputs on the same machine give bit-identical results. Also the import
isolation of the port: it pulls in neither ``jax`` nor ``repro``."""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import dse as jdse, hass as jhass, perf_model as jpm
from repro.core.tpe import TPE as JTPE
from repro_torch import configs as tconfigs
from repro_torch.core import dse as tdse, hass as thass, perf_model as tpm
from repro_torch.core.tpe import TPE as TTPE

CNNS = ["resnet18", "resnet50", "mobilenetv2", "mobilenetv3s", "mobilenetv3l"]


def _as_plain(obj):
    """Dataclass instances of either package -> comparable plain data."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _as_plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, np.ndarray):
        return ("nd", obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, (list, tuple)):
        return [_as_plain(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _as_plain(v) for k, v in obj.items()}
    return obj


def _sparse_stack(pm, configs, arch, seed=1):
    """tests/conftest.py's ``sparse_cnn_workload`` for either package."""
    rng = np.random.default_rng(seed)
    layers = pm.cnn_layer_costs(configs.get_config(arch))
    for l in layers:
        l.s_w = float(rng.uniform(0.1, 0.8))
        l.s_a = float(rng.uniform(0.1, 0.6))
        l.s_w_tile = float(rng.uniform(0.0, 0.4))
    return layers


def test_registry_and_configs_identical():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.list_archs(True) == jconfigs.list_archs(True)
    for name in jconfigs.list_archs():
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert dataclasses.asdict(jconfigs.reduce_config(j)) == \
            dataclasses.asdict(tconfigs.reduce_config(t))
        assert t.to_json() == j.to_json()
    assert tconfigs.get_config("qwen3_0_6b").name == "qwen3-0.6b"
    assert [dataclasses.asdict(s) for s in tconfigs.SHAPES] == \
        [dataclasses.asdict(s) for s in jconfigs.SHAPES]
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", CNNS)
def test_cnn_layer_costs_identical(arch):
    j = jpm.cnn_layer_costs(jconfigs.get_config(arch))
    t = tpm.cnn_layer_costs(tconfigs.get_config(arch))
    assert _as_plain(j) == _as_plain(t)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "deepseek-v3-671b", "rwkv6-1.6b",
                                  "zamba2-1.2b", "whisper-base"])
def test_lm_layer_costs_identical(arch):
    j = jpm.lm_layer_costs(jconfigs.get_config(arch), seq_len=64)
    t = tpm.lm_layer_costs(tconfigs.get_config(arch), seq_len=64)
    assert len(j) == len(t) > 0 and _as_plain(j) == _as_plain(t)


@pytest.mark.parametrize("hw_name,budget", [("FPGAModel", 12234.0),
                                            ("FPGAModel", 3000.0),
                                            ("TPUModel", 4096.0)])
@pytest.mark.parametrize("arch", ["resnet18", "mobilenetv2"])
def test_incremental_dse_and_frontier_bit_identical(arch, hw_name, budget):
    jl = _sparse_stack(jpm, jconfigs, arch)
    tl = _sparse_stack(tpm, tconfigs, arch)
    j = jdse.incremental_dse(jl, getattr(jpm, hw_name)(), budget,
                             max_iters=400)
    t = tdse.incremental_dse(tl, getattr(tpm, hw_name)(), budget,
                             max_iters=400)
    assert _as_plain(j) == _as_plain(t)          # designs, trace, frontier
    assert t.frontier is not None and len(t.frontier.res) > 1
    for b in (0.25 * budget, 0.6 * budget, budget):
        assert j.frontier.best_under(b) == t.frontier.best_under(b)


def test_dse_ref_engine_and_batch_engine_agree_with_jax_package():
    jl = _sparse_stack(jpm, jconfigs, "resnet18", seed=3)
    tl = _sparse_stack(tpm, tconfigs, "resnet18", seed=3)
    jhw, thw = jpm.FPGAModel(), tpm.FPGAModel()
    jr = jdse.incremental_dse_ref(jl, jhw, 6000.0, max_iters=150)
    tr = tdse.incremental_dse_ref(tl, thw, 6000.0, max_iters=150)
    assert _as_plain(jr) == _as_plain(tr)
    S = np.random.default_rng(0).uniform(0.0, 0.9, size=(5, len(tl)))
    jc, tc = jdse.DSECache(), tdse.DSECache()
    jb = jc.dse_vec_batch(jhw.layer_vectors(jl), jhw, 6000.0, S, max_iters=200)
    tb = tc.dse_vec_batch(thw.layer_vectors(tl), thw, 6000.0, S, max_iters=200)
    assert _as_plain([r.frontier for r in jb]) == \
        _as_plain([r.frontier for r in tb])
    assert [r.throughput for r in jb] == [r.throughput for r in tb]
    assert jc.stats() == tc.stats()


@pytest.mark.parametrize("objective,chips", [("sum", 1), ("maxmin", 4),
                                             ("auto", 4)])
def test_partition_pipeline_bit_identical(objective, chips):
    jl = _sparse_stack(jpm, jconfigs, "resnet18")
    tl = _sparse_stack(tpm, tconfigs, "resnet18")
    if chips > 1:
        jhw, thw = jpm.TPUModel(chips=chips), tpm.TPUModel(chips=chips)
        jb, tb = jhw.chip_budget, thw.chip_budget
    else:
        jhw, thw, jb, tb = jpm.FPGAModel(), tpm.FPGAModel(), 4096.0, 4096.0
    assert jb == tb
    j = jdse.partition_pipeline(jl, jhw, jb, n_parts=4, batch=256,
                                dse_iters=150, objective=objective)
    t = tdse.partition_pipeline(tl, thw, tb, n_parts=4, batch=256,
                                dse_iters=150, objective=objective)
    assert _as_plain(j) == _as_plain(t)


def test_partition_slo_objective_waits_for_the_simulator():
    """``objective="slo"`` delegates to the port's simulator
    (``sim.slo.slo_partition_search``): on the same layers and trace its
    pick, with the winning ``sim_report``, equals the JAX package's."""
    from repro import sim as jsim
    from repro_torch import sim as tsim
    picks = []
    for pm, configs, dse, sim in ((jpm, jconfigs, jdse, jsim),
                                  (tpm, tconfigs, tdse, tsim)):
        layers = _sparse_stack(pm, configs, "resnet18", seed=0)
        tpu = pm.TPUModel(chips=4)
        kw = dict(n_parts=4, batch=16, dse_iters=80)
        mm = dse.partition_pipeline(layers, tpu, tpu.chip_budget,
                                    objective="maxmin", **kw)
        rate = sim.request_rate(mm.steady_throughput, 0.4, 16)
        tr = sim.mmpp_trace(250, 0.6 * rate, 3 * rate, dwell_base=4 / rate,
                            dwell_burst=1 / rate, sizes=16, seed=0)
        p99 = sim.simulate_partition(layers, tpu, mm, tr).p99
        picks.append(dse.partition_pipeline(
            layers, tpu, tpu.chip_budget, objective="slo",
            slo=sim.SLO(target=0.9 * p99), trace=tr, **kw))
    j, t = picks
    assert t.objective == "slo" and t.sim_report is not None
    assert _as_plain(j) == _as_plain(t)
    tl = _sparse_stack(tpm, tconfigs, "resnet18")
    with pytest.raises(ValueError):
        tdse.partition_pipeline(tl, tpm.FPGAModel(), 4096.0, n_parts=2,
                                objective="nope")


@pytest.mark.parametrize("cats", [None, np.array([0, 0, 3, 4])])
def test_tpe_streams_identical(cats):
    def f(x):
        return -float(np.sum((x - 0.3) ** 2))
    lo, hi = np.zeros(4), np.array([1.0, 1.0, 3.0, 4.0])
    j, t = JTPE(lo=lo, hi=hi, seed=5, cats=cats), \
        TTPE(lo=lo, hi=hi, seed=5, cats=cats)
    for _ in range(30):
        xj, xt = j.ask(), t.ask()
        assert np.array_equal(xj, xt)
        j.tell(xj, f(xj))
        t.tell(xt, f(xt))
    for liar in ("min", None):
        bj, bt = j.ask_batch(4, liar=liar), t.ask_batch(4, liar=liar)
        assert all(np.array_equal(a, b) for a, b in zip(bj, bt))
        j.tell_batch(bj, [f(x) for x in bj])
        t.tell_batch(bt, [f(x) for x in bt])


@pytest.mark.parametrize("liar", ["min", None])
@pytest.mark.parametrize("dim", [42, 66])
def test_tpe_streams_identical_at_the_benchmarks_dims(dim, liar):
    """96-trial searches in rounds of 8 at the benchmark cells' dims
    (ResNet-18's 42, MobileNetV3-L's 66), scores rounded to 0.1 so the
    good/bad split meets ties: every proposal equal to the reference's."""
    centre = np.random.default_rng(dim).uniform(0.0, 0.95, dim)

    def f(x):
        return round(-float(np.sum((x - centre) ** 2)), 1)
    lo, hi = np.zeros(dim), np.full(dim, 0.95)
    j, t = JTPE(lo=lo, hi=hi, seed=11), TTPE(lo=lo, hi=hi, seed=11)
    for _ in range(12):
        bj, bt = j.ask_batch(8, liar=liar), t.ask_batch(8, liar=liar)
        assert all(np.array_equal(a, b) for a, b in zip(bj, bt))
        j.tell_batch(bj, [f(x) for x in bj])
        t.tell_batch(bt, [f(x) for x in bt])


@pytest.mark.parametrize("kw", [
    dict(hw="FPGAModel", batch_size=None, hardware_aware=True),
    dict(hw="FPGAModel", batch_size=4, hardware_aware=True),
    dict(hw="TPUModel", batch_size=3, hardware_aware=True, include_act=False),
    dict(hw="FPGAModel", batch_size=4, hardware_aware=False),
    dict(hw="TPUModel", batch_size=4, hardware_aware=True,
         patterns=("unstructured", "nm", "hierarchical", "activation"),
         pattern_costs={"nm": 1.3, "hierarchical": 1.6}),
])
def test_hass_search_transcript_over_lm_evaluator_identical(kw):
    kw = dict(kw)
    hw = kw.pop("hw")
    ev_kw = {k: kw.pop(k) for k in ("patterns", "pattern_costs") if k in kw}
    jev = jhass.LMEvaluator(jconfigs.get_config("qwen3-0.6b"),
                            getattr(jpm, hw)(), budget=4096.0, dse_iters=120,
                            **ev_kw)
    tev = thass.LMEvaluator(tconfigs.get_config("qwen3-0.6b"),
                            getattr(tpm, hw)(), budget=4096.0, dse_iters=120,
                            **ev_kw)
    assert jev.n_search == tev.n_search and jev.dense_thr == tev.dense_thr
    lam = dict(spa=0.3, thr=0.5, dsp=0.3, meas=0.2 if ev_kw else 0.0)
    jr = jhass.hass_search(jev, jev.n_search, iters=12, seed=3,
                           lambdas=jhass.Lambdas(**lam), **kw)
    tr = thass.hass_search(tev, tev.n_search, iters=12, seed=3,
                           lambdas=thass.Lambdas(**lam), **kw)
    assert len(jr.trials) == len(tr.trials) == 12
    for a, b in zip(jr.trials, tr.trials):               # trial for trial
        assert np.array_equal(a.x, b.x)
        assert a.score == b.score and a.metrics == b.metrics
    assert jr.best_score == tr.best_score
    assert np.array_equal(jr.best_x, tr.best_x)
    assert jr.running_best("eff") == tr.running_best("eff")


def test_flight_recorder_and_tracer_of_the_port(tmp_path):
    from repro_torch import obs
    tev = thass.LMEvaluator(tconfigs.get_config("qwen3-0.6b"),
                            tpm.FPGAModel(), budget=4096.0, dse_iters=60)
    bare = thass.hass_search(tev, tev.n_search, iters=5, seed=1)
    path = tmp_path / "run.jsonl"
    tracer = obs.Tracer()
    with obs.use_tracer(tracer), obs.FlightRecorder(str(path)) as rec:
        seen = thass.hass_search(tev, tev.n_search, iters=5, seed=1,
                                 recorder=rec)
    # instrumentation reads clocks and counters only: same transcript
    assert [t.score for t in bare.trials] == [t.score for t in seen.trials]
    run = obs.load_run(str(path))
    assert len(run["trials"]) == 5
    assert run["footer"]["best_score"] == seen.best_score
    assert sum(e["name"] == "trial" for e in tracer.events) == 5


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "import repro_torch.configs, repro_torch.obs, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.build\n"
        "import repro_torch.models.cnn, repro_torch.data.synthetic\n"
        "import repro_torch.core.pruning, repro_torch.core.perf_model\n"
        "import repro_torch.core.dse, repro_torch.core.tpe\n"
        "import repro_torch.core.hass, repro_torch.search_run\n"
        "import repro_torch.models, repro_torch.models.attention\n"
        "import repro_torch.models.transformer, repro_torch.models.moe\n"
        "import repro_torch.models.ssm, repro_torch.models.rwkv\n"
        "import repro_torch.sim, repro_torch.sim.trace\n"
        "import repro_torch.serve.serve_loop, repro_torch.device\n"
        "import repro_torch.kernels.kernel_costs, repro_torch.sim.engine\n"
        "import repro_torch.sim.faults, repro_torch.sim.slo\n"
        "import repro_torch.serve.fleet, repro_torch.deploy_run\n"
        "import repro_torch.train.optimizer, repro_torch.train.train_loop\n"
        "import repro_torch.train.checkpoint\n"
        "import repro_torch.train.fault_tolerance, repro_torch.data.pipeline\n"
        "import repro_torch.distributed.collectives\n"
        "import repro_torch.distributed.sharding, repro_torch.distributed.ctx\n"
        "import repro_torch.distributed.pipeline, repro_torch.launch.mesh\n"
        "import repro_torch.launch.dryrun, repro_torch.analysis.roofline\n"
        "import torch.distributed as dist\n"
        "import benchmarks_torch.run, benchmarks_torch.common\n"
        "import benchmarks_torch.fig1_frontier, benchmarks_torch.fig4_dse_allocation\n"
        "import benchmarks_torch.fig5_search_compare, benchmarks_torch.fig6_speedup\n"
        "import benchmarks_torch.table2_models, benchmarks_torch.dse_bench\n"
        "import benchmarks_torch.kernels_bench, benchmarks_torch.search_bench\n"
        "import benchmarks_torch.sparsity_bench\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.') or m == 'benchmarks' or "
        "m.startswith('benchmarks.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n")
    import os
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src
    # from the repository's root, where benchmarks_torch is a package
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=os.path.join(os.path.dirname(__file__), ".."),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"


def test_no_jax_import_statement_in_the_port_sources():
    import os
    import re
    root = os.path.join(os.path.dirname(__file__), "..")
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                     r"from repro[. ]|import benchmarks\b|"
                     r"from benchmarks[. ])", re.M)
    import glob
    examples = sorted(glob.glob(os.path.join(root, "examples",
                                             "*_torch.py")))
    assert len(examples) == 9
    files = [os.path.join(root, "chip_smoke.py"), *examples]
    for d, _, names in os.walk(os.path.join(root, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bench = os.path.join(root, "benchmarks_torch")
    twins = [os.path.join(bench, n) for n in sorted(os.listdir(bench))
             if n.endswith(".py")]
    assert len(twins) == 18
    files += twins
    assert len(files) > 40
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f
