"""The slice as a whole: ``repro_torch.core.hass.CNNEvaluator`` against
``repro.core.hass.CNNEvaluator`` on a reduced ResNet-18 — the same
JAX-initialised parameters (carried over by ``convert.params_from_jax``) and
the same numpy calibration images go through both, proposal for proposal.
Then the port's own invariants (serial == ``batch_size=1``, batched == serial,
the pattern axis, the tiled pruner) and the shared runner
(``search_run``) end to end on the CPU at a small size.

Two JAX evaluators are built for the whole file (the default one, shared by
the parity tests, and one with the full pattern axis on the tiled model);
each jitted prune+forward compiles once."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduce_config as jreduce
from repro.configs.paper_cnns import RESNET18 as JRESNET18
from repro.core import hass as jhass, perf_model as jpm
from repro.models import cnn as jcnn
from repro_torch.configs import reduce_config
from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.convert import params_from_jax
from repro_torch.core import hass as thass, perf_model as tpm, pruning
from repro_torch.kernels import launch_counts
from repro_torch.models import cnn

# the suite runs several test processes side by side: a few threads each
# instead of every core each (the shapes here are tiny)
torch.set_num_threads(2)

BUDGET, DSE_ITERS, L = 4096, 150, 21
ALL_PATTERNS = ("unstructured", "nm", "hierarchical", "activation")


@functools.lru_cache(maxsize=None)
def _inputs():
    jcfg, cfg = jreduce(JRESNET18), reduce_config(RESNET18)
    jparams = jcnn.init_params(jcfg, jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    images = np.random.default_rng(0).normal(
        size=(8, cfg.img_res, cfg.img_res, 3)).astype(np.float32)
    return jcfg, cfg, jparams, params_np, images


@functools.lru_cache(maxsize=None)
def _jax_ev():
    jcfg, _, jparams, _, images = _inputs()
    return jhass.CNNEvaluator(jcfg, jparams, jax.numpy.asarray(images),
                              jpm.FPGAModel(), budget=BUDGET,
                              dse_iters=DSE_ITERS)


@functools.lru_cache(maxsize=None)
def _ev(hw="FPGAModel", patterns=None, costs=False, accel=True):
    _, cfg, _, params_np, images = _inputs()
    model = getattr(tpm, hw)()
    budget = model.chip_budget if hw == "TPUModel" else BUDGET
    pattern_costs = {"unstructured": 1.0, "nm": 2.2, "hierarchical": 1.8,
                     "activation": 1.0} if costs else None
    return thass.CNNEvaluator(cfg, params_from_jax(params_np),
                              torch.from_numpy(images), model, budget=budget,
                              dse_iters=DSE_ITERS, patterns=patterns,
                              pattern_costs=pattern_costs, accel=accel)


def _proposal(k):
    """Three fixed proposals: a uniform one, a seeded random one, a harsh
    one with some layers left dense."""
    if k == 0:
        return np.full(2 * L, 0.4)
    rng = np.random.default_rng(10 + k)
    x = rng.uniform(0.0, 0.9 if k == 2 else 0.7, size=2 * L)
    if k == 2:
        x[::5] = 0.0
    return x


def test_evaluator_set_up_matches_jax():
    jev, ev = _jax_ev(), _ev()
    assert ev.names == jev.names and len(ev.prunable) == L
    assert ev.dense_thr == jev.dense_thr
    # dense logits: conv summation order differs between the frameworks
    np.testing.assert_allclose(ev.dense_logits, jev.dense_logits,
                               rtol=2e-4, atol=2e-4)
    assert np.array_equal(ev.dense_pred.numpy(), np.asarray(jev.dense_pred))
    # the tau_a tables are np.quantile of activations that agree to 2e-4;
    # the port keeps its table on the evaluator's device, in float32
    np.testing.assert_allclose(ev._act_q.cpu().numpy(), np.asarray(jev._act_q),
                               rtol=2e-4, atol=2e-4)
    assert ev._act_q.dtype == torch.float32 and ev._act_q.device == ev.device


@pytest.mark.parametrize("k", [0, 1, 2])
def test_measured_sparsities_match_jax(k):
    jev, ev = _jax_ev(), _ev()
    x = _proposal(k)
    jacc, jsw, jsa, jswt, jcodes = jev._eval_any(x)
    acc, sw, sa, swt, codes = ev._eval_any(x)
    assert codes is None and jcodes is None
    assert sw.dtype == sa.dtype == np.float32 and sw.shape == sa.shape == (L,)
    # the same thresholds on the same weights: the zero fractions are equal
    # up to the float32 mean's summation order
    np.testing.assert_allclose(sw, jsw, atol=1e-6, rtol=0)
    # an activation within rounding of tau may fall on the other side
    np.testing.assert_allclose(sa, jsa, atol=1e-3, rtol=0)
    assert np.array_equal(swt, jswt)                 # FPGA model: all zero
    # the accuracy proxy is a count over 8 images: within one image
    assert abs(float(acc) - float(jacc)) <= 1.0 / 8 + 1e-6


@pytest.mark.parametrize("k", [0, 1, 2])
def test_metrics_fed_jax_measurements_equal_jax_exactly(k):
    """The host half (perf model, DSE, frontier, Eq. 6) is bit-identical:
    the port's ``_metrics`` on JAX's measured arrays gives JAX's dict."""
    jev, ev = _jax_ev(), _ev()
    jacc, jsw, jsa, _, _ = jev._eval_any(_proposal(k))
    want = jev._metrics(float(jacc), jsw, jsa)
    got = ev._metrics(float(jacc), jsw, jsa)
    assert got == want
    rows = ev._metrics_batch(np.array([jacc, jacc]), np.stack([jsw, jsw]),
                             np.stack([jsa, jsa]), None)
    assert rows[0] == want and rows[1] == want


def test_dense_proposal_and_metric_contract():
    ev = _ev()
    dense = ev(np.zeros(2 * L))
    assert dense["acc"] == 1.0 and dense["spa"] < 0.45
    hi = ev(np.full(2 * L, 0.7))
    assert hi["thr"] > dense["thr"]
    for m in (dense, hi):
        assert 0.0 <= m["acc"] <= 1.0 and 0.0 <= m["spa"] <= 1.0
        assert m["thr"] > 0 and m["dsp"] <= 1.0 + 1e-6


def test_batched_equals_serial_exactly():
    """The JAX package's contract for its vmapped program: one batched pass
    scores B proposals as the serial (shape-1) program does within rel 1e-3
    / abs 1e-6 (grouped convolutions may sum in another order), and one
    shape's program is deterministic: the same round twice is bit-equal."""
    ev = _ev()
    xs = [_proposal(k) for k in range(3)]
    before, passes = ev.stats_forwards, ev.stats_passes
    batch = ev.evaluate_batch(xs)
    assert ev.stats_forwards == before + 3 and ev.stats_passes == passes + 1
    assert ev.evaluate_batch([]) == [] and 3 in ev.batch_shapes
    assert ev.evaluate_batch(xs) == batch
    for x, mb in zip(xs, batch):
        ms = ev(x)
        for k in ms:
            assert mb[k] == pytest.approx(ms[k], rel=1e-3, abs=1e-6), k


@pytest.mark.parametrize("hardware_aware", [True, False])
def test_batch_size_one_replays_the_serial_search(hardware_aware):
    ev = _ev()
    kw = dict(iters=5, s_max=0.9, seed=1, hardware_aware=hardware_aware)
    serial = thass.hass_search(ev, L, **kw)
    replay = thass.hass_search(ev, L, batch_size=1, **kw)
    assert len(serial.trials) == 5
    for a, b in zip(serial.trials, replay.trials):
        assert np.array_equal(a.x, b.x)
        assert a.metrics == b.metrics and a.score == b.score
    assert serial.best_score == replay.best_score


def test_batched_search_keeps_the_best_scoring_trial():
    ev = _ev()
    r = thass.hass_search(ev, L, iters=6, s_max=0.9, seed=0, batch_size=3)
    assert len(r.trials) == 6 and len(r.best_x) == 2 * L
    assert all(np.isfinite(t.score) for t in r.trials)
    best = max(r.trials, key=lambda t: t.score)
    assert r.best_score == best.score and np.array_equal(r.best_x, best.x)
    assert r.running_best("eff")[-1] == best.metrics["eff"]


def test_seed_path_without_accel_gives_the_same_measurements():
    """``accel=False`` re-sorts inside every proposal and runs the DSE
    uncached: the same thresholds, hence the same measurements."""
    x = _proposal(1)
    a, b = _ev()._eval_any(x), _ev(accel=False)._eval_any(x)
    for u, v in zip(a[:4], b[:4]):
        assert np.array_equal(u, v)
    assert _ev(accel=False)(x) == _ev()(x)


def test_unstructured_only_pattern_axis_is_the_seed_path():
    base, pat = _ev(), _ev(patterns=("unstructured",))
    assert pat.n_pattern_dims == 0 and not pat._needs_pattern_eval
    kw = dict(iters=4, s_max=0.9, seed=2, batch_size=2)
    r0 = thass.hass_search(base, L, **kw)
    r1 = thass.hass_search(pat, L, **kw)
    for t0, t1 in zip(r0.trials, r1.trials):
        assert np.array_equal(t0.x, t1.x) and t0.metrics == t1.metrics


def test_pattern_axis_prunes_each_layer_by_its_code():
    ev = _ev(patterns=ALL_PATTERNS)
    assert ev.n_pattern_dims == L and ev._needs_pattern_eval
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, L)
    codes[0] = ALL_PATTERNS.index("activation")
    x = np.concatenate([rng.uniform(0.2, 0.8, 2 * L), codes + 0.5])
    acc, sw, sa, swt, got_codes = ev._eval_any(x)
    assert np.array_equal(got_codes, codes)
    s_w, s_a = ev._split(x)
    for i, n in enumerate(ev.names):
        w = ev.params[n]["w"]
        name = ALL_PATTERNS[codes[i]]
        if name == "activation":                     # weights stay dense
            want = w
        elif name == "nm":
            want = pruning.nm_prune(w, pruning.nm_keep_for_sparsity(s_w[i]))
        elif name == "hierarchical":
            want, frac = pruning.hierarchical_prune(
                w, s_w[i] / np.float32(2.0), pruning.nm_keep_for_sparsity(
                    np.clip(s_w[i] / (np.float32(2.0) - s_w[i]), 0, 1)))
            assert swt[i] == np.float32(frac)
        else:
            want = pruning.prune_tensor(
                w, pruning.threshold_for_sparsity_sorted(ev._asort[n], s_w[i]))
        assert sw[i] == np.float32((want == 0).float().mean()), (n, name)
    # an "activation" layer spends its weight budget as extra clipping; the
    # stem reads the images, so nothing upstream of it differs
    plain = _ev()._eval_any(x[:2 * L])
    act = codes == ALL_PATTERNS.index("activation")
    assert np.all(sw[act] == 0.0) and sa[0] > plain[2][0]


def test_pattern_axis_on_the_tiled_model_matches_jax():
    """Every pattern branch and the tiled pruner against the JAX package's
    traced ``lax.switch`` dispatch, on proposals that use all four codes."""
    jcfg, _, jparams, _, images = _inputs()
    jtpu = jpm.TPUModel()
    jev = jhass.CNNEvaluator(jcfg, jparams, jax.numpy.asarray(images), jtpu,
                             budget=jtpu.chip_budget, dse_iters=DSE_ITERS,
                             patterns=ALL_PATTERNS)
    ev = _ev(hw="TPUModel", patterns=ALL_PATTERNS)
    rng = np.random.default_rng(9)
    for _ in range(2):
        codes = rng.permutation(np.arange(L) % 4)
        x = np.concatenate([rng.uniform(0.1, 0.8, 2 * L), codes + 0.5])
        jacc, jsw, jsa, jswt, jcodes = jev._eval_any(x)
        acc, sw, sa, swt, got = ev._eval_any(x)
        assert np.array_equal(got, jcodes) and np.array_equal(got, codes)
        np.testing.assert_allclose(sw, jsw, atol=1e-6, rtol=0)
        np.testing.assert_allclose(swt, jswt, atol=1e-6, rtol=0)
        np.testing.assert_allclose(sa, jsa, atol=1e-3, rtol=0)
        assert abs(float(acc) - float(jacc)) <= 1.0 / 8 + 1e-6
        assert ev._metrics(float(jacc), jsw, jsa, jswt, codes=jcodes) == \
            jev._metrics(float(jacc), jsw, jsa, jswt, codes=jcodes)


def test_pattern_search_emits_meas_and_batches_like_serial():
    ev = _ev(hw="TPUModel", patterns=ALL_PATTERNS, costs=True)
    assert ev.tiled and ev.n_pattern_dims == L
    r = thass.hass_search(ev, L, iters=4, s_max=0.9, seed=0,
                          lambdas=thass.Lambdas(meas=0.1))
    for t in r.trials:
        assert len(t.x) == 3 * L
        assert np.all((t.x[-L:] >= 0) & (t.x[-L:] < 4))
        assert "meas" in t.metrics and t.metrics["meas"] >= 0.0
    layers = ev.sparse_layers(r.best_x)
    assert {l.pattern for l in layers if l.prunable} <= set(ALL_PATTERNS)
    xs = [t.x for t in r.trials[:3]]
    for x, mb in zip(xs, ev.evaluate_batch(xs)):
        assert mb == ev(x)


def test_tiled_pruner_measures_s_w_tile_on_the_pruned_weights():
    ev = _ev(hw="TPUModel")
    assert ev.tiled and ev._asort is None
    x = np.full(2 * L, 0.6)
    pr = [l for l in ev.sparse_layers(x) if l.prunable]
    assert all(0.0 <= l.s_w_tile <= 1.0 for l in pr)
    assert any(l.s_w_tile > 0.0 for l in pr)
    w2, frac = pruning.tile_prune(ev.params[ev.names[0]]["w"], np.float32(0.6))
    assert float(frac) == pytest.approx(pruning.tile_sparsity(w2))
    assert pr[0].s_w_tile == float(frac)
    m, m_dense = ev(x), ev(np.zeros(2 * L))
    assert m["thr"] >= m_dense["thr"] > 0 and m["dsp"] <= 1.0 + 1e-6


def test_unknown_pattern_is_refused():
    _, cfg, _, params_np, images = _inputs()
    with pytest.raises(ValueError, match="unknown patterns"):
        thass.CNNEvaluator(cfg, params_from_jax(params_np),
                           torch.from_numpy(images), tpm.FPGAModel(),
                           budget=BUDGET, patterns=("bogus",))


def test_search_run_end_to_end_on_the_cpu():
    """``search_compare`` then ``execute_winner`` — what the example and
    ``chip_smoke.py`` run — at a small size on the CPU, where the wrappers
    take the plain versions: no kernel is launched."""
    from repro_torch.search_run import (dse_backend, execute_winner,
                                           search_compare)
    base = reduce_config(RESNET18)
    before = launch_counts()
    payload = search_compare(iters=4, img_res=32, seed=0, budget=BUDGET,
                             batch_size=2, device="cpu", train_steps=2,
                             base_cfg=base)
    assert payload["device"] == "cpu"
    assert payload["dse_backend"] == dse_backend() in ("c", "numpy")
    assert len(payload["hw_eff_curve"]) == len(payload["sw_eff_curve"]) == 4
    assert payload["trials_per_s"] > 0
    ev = payload["ev"]
    assert ev.device.type == "cpu" and ev.stats_forwards == 8
    rows = execute_winner(ev, payload["hw_result"].best_x, max_m=512)
    assert [r["layer"] for r in rows] == ev.names + ["fc"]
    assert [r["x"] for r in rows[-2:]] == ["seeded", "gap"]
    assert all(r["ok"] and r["M"] <= 512 for r in rows)
    assert all(0 < r["schedule_steps"] <= r["dense_steps"] for r in rows)
    assert launch_counts() == before


def test_search_run_asks_for_the_card_and_refuses_without_one():
    from repro_torch.search_run import resolve_device
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()


class _WatchedEvaluator:
    """A stand-in evaluator that records every attribute written to it
    after construction; it carries the attributes a search may look up."""

    def __init__(self):
        for k, v in (("writes", []), ("lambdas", thass.Lambdas()),
                     ("dse_cache", None)):
            object.__setattr__(self, k, v)

    def __setattr__(self, name, value):
        self.writes.append(name)
        object.__setattr__(self, name, value)

    def __call__(self, x):
        s = float(np.mean(x))
        return {"acc": 1.0 - s * s, "spa": s, "thr": 1.0 + s,
                "thr_norm": s, "dsp": 0.5 * s, "eff": 1.0}

    def evaluate_batch(self, xs):
        return [self(x) for x in xs]


@pytest.mark.parametrize("kw", [
    dict(batch_size=None), dict(batch_size=1), dict(batch_size=4),
    dict(batch_size=None, x0=np.zeros(6)), dict(batch_size=4, x0=np.zeros(6)),
])
def test_search_writes_no_attribute_of_its_evaluator(kw):
    ev = _WatchedEvaluator()
    lam = ev.lambdas
    r = thass.hass_search(ev, 3, iters=7, seed=0, hardware_aware=True,
                          lambdas=thass.Lambdas(thr=0.9), **kw)
    assert len(r.trials) == 7
    assert ev.writes == [] and ev.lambdas is lam


def _dse_plain(r):
    f = r.frontier
    return (r.throughput, r.resource, r.throughput_per_res, r.trace,
            r.theta_r, r.designs, f.res.tobytes(), f.thr.tobytes(),
            f.spe.tobytes(), f.n.tobytes())


def _interleaved_rows(kind):
    """(evaluator, DSE rows of two t_scale groups, interleaved): the seed
    pruner's rows (no decode cost) and N:M rows (decode factor 2.2)."""
    rng = np.random.default_rng(4)
    if kind == "cnn":
        ev = _ev(hw="TPUModel", patterns=ALL_PATTERNS, costs=True)
        rows = []
        for b in range(4):
            sw, sa = rng.uniform(0.0, 0.9, (2, L)).astype(np.float32)
            layers, _ = ev._sparse_layers(sw, sa, sw,
                                          codes=np.full(L, b % 2))
            rows.append(ev.hw.layer_vectors(layers))
        return ev, rows
    from repro_torch import configs as tconfigs
    ev = thass.LMEvaluator(
        tconfigs.get_config("qwen3-0.6b"), tpm.TPUModel(), budget=4096.0,
        dse_iters=120, patterns=ALL_PATTERNS,
        pattern_costs={"nm": 2.2, "hierarchical": 1.8})
    rows = [ev._row(np.concatenate([
        rng.uniform(0.0, 0.9, ev.n_search),
        np.full(ev.n_pattern_dims, float(b % 2))]))[-1] for b in range(4)]
    return ev, rows


@pytest.mark.parametrize("kind", ["cnn", "lm"])
def test_batch_dse_gives_each_row_its_own_result(kind):
    ev, rows = _interleaved_rows(kind)
    keys = [None if lv.t_scale is None else lv.t_scale.tobytes()
            for lv in rows]
    assert keys[0] is None and keys[1] is not None
    assert keys[0::2] == [keys[0]] * 2 and keys[1::2] == [keys[1]] * 2
    h = ev.hardware
    assert h.batched(len(rows))
    alone = thass.HardwareTerms(
        h.hw, h.budget, h.dse_iters, h.dse_engine, h.batch_dse,
        cache=type(h.cache)(materialize_designs=h.cache.materialize_designs),
        dense=ev.layers)
    assert alone.dense_thr == ev.dense_thr
    got = h.dse_batch(rows)
    want = [alone.dse(lv) for lv in rows]
    assert [_dse_plain(r) for r in got] == [_dse_plain(r) for r in want]
    assert [h.terms(r) for r in got] == [alone.terms(r) for r in want]
