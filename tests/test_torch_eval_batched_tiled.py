"""The evaluator's batched program on the tiled model and on the pattern
axis, against the JAX package's vmapped ``_eval_batch`` (tile-structured
pruner, measured all-zero-tile fraction) and ``_eval_p_batch`` (every
pattern branch per layer, selected per proposal by its code) on a reduced
ResNet-18 — one JAX evaluator (``TPUModel`` with all four patterns) for the
file. Then the port's own pieces of the batched pass: each pruner and
threshold over a (B,) tensor against B single calls (and the thresholds
against ``jax.vmap`` of the reference's), and ``cnn.forward_batched``
against the unbatched forward per proposal on MobileNetV3-S (``dwconv``,
SE, two linear layers) and ResNet-18.

Tolerances as in ``test_torch_eval_batched.py``: rel 1e-3 / abs 1e-6 on the
measured sparsities, one image of eight on the accuracy proxy."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduce_config as jreduce
from repro.configs.paper_cnns import RESNET18 as JRESNET18
from repro.core import hass as jhass, perf_model as jpm
from repro.core import pruning as jpruning
from repro.models import cnn as jcnn
from repro_torch.configs import reduce_config
from repro_torch.configs.paper_cnns import MOBILENETV3S, RESNET18
from repro_torch.convert import params_from_jax
from repro_torch.core import hass as thass, perf_model as tpm, pruning
from repro_torch.models import cnn

from _eval_batched import assert_passes_agree, batched_round

torch.set_num_threads(2)

DSE_ITERS, L, B = 150, 21, 3
ALL_PATTERNS = pruning.PATTERNS


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
    tpu = jpm.TPUModel()
    return jhass.CNNEvaluator(jcfg, jparams, jnp.asarray(images), tpu,
                              budget=tpu.chip_budget, dse_iters=DSE_ITERS,
                              patterns=ALL_PATTERNS)


@functools.lru_cache(maxsize=None)
def _ev(patterns=None):
    _, cfg, _, params_np, images = _inputs()
    tpu = tpm.TPUModel()
    return thass.CNNEvaluator(cfg, params_from_jax(params_np),
                              torch.from_numpy(images), tpu,
                              budget=tpu.chip_budget, dse_iters=DSE_ITERS,
                              patterns=patterns)


def test_tiled_seed_program_matches_jax_eval_batch():
    jev, ev = _jax_ev(), _ev()
    s_w, s_a, _ = batched_round(B, L)
    want = tuple(map(np.asarray, jev._eval_batch(
        jev.params, jnp.asarray(s_w), jnp.asarray(s_a))))
    got = ev._pass(s_w, s_a, None, B)
    assert_passes_agree(got, want)
    assert np.any(got[3] > 0.0)               # whole tiles were zeroed


def test_pattern_program_matches_jax_eval_p_batch():
    """All four patterns in every proposal."""
    jev, ev = _jax_ev(), _ev(patterns=ALL_PATTERNS)
    s_w, s_a, codes = batched_round(B, L)
    want = tuple(map(np.asarray, jev._eval_p_batch(
        jev.params, jnp.asarray(s_w), jnp.asarray(s_a),
        jnp.asarray(codes, jnp.int32))))
    got = ev._pass(s_w, s_a, codes, B)
    assert_passes_agree(got, want)
    act = codes == ALL_PATTERNS.index("activation")
    assert np.all(got[1][act] == 0.0)                # dense weights
    nm = codes == ALL_PATTERNS.index("nm")
    assert np.all(got[3][nm] == 0.0)                 # no tile fraction


def test_pattern_program_batched_equals_its_serial_rows():
    """Each row of the batched pattern pass against the same proposal
    through the shape-1 program (the reference's bar), and one shape's
    program bit-equal across two calls; ``evaluate_batch`` routes the same
    proposals through it and scores the pass's rows."""
    ev = _ev(patterns=ALL_PATTERNS)
    s_w, s_a, codes = batched_round(B, L)
    batched = ev._pass(s_w, s_a, codes, B)
    for b in range(B):
        for u, v in zip(batched, ev._eval(s_w[b], s_a[b], codes[b])):
            assert u[b] == pytest.approx(v, rel=1e-3, abs=1e-6)
    xs = [np.concatenate([s_w[b], s_a[b], codes[b] + 0.5]) for b in range(B)]
    shapes = set(ev.batch_shapes)
    want = ev._metrics_batch(batched[0], batched[1], batched[2], batched[3],
                             codes_rows=codes)
    assert ev.evaluate_batch(xs) == want
    assert ev.batch_shapes == shapes | {B}
    assert ev.graphs_captured == 0                    # nothing on the CPU


def test_pruners_take_a_batch_of_sparsities():
    """Each threshold and pruner over a (B,) tensor is B single calls,
    bit for bit, stacked on a new leading axis; the thresholds equal the
    reference's under ``jax.vmap`` bit for bit."""
    w = torch.from_numpy(np.random.default_rng(6).normal(
        size=(3, 3, 24, 40)).astype(np.float32))
    s = torch.tensor([0.0, 0.3, 0.55, 0.9], dtype=torch.float32)
    asort = pruning.sorted_abs(w)
    tau = pruning.threshold_for_sparsity_sorted(asort, s)
    jtau = jax.vmap(jpruning.threshold_for_sparsity_sorted,
                    in_axes=(None, 0))(jnp.asarray(asort.numpy()),
                                       jnp.asarray(s.numpy()))
    assert np.array_equal(tau.numpy(), np.asarray(jtau))
    assert torch.equal(pruning.threshold_for_sparsity(w, s), tau)
    jt = jax.vmap(jpruning.threshold_for_sparsity, in_axes=(None, 0))(
        jnp.asarray(w.numpy()), jnp.asarray(s.numpy()))
    assert np.array_equal(tau.numpy(), np.asarray(jt))
    n = pruning.nm_keep_for_sparsity(s)
    batched = {
        "prune_tensor": pruning.prune_tensor(w, tau),
        "tile_prune": pruning.tile_prune(w, s, bk=16, bn=16),
        "nm_prune": pruning.nm_prune(w, n),
        "hierarchical_prune": pruning.hierarchical_prune(w, s / 2.0, n,
                                                         bk=16, bn=16)}
    for b in range(len(s)):
        single = {
            "prune_tensor": pruning.prune_tensor(
                w, pruning.threshold_for_sparsity_sorted(asort, s[b])),
            "tile_prune": pruning.tile_prune(w, s[b], bk=16, bn=16),
            "nm_prune": pruning.nm_prune(w, n[b]),
            "hierarchical_prune": pruning.hierarchical_prune(
                w, s[b] / 2.0, n[b], bk=16, bn=16)}
        for name, want in single.items():
            got = batched[name]
            if isinstance(want, tuple):
                assert torch.equal(got[0][b], want[0]), name
                assert torch.equal(got[1][b], want[1]), name
            else:
                assert got.shape == (len(s),) + w.shape
                assert torch.equal(got[b], want), name


@pytest.mark.parametrize("base", [MOBILENETV3S, RESNET18],
                         ids=["mobilenetv3s", "resnet18"])
def test_forward_batched_rows_equal_the_unbatched_forward(base):
    """Row b of the batched stats forward (grouped convolutions over the
    proposals' channels, SE and pooling per channel, batched linear layers)
    against ``cnn.forward`` with proposal b's weights and taus."""
    cfg = reduce_config(base)
    gen = torch.Generator()
    gen.manual_seed(1)
    params = cnn.init_params(cfg, gen, device="cpu")
    images = torch.randn((4, cfg.img_res, cfg.img_res, 3), generator=gen)
    names = [s.name for s in cnn.build_specs(cfg) if s.prunable]
    rng = np.random.default_rng(7)
    s = torch.from_numpy(rng.uniform(0.0, 0.8, (B, len(names)))
                         .astype(np.float32))
    weights, taus = {}, {}
    for i, n in enumerate(names):
        w = params[n]["w"]
        weights[n] = pruning.prune_tensor(w, pruning.threshold_for_sparsity(
            w, s[:, i]))
        taus[n] = s[:, i] * 0.5
    with torch.no_grad():
        logits, stats = cnn.forward_batched(cfg, params, weights, images,
                                            taus)
        assert logits.shape == (4, B, cfg.num_classes)
        for b in range(B):
            pb = {k: dict(v) for k, v in params.items()}
            for n in names:
                pb[n]["w"] = weights[n][b]
            want, wstats = cnn.forward(cfg, pb, images, collect_stats=True,
                                       sparsity={n: taus[n][b]
                                                 for n in names})
            np.testing.assert_allclose(logits[:, b].numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-4)
            for n in names:
                assert float(stats[n][b]) == pytest.approx(
                    float(wstats[n]), rel=1e-3, abs=1e-6), n
