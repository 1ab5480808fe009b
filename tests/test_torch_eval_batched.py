"""The evaluator's batched program against the JAX package's vmapped one, on
a reduced ResNet-18 (32 x 32, 8 calibration images): the same
JAX-initialised parameters (``convert.params_from_jax``), the same images
and the same numpy proposals go through the reference's ``_eval_batch`` /
``_eval_p_batch`` and the port's batched pass (``CNNEvaluator._pass``, run
eagerly on the CPU through the kernels' plain versions). Then the
reference's batch-shape bucketing, rule for rule, and the batched clip's
plain version against ``jax.vmap`` of the reference's ``ops.act_clip`` in
interpret mode.

One JAX evaluator is built for the file (the FPGA model: its
``_eval_batch`` is the seed program). The tiled model and the pattern
program have a file of their own, ``test_torch_eval_batched_tiled.py``.

Tolerances: measured s_a and achieved s_w within rel 1e-3 / abs 1e-6 (the
reference's own bar for batched against serial); the accuracy proxy counts
8 images, so it may differ by one image where a convolution's summation
order moves one argmax."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduce_config as jreduce
from repro.configs.paper_cnns import RESNET18 as JRESNET18
from repro.core import hass as jhass, perf_model as jpm
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro_torch.configs import reduce_config
from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.convert import params_from_jax
from repro_torch.core import hass as thass, perf_model as tpm
from repro_torch.kernels import act_clip, launch_counts

from _eval_batched import assert_passes_agree, batched_round

torch.set_num_threads(2)

BUDGET, DSE_ITERS, L, B = 4096, 150, 21, 3


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
    return jhass.CNNEvaluator(jcfg, jparams, jnp.asarray(images),
                              jpm.FPGAModel(), budget=BUDGET,
                              dse_iters=DSE_ITERS)


@functools.lru_cache(maxsize=None)
def _ev(accel=True):
    _, cfg, _, params_np, images = _inputs()
    return thass.CNNEvaluator(cfg, params_from_jax(params_np),
                              torch.from_numpy(images), tpm.FPGAModel(),
                              budget=BUDGET, dse_iters=DSE_ITERS,
                              accel=accel)


@functools.lru_cache(maxsize=None)
def _jax_pass():
    jev = _jax_ev()
    s_w, s_a, _ = batched_round(B, L)
    out = jev._eval_batch(jev.params, jnp.asarray(s_w), jnp.asarray(s_a))
    return tuple(map(np.asarray, out))


@pytest.mark.parametrize("accel", [True, False])
def test_seed_program_matches_jax_eval_batch(accel):
    """``accel`` gathers tau_w from presorted tables, ``accel=False``
    re-sorts every layer inside the pass; both give the reference's
    vmapped prune + clipped stats forward."""
    ev = _ev(accel=accel)
    s_w, s_a, _ = batched_round(B, L)
    passes = ev.stats_passes
    got = ev._pass(s_w, s_a, None, B)
    assert ev.stats_passes == passes + 1
    assert_passes_agree(got, _jax_pass())
    assert np.all(got[3] == 0.0)                     # FPGA model: no tiles


def test_seed_program_batched_equals_its_serial_rows():
    """The reference's bar inside the port: each row of the batched pass
    against the same proposal through the shape-1 program, and one shape's
    program bit-equal across two calls."""
    ev = _ev()
    s_w, s_a, _ = batched_round(B, L)
    batched = ev._pass(s_w, s_a, None, B)
    again = ev._pass(s_w, s_a, None, B)
    for u, v in zip(batched, again):
        assert np.array_equal(u, v)
    for b in range(B):
        serial = ev._eval(s_w[b], s_a[b])
        for u, v in zip(batched, serial):
            assert u[b] == pytest.approx(v, rel=1e-3, abs=1e-6)


def test_ragged_tail_batch_is_padded_to_one_compiled_shape():
    """The twin of the reference's test of the same name: a search whose
    last round is ragged pads it to the fixed batch shape, so no new
    batched program is built, and the padded rows never reach
    ``tell_batch``."""
    ev = _ev()
    shapes_before = set(ev.batch_shapes)
    padded_before = ev.padded_batches
    forwards, passes = ev.stats_forwards, ev.stats_passes
    r = thass.hass_search(ev, L, iters=8, s_max=0.9, seed=1,
                          batch_size=3)                  # rounds 3 + 3 + 2
    assert len(r.trials) == 8                            # padding masked out
    assert ev.padded_batches > padded_before
    assert ev.batch_shapes - shapes_before <= {3}
    assert ev.stats_forwards == forwards + 8 and ev.stats_passes == passes + 3
    # a padded-round trial scores the same as the serial evaluator
    t = r.trials[-1]
    ms = ev(t.x)
    for k in ms:
        assert t.metrics[k] == pytest.approx(ms[k], rel=1e-3, abs=1e-6), k


def test_bucketing_follows_the_reference_rule_for_rule():
    """The same sequence of batch sizes through both evaluators' fresh
    bookkeeping: the same shapes built, the same batches padded. (The JAX
    evaluator's bookkeeping is reset for the sequence and restored after;
    its compiled programs stay.)"""
    jev = _jax_ev()
    ev = thass.CNNEvaluator(**{f: getattr(_ev(), f) for f in (
        "cfg", "params", "images", "hw", "budget", "dse_iters")})
    rng = np.random.default_rng(4)
    saved = set(jev.batch_shapes), jev.padded_batches
    jev.batch_shapes, jev.padded_batches = set(), 0
    try:
        for size in (3, 2, 1, 2):
            xs = [rng.uniform(0, 0.8, 2 * L) for _ in range(size)]
            jm = jev.evaluate_batch(xs)
            tm = ev.evaluate_batch(xs)
            assert len(jm) == len(tm) == size
            assert ev.batch_shapes == jev.batch_shapes
            assert ev.padded_batches == jev.padded_batches
        assert ev.batch_shapes == {1, 3} and ev.padded_batches == 2
    finally:
        jev.batch_shapes, jev.padded_batches = saved
    assert ev.stats_forwards == 8 and ev.stats_passes == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_plain_clip_counts_equal_jax_vmapped_act_clip(dtype):
    """One tau per row, as the Pallas kernel takes it under ``vmap``: the
    port's channel-stacked plain version counts each proposal's zeros as
    ``jax.vmap(ops.act_clip)`` does, and clips bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 8, 6, 6, 40)).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    x.reshape(-1)[3::11] = -0.0
    taus = np.array([0.0, 0.2995, 0.5, 2.0], np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jy, jcnt = jax.vmap(lambda a, t: jops.act_clip(a, t, interpret=True))(
        jnp.asarray(x, jdt), jnp.asarray(taus))
    # proposal b's channels at [b * C, (b + 1) * C) of the last dim
    stacked = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, 0, -2).reshape(8, 6, 6, 4 * 40))).to(tdt)
    y, cnt = act_clip.act_clip_count_batched(stacked, torch.from_numpy(taus))
    assert cnt.dtype == torch.int32
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
    back = np.moveaxis(y.to(torch.float32).numpy().reshape(8, 6, 6, 4, 40),
                       -2, 0)
    want = np.asarray(jy.astype(jnp.float32))
    assert np.array_equal(back.view(np.int32), want.view(np.int32))


def test_cpu_pass_launches_nothing_and_needs_no_graph():
    """On the CPU the batched program runs eagerly through the plain
    versions: no kernel launch, no graph."""
    ev = _ev()
    before = launch_counts()
    ev.evaluate_batch([np.full(2 * L, 0.3), np.full(2 * L, 0.6)])
    assert launch_counts() == before
    assert ev._graphs == {} and ev.graphs_captured == 0
