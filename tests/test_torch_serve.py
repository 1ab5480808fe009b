"""repro_torch's serving loop and request traces against the JAX package.

Twins of ``test_serve_data.py``'s two ``ServeSession`` tests, of
``test_fleet.py``'s tests that use only ``ServeSession`` (bit-exact open loop
on a backlogged trace, ragged rows invariant to their companions,
``max_new=0`` and ``Request.out``, report accounting, deadline shedding) and
of ``test_sim.py``'s trace tests. Across packages: greedy tokens of
``generate`` and ``serve_open_loop`` on converted parameters (float32, a
dense, a recurrent and the enc-dec family), the open loop's clocks against
the JAX package's timing twin ``fleet.open_loop_schedule``, and the traces,
which are numpy in both packages and equal bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_config as jreduce
from repro.models import build_model as jbuild
from repro.serve import serve_loop as jserve
from repro.serve.fleet import open_loop_schedule
from repro.sim import trace as jtrace
from repro_torch.configs import ASSIGNED, get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.serve.serve_loop import (DEFAULT_BUCKETS, Request,
                                          ServeSession, requests_from_trace)
from repro_torch.sim import (Trace, backlogged_trace, bucket_sizes,
                             diurnal_trace, mmpp_trace, poisson_trace,
                             replay_trace)

torch.set_num_threads(2)
# the first parallel torch.exp of a CPU process can come out ~1e-4 off in one
# thread's share of the tensor (tools/cpu_exp_first_call.py); this call takes
# that first call
torch.exp(torch.randn((1 << 17,), generator=torch.Generator().manual_seed(0)))
CFG = reduce_config(get_config("qwen3-0.6b"))


@pytest.fixture(scope="module")
def sess():
    api = build_model(CFG)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    return ServeSession(api, params, batch_slots=2, S_max=32, device="cpu")


# --------------------------------------------------------------------- #
# test_serve_data.py twins
# --------------------------------------------------------------------- #
def test_serve_session_matches_manual_greedy(sess):
    api = sess.api
    prompts = [np.arange(8) % CFG.vocab_size for _ in range(2)]
    outs = sess.generate(prompts, max_new=5)
    assert len(outs) == 2 and all(len(o) == 5 for o in outs)

    # manual greedy on the session's own (already cast) parameters
    toks = torch.as_tensor(np.stack(prompts), dtype=torch.int64)
    logits, cache = api.prefill(sess.params, toks, 32)
    cur = torch.argmax(logits[:, -1], -1)[:, None]
    manual = [cur]
    for _ in range(4):
        logits, cache = api.decode_step(sess.params, cache, cur)
        cur = torch.argmax(logits[:, -1], -1)[:, None]
        manual.append(cur)
    manual = torch.cat(manual, dim=1).numpy()
    assert outs == [list(map(int, r)) for r in manual]


def test_serve_batching_chunks_requests(sess):
    prompts = [np.arange(6) for _ in range(5)]
    small = ServeSession(sess.api, sess.params, batch_slots=2, S_max=16,
                         device="cpu")
    outs = small.generate(prompts, max_new=3)
    assert len(outs) == 5 and all(len(o) == 3 for o in outs)
    # identical prompts give identical rows, whatever chunk they fell in
    assert all(o == outs[0] for o in outs)


# --------------------------------------------------------------------- #
# test_fleet.py twins (ServeSession only)
# --------------------------------------------------------------------- #
def test_open_loop_backlogged_matches_generate_bit_exact(sess):
    tr = backlogged_trace(5, 8)        # 8 == smallest DEFAULT_BUCKET
    reqs = requests_from_trace(tr, vocab_size=CFG.vocab_size, prompt_len=6,
                               seed=0)
    ref = sess.generate([r.prompt for r in reqs], max_new=8)
    rep = sess.serve_open_loop(reqs, step_cycles=10.0, prefill_cycles=5.0)
    assert rep.outputs == ref
    assert [r.out for r in reqs] == ref
    assert rep.decode_steps == -(-len(reqs) // sess.B) * 7
    assert np.all(rep.completions > rep.admissions)


def test_generate_ragged_row_invariant_to_companions(sess):
    rng = np.random.default_rng(3)
    long = rng.integers(0, CFG.vocab_size, size=9)
    short = rng.integers(0, CFG.vocab_size, size=4)
    alone = sess.generate([long], max_new=6)[0]
    with_short = sess.generate([long, short], max_new=6)[0]
    swapped = sess.generate([short, long], max_new=6)[1]
    assert with_short == alone
    assert swapped == alone
    assert sess.generate([short, long], max_new=6)[0] == \
        sess.generate([short], max_new=6)[0]


def test_generate_max_new_zero_and_request_out(sess):
    rng = np.random.default_rng(4)
    reqs = [Request(prompt=rng.integers(0, CFG.vocab_size, size=5))
            for _ in range(2)]
    assert sess.generate(reqs, max_new=0) == [[], []]
    outs = sess.generate(reqs, max_new=3)
    assert [r.out for r in reqs] == outs
    assert all(len(o) == 3 for o in outs)
    a, b = Request(prompt=np.array([1])), Request(prompt=np.array([2]))
    assert a.out == [] and a.out is not b.out


def test_open_loop_report_accounting(sess):
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, CFG.vocab_size, size=6),
                    max_new=m, arrival=a)
            for m, a in ((5, 0.0), (0, 0.0), (8, 40.0), (3, 41.0))]
    rep = sess.serve_open_loop(reqs, step_cycles=10.0, prefill_cycles=5.0)
    assert np.all(rep.admissions >= rep.arrivals)
    assert np.all(rep.completions >= rep.admissions)
    assert np.array_equal(rep.queue_wait, rep.admissions - rep.arrivals)
    assert [len(o) for o in rep.outputs] == [5, 0, 8, 3]
    assert rep.completions[1] == rep.admissions[1]   # max_new=0
    assert rep.p50 <= rep.p99 <= rep.horizon
    with pytest.raises(ValueError, match="buckets"):
        sess.serve_open_loop(reqs, step_cycles=1.0, buckets=(8, 12))


def test_serve_open_loop_deadline_sheds_and_accounts(sess):
    rng = np.random.default_rng(6)
    arr = np.cumsum(rng.exponential(20.0, 12))
    reqs = [Request(prompt=rng.integers(0, CFG.vocab_size, size=5),
                    max_new=8, arrival=float(a),
                    deadline=float(a) + (50.0 if k % 3 == 0 else 1e9))
            for k, a in enumerate(arr)]
    rep = sess.serve_open_loop(reqs, step_cycles=30.0, prefill_cycles=90.0)
    assert rep.shed > 0 and rep.completed + rep.shed == 12
    assert np.all(np.isinf(rep.completions[rep.shed_mask]))
    assert np.all(np.isfinite(rep.completions[~rep.shed_mask]))
    outs = [len(o) for o in rep.outputs]
    assert all(n == 0 for n, s in zip(outs, rep.shed_mask) if s)
    assert all(n == 8 for n, s in zip(outs, rep.shed_mask) if not s)
    assert np.isfinite(rep.p99) and np.isfinite(rep.horizon)


def test_open_loop_clocks_equal_the_jax_timing_twin(sess):
    """The port's open loop admits and completes every request at the
    cycles the JAX package's ``fleet.open_loop_schedule`` computes, on
    bursty arrivals, ragged decode lengths, a zero-length request,
    deadlines and a degradation schedule."""
    rng = np.random.default_rng(8)
    n = 16
    arr = np.cumsum(rng.exponential(250.0, n)).astype(float)
    new = rng.integers(4, 20, n)
    new[3] = 0
    dls = arr + rng.uniform(8e2, 8e3, n)
    sched = [(0.0, 1.0), (float(arr[5]), 0.6), (float(arr[11]), 0.85)]
    reqs = [Request(prompt=rng.integers(0, CFG.vocab_size, size=5),
                    max_new=int(new[i]), arrival=float(arr[i]),
                    deadline=float(dls[i])) for i in range(n)]
    rep = sess.serve_open_loop(reqs, step_cycles=25.0, prefill_cycles=75.0,
                               step_schedule=sched, switch_cycles=40.0)
    adm, comp = open_loop_schedule(arr, new.astype(float), batch_slots=sess.B,
                                   step_cycles=25.0, prefill_cycles=75.0,
                                   deadlines=dls, step_schedule=sched,
                                   switch_cycles=40.0)
    assert np.array_equal(rep.admissions, adm)
    assert np.array_equal(rep.completions, comp)
    assert rep.shed + rep.completed == n


def test_sampling_is_seeded_and_entry_point_needs_a_card(sess):
    hot = [ServeSession(sess.api, sess.params, batch_slots=2, S_max=32,
                        temperature=0.8, seed=s, device="cpu")
           for s in (7, 7, 8)]
    prompts = [np.arange(5), np.arange(5) + 9]
    a, b, c = (h.generate(prompts, max_new=6) for h in hot)
    assert a == b and a != c
    assert all(0 <= t < CFG.vocab_size for row in a for t in row)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeSession(sess.api, sess.params, batch_slots=2, S_max=32)


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_generate_serves_every_lm_config(arch):
    """Every LM config at reduce_config size through ServeSession: ragged
    prompts over two chunks of slots (the enc-dec family with its frames),
    tokens in the vocabulary, and two calls agree."""
    cfg = reduce_config(get_config(arch))
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(2), device="cpu")
    s = ServeSession(api, params, batch_slots=2, S_max=24, device="cpu")
    rng = np.random.default_rng(5)
    n = 3
    lens = (6, 6, 6) if cfg.is_encoder_decoder else (6, 3, 5)
    prompts = [rng.integers(0, cfg.vocab_size, size=m) for m in lens]
    frames = rng.normal(size=(n, cfg.num_frames, cfg.d_model)).astype(
        np.float32) if cfg.is_encoder_decoder else None
    outs = s.generate(prompts, max_new=4, frames=frames)
    assert [len(o) for o in outs] == [4] * n
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert s.generate(prompts, max_new=4, frames=frames) == outs


# --------------------------------------------------------------------- #
# across packages: the same greedy tokens on converted parameters
# --------------------------------------------------------------------- #
def _pair(arch):
    jcfg = dataclasses.replace(jreduce(jget(arch)), dtype="float32")
    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              dtype="float32")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jsess = jserve.ServeSession(jbuild(jcfg), jparams, batch_slots=3,
                                S_max=32)
    tsess = ServeSession(build_model(cfg), params, batch_slots=3, S_max=32,
                         device="cpu")
    return cfg, jsess, tsess


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b",
                                  "whisper-base"])
def test_generate_greedy_tokens_match_jax(arch):
    """Ragged prompts (pad-and-mask on the transformer, equal-length
    sub-batches on the recurrent family), two chunks of slots, and the
    encoder frames of the enc-dec family."""
    cfg, jsess, tsess = _pair(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (7, 4, 7, 5)]
    frames = rng.normal(size=(4, cfg.num_frames, cfg.d_model)).astype(
        np.float32) if cfg.is_encoder_decoder else None
    if frames is not None:         # one prompt length: frames chunk by row
        prompts = [p[:4] for p in prompts]
    want = jsess.generate(prompts, max_new=6, frames=frames)
    got = tsess.generate(prompts, max_new=6, frames=frames)
    assert got == want


def test_open_loop_outputs_and_clocks_match_jax():
    cfg, jsess, tsess = _pair("qwen3-0.6b")
    tr = poisson_trace(7, 2e-2, sizes=[4, 8, 16], seed=2)
    mk = lambda mod: mod.requests_from_trace(  # noqa: E731
        tr, vocab_size=cfg.vocab_size, prompt_len=6, seed=2)
    jrep = jsess.serve_open_loop(mk(jserve), step_cycles=10.0,
                                 prefill_cycles=5.0)
    rep = tsess.serve_open_loop(requests_from_trace(
        tr, vocab_size=cfg.vocab_size, prompt_len=6, seed=2),
        step_cycles=10.0, prefill_cycles=5.0)
    assert rep.outputs == jrep.outputs
    assert np.array_equal(rep.admissions, jrep.admissions)
    assert np.array_equal(rep.completions, jrep.completions)
    assert (rep.decode_steps, rep.prefills) == \
        (jrep.decode_steps, jrep.prefills)


# --------------------------------------------------------------------- #
# test_sim.py trace twins (numpy in both packages: equal bit for bit)
# --------------------------------------------------------------------- #
def test_traces_are_seed_deterministic_and_well_formed():
    for make, jmake in (
            (lambda s: poisson_trace(300, 2e-5, sizes=8, seed=s),
             lambda s: jtrace.poisson_trace(300, 2e-5, sizes=8, seed=s)),
            (lambda s: mmpp_trace(300, 1e-5, 5e-5, dwell_base=1e6,
                                  dwell_burst=2e5, sizes=8, seed=s),
             lambda s: jtrace.mmpp_trace(300, 1e-5, 5e-5, dwell_base=1e6,
                                         dwell_burst=2e5, sizes=8, seed=s)),
            (lambda s: diurnal_trace(300, 1e-5, 4e-5, 1e7, sizes=8, seed=s),
             lambda s: jtrace.diurnal_trace(300, 1e-5, 4e-5, 1e7, sizes=8,
                                            seed=s))):
        a, b, c = make(0), make(0), make(1)
        assert np.array_equal(a.arrivals, b.arrivals)
        assert np.array_equal(a.sizes, b.sizes)
        assert not np.array_equal(a.arrivals, c.arrivals)
        assert np.all(np.diff(a.arrivals) >= 0)
        assert np.all(a.sizes >= 1)
        assert len(a) == 300
        j = jmake(0)
        assert np.array_equal(a.arrivals, j.arrivals)
        assert np.array_equal(a.sizes, j.sizes) and a.kind == j.kind


def test_poisson_trace_hits_its_rate():
    tr = poisson_trace(4000, 3e-5, seed=0)
    assert len(tr) / tr.span == pytest.approx(3e-5, rel=0.1)


def test_size_specs_constant_choice_and_weighted():
    rng_sizes = poisson_trace(200, 1e-5, sizes=16, seed=0).sizes
    assert np.all(rng_sizes == 16)
    choice = poisson_trace(200, 1e-5, sizes=[8, 32], seed=0).sizes
    assert set(np.unique(choice)) <= {8, 32}
    weighted = poisson_trace(400, 1e-5, sizes=((8, 32), (0.9, 0.1)),
                             seed=0).sizes
    assert np.mean(weighted == 8) > 0.7
    assert np.array_equal(weighted, jtrace.poisson_trace(
        400, 1e-5, sizes=((8, 32), (0.9, 0.1)), seed=0).sizes)


def test_bucket_sizes_pad_up_rule():
    out = bucket_sizes(np.array([1, 8, 9, 33, 64, 65, 200]), [8, 32, 64])
    assert list(out) == [8, 8, 32, 64, 64, 128, 256]
    with pytest.raises(ValueError):
        bucket_sizes(np.array([1]), [])
    tr = replay_trace([0.0, 1.0], [3, 40]).bucketize([8, 32, 64])
    assert list(tr.sizes) == [8, 64]
    sizes = np.arange(1, 300)
    assert np.array_equal(bucket_sizes(sizes, DEFAULT_BUCKETS),
                          jtrace.bucket_sizes(sizes, DEFAULT_BUCKETS))


def test_trace_scaling_and_offered_load():
    tr = poisson_trace(500, 1e-5, sizes=4, seed=0)
    fast = tr.scaled(2.0)
    assert fast.offered_load == pytest.approx(2 * tr.offered_load)
    assert np.array_equal(fast.sizes, tr.sizes)
    with pytest.raises(ValueError):
        tr.scaled(0.0)
    assert replay_trace([5.0, 5.0], 2).offered_load == float("inf")


def test_trace_validation():
    with pytest.raises(ValueError, match="nondecreasing"):
        Trace(np.array([1.0, 0.0]), np.array([1, 1]))
    with pytest.raises(ValueError, match="sizes"):
        Trace(np.array([0.0, 1.0]), np.array([1, 0]))
    with pytest.raises(ValueError, match="length"):
        Trace(np.array([0.0]), np.array([1, 1]))


def test_requests_from_trace_materializes_sizes():
    tr = poisson_trace(20, 1e-5, sizes=((4, 16), (0.5, 0.5)), seed=3)
    reqs = requests_from_trace(tr, vocab_size=100, prompt_len=5, seed=0)
    assert [r.max_new for r in reqs] == [int(s) for s in tr.sizes]
    assert all(len(r.prompt) == 5 for r in reqs)
    assert all(0 <= t < 100 for r in reqs for t in r.prompt)
    again = requests_from_trace(tr, vocab_size=100, prompt_len=5, seed=0)
    assert all(np.array_equal(a.prompt, b.prompt)
               for a, b in zip(reqs, again))
    jreqs = jserve.requests_from_trace(tr, vocab_size=100, prompt_len=5,
                                       seed=0)
    assert all(np.array_equal(a.prompt, b.prompt) and a.max_new == b.max_new
               for a, b in zip(reqs, jreqs))


def test_lm_serve_bounds_follow_the_config_dtype():
    """The serving bounds take the element size and the peak rate from the
    config's compute dtype: the same work in float32 moves twice the bytes
    of bfloat16 and runs at the lower float32 rate."""
    from repro_torch.kernels.bench_util import lm_serve_bounds, tree_numel
    assert CFG.dtype == "bfloat16"
    params = build_model(CFG).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    kw = dict(batch=2, prompt_len=16, kv_rows=20)
    b16 = lm_serve_bounds(CFG, params, **kw)
    b32 = lm_serve_bounds(dataclasses.replace(CFG, dtype="float32"), params,
                          **kw)
    for key in ("decode_step_bytes", "prefill_bytes"):
        assert b32[key] == 2 * b16[key]
    for key in ("decode_step_flops", "prefill_flops"):
        assert b32[key] == b16[key]
    assert b16["layer_params"] + b16["head_params"] == \
        tree_numel(params["blocks"]) + CFG.d_model + CFG.vocab_size * CFG.d_model
    for key in ("decode_step_bound_ms", "prefill_bound_ms"):
        assert b32[key] > b16[key]
