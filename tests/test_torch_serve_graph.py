"""The serving session's decode program (``serve_loop.DecodeSet``) on the
CPU, for every LM family at ``reduce_config`` size.

The reference jits its decode step (``repro/serve/serve_loop.py``:
``jax.jit(lambda p, c, t: api.decode_step(p, c, t))``), one program per
cache shape; the port runs one static-buffer step per shape, captured into
a CUDA graph on the card and run eagerly here. These tests hold everything
but the capture and the replay:

* capture safety: the static step of all ten LM configs, run on ``meta``
  tensors (a device that is not the host) under a ``TorchDispatchMode``,
  makes no operation that reads the device on the host or copies host data
  to the device (what a CUDA graph cannot hold);
* static step == plain step: the session's buffer set gives the logits and
  cache of ``api.decode_step`` bit for bit over 6 steps, for a second chunk
  that reuses the set, and in an open loop where two groups of one size
  take turns;
* against the reference: float32 logits of the session's steps within 1e-4
  x max |ref| of the JAX session's jitted ``_decode`` on converted
  parameters, with the same greedy tokens (one architecture per family);
* buffer sets: a fixed mixed-size open-loop trace builds the expected sets
  per shape.

The replay itself is held against the eager step on the card
(``tests/test_torch_serve_graph_cuda.py`` and ``chip_smoke.py``'s
``serve`` and ``serve_families``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _host_reads import HostReads, on_meta
from repro_torch.configs import ASSIGNED, get_config, reduce_config
from repro_torch.models import build_model
from repro_torch.obs.trace import Tracer, set_tracer
from repro_torch.serve.serve_loop import (Request, ServeSession, decode_into,
                                          shape_key)

torch.set_num_threads(2)
# the first parallel torch.exp of a CPU process can come out ~1e-4 off in one
# thread's share of the tensor (tools/cpu_exp_first_call.py); this call takes
# that first call
torch.exp(torch.randn((1 << 17,), generator=torch.Generator().manual_seed(0)))

ARCHS = sorted(ASSIGNED)
S_MAX, STEPS = 24, 6


def _session(arch, *, slots=2):
    api = build_model(reduce_config(get_config(arch)))
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    return ServeSession(api, params, batch_slots=slots, S_max=S_MAX,
                        device="cpu")


def _chunk(cfg, n, seed, plen=6):
    """n prompts of one length, and the enc-dec family's frames."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=plen) for _ in range(n)]
    kw = {}
    if cfg.is_encoder_decoder:
        kw["frames"] = rng.normal(size=(n, cfg.num_frames, cfg.d_model)
                                  ).astype(np.float32)
    return prompts, kw


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.uint8 if t.element_size() == 1
                               else torch.int32 if t.element_size() == 4
                               else torch.int64)


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(_bits(a), _bits(b))


def _plain_greedy(sess, prompts, kw, n):
    """Prefill + ``n - 1`` plain ``api.decode_step`` calls, greedy, on the
    session's own parameters: the token rows."""
    logits, cache, _ = sess._prefill_groups(prompts, kw)
    cur = torch.argmax(logits[:, -1], -1)[:, None]
    gen = [cur]
    for _ in range(n - 1):
        logits, cache = sess.api.decode_step(sess.params, cache, cur)
        cur = torch.argmax(logits[:, -1], -1)[:, None]
        gen.append(cur)
    return [list(map(int, r)) for r in torch.cat(gen, 1).numpy()]


# --------------------------------------------------------------------- #
# capture safety
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_reads_nothing_on_the_host(arch):
    """The session's static step of every LM config on device tensors: no
    host read, no host-to-device copy, no data-dependent shape."""
    sess = _session(arch)
    prompts, kw = _chunk(sess.api.cfg, 2, seed=0)
    _, cache, _ = sess._prefill_groups(prompts, kw)
    params, mcache = on_meta(sess.params), on_meta(cache)
    token = torch.zeros((2, 1), dtype=torch.int64, device="meta")
    with HostReads() as spy:
        logits = decode_into(sess.api, params, mcache, token)
    assert spy.found == []
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (2, 1, sess.api.cfg.vocab_size)


@pytest.mark.parametrize("case", ["bincount", "item", "host_copy",
                                  "bool_index"])
def test_host_read_check_catches(case):
    """The check above flags each kind of operation it looks for (the
    router's old ``torch.bincount`` among them)."""
    def run(x, i):
        if case == "bincount":
            return torch.bincount(i, minlength=4)
        if case == "item":
            return x * float(x.sum())
        if case == "host_copy":
            return x + torch.tensor([1.0, 2.0, 3.0]).to(x.device)
        return x[x > 0]

    x = torch.empty(3, device="meta")
    i = torch.zeros(3, dtype=torch.int64, device="meta")
    with HostReads() as spy:
        try:
            run(x, i)
        except (RuntimeError, NotImplementedError):  # meta holds no values
            pass
    assert spy.found, case


# --------------------------------------------------------------------- #
# the static step is the plain step, bit for bit
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_static_step_equals_plain_step(arch):
    """Logits at each of 6 steps and every cache leaf after them equal
    ``api.decode_step``'s bit for bit; a second chunk of the same shape
    reuses the buffer set (loaded anew) and equals it too."""
    sess = _session(arch)
    api = sess.api
    ds0 = None
    for seed in (1, 2):
        prompts, kw = _chunk(api.cfg, 2, seed)
        logits, cache, _ = sess._prefill_groups(prompts, kw)
        plain = {k: v.clone() for k, v in cache.items()}
        ds = sess.decode_set(cache)
        ds0 = ds0 or ds
        assert ds is ds0 and ds.cache is not cache
        cur = torch.argmax(logits[:, -1], -1)[:, None]
        for _ in range(STEPS):
            want, plain = api.decode_step(sess.params, plain, cur)
            got = ds.step(cur)
            assert _same(got, want)
            cur = torch.argmax(want[:, -1], -1)[:, None]
        assert sorted(plain) == sorted(ds.cache)
        for k in plain:
            assert _same(ds.cache[k], plain[k]), k
    assert sess.buffer_sets == {shape_key(cache): 1}
    assert sess.graphs_captured == 0        # no graph on the CPU


@pytest.mark.parametrize(
    "arch", [a for a in ARCHS
             if not get_config(a).is_encoder_decoder])   # the open loop
def test_open_loop_groups_of_one_size_keep_their_own_sets(arch):  # no frames
    """Group A (2 rows, 16 tokens) and group B (2 rows, admitted while A
    decodes) take turns by quanta, each in a buffer set of its own: each
    gets the tokens of the plain step run on its prompts alone."""
    sess = _session(arch, slots=4)
    cfg = sess.api.cfg
    a, _ = _chunk(cfg, 2, seed=3)
    b, _ = _chunk(cfg, 2, seed=4)
    reqs = [Request(prompt=p, max_new=16, arrival=0.0) for p in a] + \
        [Request(prompt=p, max_new=16, arrival=1.0) for p in b]
    rep = sess.serve_open_loop(reqs, step_cycles=10.0, prefill_cycles=5.0)
    assert rep.prefills == 2
    assert rep.admissions[2] < rep.completions[0]         # they overlap
    assert rep.outputs == _plain_greedy(sess, a, {}, 16) + \
        _plain_greedy(sess, b, {}, 16)
    assert [n for k, n in sess.buffer_sets.items() if k[0] == 2] == [2]


# --------------------------------------------------------------------- #
# buffer sets per shape
# --------------------------------------------------------------------- #
def test_mixed_size_open_loop_builds_the_expected_sets():
    """3 slots: A (1 row) then B (2 rows) decode together; C (2 rows) is
    admitted while B still decodes, so it takes a second 2-row set; D (1
    row) comes after A retired and reuses A's set. Sets are counted per
    shape; the tracer's ``serve.graphs`` counts captures (none here)."""
    sess = _session("qwen3-0.6b", slots=3)
    rng = np.random.default_rng(5)

    def req(new, at):
        return Request(prompt=rng.integers(0, sess.api.cfg.vocab_size,
                                           size=5), max_new=new, arrival=at)

    reqs = [req(16, 0.0), req(16, 1.0), req(8, 1.0), req(8, 100.0),
            req(8, 100.0), req(8, 300.0)]
    tr = Tracer()
    set_tracer(tr)
    try:
        rep = sess.serve_open_loop(reqs, step_cycles=10.0,
                                   prefill_cycles=5.0)
    finally:
        set_tracer(None)
    assert rep.prefills == 4 and rep.completed == 6
    assert list(rep.admissions) == [5.0, 80.0, 80.0, 235.0, 235.0, 390.0]
    assert sorted((k[0], n) for k, n in sess.buffer_sets.items()) == \
        [(1, 1), (2, 2)]
    assert tr.counters["serve.graphs"] == 0
    assert tr.counters["serve.decode_steps"] == rep.decode_steps
    # every request decoded as it would alone (greedy rows are independent)
    assert all(o == _plain_greedy(sess, [r.prompt], {}, r.max_new)[0]
               for r, o in zip(reqs, rep.outputs))


# --------------------------------------------------------------------- #
# against the reference's jitted decode
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "deepseek-v3-671b", "zamba2-1.2b",
                                  "rwkv6-1.6b", "whisper-base"])
def test_session_steps_match_the_jax_jitted_decode(arch):
    """float32, one chunk of 3 rows, 6 greedy steps (Mixtral's 8-slot ring
    wraps): the logits within 1e-4 x max |ref| of the JAX session's
    ``_decode`` at every step, the greedy tokens identical."""
    import jax
    from repro.configs import get_config as jget, reduce_config as jreduce
    from repro.models import build_model as jbuild
    from repro.serve import serve_loop as jserve
    from repro_torch.convert import params_from_jax

    jcfg = dataclasses.replace(jreduce(jget(arch)), dtype="float32")
    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              dtype="float32")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jsess = jserve.ServeSession(jbuild(jcfg), jparams, batch_slots=3,
                                S_max=32)
    tsess = ServeSession(build_model(cfg), params, batch_slots=3, S_max=32,
                         device="cpu")
    prompts, kw = _chunk(cfg, 3, seed=6)
    jlogits, jcache, _ = jsess._prefill_groups(prompts, kw)
    logits, cache, _ = tsess._prefill_groups(prompts, kw)
    ds = tsess.decode_set(cache)
    jcur = np.argmax(np.asarray(jlogits[:, -1]), -1)[:, None]
    cur = torch.argmax(logits[:, -1], -1)[:, None]
    assert np.array_equal(cur.numpy(), jcur)
    for _ in range(STEPS):
        jlogits, jcache = jsess._decode(jsess.params, jcache,
                                        jcur.astype(np.int32))
        ref = np.asarray(jlogits, np.float32)
        got = ds.step(cur).numpy()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
        jcur = np.argmax(ref[:, -1], -1)[:, None]
        cur = torch.as_tensor(np.argmax(got[:, -1], -1)[:, None])
        assert np.array_equal(cur.numpy(), jcur)
