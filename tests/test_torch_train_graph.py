"""The train step as one program per shape (``train_loop.TrainProgram``) and
the CNN warm-up's in-place SGD step, on the CPU.

The reference jits its train step (``jax.jit(make_train_step(...))`` in
``examples/train_lm.py`` and its tests) and the CNN warm-up's SGD step
(``benchmarks/common.py``); the port runs one static-buffer step per shape
key, captured into a CUDA graph on the card and run eagerly here. These
tests hold everything but the capture and the replay:

* capture safety: the train step of all ten LM configs under remat "full"
  (accum 2), "dots" and None, int8 moments with ``compress_grads``, bf16
  moments with ``cast_params_bf16``, activation-clip taus as ``sparsity``,
  and the CNN warm-up's step, run through a program on ``meta`` tensors
  under ``HostReads``: no host read, no host-to-device copy;
* buffer sets: one per shape key, a new one for a new batch shape; a state
  of other tensors is copied into the set's state, and the result equals
  the plain step from that state bit for bit;
* ``run_resilient`` through a program with a crash injected equals the
  plain step's run bit for bit (histories and final state);
* a ``DTensor`` state raises ``ValueError``;
* the in-place warm-up equals the rebinding formula bit for bit;
* against the reference: 4 steps of a program on reduced Qwen3 (float32,
  accum 2, remat "full") against ``jax.jit(make_train_step)`` from the
  same converted state, each step's loss within relative 1e-5 and its
  gradient norm within relative 1e-4 (the bars of
  ``tests/test_torch_train_families.py``).

The replay is held against the eager step on the card
(``tests/test_torch_train_graph_cuda.py`` and ``chip_smoke.py``'s
``train``, ``train_families`` and ``paper``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _host_reads import HostReads, on_meta
from repro_torch.configs import ASSIGNED, get_config, reduce_config
from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.data.synthetic import image_batch, lm_batch
from repro_torch.models import build_model, cnn
from repro_torch.search_run import deterministic_convolutions, trained_cnn
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import run_resilient
from repro_torch.train.optimizer import OptConfig, Packed8, tree_map
from repro_torch.train.train_loop import (TrainConfig, TrainProgram,
                                          flat_leaves, init_train_state,
                                          make_train_step, step_key,
                                          train_state_shape)

torch.set_num_threads(2)
# the first parallel torch.exp of a CPU process can come out ~1e-4 off in one
# thread's share of the tensor (tools/cpu_exp_first_call.py); this call takes
# that first call
torch.exp(torch.randn((1 << 17,), generator=torch.Generator().manual_seed(0)))

ARCHS = sorted(ASSIGNED)
CFG = reduce_config(get_config("qwen3-0.6b"))
OPT = OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _bits(t):
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _assert_same(a, b):
    fa, fb = flat_leaves(a), flat_leaves(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert torch.equal(_bits(fa[k]), _bits(fb[k])), k


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, Packed8):
        return Packed8(tree.q.clone(), tree.s.clone(), tree.shape)
    return tree.clone()


# --------------------------------------------------------------------- #
# capture safety
# --------------------------------------------------------------------- #
REMATS = [("full", 2), ("dots", 1), (None, 1)]


def _meta_step(cfg, tcfg, sparsity=None):
    """One call of a program of ``cfg``'s step on ``meta`` tensors under
    ``HostReads``: (found, metrics)."""
    api = build_model(cfg)
    state = train_state_shape(api.init, tcfg)
    batch = on_meta(lm_batch(cfg, 4, 16, seed=0, step=0, device="cpu"))
    prog = TrainProgram(make_train_step(api.loss, tcfg, sparsity=sparsity),
                        device="meta")
    with HostReads() as spy:
        out, m = prog(state, batch)
    assert out is state
    return spy.found, m


@pytest.mark.parametrize("remat,accum", REMATS,
                         ids=[f"{r}-{a}" for r, a in REMATS])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reads_nothing_on_the_host(arch, remat, accum):
    cfg = reduce_config(get_config(arch))
    found, m = _meta_step(cfg, TrainConfig(opt=OPT, accum=accum,
                                           remat=remat))
    assert found == []
    assert {"loss", "grad_norm", "lr"} <= set(m)
    assert all(v.device.type == "meta" for v in m.values())


@pytest.mark.parametrize("case", ["int8_compress", "bf16_cast", "taus"])
def test_train_step_variants_read_nothing_on_the_host(case):
    cfg = CFG
    sparsity = None
    if case == "int8_compress":
        tcfg = TrainConfig(opt=dataclasses.replace(OPT, state_dtype="int8"),
                           accum=2, remat="full", compress_grads=True)
    elif case == "bf16_cast":
        tcfg = TrainConfig(opt=dataclasses.replace(OPT,
                                                   state_dtype="bfloat16"),
                           remat="dots", cast_params_bf16=True)
    else:
        tcfg = TrainConfig(opt=OPT, remat=None)
        sparsity = {k: torch.full((cfg.num_layers,), 0.05, device="meta")
                    for k in ("attn", "ffn")}
    found, m = _meta_step(cfg, tcfg, sparsity)
    assert found == []
    assert all(v.device.type == "meta" for v in m.values())


def test_cnn_warmup_step_reads_nothing_on_the_host():
    """The warm-up's step (``search_run.trained_cnn``): the loss, the
    gradients and the in-place update."""
    cfg = dataclasses.replace(RESNET18, img_res=32)
    params = on_meta(cnn.init_params(cfg, _gen(), device="cpu"))
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    data = on_meta(image_batch(cfg, 2, device="cpu"))
    flat = list(flat_leaves(leaves).values())
    with HostReads() as spy:
        l, _ = cnn.loss(cfg, leaves, data)
        grads = torch.autograd.grad(l, flat)
        with torch.no_grad():
            for p, g in zip(flat_leaves(params).values(), grads):
                p.copy_(p - 2e-3 * g)
    assert spy.found == []


# --------------------------------------------------------------------- #
# buffer sets
# --------------------------------------------------------------------- #
def _setup(tcfg=None, seed=0):
    api = build_model(CFG)
    tcfg = tcfg or TrainConfig(opt=OPT, accum=2, remat="full")
    state = init_train_state(api.init, tcfg, _gen(seed), device="cpu")
    return api, tcfg, state


def test_one_set_per_key_and_a_new_set_for_a_new_batch_shape():
    api, tcfg, state = _setup()
    step = make_train_step(api.loss, tcfg)
    prog = TrainProgram(step, device="cpu")
    plain = _copy(state)
    for i in range(3):
        b = lm_batch(CFG, 4, 16, seed=0, step=i, device="cpu")
        out, m = prog(state, b)
        plain, pm = step(plain, b)
        assert out is state
        assert torch.equal(_bits(m["loss"]), _bits(pm["loss"]))
    assert len(prog.buffer_sets) == 1
    # the set's batch is its own: a new batch is copied in
    (ss,) = prog._sets.values()
    assert ss.batch["tokens"] is not b["tokens"]
    b = lm_batch(CFG, 2, 16, seed=0, step=3, device="cpu")
    out, m = prog(state, b)
    plain, pm = step(plain, b)
    assert out is state and len(prog.buffer_sets) == 2
    assert step_key(state, b) in prog.buffer_sets
    _assert_same(state, plain)
    assert int(state["opt"]["step"]) == 4
    assert prog.graphs_captured == 0 and prog.graph_pool_bytes == 0


@pytest.mark.parametrize("sdtype,compress", [("float32", False),
                                             ("int8", True)])
def test_a_second_state_is_copied_into_the_sets_state(sdtype, compress):
    """Another state of the same key (other values; int8 moments and the
    error feedback's new tensors too) is written into the set's state, and
    the step from it equals the plain step from it."""
    tcfg = TrainConfig(opt=dataclasses.replace(OPT, state_dtype=sdtype),
                       accum=2, remat="full", compress_grads=compress)
    api, _, first = _setup(tcfg)
    step = make_train_step(api.loss, tcfg)
    prog = TrainProgram(step, device="cpu")
    b0 = lm_batch(CFG, 4, 16, seed=0, step=0, device="cpu")
    prog(first, b0)
    _, _, other = _setup(tcfg, seed=1)
    other, _ = step(other, b0)
    plain = _copy(other)
    b1 = lm_batch(CFG, 4, 16, seed=0, step=1, device="cpu")
    out, m = prog(other, b1)
    want, wm = step(plain, b1)
    assert out is first and out is not other
    _assert_same(out, want)
    assert torch.equal(_bits(m["loss"]), _bits(wm["loss"]))
    if compress:
        assert float(flat_leaves(out["ef"])["embed"].abs().max()) > 0
    assert len(prog.buffer_sets) == 1


def test_resilient_run_through_a_program_equals_the_plain_run(tmp_path):
    """run_resilient with a crash after step 5 (a restore from the step-4
    checkpoint is copied into the set's state): the same history and final
    state, bit for bit, as the plain step's run, and one set."""
    runs = []
    for tag in ("plain", "program"):
        api, tcfg, state = _setup(TrainConfig(
            opt=dataclasses.replace(OPT, state_dtype="int8"), accum=2,
            remat="full"))
        step = make_train_step(api.loss, tcfg)
        prog = TrainProgram(step, device="cpu") if tag == "program" else None
        last = {}

        def run(s, b, fn=step if prog is None else prog, last=last):
            last["state"], m = fn(s, b)
            return last["state"], m

        rep = run_resilient(run, state,
                            lambda i: lm_batch(CFG, 4, 16, seed=2, step=i,
                                               device="cpu"),
                            steps=8, ckpt=CheckpointManager(
                                str(tmp_path / tag), keep=3),
                            ckpt_every=2, fail_at={5: RuntimeError("boom")})
        assert rep.restarts == 1
        runs.append((rep.history, last["state"], prog))
    (h1, s1, _), (h2, s2, prog) = runs
    assert h1 == h2 and len(h2) == 9
    _assert_same(s1, s2)
    assert len(prog.buffer_sets) == 1


def test_a_sharded_state_raises(tmp_path):
    """A state of DTensors (a world-1 gloo mesh here) runs eagerly, as
    ``step_fn``: the program refuses it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed.sharding import distribute, param_specs
    api, tcfg, state = _setup()
    prog = TrainProgram(make_train_step(api.loss, tcfg), device="cpu")
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        sharded = distribute(state, mesh, param_specs(mesh, state))
        with pytest.raises(ValueError, match="DTensor"):
            prog(sharded, lm_batch(CFG, 4, 16, device="cpu"))
    finally:
        dist.destroy_process_group()
    assert prog.buffer_sets == {}


# --------------------------------------------------------------------- #
# the CNN warm-up
# --------------------------------------------------------------------- #
def _rebinding_warmup(cfg, steps, batch=16, lr=2e-3, seed=0):
    """The warm-up as it was: every step rebinds each parameter to a new
    tensor, ``(p - lr * g).detach()``."""
    params = cnn.init_params(cfg, _gen(seed), device="cpu")
    paths = [(n, k) for n, p in params.items() for k in p]
    with deterministic_convolutions():
        for i in range(steps):
            leaves = [params[n][k].requires_grad_(True) for n, k in paths]
            l, _ = cnn.loss(cfg, params, image_batch(cfg, batch, seed=seed,
                                                     step=i, device="cpu"))
            grads = torch.autograd.grad(l, leaves)
            with torch.no_grad():
                for (n, k), p, g in zip(paths, leaves, grads):
                    params[n][k] = (p - lr * g).detach()
    return params


def test_in_place_warmup_equals_the_rebinding_formula():
    cfg = dataclasses.replace(RESNET18, img_res=32)
    got = trained_cnn(cfg, steps=3, batch=4, device="cpu")
    want = _rebinding_warmup(cfg, 3, batch=4)
    _assert_same(got, want)
    assert not any(t.requires_grad for t in flat_leaves(got).values())
    init = cnn.init_params(cfg, _gen(0), device="cpu")
    assert not torch.equal(got["fc"]["w"], init["fc"]["w"])


# --------------------------------------------------------------------- #
# against the reference's jitted step
# --------------------------------------------------------------------- #
def test_program_steps_match_the_jax_jitted_step():
    import jax
    from repro.configs import get_config as jget, reduce_config as jreduce
    from repro.data.synthetic import lm_batch as jlm_batch
    from repro.models import build_model as jbuild
    from repro.train import optimizer as jopt
    from repro.train.train_loop import (TrainConfig as JTrainConfig,
                                        init_train_state as jinit,
                                        make_train_step as jmake)
    from repro_torch.convert import train_state_from_jax

    jcfg = dataclasses.replace(jreduce(jget("qwen3-0.6b")), dtype="float32")
    cfg = dataclasses.replace(CFG, dtype="float32")
    japi, api = jbuild(jcfg), build_model(cfg)
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jtcfg = JTrainConfig(opt=jopt.OptConfig(**oc), accum=2, remat="full")
    tcfg = TrainConfig(opt=OptConfig(**oc), accum=2, remat="full")
    jstate = jinit(lambda rng: jax.jit(japi.init)(jax.random.PRNGKey(0)),
                   jtcfg, None)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 "cpu")
    jstep = jax.jit(jmake(japi.loss, jtcfg))
    prog = TrainProgram(make_train_step(api.loss, tcfg), device="cpu")
    for i in range(4):
        nb = {k: np.asarray(v)
              for k, v in jlm_batch(jcfg, 4, 16, seed=0, step=i).items()}
        jstate, jm = jstep(jstate, nb)
        state, m = prog(state, {k: torch.from_numpy(v.copy())
                                for k, v in nb.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5), i
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4), i
    assert int(state["opt"]["step"]) == 4 and len(prog.buffer_sets) == 1
