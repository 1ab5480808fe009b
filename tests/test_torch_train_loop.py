"""The port's train step: twins of ``tests/test_train_loop.py`` and of the two
training tests of ``tests/test_system.py``, run on the CPU at
``reduce_config`` size with the port's own data and initialisation (the
reference's bars: accum 2 == accum 1 within 1e-5, remat within 1e-6), plus
the ``remat`` keyword of every family's loss, ``train_state_shape`` and
``examples/train_lm_torch.py --smoke --device cpu``. Where the reference
jits the step, the twin runs it through ``TrainProgram`` (eagerly, on the
CPU)."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.models import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import run_resilient
from repro_torch.train.optimizer import OptConfig, Packed8
from repro_torch.train.train_loop import (TrainConfig, TrainProgram,
                                          compute_grads, init_train_state,
                                          make_train_step, train_state_shape)

torch.set_num_threads(2)
# the first parallel torch.exp of a CPU process can come out ~1e-4 off in one
# thread's share of the tensor (tools/cpu_exp_first_call.py); this call takes
# that first call
torch.exp(torch.randn((1 << 17,), generator=torch.Generator().manual_seed(0)))

CFG = reduce_config(get_config("qwen3-0.6b"))


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _batch(cfg, B, S, seed=0, step=0):
    return lm_batch(cfg, B, S, seed=seed, step=step, device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_loss_decreases_over_steps():
    api = build_model(CFG)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                       accum=1, remat=None)
    state = init_train_state(api.init, tcfg, _gen(), device="cpu")
    step = TrainProgram(make_train_step(api.loss, tcfg), "cpu")
    losses = []
    for i in range(10):
        state, m = step(state, _batch(CFG, 8, 32, step=i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_grad_accum_matches_full_batch():
    """accum=2 over batch 8 must equal accum=1 over the same batch 8."""
    cfg = dataclasses.replace(CFG, dtype="float32")
    api = build_model(cfg)
    batch = _batch(CFG, 8, 32, seed=1)
    t1 = TrainConfig(opt=OptConfig(lr=1e-3), accum=1, remat=None)
    t2 = TrainConfig(opt=OptConfig(lr=1e-3), accum=2, remat=None)
    s1 = init_train_state(api.init, t1, _gen(), device="cpu")
    s2 = init_train_state(api.init, t2, _gen(), device="cpu")
    s1, m1 = make_train_step(api.loss, t1)(s1, batch)
    s2, m2 = make_train_step(api.loss, t2)(s2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    d = max(float(torch.max(torch.abs(a - b))) for a, b in
            zip(_leaves(s1["params"]), _leaves(s2["params"])))
    assert d < 1e-5


def test_remat_matches_no_remat():
    cfg = dataclasses.replace(CFG, dtype="float32")
    api = build_model(cfg)
    batch = _batch(CFG, 4, 32, seed=2)
    outs = []
    for remat in (None, "full", "dots"):
        t = TrainConfig(opt=OptConfig(lr=1e-3), accum=1, remat=remat)
        s = init_train_state(api.init, t, _gen(), device="cpu")
        s, m = make_train_step(api.loss, t)(s, batch)
        outs.append(float(m["loss"]))
    assert outs[0] == pytest.approx(outs[1], rel=1e-6)
    assert outs[0] == pytest.approx(outs[2], rel=1e-6)


# one architecture of each family whose loss gained ``remat``, and the
# encoder-decoder and MTP paths of the transformer
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b",
                                  "whisper-base", "zamba2-1.2b",
                                  "rwkv6-1.6b"])
def test_remat_keeps_the_loss_and_gradients(arch):
    """remat None / "full" / "dots": the same loss bit for bit (the forward
    is the same computation) and gradients within 1e-6 x max |g|."""
    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              dtype="float32")
    api = build_model(cfg)
    params = api.init(_gen(3), device="cpu")
    batch = _batch(cfg, 2, 16, seed=3)
    out = {}
    for remat in (None, "full", "dots"):
        t = TrainConfig(accum=1, remat=remat)
        out[remat] = compute_grads(api.loss, t, params, batch)
    g0, l0, _ = out[None]
    for remat in ("full", "dots"):
        g, l, _ = out[remat]
        assert float(l) == float(l0), remat
        for a, b in zip(_leaves(g), _leaves(g0)):
            assert float((a - b).abs().max()) <= \
                1e-6 * float(b.abs().max()) + 1e-30, (arch, remat)


def test_dots_saves_only_plain_products():
    """The "dots" policy keeps the outputs of aten.mm / addmm and nothing
    else, the analogue of dots_with_no_batch_dims_saveable."""
    from repro_torch.models import common
    from torch.utils.checkpoint import CheckpointPolicy
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert common._dots_policy(None, mm) == CheckpointPolicy.MUST_SAVE
    assert common._dots_policy(None, torch.ops.aten.addmm.default) == \
        CheckpointPolicy.MUST_SAVE
    assert common._dots_policy(None, bmm) == \
        CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError):
        common.remat_fn(lambda x: x, "everything")


@pytest.mark.parametrize("sdtype", ["float32", "bfloat16", "int8"])
def test_state_dtypes_train(sdtype):
    api = build_model(CFG)
    t = TrainConfig(opt=OptConfig(lr=1e-3, state_dtype=sdtype), accum=1,
                    remat=None)
    state = init_train_state(api.init, t, _gen(), device="cpu")
    step = TrainProgram(make_train_step(api.loss, t), "cpu")
    l0 = None
    for i in range(6):
        state, m = step(state, _batch(CFG, 8, 32, step=i))
        l0 = l0 or float(m["loss"])
    assert float(m["loss"]) < l0          # still trains
    mv = state["opt"]["m"]["embed"]
    if sdtype == "int8":
        assert isinstance(mv, Packed8) and mv.q.dtype == torch.int8
    else:
        assert mv.dtype == {"float32": torch.float32,
                            "bfloat16": torch.bfloat16}[sdtype]


def test_compressed_grads_numerics():
    api = build_model(CFG)
    t = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                    accum=1, remat=None, compress_grads=True)
    state = init_train_state(api.init, t, _gen(), device="cpu")
    assert "ef" in state
    step = TrainProgram(make_train_step(api.loss, t), "cpu")
    losses = []
    for i in range(8):
        state, m = step(state, _batch(CFG, 8, 32, step=i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2   # error feedback keeps training
    ef_norm = sum(float(torch.sum(torch.abs(e)))
                  for e in _leaves(state["ef"]))
    assert ef_norm > 0                    # feedback is actually carrying error


def test_cast_params_bf16_reaches_the_float32_masters():
    """The bf16 cast is made inside the graph: the gradients are float32,
    of the masters' shapes, and the loss is the bf16 model's."""
    api = build_model(CFG)                       # bfloat16 compute
    params = api.init(_gen(), device="cpu")
    batch = _batch(CFG, 2, 16)
    g, loss, _ = compute_grads(
        api.loss, TrainConfig(accum=1, remat=None, cast_params_bf16=True),
        params, batch)
    _, loss_masters, _ = compute_grads(
        api.loss, TrainConfig(accum=1, remat=None), params, batch)
    for a, p in zip(_leaves(g), _leaves(params)):
        assert a.dtype == torch.float32 and a.shape == p.shape
        assert bool(torch.isfinite(a).all())
    assert float(loss) == pytest.approx(float(loss_masters), rel=1e-2)


def test_train_state_shape_allocates_nothing():
    cfg = get_config("qwen3-0.6b")               # full width: 596 M params
    st = train_state_shape(build_model(cfg).init,
                           TrainConfig(opt=OptConfig(state_dtype="int8"),
                                       compress_grads=True))
    leaves = list(_leaves(st))
    assert all(x.device.type == "meta" for x in leaves
               if isinstance(x, torch.Tensor))
    assert tuple(st["params"]["embed"].shape) == (cfg.vocab_size, cfg.d_model)
    m = st["opt"]["m"]["blocks"]["ffn"]["w_up"]
    assert isinstance(m, Packed8) and m.q.device.type == "meta" and \
        m.shape == (cfg.num_layers, cfg.d_model, cfg.d_ff)
    assert tuple(st["ef"]["embed"].shape) == (cfg.vocab_size, cfg.d_model)


def test_sparse_training_with_activation_clipping():
    """Twin of test_system.py: train with the paper's activation clipping
    active (dynamic S_a)."""
    api = build_model(CFG)
    taus = {"attn": torch.full((CFG.num_layers,), 0.05),
            "ffn": torch.full((CFG.num_layers,), 0.05)}
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3), accum=1, remat=None)
    state = init_train_state(api.init, tcfg, _gen(), device="cpu")
    step = TrainProgram(make_train_step(api.loss, tcfg, sparsity=taus),
                        "cpu")
    losses = []
    for i in range(6):
        state, m = step(state, _batch(CFG, 8, 32, step=i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_end_to_end_resilient_training(tmp_path):
    """Twin of test_system.py: RWKV6, accum 2, remat "full", a failure
    injected at step 5."""
    cfg = reduce_config(get_config("rwkv6-1.6b"))
    api = build_model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3), accum=2, remat="full")
    state = init_train_state(api.init, tcfg, _gen(), device="cpu")
    step = TrainProgram(make_train_step(api.loss, tcfg), "cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    rep = run_resilient(step, state, lambda i: _batch(cfg, 4, 32, step=i),
                        steps=8, ckpt=mgr, ckpt_every=3,
                        fail_at={5: RuntimeError("chaos")})
    assert rep.restarts == 1
    assert np.isfinite(rep.final_loss)


def test_train_lm_example_smoke_on_the_cpu(tmp_path, capsys):
    """examples/train_lm_torch.py --smoke --device cpu: the LM100M config at
    reduce_config size, 8 steps through run_resilient with an async
    CheckpointManager; the example asserts that the loss falls."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    try:
        import train_lm_torch
    finally:
        sys.path.pop(0)
    rep = train_lm_torch.main(["--smoke", "--device", "cpu", "--ckpt-dir",
                               str(tmp_path)])
    assert rep.steps_run == 8 and rep.final_loss < rep.history[0]
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("step_")) \
        == ["step_00000005", "step_00000008"]
    assert "loss" in capsys.readouterr().out
