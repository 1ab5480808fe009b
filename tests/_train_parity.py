"""Shared by the ``test_torch_train_families*.py`` files: one train step of
the port against the JAX package's for one configuration (see
``test_torch_train_families.py`` for what is compared and why)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_config as jreduce
from repro.data.synthetic import image_batch as jimage_batch
from repro.data.synthetic import lm_batch as jlm_batch
from repro.models import build_model as jbuild
from repro.train import optimizer as jopt
from repro.train.train_loop import (TrainConfig as JTrainConfig,
                                    init_train_state as jinit,
                                    make_train_step as jmake)
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import train_state_from_jax, train_state_to_jax
from repro_torch.models import build_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import (TrainConfig, compute_grads,
                                          make_train_step)

torch.set_num_threads(2)
# the first parallel torch.exp of a CPU process can come out ~1e-4 off in one
# thread's share of the tensor (tools/cpu_exp_first_call.py); this call takes
# that first call
torch.exp(torch.randn((1 << 17,), generator=torch.Generator().manual_seed(0)))

LR, EPS = 1e-3, 1e-8
B, S = 4, 16


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _numpy_batch(jcfg):
    if jcfg.family == "cnn":
        b = jimage_batch(jcfg, B, seed=0, step=0)
    else:
        b = jlm_batch(jcfg, B, S, seed=0, step=0)
    # whisper's frames come in bfloat16: widened exactly to float32
    return {k: np.asarray(v, np.float32) if k == "frames" else np.asarray(v)
            for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """The JAX package's model at reduce_config size (float32) and its
    parameters, initialised once per architecture."""
    jcfg = dataclasses.replace(jreduce(jget(arch)), dtype="float32")
    japi = jbuild(jcfg)
    return jcfg, japi, jax.jit(japi.init)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_side(arch, remat, accum):
    """The JAX package's (state before the step as numpy, batch, loss,
    gradients, parameters after the step), from one jitted call."""
    jcfg, japi, params = _jax_model(arch)
    oc = jopt.OptConfig(lr=LR, warmup_steps=1, total_steps=10)
    tcfg = JTrainConfig(opt=oc, accum=accum, remat=remat)
    state = jinit(lambda rng: params, tcfg, None)
    batch = _numpy_batch(jcfg)

    def lfn(p, b):
        return japi.loss(p, b, remat=remat)[0]

    @jax.jit
    def run(state, batch):
        if accum == 1:
            # make_train_step's own body at accum 1: value_and_grad, AdamW
            loss, grads = jax.value_and_grad(lfn)(state["params"], batch)
            new_params, _, _ = jopt.adamw_update(state["params"], grads,
                                                 state["opt"], oc)
            return loss, grads, new_params, loss
        # the reference's step (its lax.scan), and the mean of the two
        # microbatches' gradients beside it
        new_state, metrics = jmake(japi.loss, tcfg)(state, batch)
        lg = [jax.value_and_grad(lfn)(state["params"], jax.tree_util.tree_map(
            lambda x: x.reshape((accum, -1) + x.shape[1:])[i], batch))
            for i in range(accum)]
        grads = jax.tree_util.tree_map(lambda *g: sum(g) / accum,
                                       *[g for _, g in lg])
        return sum(l for l, _ in lg) / accum, grads, new_state["params"], \
            metrics["loss"]

    loss, grads, new_params, step_loss = run(state, batch)
    before = jax.tree_util.tree_map(np.asarray, state)
    return (before, batch, float(step_loss), float(loss), _flat(grads),
            _flat(new_params))


def _port(arch):
    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              dtype="float32")
    return build_model(cfg)


def check_train_step(arch, remat, accum):
    before, batch, step_loss, ref_loss, ref_g, ref_p = \
        _jax_side(arch, remat, accum)
    api = _port(arch)
    tcfg = TrainConfig(opt=OptConfig(lr=LR, warmup_steps=1, total_steps=10),
                       accum=accum, remat=remat)
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}

    state = train_state_from_jax(before, "cpu")
    g, loss, _ = compute_grads(api.loss, tcfg, state["params"], tbatch)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    got_g = _flat(train_state_to_jax(g))
    assert got_g.keys() == ref_g.keys()
    for k, rg in ref_g.items():
        scale = float(np.abs(rg).max())
        err = float(np.abs(got_g[k] - rg).max())
        assert err <= 1e-4 * scale + 1e-30, (k, err, scale)

    state = train_state_from_jax(before, "cpu")
    new_state, m = make_train_step(api.loss, tcfg)(state, tbatch)
    assert float(m["loss"]) == pytest.approx(step_loss, rel=1e-5)
    assert int(new_state["opt"]["step"]) == 1
    got_p = _flat(train_state_to_jax(new_state["params"]))
    for k, rp in ref_p.items():
        rg = np.abs(ref_g[k])
        gmax = float(rg.max())
        big = rg > 1e-3 * gmax
        err = np.abs(got_p[k] - rp)
        tol = 1e-6 + LR * EPS * (1e-4 * gmax) / np.maximum(
            rg.astype(np.float64), 1e-30) ** 2
        assert np.all(err[big] <= tol[big]), (k, float(err[big].max()))
        assert np.all(err <= 2 * LR + 1e-6), (k, float(err.max()))
