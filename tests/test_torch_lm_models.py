"""repro_torch's LM families against repro's, for all ten LM configs at
``reduce_config`` size.

Cross-package: JAX-initialised parameters, carried over by
``convert.params_from_jax``, and the same numpy tokens (and whisper frames)
go through both packages: the full-sequence forward and its loss, a prefill,
and four decode steps. In float32 the logits agree to 1e-4 x max |ref| and
the greedy tokens are identical. In bfloat16 (once per family) the decode
steps are teacher-forced (a greedy token that differs would change the next
input) and each family is held to its own limit: 1.5 x the distance of the
JAX package's bfloat16 logits from its own float32 logits on the same
inputs, which the test measures too. The two frameworks round their
bfloat16 elementwise ops differently (``jax.nn.sigmoid`` is
``1 / (1 + exp(-x))`` rounded op by op, ``F.silu`` rounds once), so the port
is one more bfloat16 rounding of the same function: its distance from the
JAX package's bfloat16 is of the order of that package's own bfloat16 error
(below it for every family on these inputs), and the limit leaves half
again as much.

Within the port: twins of ``test_models_smoke.py`` (forward value and
decode shapes; the train step waits for the training slice) and of
``test_decode_consistency.py`` (prefill + decode reproduces the
teacher-forced forward, all ten archs, and the SWA ring buffer past the
window).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as jcommon
import repro.models.rwkv as jrwkv
import repro.models.ssm as jssm
import repro.models.transformer as jtfm
from repro.configs import get_config as jget, reduce_config as jreduce
from repro.models import build_model as jbuild
from repro_torch.configs import ASSIGNED, get_config, reduce_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.data.synthetic import batch_for, lm_batch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import build_model, serving_params
from repro_torch.models import common, rwkv, ssm
from repro_torch.models import transformer as tfm

# several test processes run side by side: a few threads each
torch.set_num_threads(2)
# the first parallel torch.exp of a CPU process can come out ~1e-4 off in one
# thread's share of the tensor (tools/cpu_exp_first_call.py); this call takes
# that first call
torch.exp(torch.randn((1 << 17,), generator=torch.Generator().manual_seed(0)))

ARCHS = sorted(ASSIGNED)
# one architecture of each family for the bfloat16 comparison
BF16_ARCHS = ["qwen3-0.6b", "mixtral-8x7b", "rwkv6-1.6b", "zamba2-1.2b",
              "whisper-base", "chameleon-34b"]
B, S, SPLIT, STEPS = 2, 12, 8, 4
F32_TOL = 1e-4
# a family's bfloat16 limit, as a multiple of the JAX package's own
# bfloat16-vs-float32 distance for it
BF16_OF_OWN_GAP = 1.5


def _cfgs(arch, dtype):
    jcfg = dataclasses.replace(jreduce(jget(arch)), dtype=dtype)
    cfg = dataclasses.replace(reduce_config(get_config(arch)), dtype=dtype)
    return jcfg, cfg


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = rng.normal(size=(B, cfg.num_frames, cfg.d_model)).astype(
        np.float32) if cfg.is_encoder_decoder else None
    return toks, frames


def _jax_teacher(cfg, params, tokens, frames=None):
    if cfg.rwkv is not None:
        return jrwkv.forward(cfg, params, tokens)[0]
    if cfg.ssm is not None:
        return jssm.forward(cfg, params, tokens)
    return jtfm.lm_forward(cfg, params, tokens, frames=frames)[1]


def _teacher(cfg, params, tokens, frames=None):
    if cfg.rwkv is not None:
        return rwkv.forward(cfg, params, tokens)[0]
    if cfg.ssm is not None:
        return ssm.forward(cfg, params, tokens)
    return tfm.lm_forward(cfg, params, tokens, frames=frames)[1]


def _f32(a):
    return np.asarray(a, dtype=np.float32) if not isinstance(a, torch.Tensor) \
        else a.detach().to(torch.float32).numpy()


@functools.lru_cache(maxsize=None)
def _jax_side(arch, dtype, greedy):
    """The JAX package's (loss, forward logits, [prefill logits + one per
    decode step], the tokens fed to the decode steps), in one jitted call:
    greedy decode feeds each step its own argmax, teacher-forced decode the
    input tokens. Also the JAX parameters (float32 whatever ``dtype``)."""
    jcfg, cfg = _cfgs(arch, dtype)
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    toks, frames = _inputs(cfg)

    @jax.jit
    def run(p, t, fr):
        batch = {"tokens": t}
        kw = {}
        if fr is not None:
            batch["frames"] = kw["frames"] = fr
        loss, _ = japi.loss(p, batch)
        full = _jax_teacher(jcfg, p, t, fr)
        lg, cache = japi.prefill(p, t[:, :SPLIT], 16, **kw)
        steps, fed = [lg], []
        for i in range(STEPS):
            cur = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None] \
                if greedy else t[:, SPLIT + i:SPLIT + i + 1]
            fed.append(cur)
            lg, cache = japi.decode_step(p, cache, cur)
            steps.append(lg)
        return loss, full, steps, fed

    jout = run(jparams, jnp.asarray(toks),
               None if frames is None else jnp.asarray(frames))
    jloss, jfull, jsteps, jfed = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jout)
    return (float(jloss), jfull, jsteps, jfed), jparams


@functools.lru_cache(maxsize=None)
def _both(arch, dtype):
    """Everything the cross-package checks compare, from both packages:
    (loss, forward logits, [prefill logits + one per decode step], the
    tokens fed to the decode steps). In float32 the decode is greedy (each
    package feeds its own argmax); in bfloat16 it is teacher-forced."""
    _, cfg = _cfgs(arch, dtype)
    api = build_model(cfg)
    greedy = dtype == "float32"
    jout, jparams = _jax_side(arch, dtype, greedy)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    toks, frames = _inputs(cfg)

    with torch.no_grad():
        t = torch.as_tensor(toks, dtype=torch.int64)
        fr = None if frames is None else torch.as_tensor(frames)
        batch = {"tokens": t}
        kw = {}
        if fr is not None:
            batch["frames"] = kw["frames"] = fr
        loss, _ = api.loss(params, batch)
        full = _teacher(cfg, params, t, fr)
        lg, cache = api.prefill(params, t[:, :SPLIT], 16, **kw)
        steps, fed = [_f32(lg)], []
        for i in range(STEPS):
            cur = torch.argmax(lg[:, -1], -1)[:, None] if greedy \
                else t[:, SPLIT + i:SPLIT + i + 1]
            fed.append(cur.numpy())
            lg, cache = api.decode_step(params, cache, cur)
            steps.append(_f32(lg))
    port = (float(loss), _f32(full), steps, fed)
    return jout, port


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_forward_loss_and_greedy_decode_match_jax(arch):
    (jloss, jfull, jsteps, jfed), (loss, full, steps, fed) = \
        _both(arch, "float32")
    assert abs(loss - jloss) <= F32_TOL * abs(jloss), (loss, jloss)
    assert full.shape == jfull.shape == (B, S, 503)
    assert _rel(full, jfull) <= F32_TOL
    errs = [_rel(a, r) for a, r in zip(steps, jsteps)]
    assert len(errs) == STEPS + 1 and max(errs) <= F32_TOL, errs
    assert all(np.array_equal(a, r) for a, r in zip(fed, jfed)), (fed, jfed)


def _bf16_gaps(arch):
    """(the port's bfloat16 distance from the JAX package's bfloat16, that
    package's own bfloat16 distance from its float32), each the max over the
    forward and the teacher-forced prefill and decode steps, in units of
    max |ref|; and the two losses."""
    (jloss, jfull, jsteps, _), (loss, full, steps, _) = \
        _both(arch, "bfloat16")
    (_, f32_full, f32_steps, _), _ = _jax_side(arch, "float32", False)
    port = max([_rel(full, jfull)] +
               [_rel(a, r) for a, r in zip(steps, jsteps)])
    own = max([_rel(jfull, f32_full)] +
              [_rel(a, r) for a, r in zip(jsteps, f32_steps)])
    return port, own, loss, jloss


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bfloat16_forward_and_decode_match_jax(arch):
    port, own, loss, jloss = _bf16_gaps(arch)
    limit = BF16_OF_OWN_GAP * own
    assert 0 < own < 0.1, own               # bfloat16 rounding, nothing worse
    assert abs(loss - jloss) <= limit * abs(jloss), (loss, jloss, limit)
    assert port <= limit, (port, own)


def test_bf16_archs_cover_every_family():
    assert {get_config(a).family for a in BF16_ARCHS} == \
        {c.family for c in ASSIGNED.values()}


def test_clip_thresholds_match_jax():
    """The paper's activation clip on the LM path (per-layer stacked taus
    into attention and FFN inputs) agrees with the JAX package."""
    jcfg, cfg = _cfgs("qwen3-0.6b", "float32")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    toks, _ = _inputs(cfg, seed=3)
    taus = {"attn": np.array([0.3, 0.6], np.float32),
            "ffn": np.array([0.2, 0.05], np.float32)}
    ref = jax.jit(lambda p, t, s: jtfm.lm_forward(jcfg, p, t, sparsity=s)[1])(
        jparams, jnp.asarray(toks), {k: jnp.asarray(v) for k, v in taus.items()})
    out = tfm.lm_forward(cfg, params, torch.as_tensor(toks, dtype=torch.int64),
                         sparsity={k: torch.as_tensor(v)
                                   for k, v in taus.items()})[1]
    dense = tfm.lm_forward(cfg, params,
                           torch.as_tensor(toks, dtype=torch.int64))[1]
    assert _rel(_f32(out), np.asarray(ref)) <= F32_TOL
    assert _rel(_f32(dense), np.asarray(ref)) > 1e-3     # the clip did act


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_building_blocks_match_jax(dtype):
    """rmsnorm (float32 inside), the three activations (gelu is the tanh
    approximation, jax.nn.gelu's default) and the split-half RoPE."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 2
    scale = rng.uniform(0.5, 1.5, size=16).astype(np.float32)
    pos = np.array([0, 1, 7, 100, 4095])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = common.dtype_of(dtype)
    jx, tx = jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)
    tol = 1e-6 if dtype == "float32" else 1e-2
    pairs = [(jcommon.rmsnorm(jx, jnp.asarray(scale)),
              common.rmsnorm(tx, torch.as_tensor(scale))),
             (jcommon.apply_rope(jx, jnp.asarray(pos), 1e6),
              common.apply_rope(tx, torch.as_tensor(pos), 1e6))]
    pairs += [(jcommon.activation(n)(jx), common.activation(n)(tx))
              for n in ("silu", "gelu", "relu2")]
    for j, t in pairs:
        assert t.dtype == tdt
        ref = np.asarray(j.astype(jnp.float32))
        assert _rel(_f32(t), ref) <= tol


# --------------------------------------------------------------------- #
# Parameter trees
# --------------------------------------------------------------------- #
def _tree_sig(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_sig(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_tree_converts_to_the_port_init_tree(arch):
    """Every family's JAX parameter tree (stacked leaves, MLA, MoE, SSM,
    RWKV, encoder) converts to a tree with the port's own names, shapes and
    dtypes, and back unchanged."""
    jcfg, cfg = _cfgs(arch, "bfloat16")
    jnp_tree = jax.tree_util.tree_map(
        np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    conv = params_from_jax(jnp_tree)
    gen = torch.Generator().manual_seed(0)
    own = build_model(cfg).init(gen, device="cpu")
    assert _tree_sig(conv) == _tree_sig(own)
    back = params_to_jax(conv)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, jnp_tree))


def test_bfloat16_leaves_convert_exactly():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 97), jnp.bfloat16))
    t = params_from_jax({"w": a})["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.to(torch.float32).numpy(), a.astype(np.float32))
    assert np.array_equal(params_to_jax({"w": t})["w"], a.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_params_cast_once_is_bit_identical(arch):
    """Casting the weights to the compute dtype once (what ``ServeSession``
    does) gives the same bits as casting them at every read; only the
    family's own float32 leaves stay float32."""
    _, cfg = _cfgs(arch, "bfloat16")
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(1), device="cpu")
    cast = serving_params(api, params, "cpu")
    assert "final_norm" in api.read_in_float32
    for k, v in _flat(cast).items():
        kept = k.split("/")[1] in api.read_in_float32
        assert (v.dtype == torch.float32) == kept, (k, v.dtype)
    toks, frames = _inputs(cfg, seed=1)
    kw = {} if frames is None else {"frames": torch.as_tensor(frames)}
    t = torch.as_tensor(toks, dtype=torch.int64)
    outs = []
    for p in (params, cast):
        lg, cache = api.prefill(p, t[:, :SPLIT], 16, **kw)
        seq = [lg]
        for i in range(2):
            lg, cache = api.decode_step(p, cache, t[:, SPLIT + i:SPLIT + i + 1])
            seq.append(lg)
        outs.append(torch.cat(seq, dim=1))
    assert torch.equal(outs[0], outs[1])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# --------------------------------------------------------------------- #
# Twins of test_models_smoke.py (forward value, decode shapes, data)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_forward(arch):
    cfg = reduce_config(get_config(arch))
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    batch = lm_batch(cfg, B, 16, seed=0, device="cpu")
    with torch.no_grad():
        loss, _ = api.loss(params, batch)
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)) and float(loss) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_decode_shapes(arch):
    cfg = reduce_config(get_config(arch))
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    cache = api.init_cache(B, 32, device="cpu")
    token = torch.zeros((B, 1), dtype=torch.int64)
    with torch.no_grad():
        logits, new_cache = api.decode_step(params, cache, token)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert not bool(torch.isnan(logits.to(torch.float32)).any())
    assert int(new_cache["pos"][0]) == 1


def test_synthetic_lm_batches_deterministic():
    cfg = reduce_config(get_config("qwen3-0.6b"))
    b1 = lm_batch(cfg, 4, 32, seed=3, step=7, device="cpu")
    b2 = lm_batch(cfg, 4, 32, seed=3, step=7, device="cpu")
    b3 = lm_batch(cfg, 4, 32, seed=3, step=8, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert int(b1["tokens"].min()) >= 0
    assert int(b1["tokens"].max()) < cfg.vocab_size
    wcfg = reduce_config(get_config("whisper-base"))
    wb = batch_for(wcfg, ShapeConfig("t", 16, 2, "train"), seed=1,
                   device="cpu")
    assert wb["tokens"].shape == (2, 16)
    assert wb["frames"].shape == (2, wcfg.num_frames, wcfg.d_model)


# --------------------------------------------------------------------- #
# Twins of test_decode_consistency.py
# --------------------------------------------------------------------- #
def _consistent_cfg(arch):
    cfg = dataclasses.replace(reduce_config(get_config(arch)), dtype="float32")
    if cfg.moe is not None:          # no drops: the one batch-dependent term
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return cfg


@pytest.mark.parametrize("arch,tol", [
    ("qwen3-0.6b", 1e-4), ("qwen2.5-3b", 1e-4), ("stablelm-12b", 1e-4),
    ("chameleon-34b", 1e-4), ("deepseek-67b", 1e-4),
    ("deepseek-v3-671b", 1e-4), ("mixtral-8x7b", 1e-4), ("rwkv6-1.6b", 1e-4),
    ("zamba2-1.2b", 5e-4), ("whisper-base", 1e-4),
])
def test_decode_matches_teacher_forcing(arch, tol):
    cfg = _consistent_cfg(arch)
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(1), device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    kw, frames = {}, None
    if cfg.is_encoder_decoder:
        frames = torch.randn((B, cfg.num_frames, cfg.d_model), generator=g)
        kw["frames"] = frames
    with torch.no_grad():
        ref = _teacher(cfg, params, tokens, frames)
        last, cache = api.prefill(params, tokens[:, :SPLIT], 16, **kw)
        scale = float(ref.abs().max())
        errs = [float((last[:, 0] - ref[:, SPLIT - 1]).abs().max())]
        for t in range(SPLIT, S):
            lg, cache = api.decode_step(params, cache, tokens[:, t:t + 1])
            errs.append(float((lg[:, 0] - ref[:, t]).abs().max()))
    assert max(errs) <= tol * max(scale, 1.0), f"{arch}: {errs}"


def test_swa_ring_buffer_beyond_window():
    """Mixtral-style SWA: decode far past the window stays consistent."""
    cfg = _consistent_cfg("mixtral-8x7b")                    # window 8
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(1), device="cpu")
    S_long = 24
    tokens = torch.randint(0, cfg.vocab_size, (B, S_long),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = _teacher(cfg, params, tokens)
        last, cache = api.prefill(params, tokens[:, :8], 32)
        assert cache["k"].shape[2] == 8                       # a ring of 8
        errs = []
        for t in range(8, S_long):
            lg, cache = api.decode_step(params, cache, tokens[:, t:t + 1])
            errs.append(float((lg[:, 0] - ref[:, t]).abs().max()))
    assert max(errs) < 1e-3, errs
