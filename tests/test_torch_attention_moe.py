"""repro_torch.models.attention and .moe against the JAX package: twins of
``tests/test_attention.py`` (all six) and ``tests/test_moe.py`` (all four).
Each twin feeds the same numpy inputs to both packages, holds the port to
the reference test's own contract, and compares the port's output with the
JAX function's (float32, 2e-5 as the reference tests use; 1e-5 for MoE)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget, reduce_config as jreduce
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import attention as JA
from repro.models import build_model as jbuild
from repro.models import moe as JM
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as A
from repro_torch.models import moe as M

torch.set_num_threads(2)
# the first parallel torch.exp of a CPU process can come out ~1e-4 off in one
# thread's share of the tensor (tools/cpu_exp_first_call.py); this call takes
# that first call
torch.exp(torch.randn((1 << 17,), generator=torch.Generator().manual_seed(0)))
TOL = dict(atol=2e-5, rtol=2e-5)
# every test draws its inputs from its own seeded stream (the property tests
# from a seed that hypothesis draws), so they do not depend on test order


def _mk(seed, B, Sq, Sk, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, D)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, D)).astype(np.float32))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("Sk,block_k", [(256, 64), (384, 64), (520, 64)])
@pytest.mark.parametrize("window", [0, 128])
def test_blockwise_matches_reference(Sk, block_k, window):
    q, k, v = _mk(Sk + window, 2, Sk, Sk, 4, 2, 16)
    out = A.blockwise_attention(*_t(q, k, v), causal=True, window=window,
                                block_k=block_k)
    ref = A.reference_attention(*_t(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    jout = JA.blockwise_attention(*_j(q, k, v), causal=True, window=window,
                                  block_k=block_k)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_banded_matches_full():
    q, k, v = _mk(1, 1, 512, 512, 4, 4, 16)
    full = A.blockwise_attention(*_t(q, k, v), causal=True, block_k=64,
                                 impl="blockwise_full")
    band = A.blockwise_attention(*_t(q, k, v), causal=True, block_k=64,
                                 impl="banded")
    np.testing.assert_allclose(full.numpy(), band.numpy(), **TOL)
    jband = JA.blockwise_attention(*_j(q, k, v), causal=True, block_k=64,
                                   impl="banded")
    np.testing.assert_allclose(band.numpy(), np.asarray(jband), **TOL)


def test_banded_window_skips_blocks():
    """With a window, the banded block list must shrink the loop."""
    q, k, v = _mk(2, 1, 64, 1024, 2, 2, 8)
    assert len(A._band_blocks(1024 // 64, 64, 960, 64, True, 128)) == 3
    out = A.blockwise_attention(*_t(q, k, v), causal=True, window=128,
                                block_k=64, q_offset=960, impl="banded")
    ref = A.reference_attention(*_t(q, k, v), causal=True, window=128,
                                q_offset=960)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    jout = JA.blockwise_attention(*_j(q, k, v), causal=True, window=128,
                                  block_k=64, q_offset=960, impl="banded")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_decode_attention_masks_by_length():
    q, k, v = _mk(3, 3, 1, 64, 4, 2, 16)
    kv_len = np.asarray([1, 17, 64])
    out = A.decode_attention(*_t(q, k, v, kv_len))
    ref = A.reference_attention(*_t(q, k, v), causal=False,
                                kv_len=torch.as_tensor(kv_len))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    jout = JA.decode_attention(*_j(q, k, v, kv_len))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    # a sliding window keeps only the last `window` valid positions
    outw = A.decode_attention(*_t(q, k, v, kv_len), window=5)
    joutw = JA.decode_attention(*_j(q, k, v, kv_len), window=5)
    np.testing.assert_allclose(outw.numpy(), np.asarray(joutw), **TOL)


@settings(max_examples=20, deadline=None)
@given(
    B=st.integers(1, 3),
    Sk=st.sampled_from([96, 128, 200, 256]),
    H=st.sampled_from([2, 4]),
    G=st.sampled_from([1, 2]),
    D=st.sampled_from([8, 16]),
    causal=st.booleans(),
    seed=st.integers(0, 2**31 - 1),
)
def test_property_blockwise_equals_reference(B, Sk, H, G, D, causal, seed):
    KV = H // G if H % G == 0 else H
    q, k, v = _mk(seed, B, Sk, Sk, KV * G, KV, D)
    out = A.blockwise_attention(*_t(q, k, v), causal=causal, block_k=32)
    ref = A.reference_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=3e-5, rtol=3e-5)
    jref = JA.reference_attention(*_j(q, k, v), causal=causal)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref),
                               atol=3e-5, rtol=3e-5)


def test_softmax_rows_sum_to_one_property():
    """Attention output of constant V must be constant (softmax partition)."""
    q, k, _ = _mk(4, 2, 128, 128, 2, 2, 8)
    v = np.full((2, 128, 2, 8), 3.5, np.float32)
    out = A.blockwise_attention(*_t(q, k, v), causal=True, block_k=32)
    np.testing.assert_allclose(out.numpy(), 3.5, atol=1e-4)


def test_ragged_tail_and_fully_masked_rows_stay_finite():
    """A ragged Sk pads to block_k and masks the tail through kv_len; a row
    with no valid key (kv_len 0) is finite (NEG_INF, not -inf), as in JAX."""
    q, k, v = _mk(5, 2, 70, 200, 4, 2, 8)
    kv_len = np.asarray([0, 150])
    out = A.blockwise_attention(*_t(q, k, v), causal=False, block_k=64,
                                kv_len=torch.as_tensor(kv_len))
    jout = JA.blockwise_attention(*_j(q, k, v), causal=False, block_k=64,
                                  kv_len=jnp.asarray(kv_len))
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_bfloat16_attention_matches_jax():
    q, k, v = _mk(6, 2, 200, 200, 4, 2, 16)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    out = A.blockwise_attention(tq, tk, tv, causal=True, window=50,
                                block_k=64)
    jout = JA.blockwise_attention(jq, jk, jv, causal=True, window=50,
                                  block_k=64)
    assert out.dtype == torch.bfloat16
    # both compute in float32 from the same bf16 inputs and round once
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


# --------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------- #

def dense_reference(x, gates, idx, moe, expert_fn_dense):
    """Straightforward per-token loop (no capacity drops)."""
    T, d = x.shape
    out = np.zeros((T, d), np.float32)
    for t in range(T):
        for j in range(moe.top_k):
            e = int(idx[t, j])
            out[t] += float(gates[t, j]) * np.asarray(
                expert_fn_dense(e, np.asarray(x[t:t + 1])))[0]
    return out


def test_dispatch_matches_dense_when_no_drops():
    T, d, E, k = 32, 8, 4, 2
    moe = MoEConfig(num_experts=E, top_k=k, capacity_factor=8.0)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(T, d)).astype(np.float32)
    W = rng.normal(size=(E, d, d)).astype(np.float32)
    gates = rng.uniform(0.1, 1.0, size=(T, k)).astype(np.float32)
    idx = rng.integers(0, E, size=(T, k))
    Wt = torch.as_tensor(W)
    out = M.dispatch_combine(*_t(x, gates, idx), moe,
                             lambda buf: torch.bmm(buf, Wt))
    ref = dense_reference(x, gates, idx, moe, lambda e, xt: xt @ W[e])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    jout = JM.dispatch_combine(
        *_j(x, gates, idx.astype(np.int32)),
        JMoEConfig(num_experts=E, top_k=k, capacity_factor=8.0),
        lambda buf: jnp.einsum("ecd,edf->ecf", buf, jnp.asarray(W)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)


def test_capacity_drops_tokens_beyond_C():
    """All tokens to expert 0 with tiny capacity: only C survive — the first
    C slots in slot order, as in JAX."""
    T, d, E = 16, 4, 4
    moe = MoEConfig(num_experts=E, top_k=1, capacity_factor=1.0)
    C = M.capacity(T, moe)
    x = np.arange(T * d, dtype=np.float32).reshape(T, d) + 1.0
    gates = np.ones((T, 1), np.float32)
    idx = np.zeros((T, 1), np.int64)
    out = M.dispatch_combine(*_t(x, gates, idx), moe, lambda buf: buf)
    kept = int((out.numpy().sum(axis=1) > 0).sum())
    assert kept == min(T, C)
    jout = JM.dispatch_combine(
        *_j(x, gates, idx.astype(np.int32)),
        JMoEConfig(num_experts=E, top_k=1, capacity_factor=1.0),
        lambda buf: buf)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_router_normalizes_gates_and_aux_loss():
    moe = MoEConfig(num_experts=4, top_k=2, aux_loss_coef=0.01)
    jmoe = JMoEConfig(num_experts=4, top_k=2, aux_loss_coef=0.01)
    rng = np.random.default_rng(13)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    gates, idx, aux = M.route(*_t(x, w), moe)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(aux) > 0
    jg, ji, jaux = JM.route(*_j(x, w), jmoe)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    # perfectly balanced router -> aux ~= coef; every probability ties and
    # the top-k takes the lower expert indices, as jax.lax.top_k does
    wb = np.zeros((8, 4), np.float32)
    _, idx_b, aux_b = M.route(*_t(x, wb), moe)
    assert float(aux_b) == pytest.approx(0.01, rel=0.3)
    _, jidx_b, jaux_b = JM.route(*_j(x, wb), jmoe)
    np.testing.assert_array_equal(idx_b.numpy(), np.asarray(jidx_b))
    assert np.all(idx_b.numpy() == [0, 1])
    assert float(aux_b) == pytest.approx(float(jaux_b), rel=1e-6)


@settings(max_examples=10, deadline=None)
@given(T=st.sampled_from([8, 24, 64]), E=st.sampled_from([2, 4, 8]),
       k=st.sampled_from([1, 2]), seed=st.integers(0, 2**31 - 1))
def test_property_combine_is_gate_weighted_identity(T, E, k, seed):
    """expert_fn = identity => output = sum(gates)*x for surviving tokens."""
    moe = MoEConfig(num_experts=E, top_k=k, capacity_factor=16.0)
    d = 4
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    gates = np.full((T, k), 1.0 / k, np.float32)
    idx = rng.integers(0, E, size=(T, k))
    out = M.dispatch_combine(*_t(x, gates, idx), moe, lambda b: b)
    np.testing.assert_allclose(out.numpy(), x, atol=1e-5, rtol=1e-5)


def test_moe_ffn_default_capacity_drops_match_jax():
    """A Mixtral layer at its default capacity_factor (1.25) on 96 tokens
    that share a direction (as the hidden states of one context do), so the
    router favours some experts: slots are dropped, and the port drops the
    same ones as JAX (the stable sort by expert gives the capacity
    priority)."""
    jcfg = jreduce(jget("mixtral-8x7b"))
    cfg = reduce_config(get_config("mixtral-8x7b"))
    assert cfg.moe.capacity_factor == 1.25
    jp = jbuild(jcfg).init(jax.random.PRNGKey(5))["blocks"]["ffn"]
    jp = jax.tree_util.tree_map(lambda a: a[0], jp)
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    T = 96
    rng = np.random.default_rng(12)
    shared = rng.normal(size=(1, cfg.d_model))
    x = (1.5 * shared + rng.normal(size=(T, cfg.d_model))).astype(np.float32)
    _, idx, _ = M.route(torch.as_tensor(x), p["router"], cfg.moe)
    load = np.bincount(idx.numpy().ravel(), minlength=cfg.moe.num_experts)
    dropped = int(np.maximum(load - M.capacity(T, cfg.moe), 0).sum())
    assert dropped > 0
    y, aux = M.moe_ffn(torch.as_tensor(x), p, cfg.moe, cfg.act)
    jy, jaux = JM.moe_ffn(jnp.asarray(x), jp, jcfg.moe, jcfg.act)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


def test_dispatch_combine_is_deterministic_and_order_independent_of_k():
    """Two calls give the same bits, and top-3 combines match JAX (the
    contributions are added in expert order)."""
    T, d, E, k = 40, 6, 8, 3
    moe = MoEConfig(num_experts=E, top_k=k, capacity_factor=1.0)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(T, d)).astype(np.float32)
    probs = rng.uniform(size=(T, E)).astype(np.float32)
    gates, idx = M._top_k(torch.as_tensor(probs), k)
    W = torch.as_tensor(rng.normal(size=(E, d, d)).astype(np.float32))
    a = M.dispatch_combine(torch.as_tensor(x), gates, idx, moe,
                           lambda b: torch.bmm(b, W))
    b = M.dispatch_combine(torch.as_tensor(x), gates, idx, moe,
                           lambda b: torch.bmm(b, W))
    assert torch.equal(a, b)
    jg, ji = jax.lax.top_k(jnp.asarray(probs), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    jout = JM.dispatch_combine(
        jnp.asarray(x), jg, ji,
        JMoEConfig(num_experts=E, top_k=k, capacity_factor=1.0),
        lambda buf: jnp.einsum("ecd,edf->ecf", buf, jnp.asarray(W.numpy())))
    np.testing.assert_allclose(a.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("T,E,k,seed", [(40, 8, 3, 0), (96, 8, 2, 1),
                                        (16, 5, 1, 2), (64, 3, 2, 3)])
def test_group_positions_equal_the_references_scatter_min(T, E, k, seed):
    """Each sorted slot's position in its expert's group, bit for bit: the
    reference's scatter-min of the ranks (``.at[se].min``), and the rank
    less ``searchsorted(se, se)`` that the port took before. E = 5 and the
    small T leave experts without a slot."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, E, size=(T, k))
    se = np.sort(idx.reshape(-1), kind="stable")
    pos = M.group_positions(torch.as_tensor(se), E)
    ranks = jnp.arange(T * k, dtype=jnp.int32)
    jse = jnp.asarray(se.astype(np.int32))
    start = jnp.full((E,), T * k, jnp.int32).at[jse].min(ranks)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ranks - start[jse]))
    t = torch.as_tensor(se)
    np.testing.assert_array_equal(
        pos.numpy(), (torch.arange(T * k) - torch.searchsorted(t, t)).numpy())
    assert pos.dtype == torch.int64
