"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU a wrapper of the port takes its kernel's plain PyTorch version, and
the JAX side runs its Pallas kernels in interpret mode through ``ops``, as
``tests/test_kernels.py`` does: the same numpy inputs go through both. The
CUDA kernels themselves are held against their plain versions on the card by
``tests/test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops, ref as jref
from repro.kernels import block_sparse_matmul as jbsm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels.act_clip import act_clip_count, act_clip_count_flat

# the suite runs several test processes side by side: a few threads each
# instead of every core each (the shapes here are tiny)
torch.set_num_threads(2)

RNG = np.random.default_rng(7)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _to_torch(a: np.ndarray, dtype: str, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype]).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _tile_sparse_weight(K, N, p=0.4):
    w = RNG.normal(size=(K, N)).astype(np.float32)
    for i in range(-(-K // 128)):
        for j in range(-(-N // 128)):
            if RNG.random() < p:
                w[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = 0.0
    return w


# --------------------------------------------------------------------- #
# block_sparse_matmul
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 384, 256),
                                   (100, 300, 200), (64, 512, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_matmul_sweep(M, K, N, dtype):
    x = RNG.normal(size=(M, K)).astype(np.float32)
    w = _tile_sparse_weight(K, N)
    jx, jw = jnp.asarray(x, JDT[dtype]), jnp.asarray(w, JDT[dtype])
    jout = np.asarray(jops.SparseWeight(jw).matmul(jx))
    sw = ops.SparseWeight(_to_torch(w, dtype))
    out = sw.matmul(_to_torch(x, dtype))
    assert out.dtype == torch.float32 and out.shape == (M, N)
    oracle = ref.block_sparse_matmul_ref(
        _to_torch(x, dtype).float(), _to_torch(w, dtype).float(),
        sw.mask, 128, 128)
    # 1e-4 for f32 (summation order), 2e-1 for bf16 inputs: the reference's
    # own tolerances
    tol = 1e-4 if dtype == "float32" else 2e-1
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), jout, atol=tol, rtol=tol)


def test_schedule_skips_zero_tiles():
    mask = np.array([[1, 0], [0, 0], [1, 1]], dtype=bool)
    counts, indices = bsm.build_tile_schedule(mask)
    assert counts.tolist() == [2, 1]
    assert indices[0, :2].tolist() == [0, 2]
    assert indices.shape[1] == 2
    jc, ji = jbsm.build_tile_schedule(mask)
    assert np.array_equal(counts, jc) and np.array_equal(indices, ji)


def test_masked_tiles_contribute_zero_even_if_weight_nonzero():
    x = torch.ones((128, 256))
    w = torch.ones((256, 128))
    mask = np.array([[True], [False]])
    counts, indices = bsm.build_tile_schedule(mask)
    out = bsm.block_sparse_matmul(x, w, torch.from_numpy(counts),
                                  torch.from_numpy(indices))
    np.testing.assert_allclose(_np(out), 128.0)
    jout = jbsm.block_sparse_matmul(
        jnp.ones((128, 256)), jnp.ones((256, 128)), jnp.asarray(counts),
        jnp.asarray(indices), interpret=True)
    np.testing.assert_array_equal(_np(out), np.asarray(jout))


def test_all_zero_column_gives_zeros():
    w = RNG.normal(size=(256, 256)).astype(np.float32)
    w[:, 128:] = 0.0
    x = RNG.normal(size=(128, 256)).astype(np.float32)
    out = ops.block_sparse_dense(torch.from_numpy(x), torch.from_numpy(w))
    assert float(out[:, 128:].abs().max()) == 0.0
    np.testing.assert_allclose(_np(out), x @ w, atol=1e-4, rtol=1e-4)


def test_schedule_mask_inverts_build_tile_schedule():
    for _ in range(20):
        mask = RNG.random((int(RNG.integers(1, 9)),
                           int(RNG.integers(1, 9)))) < 0.5
        c, i = bsm.build_tile_schedule(mask)
        assert np.array_equal(bsm.schedule_mask(c, i, mask.shape[0]), mask)


@settings(max_examples=15, deadline=None)
@given(kt=st.integers(1, 4), nt=st.integers(1, 3),
       density=st.floats(0.1, 1.0))
def test_property_schedule_counts_match_mask(kt, nt, density):
    mask = RNG.random((kt, nt)) < density
    counts, indices = bsm.build_tile_schedule(mask)
    jc, ji = jbsm.build_tile_schedule(mask)
    assert np.array_equal(counts, jc) and np.array_equal(indices, ji)
    assert (counts == mask.sum(0)).all()
    for j in range(nt):
        nz = np.nonzero(mask[:, j])[0]
        assert indices[j, :len(nz)].tolist() == nz.tolist()


def test_build_tile_schedule_matches_reference_loop():
    rng = np.random.default_rng(0)
    for _ in range(60):
        kt, nt = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        mask = rng.random((kt, nt)) < rng.uniform(0.0, 1.0)
        c1, i1 = bsm.build_tile_schedule(mask)
        c2, i2 = bsm._build_tile_schedule_ref(mask)
        c3, i3 = jbsm.build_tile_schedule(mask)
        assert np.array_equal(c1, c2) and np.array_equal(i1, i2)
        assert np.array_equal(c1, c3) and np.array_equal(i1, i3)


def test_build_tile_schedule_memoizes_per_mask_content():
    rng = np.random.default_rng(1)
    mask = rng.random((12, 9)) < 0.4
    bsm._SCHEDULE_CACHE.clear()
    a = bsm.build_tile_schedule(mask)
    b = bsm.build_tile_schedule(mask.copy())
    assert a[0] is b[0] and a[1] is b[1]
    assert len(bsm._SCHEDULE_CACHE) == 1
    mask2 = mask.copy()
    mask2[0, 0] = not mask2[0, 0]
    bsm.build_tile_schedule(mask2)
    assert len(bsm._SCHEDULE_CACHE) == 2


def test_schedule_cache_is_bounded():
    rng = np.random.default_rng(2)
    bsm._SCHEDULE_CACHE.clear()
    for _ in range(bsm._SCHEDULE_CACHE_MAX + 10):
        bsm.build_tile_schedule(rng.random((6, 6)) < 0.5)
    assert len(bsm._SCHEDULE_CACHE) <= bsm._SCHEDULE_CACHE_MAX


def _patterned_weight(kind, seed, K=384, N=256):
    """The same pattern-pruned weight from both packages (asserted equal)."""
    from repro.core import pruning as jpr
    from repro_torch.core import pruning as tpr
    w = np.random.default_rng(seed).normal(size=(K, N)).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if kind == "nm":
        jw = jpr.nm_prune(jpr.tile_prune(jw, 0.4)[0], 4)
        tw = tpr.nm_prune(tpr.tile_prune(tw, 0.4)[0], 4)
    elif kind == "hierarchical":
        jw = jpr.hierarchical_prune(jw, 0.5, 3)[0]
        tw = tpr.hierarchical_prune(tw, 0.5, 3)[0]
    else:
        jw = jpr.tile_prune(jw, 0.5)[0]
        tw = tpr.tile_prune(tw, 0.5)[0]
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    return tw


@pytest.mark.parametrize("kind", ["unstructured", "nm", "hierarchical"])
@pytest.mark.parametrize("seed", [0, 1])
def test_patterned_mask_schedule_matches_reference(kind, seed):
    w = _patterned_weight(kind, seed)
    mask = bsm.tile_mask(w.numpy())
    c1, i1 = bsm.build_tile_schedule(mask)
    c2, i2 = bsm._build_tile_schedule_ref(mask)
    assert np.array_equal(c1, c2) and np.array_equal(i1, i2)
    if kind != "nm":
        assert (c1 < mask.shape[0]).any()


@pytest.mark.parametrize("kind", ["nm", "hierarchical"])
def test_block_sparse_matmul_on_patterned_weights(kind):
    w = _patterned_weight(kind, 3)
    x = torch.from_numpy(RNG.normal(size=(128, w.shape[0])).astype(np.float32))
    counts, indices = bsm.build_tile_schedule(bsm.tile_mask(w.numpy()))
    out = bsm.block_sparse_matmul(x, w, torch.from_numpy(counts),
                                  torch.from_numpy(indices))
    np.testing.assert_allclose(_np(out), _np(x @ w), atol=1e-4, rtol=1e-4)


def test_tile_mask_shape_and_content():
    w = np.zeros((256, 256), np.float32)
    w[130, 5] = 1.0
    mask = bsm.tile_mask(w)
    assert mask.shape == (2, 2)
    assert mask.tolist() == [[False, False], [True, False]]
    assert np.array_equal(mask, jbsm.tile_mask(w))
    with pytest.raises(AssertionError):
        bsm.tile_mask(np.zeros((100, 256), np.float32))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w = torch.zeros((128, 128)), torch.zeros((128, 128))
    c = torch.zeros((1,), dtype=torch.int32)
    i = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        bsm.block_sparse_matmul(x[:100], w, c, i)            # M % bm
    with pytest.raises(ValueError):
        bsm.block_sparse_matmul(x, w, c[:0], i)              # schedule shape
    with pytest.raises(TypeError):
        bsm.block_sparse_matmul(x, w.to(torch.bfloat16), c, i)
    with pytest.raises(ValueError):
        act_clip_count(torch.zeros((100, 256)), 0.0)         # M % bm
    with pytest.raises(ValueError):
        act_clip_count(torch.zeros((256,)), 0.0)             # not 2-D
    # the any-shape entries the main path calls take unpadded operands, but
    # not a mismatched K, a plan made for another M, or an empty input
    sw = ops.SparseWeight(w)
    with pytest.raises(ValueError):
        sw.matmul(torch.zeros((100, 120)))                   # K != 128
    with pytest.raises(ValueError):
        bsm.run_plan(x[:100], sw.w_padded, sw.indices, sw.plan(128), 128)
    with pytest.raises(ValueError):
        act_clip_count_flat(torch.zeros((0, 3)), 0.0)        # empty


# --------------------------------------------------------------------- #
# act_clip
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(64, 64), (100, 333), (7, 1024), (1, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tau", [0.0, 0.5, 2.0])
def test_act_clip_sweep(shape, dtype, tau):
    x = RNG.normal(size=shape).astype(np.float32)
    jy, jcnt = jops.act_clip(jnp.asarray(x, JDT[dtype]), tau)
    tx = _to_torch(x, dtype)
    y, cnt = ops.act_clip(tx, tau)
    y_ref, cnt_ref = ref.act_clip_count_ref(tx, tau)
    assert y.shape == tx.shape and y.dtype == tx.dtype
    assert torch.equal(y, y_ref) and int(cnt) == int(cnt_ref)
    # bit-equal to the Pallas kernel (interpret mode) on the same input
    np.testing.assert_array_equal(_np(y), np.asarray(jy, np.float32))
    assert int(cnt) == int(jcnt)


@settings(max_examples=10, deadline=None)
@given(m=st.integers(1, 130), k=st.integers(1, 300), tau=st.floats(0, 3))
def test_property_clip_idempotent_and_counts(m, k, tau):
    x = torch.from_numpy(RNG.normal(size=(m, k)).astype(np.float32))
    y, cnt = ops.act_clip(x, tau)
    y2, cnt2 = ops.act_clip(y, tau)
    assert torch.equal(y, y2)
    assert int(cnt) == int(cnt2) == int((y == 0).sum())


def test_act_clip_counts_existing_and_negative_zeros():
    x = torch.tensor([[0.0, -0.0, 1.0, -2.0]] * 4)
    y, cnt = ops.act_clip(x, 0.0)
    assert int(cnt) == 8
    # tau = 0 leaves x as it is, bit for bit (-0.0 stays -0.0)
    assert torch.equal(y.view(torch.int32), x.view(torch.int32))
    jy, jcnt = jops.act_clip(jnp.asarray(x.numpy()), 0.0)
    assert int(jcnt) == 8


def test_act_clip_count_per_tile_counts_match_pallas():
    x = RNG.normal(size=(512, 512)).astype(np.float32)
    from repro.kernels.act_clip import act_clip_count as jacc
    jy, jcnt = jacc(jnp.asarray(x), 0.7, interpret=True)
    y, cnt = act_clip_count(torch.from_numpy(x), 0.7)
    assert cnt.dtype == torch.int32 and tuple(cnt.shape) == (2, 2)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_bf16_compare_is_made_in_float32_like_the_pallas_kernel():
    """For a bf16 input the TPU kernel compares ``abs(x) >= tau`` in float32
    (its tau is a float32 scalar), while the JAX package's ``ref`` with a
    Python-float tau compares in bf16. They agree where tau is bf16-exact
    (0, 0.5, 2.0) and differ e.g. at tau = 0.2995 for x = bf16(0.2988...):
    in bf16 tau rounds to 0.2988 and x is kept, in float32 it is clipped.
    The port's kernel and its plain version both follow the kernel."""
    tau = 0.2995
    xb = jnp.asarray([0.2988], jnp.bfloat16)           # == bf16(tau)
    assert float(xb[0]) < tau and float(jnp.bfloat16(tau)) == float(xb[0])
    x = np.tile(np.asarray(xb, np.float32), (8, 16))
    jx = jnp.asarray(x, jnp.bfloat16)
    y_kernel, cnt_kernel = jops.act_clip(jx, tau)
    y_jref, cnt_jref = jref.act_clip_count_ref(jx, tau)
    assert int(cnt_kernel) == x.size and int(cnt_jref) == 0   # they differ
    tx = _to_torch(x, "bfloat16")
    y, cnt = ops.act_clip(tx, tau)
    y_ref, cnt_ref = ref.act_clip_count_ref(tx, tau)
    assert int(cnt) == int(cnt_ref) == int(cnt_kernel)
    np.testing.assert_array_equal(_np(y), np.asarray(y_kernel, np.float32))
