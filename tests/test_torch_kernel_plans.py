"""The redesigned kernels' host-side contracts on the CPU: the matmul's work
plan, its plain executor against the JAX kernel, the wrapper's device checks,
the clip's any-shape view without a padded copy against the JAX
``ops.act_clip``, and the bounds the card's measurements are held to.

The same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernel in interpret mode) and the port's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnns import RESNET18 as JRESNET18
from repro.kernels import ops as jops
from repro.kernels.act_clip import act_clip_count as jacc
from repro.models import cnn as jcnn
from repro_torch.kernels import act_clip, bench_util, ops, ref
from repro_torch.kernels import block_sparse_matmul as bsm

torch.set_num_threads(2)

# the execute step's products on ResNet-18 at 224 x 224 (M capped at
# 25,088), and ragged shapes
MAIN_SHAPES = [(25088, 147, 64), (25088, 576, 64), (6272, 576, 128),
               (6272, 1152, 128), (6272, 64, 128), (1568, 1152, 256),
               (1568, 2304, 256), (1568, 128, 256), (392, 2304, 512),
               (392, 4608, 512), (392, 256, 512), (8, 512, 1000)]
RAGGED_SHAPES = [(100, 300, 200), (8, 512, 1000), (1, 5, 3), (257, 129, 130)]


def _counts(K, N, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((-(-K // 128), -(-N // 128))) < density
    return bsm.build_tile_schedule(mask)


CPT = 128 // bsm.CHUNK          # chunks per 128-deep K-tile


def _covered(plan, counts):
    """{(m_tile, n_tile) -> list of the chunks its items cover}."""
    seen = {}
    for m, n, c0, c1, slot in plan.items.tolist():
        assert 0 <= c0 <= c1 <= counts[n * plan.tile[1] // 128] * CPT
        assert 0 <= slot < plan.splits[n * plan.tile[1] // 128]
        seen.setdefault((m, n), []).extend(range(c0, c1))
    return seen


@pytest.mark.parametrize("M,K,N", MAIN_SHAPES + RAGGED_SHAPES)
@pytest.mark.parametrize("density", [1.0, 0.6, 0.1])
def test_plan_covers_every_step_once_and_keeps_its_promise(M, K, N, density):
    counts, _ = _counts(K, N, density, seed=M + K + N)
    plan = bsm.make_plan(counts, M, N)
    BM, BN = plan.tile
    tm, tn = -(-M // BM), -(-N // BN)
    seen = _covered(plan, counts)
    assert set(seen) == {(m, n) for m in range(tm) for n in range(tn)}
    for (m, n), chunks in seen.items():
        # every (column, scheduled step) exactly once, as its CPT chunks
        assert sorted(chunks) == list(range(counts[n * BN // 128] * CPT))
    # each output tile has exactly splits[j] items, one per slot
    slots = {}
    for m, n, _, _, slot in plan.items.tolist():
        slots.setdefault((m, n), []).append(slot)
    for (m, n), ss in slots.items():
        assert sorted(ss) == list(range(plan.splits[n * BN // 128]))
    achievable = tm * int(np.maximum(
        1, -(-counts[np.arange(tn) * BN // 128] * CPT // 2)).sum())
    assert plan.promised == min(plan.target // 2, achievable)
    assert plan.blocks >= plan.promised
    assert plan.blocks >= tm * tn


def test_plan_splits_only_where_the_tiles_are_too_few():
    counts, _ = _counts(4608, 512, 1.0, seed=0)
    small = bsm.make_plan(counts, 392, 512)
    assert small.max_splits > 1 and small.blocks >= small.promised > 132
    counts, _ = _counts(4608, 512, 1.0, seed=0)
    many = bsm.make_plan(counts, 25088, 512)
    assert many.tile == (128, 64) and many.max_splits == 1
    assert many.blocks == 196 * 8 >= many.target
    counts, _ = _counts(512, 1000, 1.0, seed=0)
    assert bsm.make_plan(counts, 8, 1000).tile == (16, 128)


@pytest.mark.parametrize("M,K,N", [(100, 300, 200), (8, 512, 1000),
                                   (130, 147, 64), (200, 700, 260)])
@pytest.mark.parametrize("tile", bsm.TILES)
@pytest.mark.parametrize("min_chunks", [1, 3, 8])
def test_plan_executor_matches_jax_kernel(M, K, N, tile, min_chunks):
    rng = np.random.default_rng(M * 7 + K)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    mask = rng.random((-(-K // 128), -(-N // 128))) < 0.6
    w *= np.kron(mask, np.ones((128, 128)))[:K, :N].astype(np.float32)
    jout = np.asarray(jops.SparseWeight(jnp.asarray(w)).matmul(
        jnp.asarray(x)))
    sw = ops.SparseWeight(torch.from_numpy(w))
    plan = bsm.make_plan(sw.host_counts, M, N, tile=tile, min_chunks=min_chunks,
                         target=10_000)
    out = ref.block_sparse_matmul_plan_ref(
        torch.from_numpy(x), sw.w_padded, sw.indices, plan.items,
        plan.splits, plan.tile, N, 128, 128)
    assert out.shape == (M, N)
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-4, rtol=1e-4)


def test_sparse_weight_keeps_one_plan_per_row_count():
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(300, 200)).astype(np.float32))
    sw = ops.SparseWeight(w)
    a, b = sw.plan(100), sw.plan(100)
    assert a is b and sw.plan(8) is not a
    assert a.plan.M == 100 and sw.plan(8).plan.tile == (16, 128)


@pytest.mark.parametrize("where", ["w", "indices", "plan", "splits"])
def test_run_plan_refuses_an_operand_on_another_device(where):
    """The kernel would read a pointer of another device as its own: the
    wrapper raises instead (a CPU operand beside a CUDA x, or another card;
    here a ``meta`` tensor stands for the other device)."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(300, 200)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(100, 300)).astype(np.float32))
    sw = ops.SparseWeight(w)
    dp = bsm.DevicePlan(sw.plan(100).plan, "cpu")
    wp, idx = sw.w_padded, sw.indices
    if where == "w":
        wp = wp.to("meta")
    elif where == "indices":
        idx = idx.to("meta")
    elif where == "plan":
        dp.items = dp.items.to("meta")
    else:
        dp.splits = dp.splits.to("meta")
    with pytest.raises(ValueError, match="meta"):
        bsm.run_plan(x, wp, idx, dp, 200)
    # all on one device that is not a card: still no launch
    with pytest.raises(ValueError, match="cuda"):
        bsm.run_plan(x, sw.w_padded, sw.indices, sw.plan(100), 200)


def test_sparse_weight_refuses_x_on_another_device():
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=(300, 200)).astype(np.float32))
    with pytest.raises(ValueError, match="w is on cpu"):
        ops.SparseWeight(w).matmul(torch.zeros((100, 300), device="meta"))


@pytest.mark.parametrize("shape", [(2, 56, 56, 64), (1, 9), (100, 333),
                                   (3, 7, 7, 512), (2, 224, 224, 3), (2, 512),
                                   (7, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_clip_ragged_matches_jax(shape, dtype):
    rng = np.random.default_rng(int(np.prod(shape)) % 1000)
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jy, jtotal = jops.act_clip(jnp.asarray(x, jdt), 0.4)
    tx = torch.from_numpy(x).to(tdt)
    y, total = ops.act_clip(tx, 0.4)
    assert y.shape == tx.shape and y.dtype == tdt
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(jy, np.float32))
    assert int(total) == int(jtotal)
    # the kernel's own outputs: per-tile counts as the JAX kernel gives them
    # on the padded copy, and the total without the padding
    y2, cnt, total2 = act_clip.act_clip_count_flat(tx, 0.4)
    assert torch.equal(y2, y) and int(total2) == int(total)
    cols, bm, tiles = act_clip.flat_tiles(x.size)
    xp = np.pad(x.reshape(-1), (0, tiles * bm * cols - x.size))
    _, jcnt = jacc(jnp.asarray(xp.reshape(-1, cols), jdt), 0.4, bm=bm,
                   bn=cols, interpret=True)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt).reshape(-1))


@pytest.mark.parametrize("n,bm,bn,want", [
    (9, 256, 256, (9, 1, 1)), (33300, 256, 256, (256, 131, 1)),
    (8 * 56 * 56 * 64, 256, 256, (256, 256, 25)),
    (8 * 224 * 224 * 3, 256, 256, (256, 256, 19)),
    (4096, 256, 256, (256, 16, 1))])
def test_flat_tiles_is_the_jax_wrappers_view(n, bm, bn, want):
    assert act_clip.flat_tiles(n, bm, bn) == want


def test_main_path_clip_shapes_are_the_jax_models_prunable_inputs():
    want = [(s.name, (8, s.in_hw, s.in_hw, s.cin) if s.kind == "conv"
             else (8, s.cin))
            for s in jcnn.build_specs(JRESNET18) if s.prunable]
    got = bench_util.main_path_clip_shapes(8)
    assert got == want and len(got) == 21
    assert got[0][1] == (8, 224, 224, 3) and got[-1][1] == (8, 512)


@pytest.mark.parametrize("M,K,N", [(100, 300, 200), (8, 512, 1000),
                                   (392, 4608, 512)])
def test_matmul_bound_counts_the_unpadded_scheduled_work(M, K, N):
    gen = torch.Generator().manual_seed(M + K)
    dense = ops.SparseWeight(bench_util.tile_sparse_weight(K, N, 1.0, gen))
    t, by = bench_util.matmul_bound_ms(dense, M, 4)
    Kt, Nt = -(-K // 128), -(-N // 128)
    flops = 2.0 * M * K * N
    nbytes = 4 * (M * K + K * N + M * N + Nt + Kt * Nt)
    want = max(flops / bench_util.FP32_FLOPS,
               nbytes / bench_util.HBM_BYTES_PER_S) * 1e3
    assert t == pytest.approx(want, rel=1e-12)
    assert by == ("operations" if flops / bench_util.FP32_FLOPS >=
                  nbytes / bench_util.HBM_BYTES_PER_S else "bytes")
    # an emptier schedule has a smaller bound; an empty one moves only the
    # output and the counts
    sparse = ops.SparseWeight(bench_util.tile_sparse_weight(K, N, 0.3, gen))
    assert bench_util.matmul_bound_ms(sparse, M, 4)[0] <= t
    empty = ops.SparseWeight(torch.zeros((K, N)))
    t0, by0 = bench_util.matmul_bound_ms(empty, M, 4)
    assert by0 == "bytes" and t0 == pytest.approx(
        4 * (M * N + Nt) / bench_util.HBM_BYTES_PER_S * 1e3, rel=1e-12)


@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_tile_sparse_weight_keeps_whole_tiles(density):
    gen = torch.Generator().manual_seed(9)
    w = bench_util.tile_sparse_weight(300, 200, density, gen)
    mask = ops.weight_tile_mask(w.numpy())
    assert w.shape == (300, 200) and mask.shape == (3, 2)
    if density == 1.0:
        assert mask.all()
    elif density == 0.0:
        assert not mask.any()
    # a kept tile is kept whole: it has no zero inside the weight's bounds
    for i, j in zip(*np.nonzero(mask)):
        assert bool((w[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128]
                     != 0).all())


def test_clip_bound_is_the_bytes_moved():
    x = torch.zeros((8, 56, 56, 64))
    t, by = bench_util.clip_bound_ms(x, 25)
    assert by == "bytes"
    assert t == pytest.approx((2 * x.numel() * 4 + 4 * 25)
                              / bench_util.HBM_BYTES_PER_S * 1e3, rel=1e-12)
