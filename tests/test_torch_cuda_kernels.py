"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where there is no GPU (a
CUDA kernel has no CPU mode). This file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch, nvcc and a card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.paper_cnns import PAPER_CNNS, RESNET18
from repro_torch.kernels import launch_counts, ops, ref
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels.act_clip import (act_clip_count, act_clip_count_flat,
                                         flat_tiles)

RNG = np.random.default_rng(7)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (100, 333), (7, 1024), (1, 9),
                                   (8, 56, 56, 64), (8, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tau", [0.0, 0.2995, 0.5, 2.0])
def test_cuda_act_clip_bit_equal(cuda, shape, dtype, tau):
    x = _to_torch(RNG.normal(size=shape), dtype, cuda)
    x.view(-1)[::7] = 0.0
    x.view(-1)[3::11] = -0.0
    before = launch_counts()["act_clip_count"]
    y, cnt = ops.act_clip(x, tau)
    torch.cuda.synchronize()
    assert launch_counts()["act_clip_count"] == before + 1
    y_ref, cnt_ref = ref.act_clip_count_ref(x, tau)
    bits = torch.int32 if dtype == "float32" else torch.int16
    assert torch.equal(y.view(bits), y_ref.view(bits))
    assert int(cnt) == int(cnt_ref)
    y_cpu, cnt_cpu = ops.act_clip(x.cpu(), tau)
    assert torch.equal(y.cpu().view(bits), y_cpu.view(bits))
    assert int(cnt) == int(cnt_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 384, 256),
                                   (100, 300, 200), (64, 512, 128),
                                   (1568, 2304, 256), (8, 512, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_block_sparse_matmul(cuda, M, K, N, dtype):
    x = _to_torch(RNG.normal(size=(M, K)), dtype, cuda)
    w = _tile_sparse_weight(K, N)
    if K > 512:
        # the search's own shapes: weights at their initialisation scale
        # (LeCun, 1/sqrt(fan_in)), so that outputs stay O(1) and the 1e-4
        # bound on float32 summation order means what it means at K <= 512
        w = w / np.sqrt(K)
    w = _to_torch(w, dtype, cuda)
    sw = ops.SparseWeight(w)
    before = launch_counts()["block_sparse_matmul"]
    out = sw.matmul(x)
    torch.cuda.synchronize()
    assert launch_counts()["block_sparse_matmul"] == before + 1
    oracle = ref.block_sparse_matmul_ref(x, w, sw.mask, 128, 128)
    tol = 1e-4 if dtype == "float32" else 2e-1
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)


# the 22 products of the execute step on ResNet-18 (224 x 224, 8 images, M
# capped at 25,088): (M, K, N)
MAIN_PRODUCTS = [(25088, 147, 64)] + [(25088, 576, 64)] * 4 + [
    (6272, 576, 128), (6272, 1152, 128), (6272, 64, 128), (6272, 1152, 128),
    (6272, 1152, 128), (1568, 1152, 256), (1568, 2304, 256), (1568, 128, 256),
    (1568, 2304, 256), (1568, 2304, 256), (392, 2304, 512), (392, 4608, 512),
    (392, 256, 512), (392, 4608, 512), (392, 4608, 512), (8, 512, 1000),
    (8, 512, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", sorted(set(MAIN_PRODUCTS)))
def test_cuda_block_sparse_matmul_main_path_products(cuda, M, K, N):
    """The execute step's shapes, unpadded x as SparseWeight.matmul takes
    it, weights at initialisation scale (outputs O(1), 1e-4 meaningful)."""
    x = _to_torch(RNG.normal(size=(M, K)), "float32", cuda)
    w = _to_torch(_tile_sparse_weight(K, N) / np.sqrt(K), "float32", cuda)
    sw = ops.SparseWeight(w)
    out = sw.matmul(x)
    oracle = ref.block_sparse_matmul_ref(x, w, sw.mask, 128, 128)
    torch.cuda.synchronize()
    assert out.shape == (M, N) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(_np(out), _np(oracle), atol=1e-4, rtol=1e-4)


def _execute_shapes(cfg, batch: int = 8, max_m: int = 25088):
    """(M, K, N) of each prunable layer's product in the execute step
    (``search_run.execute_winner``) on ``cfg`` at 224 x 224: the matmul view
    (k * k * cin, cout) of its weight over ``batch * out_hw ** 2`` rows,
    capped at ``max_m``, or ``batch`` rows for a linear layer."""
    from repro_torch.models import cnn
    return [(batch if s.kind == "linear" else min(batch * s.out_hw ** 2,
                                                  max_m),
             s.k * s.k * s.cin, s.cout)
            for s in cnn.build_specs(cfg) if s.prunable]


#: the products of the other four paper CNNs (ResNet-50, MobileNetV2,
#: MobileNetV3-S/L) that ResNet-18's execute step does not have
PAPER_PRODUCTS = sorted({p for cfg in PAPER_CNNS for p in _execute_shapes(cfg)}
                        - set(_execute_shapes(RESNET18)))
#: those that are one 128 x 128 weight tile
SINGLE_TILE = [p for p in PAPER_PRODUCTS if p[1] <= 128 and p[2] <= 128]


def test_resnet18_execute_shapes_are_the_main_path_products():
    assert _execute_shapes(RESNET18) == MAIN_PRODUCTS[:-1]
    assert len(PAPER_PRODUCTS) > 60 and (25088, 27, 16) in SINGLE_TILE


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", PAPER_PRODUCTS)
def test_cuda_block_sparse_matmul_paper_cnn_products(cuda, M, K, N):
    """The execute step's shapes on the MobileNets and ResNet-50 (K and N
    down to 16, one weight tile, the narrow cp.async path at K = 27), with
    weights at initialisation scale."""
    x = _to_torch(RNG.normal(size=(M, K)), "float32", cuda)
    w = _to_torch(_tile_sparse_weight(K, N) / np.sqrt(K), "float32", cuda)
    sw = ops.SparseWeight(w)
    before = launch_counts()["block_sparse_matmul"]
    out = sw.matmul(x)
    oracle = ref.block_sparse_matmul_ref(x, w, sw.mask, 128, 128)
    torch.cuda.synchronize()
    assert launch_counts()["block_sparse_matmul"] == before + 1
    assert out.shape == (M, N) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(_np(out), _np(oracle), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", SINGLE_TILE + [(25088, 64, 256)])
def test_cuda_block_sparse_matmul_all_empty_schedule_column(cuda, M, K, N):
    """A weight whose only tile is zero (and one whose second column of
    tiles is): the schedule has a column with no steps, which the work plan
    gives one empty item that writes the column's zeros."""
    x = _to_torch(RNG.normal(size=(M, K)), "float32", cuda)
    w = RNG.normal(size=(K, N)).astype(np.float32) / np.sqrt(K)
    if N <= 128:
        w[:] = 0.0
    else:
        w[:, 128:] = 0.0
    w = _to_torch(w, "float32", cuda)
    sw = ops.SparseWeight(w)
    assert int(sw.host_counts.min()) == 0
    out = sw.matmul(x)
    oracle = ref.block_sparse_matmul_ref(x, w, sw.mask, 128, 128)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float(out[:, 128:].abs().max() if N > 128 else out.abs().max()) \
        == 0.0
    np.testing.assert_allclose(_np(out), _np(oracle), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(100, 300, 200), (1, 5, 3), (130, 147, 64),
                                   (257, 129, 130), (8, 512, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_block_sparse_matmul_unpadded_ragged(cuda, M, K, N, dtype):
    """Ragged M, K (odd K too) and N: the kernel reads x in place, masks
    rows >= M and columns >= K on load and writes (M, N) directly; the same
    operands through the plan's plain executor agree."""
    x = _to_torch(RNG.normal(size=(M, K)), dtype, cuda)
    w = _to_torch(_tile_sparse_weight(K, N), dtype, cuda)
    sw = ops.SparseWeight(w)
    out = sw.matmul(x)
    oracle = ref.block_sparse_matmul_ref(x, w, sw.mask, 128, 128)
    dp = sw.plan(M).plan
    planned = ref.block_sparse_matmul_plan_ref(
        x.cpu(), sw.w_padded.cpu(), sw.indices.cpu(), dp.items, dp.splits,
        dp.tile, N, 128, 128)
    tol = 1e-4 if dtype == "float32" else 2e-1
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(planned), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", bsm.TILES)
def test_cuda_split_k_is_bit_equal_across_calls(cuda, tile):
    M, K, N = 392, 4608, 512
    x = _to_torch(RNG.normal(size=(M, K)), "float32", cuda)
    w = _to_torch(_tile_sparse_weight(K, N, p=0.2) / np.sqrt(K), "float32",
                  cuda)
    sw = ops.SparseWeight(w)
    counts = sw.counts.cpu().numpy()
    dp = bsm.DevicePlan(bsm.make_plan(counts, M, N, tile=tile, min_chunks=4, target=1000),
                        cuda)
    assert dp.plan.max_splits > 1
    a = bsm.run_plan(x, sw.w_padded, sw.indices, dp, N)
    b = bsm.run_plan(x, sw.w_padded, sw.indices, dp, N)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    oracle = ref.block_sparse_matmul_ref(x, w, sw.mask, 128, 128)
    np.testing.assert_allclose(_np(a), _np(oracle), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 9), (100, 333), (2, 56, 56, 64),
                                   (8, 56, 56, 64), (8, 224, 224, 3),
                                   (8, 7, 7, 512), (8, 512), (3, 1000003)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_act_clip_flat_total_and_tiles(cuda, shape, dtype):
    """The total equals the per-tile counts minus the padding the tiles
    would hold, and both equal the plain version; y is bit-equal."""
    x = _to_torch(RNG.normal(size=shape), dtype, cuda)
    x.view(-1)[::5] = 0.0
    x.view(-1)[2::13] = -0.0
    y, cnt, total = act_clip_count_flat(x, 0.3)
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == "float32" else torch.int16
    y_ref, cnt_ref, total_ref = act_clip_count_flat(x.cpu(), 0.3)
    assert torch.equal(y.cpu().view(bits), y_ref.view(bits))
    assert torch.equal(cnt.cpu(), cnt_ref)
    cols, bm, tiles = flat_tiles(x.numel())
    padding = tiles * bm * cols - x.numel()
    assert int(total) == int(total_ref) == int(cnt.sum()) - padding
    assert int(total) == int((ref.act_clip_ref(x, 0.3) == 0).sum())


@pytest.mark.cuda
def test_cuda_masked_tiles_never_read(cuda):
    x = torch.ones((128, 256), device=cuda)
    w = torch.ones((256, 128), device=cuda)
    counts, indices = bsm.build_tile_schedule(np.array([[True], [False]]))
    out = bsm.block_sparse_matmul(x, w, torch.from_numpy(counts).to(cuda),
                                  torch.from_numpy(indices).to(cuda))
    assert torch.equal(out, torch.full_like(out, 128.0))
    counts0 = torch.zeros((1,), dtype=torch.int32, device=cuda)
    out0 = bsm.block_sparse_matmul(x, w, counts0,
                                   torch.from_numpy(indices).to(cuda))
    assert float(out0.abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.zeros((128, 128), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        act_clip_count(x, 0.0, bm=128, bn=128)
    with pytest.raises(ValueError):
        act_clip_count(torch.zeros((256, 512), device=cuda)[:, ::2], 0.0)
    # a weight on the host beside x on the card: refused before any launch,
    # so the card stays usable
    sw = ops.SparseWeight(torch.ones((300, 200)))
    with pytest.raises(ValueError):
        sw.matmul(torch.ones((100, 300), device=cuda))
    out = ops.SparseWeight(torch.ones((300, 200), device=cuda)).matmul(
        torch.ones((100, 300), device=cuda))
    assert float(out.min()) == float(out.max()) == 300.0


@pytest.mark.cuda
def test_cuda_act_clip_calls_share_no_state(cuda):
    """Each call zeroes its own ticket word: calls queued on two streams at
    once, and calls replayed from a CUDA graph beside eager ones, each give
    their own input's count."""
    xs = [_to_torch(RNG.normal(size=(8, 56, 56, 64)), "float32", cuda)
          for _ in range(4)]
    want = [int((ref.act_clip_ref(x, 0.5) == 0).sum()) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for i, x in enumerate(xs):
        with torch.cuda.stream(streams[i % 2]):
            got.append(ops.act_clip(x, 0.5)[1])
    torch.cuda.synchronize()
    assert [int(t) for t in got] == want
    static = xs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.act_clip(static, 0.5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, total = ops.act_clip(static, 0.5)
    for i in (1, 2, 3):
        static.copy_(xs[i])
        graph.replay()
        eager = ops.act_clip(xs[(i + 1) % 4], 0.5)[1]
        torch.cuda.synchronize()
        assert int(total) == want[i] and int(eager) == want[(i + 1) % 4]


def _stacked(rows_shape, B, C, dtype, device):
    """B proposals' activations side by side in the last dim, zeros and
    negative zeros planted."""
    x = _to_torch(RNG.normal(size=rows_shape + (B * C,)), dtype, device)
    x.view(-1)[::7] = 0.0
    x.view(-1)[3::11] = -0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("rows_shape,B,C", [
    ((8, 224, 224), 8, 3),        # the stem's input: not vectorisable
    ((8, 56, 56), 8, 64), ((8, 7, 7), 8, 512), ((8,), 8, 512),
    ((8, 28, 28), 3, 128), ((1,), 1, 9), ((37,), 5, 6), ((3, 5), 2, 20),
    ((8, 14, 14), 300, 8)])       # more proposals than the last block's round
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_act_clip_batched_bit_equal(cuda, rows_shape, B, C, dtype):
    """The batched entry against its plain version: y bit for bit, each
    proposal's count exactly, at taus that include 0 (counts the zeros
    already there, -0.0 among them) and one that is not bf16-exact."""
    x = _stacked(rows_shape, B, C, dtype, cuda)
    taus = torch.from_numpy(np.resize(np.array([0.0, 0.2995, 0.5, 2.0],
                                               np.float32), B)).to(cuda)
    before = launch_counts()["act_clip_count_batched"]
    y, cnt = ops.act_clip_batched(x, taus)
    torch.cuda.synchronize()
    assert launch_counts()["act_clip_count_batched"] == before + 1
    y_ref, cnt_ref = ref.act_clip_count_batched_ref(x, taus)
    bits = torch.int32 if dtype == "float32" else torch.int16
    assert torch.equal(y.view(bits), y_ref.view(bits))
    assert torch.equal(cnt, cnt_ref)
    # each proposal's count is the single entry's count on its own columns
    xs = x.reshape(-1, B, C)
    for b in range(min(B, 4)):
        want = ref.act_clip_count_ref(xs[:, b].contiguous(),
                                      float(taus[b]))[1]
        assert int(cnt[b]) == int(want)


@pytest.mark.cuda
def test_cuda_act_clip_batched_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((4, 24), device=cuda)
    with pytest.raises(TypeError):                  # taus not float32
        ops.act_clip_batched(x, torch.zeros(3, device=cuda,
                                            dtype=torch.float64))
    with pytest.raises(ValueError):                 # taus on the host
        ops.act_clip_batched(x, torch.zeros(3))
    with pytest.raises(ValueError):                 # 24 is not 5 x C
        ops.act_clip_batched(x, torch.zeros(5, device=cuda))
    with pytest.raises(ValueError):                 # not contiguous
        ops.act_clip_batched(torch.zeros((4, 48), device=cuda)[:, ::2],
                             torch.zeros(3, device=cuda))


@pytest.fixture(scope="module")
def cuda_evaluator():
    """A reduced ResNet-18 evaluator on the card (32 x 32, 8 images)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.configs import reduce_config
    from repro_torch.core.hass import CNNEvaluator
    from repro_torch.core.perf_model import FPGAModel
    from repro_torch.models import cnn
    cfg = reduce_config(RESNET18)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = cnn.init_params(cfg, gen, device="cuda")
    images = torch.randn((8, cfg.img_res, cfg.img_res, 3),
                         generator=gen).to("cuda")
    return CNNEvaluator(cfg, params, images, FPGAModel(), budget=4096,
                        dse_iters=150)


def _rounds(L, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 0.9, (B, L)).astype(np.float32),
            rng.uniform(0, 0.9, (B, L)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
def test_cuda_captured_replay_equals_the_eager_pass(cuda_evaluator, B):
    """A shape's first pass runs eagerly and captures the graph; later
    passes replay it: bit-equal to the same batched program run eagerly,
    at each replay's own proposals."""
    ev = cuda_evaluator
    L = len(ev.names)
    ev._pass(*_rounds(L, B, 0), None, B)             # eager + capture
    assert (False, B) in ev._graphs
    for seed in (1, 2):
        s_w, s_a = _rounds(L, B, seed)
        replayed = ev._pass(s_w, s_a, None, B)
        with torch.no_grad():
            eager = ev._device_pass(torch.from_numpy(s_w).to(ev.device),
                                    torch.from_numpy(s_a).to(ev.device))
        eager = eager.cpu().numpy()
        got = np.concatenate([replayed[0][:, None], *replayed[1:]], 1)
        assert np.array_equal(got.view(np.int32), eager.view(np.int32))


@pytest.mark.cuda
def test_cuda_replays_count_their_launches(cuda_evaluator):
    """Batched-entry launches == prunable layers x passes over N replays:
    the launches a graph holds count at each replay, never at capture."""
    from repro_torch import kernels
    ev = cuda_evaluator
    L = len(ev.names)
    kernels.reset_launch_counts()
    passes = ev.stats_passes
    for seed in range(5):
        ev._pass(*_rounds(L, 3, seed), None, 3)
    torch.cuda.synchronize()
    assert ev.stats_passes == passes + 5
    assert kernels.launch_counts() == {"act_clip_count": 0,
                                       "act_clip_count_batched": 5 * L,
                                       "block_sparse_matmul": 0}
    graph = ev._graphs[(False, 3)][0]
    assert graph.held == {"act_clip_count": 0, "act_clip_count_batched": L,
                          "block_sparse_matmul": 0}
