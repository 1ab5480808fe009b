"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where there is no GPU (a
CUDA kernel has no CPU mode). This file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch, nvcc and a card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels.act_clip import act_clip_count

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
    from repro_torch.kernels import act_clip as mod
    x = _to_torch(RNG.normal(size=shape), dtype, cuda)
    x.view(-1)[::7] = 0.0
    x.view(-1)[3::11] = -0.0
    before = mod.launches
    y, cnt = ops.act_clip(x, tau)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
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
    before = bsm.launches
    out = sw.matmul(x)
    torch.cuda.synchronize()
    assert bsm.launches == before + 1
    oracle = ref.block_sparse_matmul_ref(x, w, sw.mask, 128, 128)
    tol = 1e-4 if dtype == "float32" else 2e-1
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)


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
