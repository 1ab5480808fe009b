"""The captured train step and CNN warm-up against their eager runs, on the
card. Every test here is marked ``cuda`` and skips where there is no GPU (a
CUDA graph has no CPU mode). This file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest tests/test_torch_train_graph_cuda.py -m cuda -q

At ``reduce_config`` size, for every LM family: a ``TrainProgram``'s first
step runs eagerly and captures the graph, every later step replays it, and
8 steps equal 8 steps of the plain step from a copy of the same state, bit
for bit (every parameter, both moments, ``step``, every loss). The
embedding's and the loss's backward accumulate with atomics unless
deterministic algorithms are on, so these tests turn them on (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``). A step that cannot be captured
raises; nothing runs eagerly in its place.
"""
import dataclasses
import os

import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.data.synthetic import lm_batch
from repro_torch.models import build_model
from repro_torch.search_run import trained_cnn
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import run_resilient
from repro_torch.train.optimizer import OptConfig, Packed8
from repro_torch.train.train_loop import (TrainConfig, TrainProgram,
                                          flat_leaves, init_train_state,
                                          make_train_step)

STEPS = 8
FAMILIES = ["qwen3-0.6b", "mixtral-8x7b", "deepseek-v3-671b", "zamba2-1.2b",
            "rwkv6-1.6b", "whisper-base"]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(was)


def _bits(t):
    return t.contiguous().view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32,
         8: torch.int64}[t.element_size()])


def _assert_same(a, b):
    fa, fb = flat_leaves(a), flat_leaves(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert torch.equal(_bits(fa[k]), _bits(fb[k])), k


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, Packed8):
        return Packed8(tree.q.clone(), tree.s.clone(), tree.shape)
    return tree.clone()


def _setup(arch, dev, **okw):
    cfg = reduce_config(get_config(arch))
    api = build_model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=20, **okw),
                       accum=2, remat="full")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return cfg, api, tcfg, init_train_state(api.init, tcfg, gen, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_replay_equals_eager_bit_for_bit(cuda, arch):
    cfg, api, tcfg, state = _setup(arch, cuda)
    step = make_train_step(api.loss, tcfg)
    prog = TrainProgram(step, cuda)
    eager = _copy(state)
    for i in range(STEPS):
        b = lm_batch(cfg, 4, 16, seed=0, step=i, device=cuda)
        eager, want = step(eager, b)
        out, got = prog(state, b)
        assert out is state and prog.graphs_captured == 1
        assert torch.equal(_bits(got["loss"]), _bits(want["loss"])), i
    _assert_same(state, eager)
    assert int(state["opt"]["step"]) == STEPS
    assert prog.capture_s > 0 and prog.graph_pool_bytes >= 0


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    """A step that reads the host cannot be captured: the program raises
    instead of stepping eagerly."""
    cfg, api, tcfg, state = _setup("qwen3-0.6b", cuda)
    step = make_train_step(api.loss, tcfg)

    def reads_the_host(state, batch):
        new, m = step(state, batch)
        return new, dict(m, loss=m["loss"] * float(m["loss"] > 0))

    prog = TrainProgram(reads_the_host, cuda)
    with pytest.raises(RuntimeError):
        prog(state, lm_batch(cfg, 4, 16, device=cuda))
    assert prog.graphs_captured == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_a_restore_written_into_the_captured_state(cuda, tmp_path):
    """run_resilient through a program, int8 moments, a crash after step 5:
    the restore is copied into the captured state, and the losses and the
    final state equal a clean run's bit for bit."""
    runs = []
    for tag, fail_at in (("clean", None), ("crash", {5: RuntimeError("x")})):
        cfg, api, tcfg, state = _setup("qwen3-0.6b", cuda,
                                       state_dtype="int8")
        prog = TrainProgram(make_train_step(api.loss, tcfg), cuda)
        rep = run_resilient(prog, state,
                            lambda i: lm_batch(cfg, 4, 16, seed=3, step=i,
                                               device=cuda),
                            steps=8, ckpt=CheckpointManager(
                                str(tmp_path / tag), keep=3,
                                async_save=True),
                            ckpt_every=2, fail_at=fail_at)
        assert prog.graphs_captured == 1
        runs.append((rep, state))
    (r1, s1), (r2, s2) = runs
    assert r2.restarts == 1
    assert r2.history == r1.history[:5] + r1.history[4:]
    _assert_same(s1, s2)


@pytest.mark.cuda
def test_captured_warmup_equals_eager_warmup(cuda):
    cfg = dataclasses.replace(RESNET18, img_res=32)
    got = trained_cnn(cfg, steps=4, device=cuda)
    want = trained_cnn(cfg, steps=4, device=cuda, graph=False)
    _assert_same(got, want)
    assert not any(t.requires_grad for t in flat_leaves(got).values())


@pytest.mark.cuda
def test_a_dtensor_state_raises(cuda, tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed.sharding import distribute, param_specs
    cfg, api, tcfg, state = _setup("qwen3-0.6b", cuda)
    prog = TrainProgram(make_train_step(api.loss, tcfg), cuda)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(
                                os.path.join(tmp_path, "store"), 1))
    try:
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        with pytest.raises(ValueError, match="DTensor"):
            prog(distribute(state, mesh, param_specs(mesh, state)),
                 lm_batch(cfg, 4, 16, device=cuda))
    finally:
        dist.destroy_process_group()
    assert prog.graphs_captured == 0
