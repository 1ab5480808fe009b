"""The serving session's captured decode step against the eager step, on the
card. Every test here is marked ``cuda`` and skips where there is no GPU (a
CUDA graph has no CPU mode). This file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest tests/test_torch_serve_graph_cuda.py -m cuda -q

At ``reduce_config`` size, for a dense, a MoE and a recurrent family: the
first step of a buffer set runs eagerly and captures the graph, every later
step replays it, and each step's logits and the cache after 8 steps equal
``api.decode_step`` run eagerly from the same prefill, bit for bit. A step
that cannot be captured raises; nothing runs eagerly in its place.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import build_model
from repro_torch.serve.serve_loop import ServeSession

STEPS = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32,
         8: torch.int64}[t.element_size()])


def _session(arch, dev, api=None):
    cfg = reduce_config(get_config(arch))
    api = api or build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return ServeSession(api, api.init(gen, device=dev), batch_slots=2,
                        S_max=32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "rwkv6-1.6b"])
def test_replay_equals_eager_bit_for_bit(cuda, arch):
    sess = _session(arch, cuda)
    api = sess.api
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, api.cfg.vocab_size, size=6) for _ in range(2)]
    logits, cache, _ = sess._prefill_groups(prompts, {})
    eager = {k: v.clone() for k, v in cache.items()}
    ds = sess.decode_set(cache)
    cur = torch.argmax(logits[:, -1], -1)[:, None]
    with torch.no_grad():
        for i in range(STEPS):
            want, eager = api.decode_step(sess.params, eager, cur)
            got = ds.step(cur)
            assert ds.graph is not None and sess.graphs_captured == 1
            assert torch.equal(_bits(got), _bits(want)), i
            cur = torch.argmax(want[:, -1], -1)[:, None]
    for k in eager:
        assert torch.equal(_bits(ds.cache[k]), _bits(eager[k])), k
    # the session's own loop runs the same graph
    assert len(sess.generate(prompts, max_new=4)[0]) == 4
    assert sess.graphs_captured == 1
    assert sess.graph_pool_bytes >= 0 and sess.capture_s > 0


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    """A decode step that reads the host cannot be captured: the session
    raises instead of decoding eagerly."""
    api = build_model(reduce_config(get_config("qwen3-0.6b")))

    def reads_the_host(params, cache, token):
        logits, new = api.decode_step(params, cache, token)
        return logits * float(logits.abs().max() > 0), new

    sess = _session("qwen3-0.6b", cuda,
                    dataclasses.replace(api, decode_step=reads_the_host))
    with pytest.raises(RuntimeError):
        sess.generate([np.arange(6), np.arange(6) + 1], max_new=4)
    assert sess.graphs_captured == 0
    torch.cuda.synchronize()
