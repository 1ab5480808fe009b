"""Timing and bounds for the kernels on the card, shared by ``chip_smoke.py``
and ``tools/kernel_sweep_torch.py``.

Times are CUDA-event times; a bound is the least time the H100 could take for
the same work: the larger of the bytes the function must move over the memory
rate and its operations over the peak rate of their type (H100 SXM data
sheet).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12               # float32 outside the tensor cores
BF16_FLOPS = 989e12              # dense bf16 tensor-core rate


def time_ms(fn, *, warmup: int = 3, min_reps: int = 5, budget_ms: float = 60.0
            ) -> float:
    """Mean time of ``fn()`` on the card, by CUDA events around a run of
    launches (inputs stay where the previous launch left them: warm L2, as
    the caller that has just produced an activation finds it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    one = max(a.elapsed_time(b), 1e-3)
    reps = int(max(min_reps, min(200, budget_ms / one)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, *, budget_ms: float = 40.0) -> float:
    """Device time of one ``fn()``: a run of calls captured in one CUDA graph
    and replayed, CUDA events around the replays. ``fn`` must allocate
    nothing it keeps and must not synchronise (a kernel's wrapper; one
    ``torch.matmul``). Warm L2, as in ``time_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    one = max(a.elapsed_time(b), 1e-3)
    per_graph = int(max(4, min(50, budget_ms / 4 / one)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    replays = 4
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * per_graph)


def clip_bound_ms(x: torch.Tensor, n_tiles: int) -> Tuple[float, str]:
    """Read x once, write y once, one int32 per tile; one compare per
    element on the float32 pipes."""
    by = 2 * x.numel() * x.element_size() + 4 * n_tiles
    t_bytes = by / HBM_BYTES_PER_S * 1e3
    t_ops = x.numel() / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def matmul_bound_ms(sw, M: int, elem_size: int) -> Tuple[float, str]:
    """The least work of ``x (M, K) @ w (K, N)`` under ``sw``'s schedule (an
    ``ops.SparseWeight``), on the unpadded operands: 2 * M * rows * cols
    flops for every scheduled tile (its real rows and columns inside (K,
    N)), against x's columns that any scheduled tile names read once, the
    scheduled part of w once, the float32 output once, and the schedule's
    used entries."""
    counts = sw.counts.cpu().numpy()
    idx = sw.indices.cpu().numpy()
    K, N = sw.shape
    bk, bn = sw.bk, sw.bn
    w_elems, used_kt = 0, set()
    for j, c in enumerate(counts):
        cols = min(bn, N - j * bn)
        for kt in idx[j, :c].tolist():
            w_elems += min(bk, K - kt * bk) * cols
            used_kt.add(kt)
    x_cols = sum(min(bk, K - kt * bk) for kt in used_kt)
    steps = int(counts.sum())
    flops = 2.0 * M * w_elems
    by = (M * x_cols * elem_size + w_elems * elem_size + M * N * 4
          + 4 * len(counts) + 4 * steps)
    t_ops = flops / (FP32_FLOPS if elem_size == 4 else BF16_FLOPS) * 1e3
    t_bytes = by / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tile_sparse_weight(K: int, N: int, density: float, gen: torch.Generator,
                       lecun: bool = True) -> torch.Tensor:
    """A (K, N) weight with about ``density`` of its 128 x 128 tiles kept;
    ``lecun`` scales it 1/sqrt(K) as an initialised layer has it, so that
    outputs stay O(1) at the search's large K."""
    w = torch.randn((K, N), generator=gen)
    if lecun:
        w = w / np.sqrt(K)
    Kt, Nt = -(-K // 128), -(-N // 128)
    keep = torch.rand((Kt, Nt), generator=gen) < density
    if density >= 1.0:
        keep[:] = True
    m = keep.repeat_interleave(128, 0).repeat_interleave(128, 1)[:K, :N]
    return w * m


def main_path_clip_shapes(batch: int = 8) -> List[Tuple[str, tuple]]:
    """The inputs of ResNet-18's prunable layers for ``batch`` images at its
    published 224 x 224: what one stats forward hands to ``ops.act_clip``."""
    from repro_torch.configs.paper_cnns import RESNET18
    from repro_torch.models import cnn
    shapes = []
    for s in cnn.build_specs(RESNET18):
        if s.prunable:
            shapes.append((s.name, (batch, s.in_hw, s.in_hw, s.cin)
                           if s.kind == "conv" else (batch, s.cin)))
    return shapes


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    return tree.numel()


def lm_serve_bounds(cfg, params, *, batch: int, prompt_len: int,
                    kv_rows: float) -> dict:
    """The least time of the serving loop's two calls on a dense GQA
    transformer (``models.transformer``), from its shapes, in the config's
    compute dtype (its element size for the bytes, the tensor-core rate for
    a 2-byte dtype, the float32 rate otherwise):

    * a decode step of ``batch`` sequences, each attending to ``kv_rows``
      cached rows: every layer weight and the output head read once, the
      valid K/V rows read once; 2 flops per weight per sequence plus the
      attention's 4 * H * hd per cached row;
    * a prefill of ``batch`` x ``prompt_len`` tokens: 2 flops per layer
      weight per token, the causal attention (2 * 2 * H * hd per query-key
      pair, half the square), the last position's logits; every weight read
      once and the K/V cache written once.

    The embedding rows gathered for the new tokens are not counted (B rows).
    """
    from repro_torch.models.common import dtype_of
    elem_size = dtype_of(cfg.dtype).itemsize
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    layer_w = tree_numel(params["blocks"]) + d            # + final norm
    head_w = V * d
    kv_row_bytes = 2 * L * KV * hd * elem_size            # K and V, all layers
    dec_bytes = (layer_w + head_w) * elem_size + batch * kv_rows * kv_row_bytes
    dec_flops = 2 * batch * (layer_w + head_w) + 4 * L * batch * H * hd * kv_rows
    n = batch * prompt_len
    pre_flops = (2 * layer_w * n
                 + 2 * L * batch * H * hd * prompt_len * (prompt_len + 1)
                 + 2 * batch * head_w)
    pre_bytes = (layer_w + head_w) * elem_size + n * kv_row_bytes
    rate = BF16_FLOPS if elem_size == 2 else FP32_FLOPS

    def bound(flops, by):
        t_ops, t_bytes = flops / rate * 1e3, by / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    dec_ms, dec_by = bound(dec_flops, dec_bytes)
    pre_ms, pre_by = bound(pre_flops, pre_bytes)
    return {"decode_step_bound_ms": dec_ms, "decode_bound_by": dec_by,
            "decode_step_bytes": dec_bytes, "decode_step_flops": dec_flops,
            "prefill_bound_ms": pre_ms, "prefill_bound_by": pre_by,
            "prefill_flops": pre_flops, "prefill_bytes": pre_bytes,
            "layer_params": layer_w, "head_params": head_w}


def lm_train_bounds(cfg, params, *, batch: int, seq_len: int) -> dict:
    """The least time of one AdamW train step of a dense GQA transformer
    (``models.transformer``) over ``batch`` x ``seq_len`` tokens, from its
    shapes, counted as ``lm_serve_bounds`` counts a prefill:

    * the model's operations: 6 flops per parameter per token (2 forward, 4
      backward; a tied embedding counts once, as the output head's product)
      plus the causal attention, 3 x the forward's 2 * 2 * H * hd per
      query-key pair over half the square, at the tensor-core rate for a
      2-byte compute dtype (the float32 rate otherwise);
    * then the optimizer's bytes: a float32 AdamW step reads p, g, m and v
      and writes p, m and v, 28 bytes per parameter, at the memory rate.

    The bound is the sum of the two phases (``step_bound_ms``). The extra
    forward that ``remat="full"`` runs in the backward pass (the blocks
    again, not the output head) is ``recompute_ms``, not in the bound."""
    from repro_torch.models.common import dtype_of
    rate = BF16_FLOPS if dtype_of(cfg.dtype).itemsize == 2 else FP32_FLOPS
    L, S = cfg.num_layers, seq_len
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    n_params = tree_numel(params)
    layer_w = tree_numel(params["blocks"])
    tokens = batch * seq_len
    attn_fwd = 2 * L * batch * H * hd * S * (S + 1)
    model_flops = 6 * n_params * tokens + 3 * attn_fwd
    opt_bytes = 28 * n_params
    recompute_flops = 2 * layer_w * tokens + attn_fwd
    model_ms = model_flops / rate * 1e3
    opt_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    return {"step_bound_ms": model_ms + opt_ms,
            "model_ms": model_ms, "model_flops": model_flops,
            "optimizer_ms": opt_ms, "optimizer_bytes": opt_bytes,
            "recompute_ms": recompute_flops / rate * 1e3,
            "recompute_flops": recompute_flops,
            "params": n_params, "tokens": tokens}
