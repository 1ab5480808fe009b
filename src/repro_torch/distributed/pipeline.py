"""Pipeline parallelism (GPipe-style) over ``torch.distributed`` point-to-point
operations.

The paper's architecture IS a layer pipeline (Fig. 3); on a mesh the
equivalent is stage parallelism: layers are partitioned into S stages mapped
to a 'stage' mesh dimension, microbatches flow stage to stage, and the bubble
fraction is (S-1)/(S-1+M) for M microbatches. The HASS DSE's rate balancing
(Eq. 4-5) chooses the layer -> stage assignment so per-stage
(sparsity-scaled) work is even — exported here as
``balanced_stage_assignment``.

Stages run the *same* block program with their own parameters — with
layer-stacked params a stage is just a contiguous slice of the stack, and
each rank holds only its own stage's slice.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


def balanced_stage_assignment(costs: Sequence[float], n_stages: int
                              ) -> List[int]:
    """Contiguous partition of layers into stages minimizing the max stage
    cost (the pipeline bottleneck, Eq. 3). DP over prefix sums; costs are the
    sparsity-scaled per-layer times from the HASS perf model."""
    L = len(costs)
    n_stages = min(n_stages, L)
    pre = np.concatenate([[0.0], np.cumsum(costs)])

    def seg(i, j):
        return pre[j] - pre[i]

    dp = np.full((n_stages + 1, L + 1), np.inf)
    cut = np.zeros((n_stages + 1, L + 1), dtype=int)
    dp[0, 0] = 0.0
    for s in range(1, n_stages + 1):
        for j in range(1, L + 1):
            for i in range(s - 1, j):
                v = max(dp[s - 1, i], seg(i, j))
                if v < dp[s, j]:
                    dp[s, j], cut[s, j] = v, i
    bounds = [L]
    for s in range(n_stages, 0, -1):
        bounds.append(int(cut[s, bounds[-1]]))
    bounds = bounds[::-1]
    assign = []
    for s in range(n_stages):
        assign += [s] * (bounds[s + 1] - bounds[s])
    return assign


def make_pipelined_fn(stage_fn: Callable, mesh, *, n_stages: int,
                      n_microbatches: int, stage_axis: str = "stage"):
    """Wrap ``stage_fn(stage_params, x) -> x`` into a GPipe loop.

    stage_params: this rank's stage's parameters (rank s of the
    ``stage_axis`` dimension of ``mesh`` holds stage s's).
    x: (n_microbatches, mb, ...), the same on every rank; ``stage_fn`` keeps
    a microbatch's shape and dtype.
    Schedule: T = n_microbatches + n_stages - 1 ticks; at tick t, stage s
    processes microbatch t - s (stages outside [0, M) idle: the bubble);
    activations hop s -> s+1 by ``batch_isend_irecv`` on the stage
    dimension's process group. The last stage's (M, mb, ...) outputs reach
    every rank of that group by one broadcast from the last stage, so every
    rank returns them.
    """
    import torch
    import torch.distributed as dist
    S, M = n_stages, n_microbatches

    def pipelined(stage_params, x):
        group = mesh.get_group(stage_axis)
        ranks = dist.get_process_group_ranks(group)
        assert len(ranks) == S, f"{stage_axis} has {len(ranks)} ranks, not {S}"
        sid = mesh.get_local_rank(stage_axis)
        outs = torch.zeros_like(x)
        state = None                                   # stage input buffer
        for t in range(S + M - 1):
            mb = t - sid
            y = None
            if 0 <= mb < M:
                y = stage_fn(stage_params, x[mb] if sid == 0 else state)
                if sid == S - 1:
                    outs[mb] = y
            ops = []
            if y is not None and sid < S - 1:
                ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                      ranks[sid + 1], group))
            if sid > 0 and 0 <= t - (sid - 1) < M:     # the predecessor's hop
                state = torch.empty_like(x[0])
                ops.append(dist.P2POp(dist.irecv, state, ranks[sid - 1],
                                      group))
            if ops:
                for w in dist.batch_isend_irecv(ops):
                    w.wait()
        dist.broadcast(outs, src=ranks[S - 1], group=group)
        return outs

    return pipelined


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages - 1 + n_microbatches)
