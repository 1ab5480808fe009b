"""Search -> partition -> simulate -> SLO-aware pick (DESIGN.md §13), as one
runner shared by ``examples/deploy_sim_torch.py`` and ``chip_smoke.py``.

A short LM sparsity search on the analytic ``LMEvaluator``; the best stack
partitioned across ``chips`` chips of a ``TPUModel`` with the analytic max-min
DP; a bursty (MMPP) request trace offered at ``util`` of that pick's steady
rate; and ``partition_pipeline(objective="slo")`` re-picking the cuts against
a p99 target, every candidate simulated on the trace. All of it is numpy on
the host: no tensor reaches a device.
"""
from __future__ import annotations

import time

from repro_torch.configs import get_config
from repro_torch.core.dse import DSECache, partition_pipeline
from repro_torch.core.hass import LMEvaluator, hass_search
from repro_torch.core.perf_model import (TPUModel, lm_block_bounds,
                                         thin_cut_points)
from repro_torch.sim import (SLO, mmpp_trace, request_rate,
                             simulate_partition)


def deploy_compare(config: str = "qwen3_0_6b", chips: int = 4,
                   iters: int = 8, requests: int = 600, util: float = 0.45,
                   req_tokens: int = 32, slo_x: float = 3.0,
                   max_cuts: int = 10, dse_iters: int = 200,
                   seed: int = 0) -> dict:
    """The deployment flow of ``examples/deploy_sim.py`` (its flags are this
    function's arguments). Returns the config, the search result, the
    sparse stack and its candidate cuts, the hardware model, the shared
    ``DSECache``, the trace, the SLO, the max-min and SLO picks with their
    simulation reports, and the seconds of the SLO pick."""
    cfg = get_config(config)
    tpu = TPUModel(chips=max(chips, 2))
    ev = LMEvaluator(cfg, tpu, tpu.chip_budget, dse_iters=dse_iters)
    res = hass_search(ev, ev.n_search, iters=iters, seed=seed,
                      include_act=False, batch_size=4)
    layers = ev.sparse_layers(res.best_x)
    cut_points = thin_cut_points(lm_block_bounds(layers), max_cuts)

    cache = DSECache()
    kw = dict(n_parts=tpu.chips, batch=req_tokens, dse_iters=dse_iters,
              cut_points=cut_points, cache=cache)
    mm = partition_pipeline(layers, tpu, tpu.chip_budget,
                            objective="maxmin", **kw)

    # offered load: bursty MMPP at ``util`` of the max-min steady rate
    rate = request_rate(mm.steady_throughput, util, req_tokens)
    trace = mmpp_trace(requests, 0.6 * rate, 3.0 * rate,
                       dwell_base=4.0 / rate, dwell_burst=1.0 / rate,
                       sizes=req_tokens, seed=seed)

    one = partition_pipeline(layers, tpu, tpu.chip_budget, n_parts=1,
                             batch=req_tokens, dse_iters=dse_iters,
                             cut_points=cut_points, cache=cache,
                             objective="sum")
    slo = SLO(target=slo_x * req_tokens / one.part_throughput[0],
              quantile=99.0)

    t0 = time.perf_counter()
    sl = partition_pipeline(layers, tpu, tpu.chip_budget, objective="slo",
                            slo=slo, trace=trace, **kw)
    slo_s = time.perf_counter() - t0
    reports = {tag: (p.sim_report if p.sim_report is not None
                     else simulate_partition(layers, tpu, p, trace))
               for tag, p in (("maxmin", mm), ("slo", sl))}
    return {"cfg": cfg, "result": res, "layers": layers,
            "cut_points": cut_points, "tpu": tpu, "cache": cache,
            "trace": trace, "slo": slo, "maxmin": mm, "slo_pick": sl,
            "reports": reports, "slo_s": slo_s}
