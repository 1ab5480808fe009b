"""LM-workload hardware-aware sparsity search (DESIGN.md §11) on the PyTorch
port: the flow of ``examples/lm_search.py`` through ``repro_torch``.

The deep-stack HASS pipeline: TPE proposes per-matrix-kind sparsity targets
for a hundreds-of-matmul LM stack (``lm_layer_costs``, sample = token), the
analytic ``LMEvaluator`` scores Eq. 6 on the TPU backend, and the best
proposal's sparse stack is partitioned across chips with the segment-table
DP — max-min steady-rate objective vs the sum-form temporal objective.

All of it is host code (the evaluator is analytic, the DSE and the DP are
numpy): it touches no device. For the same arguments it prints the same
best metrics, targets, DSECache statistics and cuts as the JAX example.

    PYTHONPATH=src python examples/lm_search_torch.py --config deepseek_v3_671b --chips 4
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="deepseek_v3_671b",
                    help="arch id (underscore or hyphen spelling)")
    ap.add_argument("--chips", type=int, default=4,
                    help="TPU chips; >1 partitions the best stack")
    ap.add_argument("--iters", type=int, default=12,
                    help="TPE iterations")
    ap.add_argument("--batch-size", type=int, default=4,
                    help="TPE proposals per round (0 = serial)")
    ap.add_argument("--seq-len", type=int, default=2048,
                    help="context length for the attn-score workload")
    ap.add_argument("--max-cuts", type=int, default=12,
                    help="candidate cut positions for the partition DP "
                         "(block boundaries, evenly thinned)")
    ap.add_argument("--pipeline-batch", type=int, default=64,
                    help="tokens per pipelined batch (amortizes switches)")
    ap.add_argument("--dse-iters", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.dse import DSECache, partition_pipeline
    from repro_torch.core.hass import LMEvaluator, hass_search
    from repro_torch.core.perf_model import (TPUModel, lm_block_bounds,
                                             param_count, thin_cut_points)

    cfg = get_config(args.config)
    tpu = TPUModel(chips=max(args.chips, 1))
    ev = LMEvaluator(cfg, tpu, tpu.chip_budget, seq_len=args.seq_len,
                     dse_iters=args.dse_iters)
    print(f"{cfg.name}: {len(ev.layers)} matmul workloads "
          f"({sum(1 for l in ev.layers if l.prunable)} prunable), "
          f"{param_count(cfg) / 1e9:.1f}B params, "
          f"{ev.n_search} search vars ({', '.join(ev.group_names)})")

    t0 = time.perf_counter()
    res = hass_search(ev, ev.n_search, iters=args.iters, seed=args.seed,
                      include_act=False,     # s_a never skips MXU compute
                      batch_size=args.batch_size or None)
    dt = time.perf_counter() - t0
    m = res.best_metrics
    print(f"\nsearch: {args.iters} trials in {dt:.1f}s "
          f"({args.iters / dt:.1f} trials/s)")
    print(f"best: acc={m['acc']:.3f} spa={m['spa']:.3f} "
          f"thr={m['thr']:.1f} tok/s dsp={m['dsp']:.3f} "
          f"score={m['score']:.3f}")
    targets = ", ".join(f"{n}={s:.2f}" for n, s in
                        zip(ev.group_names, res.best_x[:ev.n_search]))
    print(f"tile-sparsity targets: {targets}")
    st = ev.dse_cache.stats()
    print(f"search DSECache: {st['cold_runs']} cold engine runs, "
          f"{st['hits']} exact hits, warm starts "
          f"L1={st['warm_l1']} (floor-stability) "
          f"L2={st['warm_l2']} (t-vector certificate)")

    if args.chips <= 1:
        return
    layers = ev.sparse_layers(res.best_x)
    cut_points = thin_cut_points(lm_block_bounds(layers), args.max_cuts)
    # ONE DSECache across both objectives (and any further what-ifs): the
    # second DP re-reads every segment frontier instead of re-searching it
    # (DESIGN.md §12)
    cache = DSECache()
    kw = dict(n_parts=args.chips, batch=args.pipeline_batch,
              dse_iters=args.dse_iters, cut_points=cut_points, cache=cache)
    print(f"\npartitioning across {args.chips} chips "
          f"({len(cut_points)} candidate cuts at block boundaries):")
    for objective in ("sum", "maxmin"):
        t0 = time.perf_counter()
        p = partition_pipeline(layers, tpu, tpu.chip_budget,
                               objective=objective, **kw)
        print(f"  {objective:6s}: cuts={p.cuts} "
              f"steady={p.steady_throughput * tpu.freq:8.1f} tok/s "
              f"amortized={p.throughput * tpu.freq:8.1f} tok/s "
              f"({p.dse_calls} segment DSEs, "
              f"{time.perf_counter() - t0:.1f}s)")
    st = cache.stats()
    print(f"  shared DSECache: {st['cold_runs']} cold segment DSEs, "
          f"{st['hits']} exact + {st['warm_l1']} warm-L1 + "
          f"{st['warm_l2']} warm-L2 reuses "
          f"(maxmin re-reads the sum DP's frontiers; never worse on the "
          f"steady rate — DESIGN.md §11/§12)")


if __name__ == "__main__":
    main()
