"""End-to-end ``hass_search`` speed gate (DESIGN.md §12), on the port.

The search-loop acceleration subsystem (DSECache + class-grouped DSE engine
+ presorted tau tables + vectorized stack realization) must be FAST and
INVISIBLE: every section runs the same fixed-seed search twice — the
``baseline`` arm is the seed code path (``accel=False``, flat DSE engine,
no cache) and the ``accel`` arm is the subsystem — and asserts the two
produce bit-identical trial sequences before gating the wall-clock ratio.
The gates are the JAX package's, unchanged: they were set for JAX on a CPU,
and on the card a gate that does not hold fails the job with its numbers.

Sections, saved as ``search_bench_h100.json`` (``_cpu`` on the host):

  * ``cnn``   — ResNet-18 ``CNNEvaluator`` search (the paper's Fig. 5
    structure), its prune + stats forward on ``device``. The seed path
    re-sorts every weight tensor for each proposal; the accel arm gathers
    from presorted tables. Gate: >=5x, identical trials.
  * ``lm``    — ``LMEvaluator`` searches on LM stacks (host). Gate: >=5x,
    identical trials per model.
  * ``sweep`` — deployment sweep: partition the best sparse stacks across
    1/2/4(/3/6/8) chips (both DP objectives) with ONE shared DSECache vs a
    fresh segment table per call. Gate: >=SWEEP_GATEx fewer cold DSE runs,
    identical PartitionResults.
  * ``sensitivity`` — per-kind probes around the best proposal: the
    DSECache warm-start certificate must fire at least once.
  * ``liar``  — constant-liar vs independent-draw batch proposals at equal
    trial budget (report-only).
  * ``batch`` — proposal-batched DSE against per-proposal dispatch: both
    arms run the full subsystem and differ only in ``batch_dse``. Gate:
    bit-identical trial sequences always; >=BATCH_GATEx wall-clock when the
    compiled C backend is available.

    python -m benchmarks_torch.search_bench [--smoke] [--device cpu --out-dir DIR]
"""
import argparse
import dataclasses
import time

import numpy as np

from benchmarks_torch.common import (calib_images, emit, save_json, sync,
                                     target, trained_cnn)
from repro_torch.configs import get_config
from repro_torch.configs.paper_cnns import RESNET18
from repro_torch.core.dse import DSECache, partition_pipeline
from repro_torch.core.hass import CNNEvaluator, LMEvaluator, hass_search
from repro_torch.core.perf_model import (FPGAModel, TPUModel, lm_block_bounds,
                                         thin_cut_points)

SPEED_GATE = 5.0          # end-to-end accel-vs-seed search speedup
SWEEP_GATE_FULL = 10.0    # cold-DSE-run reduction in the deployment sweep
SWEEP_GATE_SMOKE = 4.0    # smoke runs fewer chip counts -> less reuse
BATCH_GATE_FULL = 3.0     # batched-wave vs per-proposal engine dispatch
BATCH_GATE_SMOKE = 2.0    # smoke runs fewer waves -> less amortization


def _assert_identical(a, b, tag):
    """Trial-for-trial bit-exactness between the two arms."""
    assert len(a.trials) == len(b.trials), tag
    for ta, tb in zip(a.trials, b.trials):
        assert np.array_equal(ta.x, tb.x), (tag, "proposal diverged")
        assert ta.score == tb.score, (tag, "score diverged")
        assert ta.metrics == tb.metrics, (tag, "metrics diverged")
    assert a.best_score == b.best_score, tag


def _timed_search(ev, n_search, **kw):
    sync()
    t0 = time.perf_counter()
    r = hass_search(ev, n_search, **kw)
    sync()
    return r, time.perf_counter() - t0


def _cache_str(stats) -> str:
    return (f"cache hits={stats['hits']} warm_l1={stats['warm_l1']} "
            f"warm_l2={stats['warm_l2']} cold={stats['cold_runs']}")


def bench_cnn(iters: int, gates: list, seed: int = 0, img_res: int = 32,
              device="cuda"):
    """``gates`` receives ``(holds, message)`` of the speed gate."""
    cfg = dataclasses.replace(RESNET18, img_res=img_res)
    params = trained_cnn(cfg, steps=10, device=device)
    images = calib_images(img_res, seed, device=device)

    def make(accel):
        return CNNEvaluator(cfg, params, images, FPGAModel(), budget=4096,
                            dse_iters=400, cost_cfg=RESNET18, accel=accel,
                            dse_engine="auto" if accel else "flat")

    ev_b, ev_a = make(False), make(True)
    kw = dict(iters=iters, seed=seed, s_max=0.9)
    r_b, t_b = _timed_search(ev_b, len(ev_b.prunable), **kw)
    r_a, t_a = _timed_search(ev_a, len(ev_a.prunable), **kw)
    _assert_identical(r_b, r_a, "cnn")
    speedup = t_b / t_a
    row = {"model": "resnet18", "iters": iters,
           "baseline_s": round(t_b, 2), "accel_s": round(t_a, 2),
           "speedup": round(speedup, 1),
           "best_score": r_a.best_score,
           "cache": ev_a.dse_cache.stats()}
    print(f"  cnn resnet18      {iters:3d} trials  "
          f"seed-path={t_b:7.1f}s  accel={t_a:6.1f}s  {speedup:6.1f}x  "
          f"(identical trials, {_cache_str(row['cache'])})")
    gates.append((speedup >= SPEED_GATE,
          f"CNN search speedup regressed: {speedup:.1f}x < {SPEED_GATE}x "
          f"(seed path {t_b:.3f} s, accel {t_a:.3f} s, {iters} trials)"))
    return row, ev_a, r_a


def bench_lm(models, iters: int, gates: list, seed: int = 0,
             dse_iters: int = 300):
    rows = []
    best = {}
    for name in models:
        cfg = get_config(name)
        tpu = TPUModel()

        def make(accel):
            return LMEvaluator(cfg, tpu, tpu.chip_budget, dse_iters=dse_iters,
                               accel=accel,
                               dse_engine="auto" if accel else "flat")

        # both arms run the batched frontier; liar=None keeps rounds
        # single-fit
        kw = dict(iters=iters, seed=seed, include_act=False,
                  batch_size=8, liar=None)
        # min of 3 fresh-evaluator repetitions per arm
        t_b = t_a = float("inf")
        for _ in range(3):
            ev_b, ev_a = make(False), make(True)
            r_b, dt = _timed_search(ev_b, ev_b.n_search, **kw)
            t_b = min(t_b, dt)
            r_a, dt = _timed_search(ev_a, ev_a.n_search, **kw)
            t_a = min(t_a, dt)
            _assert_identical(r_b, r_a, name)
        speedup = t_b / t_a
        rows.append({"model": name, "iters": iters,
                     "baseline_s": round(t_b, 2), "accel_s": round(t_a, 2),
                     "speedup": round(speedup, 1),
                     "trials_per_s": round(iters / t_a, 1),
                     "best_score": r_a.best_score,
                     "cache": ev_a.dse_cache.stats()})
        best[name] = (ev_a, r_a)
        print(f"  lm  {name:14s}{iters:3d} trials  "
              f"seed-path={t_b:7.1f}s  accel={t_a:6.1f}s  {speedup:6.1f}x  "
              f"(identical trials, {iters / t_a:.0f} trials/s, "
              f"{_cache_str(rows[-1]['cache'])})")
        gates.append((speedup >= SPEED_GATE,
                      f"{name} search speedup regressed: {speedup:.1f}x < "
                      f"{SPEED_GATE}x (seed path {t_b:.3f} s, accel "
                      f"{t_a:.3f} s)"))
    return rows, best


def bench_batch(iters: int, gate: float, gates: list, seed: int = 0,
                batch_size: int = 8, dse_iters: int = 300, reps: int = 5):
    """Proposal-batched DSE vs per-proposal dispatch, same fixed-seed
    search; the wall-clock gate applies only with the compiled backend."""
    from repro_torch.core import _dse_ckernel
    cfg = get_config("qwen3-0.6b")
    tpu = TPUModel()
    kw = dict(iters=iters, seed=seed, include_act=False,
              batch_size=batch_size, liar=None)

    def make(batch_dse):
        return LMEvaluator(cfg, tpu, tpu.chip_budget, dse_iters=dse_iters,
                           batch_dse=batch_dse)

    t_s = t_a = float("inf")
    for _ in range(reps):
        ev_s, ev_a = make(False), make(True)
        r_s, dt = _timed_search(ev_s, ev_s.n_search, **kw)
        t_s = min(t_s, dt)
        r_a, dt = _timed_search(ev_a, ev_a.n_search, **kw)
        t_a = min(t_a, dt)
        _assert_identical(r_s, r_a, "batch")
    compiled = _dse_ckernel.get_lib() is not None
    speedup = t_s / t_a
    row = {"model": "qwen3-0.6b", "iters": iters, "batch_size": batch_size,
           "engine": "compiled" if compiled else "lockstep",
           "serial_ms": round(t_s * 1e3, 1), "batched_ms": round(t_a * 1e3, 1),
           "speedup": round(speedup, 2), "gate": gate,
           "best_score": r_a.best_score,
           "cache": ev_a.dse_cache.stats()}
    print(f"  batch qwen3-0.6b  {iters:3d} trials/wave={batch_size}  "
          f"per-proposal={t_s * 1e3:6.1f}ms  batched={t_a * 1e3:6.1f}ms  "
          f"{speedup:5.2f}x  (identical trials, {row['engine']} engine, "
          f"{_cache_str(row['cache'])})")
    if compiled:
        gates.append((speedup >= gate,
                      f"batched-DSE speedup regressed: {speedup:.2f}x < "
                      f"{gate}x (per-proposal {t_s * 1e3:.1f} ms, batched "
                      f"{t_a * 1e3:.1f} ms)"))
    else:
        print("  batch: compiled backend unavailable -> lockstep fallback, "
              "speed gate skipped (identity still asserted)")
    return row


def bench_sweep(stacks, chips_list, batches, dse_iters: int):
    """Deployment sweep: partitions x both DP objectives x pipeline batch
    sizes of the same sparse stacks, one shared ``DSECache`` against a fresh
    segment table per ``partition_pipeline`` call."""
    rows = []
    for tag, layers, cut_points in stacks:
        plans = []
        for batch in batches:
            for chips in chips_list:
                for objective in (("sum",) if chips == 1
                                  else ("sum", "maxmin")):
                    plans.append((chips, objective, batch))

        def sweep(cache):
            out = []
            calls = 0
            for chips, objective, batch in plans:
                tpu = TPUModel(chips=chips)
                p = partition_pipeline(
                    layers, tpu, tpu.chip_budget, n_parts=chips, batch=batch,
                    dse_iters=dse_iters, cut_points=cut_points,
                    objective=objective, cache=cache)
                calls += p.dse_calls
                out.append(p)
            return out, calls

        t0 = time.perf_counter()
        base, base_calls = sweep(None)
        t_b = time.perf_counter() - t0
        cache = DSECache()
        t0 = time.perf_counter()
        acc, _ = sweep(cache)
        t_a = time.perf_counter() - t0
        for p, q in zip(base, acc):
            assert p.cuts == q.cuts and p.objective == q.objective, tag
            assert p.time_per_batch == q.time_per_batch, tag
            assert p.throughput == q.throughput, tag
            assert p.steady_throughput == q.steady_throughput, tag
        cold = cache.stats()["cold_runs"]
        reduction = base_calls / max(cold, 1)
        rows.append({"stack": tag, "plans": len(plans),
                     "segment_dses_uncached": base_calls,
                     "cold_runs_cached": cold,
                     "cold_reduction": round(reduction, 1),
                     "baseline_s": round(t_b, 2), "accel_s": round(t_a, 2),
                     "speedup": round(t_b / max(t_a, 1e-9), 1),
                     "cache": cache.stats()})
        print(f"  sweep {tag:16s}{len(plans):2d} partition calls: "
              f"{base_calls:4d} segment DSEs -> {cold:4d} cold "
              f"({reduction:.1f}x fewer), wall {t_b:.1f}s -> {t_a:.1f}s")
    return rows


def bench_sensitivity(ev, best_x, delta: float = 0.05):
    """Per-kind probes around the incumbent (warm-start certificate)."""
    cache = ev.dse_cache
    before = dict(cache.stats())
    ev(best_x)
    for k in range(ev.n_search):
        for d in (-delta, delta):
            x = np.array(best_x, dtype=float).copy()
            x[k] = float(np.clip(x[k] + d, 0.0, 0.95))
            ev(x)
    after = cache.stats()
    probes = 2 * ev.n_search
    row = {"probes": probes,
           "exact_hits": after["hits"] - before["hits"],
           "warm_hits": after["warm_hits"] - before["warm_hits"],
           "cold_runs": after["cold_runs"] - before["cold_runs"]}
    print(f"  sensitivity: {probes} probes -> {row['warm_hits']} warm + "
          f"{row['exact_hits']} exact hits, {row['cold_runs']} cold")
    return row


def bench_liar(models, iters: int, batch_size: int = 6, seed: int = 0,
               dse_iters: int = 300):
    """Constant-liar vs independent-draw batches at equal trial budget."""
    rows = []
    for name in models:
        cfg = get_config(name)
        tpu = TPUModel()
        scores = {}
        for liar in ("min", None):
            ev = LMEvaluator(cfg, tpu, tpu.chip_budget, dse_iters=dse_iters)
            r = hass_search(ev, ev.n_search, iters=iters, seed=seed,
                            include_act=False, batch_size=batch_size,
                            liar=liar)
            scores["liar" if liar else "independent"] = r.best_score
        rows.append({"model": name, "iters": iters,
                     "batch_size": batch_size, **scores})
        print(f"  liar {name:14s} best: constant-liar={scores['liar']:.4f} "
              f"independent={scores['independent']:.4f}")
    return rows


def run(smoke: bool = False, device="cuda", out_dir=None):
    dev, out_dir = target(device, out_dir)
    lm_models = ["qwen3-0.6b"] if smoke else ["qwen3-0.6b", "mixtral-8x7b"]
    cnn_iters = 8 if smoke else 16
    lm_iters = 24 if smoke else 48
    chips_list = (1, 2, 4) if smoke else (1, 2, 3, 4, 6, 8)
    dse_iters = 300
    sweep_gate = SWEEP_GATE_SMOKE if smoke else SWEEP_GATE_FULL

    print("hass_search end-to-end: seed path vs acceleration subsystem")
    # the speed gates are checked once every section has run and the
    # payload is written, so that a gate that fails leaves its numbers
    gates: list = []
    cnn_row, cnn_ev, cnn_res = bench_cnn(cnn_iters, gates, device=dev)
    lm_rows, lm_best = bench_lm(lm_models, lm_iters, gates,
                                dse_iters=dse_iters)
    batch_row = bench_batch(lm_iters,
                            BATCH_GATE_SMOKE if smoke else BATCH_GATE_FULL,
                            gates, dse_iters=dse_iters,
                            reps=3 if smoke else 5)

    stacks = [("resnet18", cnn_ev.sparse_layers(cnn_res.best_x), None)]
    for name, (ev, r) in lm_best.items():
        layers = ev.sparse_layers(r.best_x)
        cuts = thin_cut_points(lm_block_bounds(layers), 8 if smoke else 12)
        stacks.append((name, layers, cuts))
    batches = (32, 128) if smoke else (32, 128, 512)
    print(f"deployment sweep ({list(chips_list)} chips x objectives x "
          f"{list(batches)} batch, shared DSECache vs per-call tables)")
    sweep_rows = bench_sweep(stacks, chips_list, batches,
                             dse_iters=dse_iters)
    worst_red = min(r["cold_reduction"] for r in sweep_rows)

    name0 = lm_models[0]
    sens_row = bench_sensitivity(*[lm_best[name0][0], lm_best[name0][1].best_x])

    liar_rows = bench_liar(lm_models[:1], iters=24 if smoke else 48,
                           dse_iters=dse_iters)

    worst = min([cnn_row["speedup"]] + [r["speedup"] for r in lm_rows])
    payload = {"smoke": smoke, "speed_gate": SPEED_GATE,
               "sweep_gate": sweep_gate, "cnn": cnn_row, "lm": lm_rows,
               "batch": batch_row, "sweep": sweep_rows,
               "sensitivity": sens_row, "liar": liar_rows,
               "worst_search_speedup": worst,
               "worst_sweep_reduction": worst_red}
    save_json("search_bench", payload, dev, out_dir)
    emit("search_bench.hass_search",
         (cnn_row["accel_s"] + sum(r["accel_s"] for r in lm_rows)) * 1e6,
         f"worst_speedup={worst:.1f}x (gate {SPEED_GATE}x) "
         f"sweep_cold_reduction={worst_red:.1f}x (gate {sweep_gate}x) "
         f"batched_dse={batch_row['speedup']:.2f}x "
         f"(gate {batch_row['gate']}x), "
         f"iso-results asserted trial-for-trial")
    failed = [msg for holds, msg in gates if not holds]
    assert not failed, "; ".join(failed)
    assert worst_red >= sweep_gate, \
        f"sweep cold-DSE reduction regressed: {worst_red:.1f}x < {sweep_gate}x"
    assert sens_row["warm_hits"] + sens_row["exact_hits"] >= 1, \
        "warm-start certificate never fired on sensitivity probes"
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced set for CI (one LM model, 1/4-chip sweep)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    run(smoke=args.smoke, device=args.device, out_dir=args.out_dir)
