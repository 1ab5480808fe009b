"""The paper's main experiment on the PyTorch/CUDA port: hardware-aware
sparsity search on ResNet-18, hardware-aware vs software-metrics-only
(Fig. 5), then the winner executed through the block-sparse CUDA kernel.

    PYTHONPATH=src python examples/hass_search_torch.py --iters 24

Runs on the GPU; ``--device cpu`` runs on the host on purpose (the kernels'
plain versions then stand in, e.g. with ``--img-res 32 --iters 8``).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--img-res", type=int, default=224)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="TPE proposals per evaluation round "
                         "(0 = serial ask/tell loop)")
    ap.add_argument("--chips", type=int, default=1,
                    help="chips of the TPU hardware model for the "
                         "partitioned multi-chip DSE on the best proposal "
                         "(1 = skip)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args()

    from repro_torch.kernels import launch_counts
    from repro_torch.search_run import execute_winner, search_compare
    payload = search_compare(iters=args.iters, img_res=args.img_res,
                             batch_size=args.batch_size, device=args.device)
    hw, sw = payload["hw_best"], payload["sw_best"]
    print(f"\nsearch throughput: {payload['trials_per_s']:.2f} trials/s "
          f"(batch={args.batch_size}, device={payload['device']}, "
          f"DSE backend={payload['dse_backend']})")
    print(f"\nhardware-aware: eff={hw['eff']:.1f} acc={hw['acc']:.3f} "
          f"thr={hw['thr']:.0f} img/s dsp={hw['dsp']:.2f}")
    print(f"software-only : eff={sw['eff']:.1f} acc={sw['acc']:.3f} "
          f"thr={sw['thr']:.0f} img/s dsp={sw['dsp']:.2f}")
    print(f"efficiency gain from hardware awareness: "
          f"{hw['eff'] / max(sw['eff'], 1e-9):.2f}x  (paper Fig. 5: higher)")
    ev = payload["ev"]
    rows = execute_winner(ev, payload["hw_result"].best_x)
    steps = sum(r["schedule_steps"] for r in rows)
    dense = sum(r["dense_steps"] for r in rows)
    worst = max(r["max_abs_err"] for r in rows)
    print(f"\nwinner through block_sparse_matmul: {len(rows)} products, "
          f"{steps}/{dense} tile-steps scheduled, max |err| vs plain "
          f"{worst:.2e}, all ok={all(r['ok'] for r in rows)}")
    print(f"kernel launches: {launch_counts()}")
    if args.chips and args.chips > 1:
        from repro_torch.core.dse import partition_pipeline
        from repro_torch.core.perf_model import TPUModel
        tpu = TPUModel(chips=args.chips)
        layers = ev.sparse_layers(payload["hw_result"].best_x)
        part = partition_pipeline(layers, tpu, tpu.chip_budget,
                                  n_parts=args.chips, batch=256)
        print(f"\npartitioned multi-chip TPU-model DSE ({args.chips} chips): "
              f"{len(part.cuts) + 1} partitions, cuts={part.cuts}")
        print(f"  amortized {part.throughput * tpu.freq:.0f} img/s "
              f"(steady pipeline {part.steady_throughput * tpu.freq:.0f} "
              f"img/s, {part.dse_calls} segment DSEs)")
    if not all(r["ok"] for r in rows):
        raise SystemExit("a block-sparse product disagreed with its plain "
                         "version")


if __name__ == "__main__":
    main()
