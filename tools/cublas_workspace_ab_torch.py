"""What ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (which ``chip_smoke.py`` sets
before torch first touches the card, for its deterministic restart gate)
does to the port's host-bound LM paths: the same measurements in fresh
processes with and without it, in turns (with, without, without, with), on
one card.

    python3 tools/cublas_workspace_ab_torch.py     # needs one CUDA device

Each process measures, on Qwen3-0.6B at full width (random weights, seed 0):
``mm_host_us`` (host time to enqueue one bf16 (2048, 1024) @ (1024, 3072)
product, over 2,000 back-to-back calls), ``mm_device_ms`` (its device time,
CUDA events), ``decode_ms`` (median of 16 eager bf16 decode steps of 8
sequences after a 128-token prefill, host clock with a synchronise) and
``train_step_ms`` (median of 4 AdamW steps of 8 x 256 tokens, bf16 compute,
float32 masters, accum 2, remat "full", after one warm-up step). Prints one
JSON line per process, then a summary line.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ENV = "CUBLAS_WORKSPACE_CONFIG"


def _sync_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def child() -> None:
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model, serving_params
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import (TrainConfig, init_train_state,
                                              make_train_step)
    dev = resolve_device("cuda")
    out = {"cublas_workspace_config": os.environ.get(ENV)}

    a = torch.randn((2048, 1024), device=dev, dtype=torch.bfloat16)
    b = torch.randn((1024, 3072), device=dev, dtype=torch.bfloat16)
    for _ in range(50):
        a @ b
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        a @ b
    out["mm_host_us"] = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(200):
        a @ b
    e1.record()
    torch.cuda.synchronize()
    out["mm_device_ms"] = e0.elapsed_time(e1) / 200

    cfg = get_config("qwen3-0.6b")
    api = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = api.init(gen, device=dev)
    sp = serving_params(api, params, dev)
    toks = torch.randint(0, cfg.vocab_size, (8, 128), device=dev,
                         generator=gen)
    with torch.no_grad():
        lg, cache = api.prefill(sp, toks, 256)
        cur = torch.argmax(lg[:, -1], -1)[:, None]
        times = []
        for _ in range(16):
            def step():
                nonlocal lg, cache
                lg, cache = api.decode_step(sp, cache, cur)
            times.append(_sync_ms(torch, step))
    out["decode_ms"] = statistics.median(times[2:])
    del sp, cache, lg, params

    tcfg = TrainConfig(opt=OptConfig(lr=6e-4, warmup_steps=2,
                                     total_steps=16), accum=2, remat="full")
    state = init_train_state(api.init, tcfg, gen, device=dev)
    step_fn = make_train_step(api.loss, tcfg)
    pipe = DataPipeline(cfg, ShapeConfig("train", 256, 8, "train"), seed=0,
                        device=dev, prefetch=2)
    times = []
    for _ in range(5):
        def step():
            nonlocal state
            state, _ = step_fn(state, next(pipe))
        times.append(_sync_ms(torch, step))
    pipe.close()
    out["train_step_ms"] = statistics.median(times[1:])
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


def main() -> None:
    rows = []
    for with_env in (True, False, False, True):
        env = dict(os.environ)
        env.pop(ENV, None)
        if with_env:
            env[ENV] = ":4096:8"
        r = subprocess.run([sys.executable, __file__, "--child"], env=env,
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            sys.exit(r.returncode)
        rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for key in ("mm_host_us", "mm_device_ms", "decode_ms", "train_step_ms"):
        summary[key] = {
            "with": [r[key] for r in rows if r["cublas_workspace_config"]],
            "without": [r[key] for r in rows
                        if not r["cublas_workspace_config"]]}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    if "--child" in sys.argv:
        child()
    else:
        main()
