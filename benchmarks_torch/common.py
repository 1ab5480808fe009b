"""Shared benchmark utilities of the port's benchmarks.

Where results go: a run on the card writes ``experiments/<name>_h100.json``
(or into ``out_dir`` where the caller gives one), and each payload names the
card and its power limit under ``"card"``. A run on the CPU writes
``<out_dir>/<name>_cpu.json`` and refuses to run without an ``out_dir``, so
that no run of the port ever writes a file of the JAX package's benchmarks
(``experiments/<name>.json``).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import json
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.search_run import (calib_images,  # noqa: F401 (re-exported)
                                   trained_cnn)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "experiments")


def emit(name: str, us_per_call: float, derived: str) -> None:
    """CSV row: name,us_per_call,derived."""
    print(f"{name},{us_per_call:.1f},{derived}")


def sync() -> None:
    """Wait for the card, where this process has touched it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, repeat: int = 1):
    """``(fn(*args), microseconds per call)``: the device is synchronised
    before each reading of the clock, so a call that only enqueues work on
    the card is timed to its end."""
    sync()
    t0 = time.perf_counter()
    out = None
    for _ in range(repeat):
        out = fn(*args)
    sync()
    dt = (time.perf_counter() - t0) / repeat
    return out, dt * 1e6


def target(device="cuda", out_dir=None):
    """``(torch.device, directory the results go to)``. Raises for the CPU
    without an ``out_dir``, and for the card where there is none."""
    dev = resolve_device(device)
    if dev.type == "cpu" and not out_dir:
        raise ValueError("a CPU run writes only into an out_dir the caller "
                         "gives (--out-dir)")
    return dev, out_dir or RESULTS_DIR


def results_path(name: str, dev: torch.device, out_dir: str) -> str:
    """``<out_dir>/<name>_h100.json`` on the card, ``_cpu.json`` on the
    host: never a name of the JAX package's results."""
    tag = "h100" if dev.type == "cuda" else "cpu"
    return os.path.join(out_dir, f"{name}_{tag}.json")


def save_json(name: str, payload, dev: torch.device, out_dir: str) -> str:
    """Write ``payload`` as ``results_path(name, ...)``; on the card a dict
    payload gains ``"card"``: the card's name and power limit."""
    if dev.type == "cuda" and isinstance(payload, dict):
        from repro_torch.kernels.kernel_costs import card_record
        payload = dict(payload, card=card_record(dev))
    os.makedirs(out_dir, exist_ok=True)
    path = results_path(name, dev, out_dir)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    return path


def replay_model(arch: str, dev: torch.device):
    """``(cfg, api, params)`` of the model a serving replay runs: the
    architecture at its published width and depth in bf16 on the card (as
    ``chip_smoke.py``'s ``serve`` phase builds it), at ``reduce_config``
    size on the CPU (as the JAX package's scripts build theirs). Random
    weights from seed 0: the replays' gates read virtual clocks only."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    if dev.type != "cuda":
        cfg = reduce_config(cfg)
    api = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return cfg, api, api.init(gen, device=dev)


def serve_timed(sess, requests, timing=None, tag: str = "serve", **kw):
    """``sess.serve_open_loop(requests, **kw)``; where ``timing`` is a dict,
    adds under ``tag`` the call's wall seconds (the device synchronised at
    both ends), its decode steps and prefills, and wall milliseconds per
    decode step (prefills included)."""
    sync()
    t0 = time.perf_counter()
    rep = sess.serve_open_loop(requests, **kw)
    sync()
    dt = time.perf_counter() - t0
    if timing is not None:
        cfg = sess.api.cfg
        timing[tag] = {"model": cfg.name, "layers": cfg.num_layers,
                       "d_model": cfg.d_model, "dtype": cfg.dtype,
                       "device": str(sess.device), "batch_slots": sess.B,
                       "S_max": sess.S_max, "serve_s": dt,
                       "decode_steps": rep.decode_steps,
                       "prefills": rep.prefills,
                       "ms_per_decode_step": dt * 1e3
                       / max(1, rep.decode_steps)}
    return rep
