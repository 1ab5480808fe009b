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
