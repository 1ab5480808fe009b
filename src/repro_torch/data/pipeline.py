"""Prefetching data pipeline over the synthetic generators.

``DataPipeline`` is an iterator of batches on ``device``:
  * deterministic in (seed, step) — resume = set the cursor (see synthetic.py)
  * background prefetch: a worker thread makes the next batches on the host
    (in pinned memory when the device is a card) while the device computes;
    ``__next__`` copies one to the device on the caller's current stream,
    without blocking the host.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional


from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.synthetic import batch_for
from repro_torch.device import resolve_device


class DataPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                 start_step: int = 0, device="cuda", prefetch: int = 2):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.step = start_step
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- simple synchronous API ------------------------------------- #
    def batch_at(self, step: int) -> Dict[str, Any]:
        return batch_for(self.cfg, self.shape, seed=self.seed, step=step,
                         device=self.device)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def __next__(self) -> Dict[str, Any]:
        if self._thread is None and self.prefetch > 0:
            self._start()
        if self._thread is None:
            b = self.batch_at(self.step)
            self.step += 1
            return b
        b = self._q.get()
        if isinstance(b, BaseException):         # the worker failed
            raise b
        self.step += 1
        return {k: v.to(self.device, non_blocking=True) for k, v in b.items()}

    # -- background prefetch ----------------------------------------- #
    def _host_batch(self, step: int) -> Dict[str, Any]:
        b = batch_for(self.cfg, self.shape, seed=self.seed, step=step,
                      device="cpu")
        if self.device.type == "cuda":
            b = {k: v.pin_memory() for k, v in b.items()}
        return b

    def _start(self):
        def put(item):
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def worker(step):
            try:
                while not self._stop.is_set():
                    put(self._host_batch(step))
                    step += 1
            except Exception as e:               # raised by __next__
                put(e)
        self._thread = threading.Thread(target=worker, args=(self.step,),
                                        daemon=True)
        self._thread.start()

    def close(self, timeout: float = 5.0):
        """Stop the prefetch thread and wait (up to ``timeout`` s) for it to
        end."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
