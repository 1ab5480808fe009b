"""Batched serving: prefill + decode steps with KV-cache management.

``ServeSession`` drives batched requests end-to-end, on the card unless the
caller passes ``device="cpu"``, two ways:

  * **closed-loop** — ``generate``/``replay_trace``: requests served back
    to back through fixed-slot continuous batching (tiny vLLM-style front
    end). Ragged prompts pad to the chunk max and mask (the transformer
    prefill takes ``prompt_lens``; recurrent families, whose state has no
    pad mask, split into equal-length sub-batches).
  * **open-loop** — ``serve_open_loop`` (DESIGN.md §14): a request queue
    keyed by trace arrival timestamps, admission into the running decode
    batch at bucket boundaries (the evaluators' ``bucket_sizes`` pad-up
    rule), and a virtual clock charging ``prefill_cycles`` per admission
    prefill and ``step_cycles`` per decode step per live group. The
    returned ``ServeReport`` carries per-request queueing/latency arrays
    comparable to ``SimReport``'s.

Every decode step runs one program per cache shape, as the JAX package's
``jax.jit`` of the step compiles one per shape: a ``DecodeSet`` holds the
static buffers of a shape (the token, every cache leaf) and the step that
reads and writes them (``decode_into``). On the card the step is captured
once per buffer set into a CUDA graph and replayed per token; on the CPU
the same static-buffer step runs eagerly. Prefill stays eager, as the
reference's does.
"""
from __future__ import annotations

import inspect
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import ModelAPI, serving_params
from repro_torch.obs.trace import get_tracer
from repro_torch.sim.trace import bucket_sizes

# decode-length buckets every serving layer shares (each a multiple of the
# smallest — the admission quantum), mirroring the evaluators' compiled
# batch shapes
DEFAULT_BUCKETS = (8, 16, 32, 64)


def _norm_step_schedule(step_schedule):
    """Normalize degradation breakpoints to sorted parallel lists
    ``(times, scales)``; scale is the rung's relative decode-step cost
    (1.0 = the base operating point). Shared by ``serve_open_loop`` and
    its timing twin ``fleet.open_loop_schedule``."""
    if not step_schedule:
        return [], []
    rows = sorted((float(bt), float(bs)) for bt, bs in step_schedule)
    if any(bs <= 0 for _, bs in rows):
        raise ValueError("step_schedule scales must be positive")
    return [bt for bt, _ in rows], [bs for _, bs in rows]


@dataclass
class Request:
    """One serving request. ``arrival`` is the trace timestamp (cycles;
    0 for closed-loop use) and ``out`` collects the generated tokens —
    filled in place by ``generate``/``replay_trace``/``serve_open_loop``
    so callers get per-request outputs without positional bookkeeping.
    ``deadline`` is an absolute cycle timestamp: a request whose
    admission round opens after its deadline is *shed* (counted in
    ``ServeReport.shed``) instead of serving arbitrarily-late work."""
    prompt: np.ndarray
    max_new: int = 16
    arrival: float = 0.0
    deadline: float = float("inf")
    out: List[int] = field(default_factory=list)


def requests_from_trace(trace, *, vocab_size: int, prompt_len: int = 8,
                        seed: int = 0) -> List[Request]:
    """Materialize a simulator ``Trace`` (``repro_torch.sim.trace``) into
    ``ServeSession`` requests: one request per trace entry, decoding as
    many new tokens as the entry's sample count and carrying the entry's
    arrival timestamp — the same seeded traffic the deployment simulator
    scores analytically can drive the real serving loop (DESIGN.md §13)."""
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab_size, size=prompt_len),
                    max_new=int(sz), arrival=float(at))
            for at, sz in zip(trace.arrivals, trace.sizes)]


@dataclass
class ServeReport:
    """Per-request accounting of one open-loop serving run. All times are
    virtual-clock cycles, so the arrays line up with ``SimReport``'s:
    ``latency = completions - arrivals`` and ``queue_wait = admissions -
    arrivals`` (time spent waiting for a batch slot). Shed requests
    (deadline passed before their admission round) carry
    ``completions = inf`` and are excluded from the latency percentiles;
    ``admissions == completions + shed`` by construction."""
    arrivals: np.ndarray          # (N,)
    admissions: np.ndarray        # (N,) prefill joined the running batch
    completions: np.ndarray       # (N,) bucket boundary the request left at
    latency: np.ndarray           # (N,) completions - arrivals
    queue_wait: np.ndarray        # (N,) admissions - arrivals
    outputs: List[List[int]]
    decode_steps: int = 0         # model decode calls issued
    prefills: int = 0             # admission prefill calls issued
    shed_mask: np.ndarray = None  # (N,) True = dropped at its deadline
    switch_stalls: int = 0        # degradation rung switches charged

    def __post_init__(self):
        if self.shed_mask is None:
            self.shed_mask = np.zeros(len(self.arrivals), dtype=bool)

    @property
    def completed(self) -> int:
        return int((~self.shed_mask).sum())

    @property
    def shed(self) -> int:
        return int(self.shed_mask.sum())

    @property
    def horizon(self) -> float:
        served = self.completions[~self.shed_mask]
        return float(served.max()) if len(served) else 0.0

    def latency_percentile(self, quantile: float) -> float:
        lat = self.latency[~self.shed_mask]
        if len(lat) == 0:
            raise ValueError(
                "latency_percentile on a report with zero completions")
        return float(np.percentile(lat, quantile))

    @property
    def p50(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p95(self) -> float:
        return self.latency_percentile(95.0)

    @property
    def p99(self) -> float:
        return self.latency_percentile(99.0)


def decode_into(api: ModelAPI, params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor) -> torch.Tensor:
    """The static-buffer decode step: ``api.decode_step`` on ``cache`` and
    ``token``, each new cache leaf it returns copied back into ``cache``'s
    own tensor (the leaves a family writes in place are already there).
    Returns the logits (g, 1, V). It reads nothing on the host, so a CUDA
    graph captures it whole."""
    logits, new = api.decode_step(params, cache, token)
    for k, v in new.items():
        if v is not cache[k]:
            cache[k].copy_(v)
    return logits


def shape_key(cache: Dict[str, torch.Tensor]) -> Tuple:
    """A decode program's shape: the group size and every cache leaf's
    shape and dtype (what ``jax.jit`` recompiles the step for)."""
    return (int(cache["pos"].shape[0]),) + tuple(
        (k, tuple(v.shape), v.dtype) for k, v in sorted(cache.items()))


class DecodeSet:
    """One static buffer set of a cache shape: the token (g, 1), a copy of
    every cache leaf, and the decode program over them. On the card its
    first ``step`` runs eagerly on a side stream and captures the step into
    a CUDA graph (in the session's memory pool); every later step replays
    it. On the CPU every step runs ``decode_into`` eagerly."""

    def __init__(self, sess: "ServeSession", cache):
        self.sess = sess
        self.token = torch.zeros((cache["pos"].shape[0], 1),
                                 dtype=torch.int64, device=sess.device)
        self.cache = {k: v.clone() for k, v in cache.items()}
        self.graph = None
        self.logits = None               # the graph's static output

    def load(self, cache) -> None:
        """Copy a prefill's cache into this set, leaf by leaf."""
        for k, v in cache.items():
            self.cache[k].copy_(v)

    def _run(self) -> torch.Tensor:
        return decode_into(self.sess.api, self.sess.params, self.cache,
                           self.token)

    @torch.no_grad()
    def step(self, token: torch.Tensor) -> torch.Tensor:
        """Advance the set's cache by ``token`` (g, 1); returns the logits
        (g, 1, V), valid until the set's next step."""
        self.token.copy_(token)
        if self.graph is not None:
            self.graph.replay()
            return self.logits
        if self.sess.device.type != "cuda":
            return self._run()
        return self.sess._capture(self)


class ServeSession:
    """Fixed-slot continuous batching (tiny vLLM-style front end).

    The parameters are moved to ``device`` and the weights that prefill and
    decode read in the compute dtype are cast to it once, here
    (``models.serving_params``; bit-identical outputs). Sampling at
    ``temperature > 0`` draws from the session's own ``torch.Generator``
    seeded by ``seed``; greedy decoding (``temperature <= 0``) takes the
    first maximal logit.

    Decode steps run through ``DecodeSet``s, one per cache shape and group
    in flight, kept for the session's life and reused: a set is built only
    when every set of its shape is held by a live group. On the card
    ``graphs_captured``, ``capture_s`` and ``graph_pool_bytes`` say what
    the captures cost."""

    def __init__(self, api: ModelAPI, params, *, batch_slots: int,
                 S_max: int, temperature: float = 0.0, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.api = api
        self.params = serving_params(api, params, self.device)
        self.B, self.S_max = batch_slots, S_max
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        #: shape key -> every buffer set built for that shape
        self._sets: Dict[Tuple, List[DecodeSet]] = {}
        self._pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self.graphs_captured: int = 0
        self.capture_s: float = 0.0
        #: device memory the graphs' pool holds (``warm_and_capture``)
        self.graph_pool_bytes: int = 0
        try:
            sig = inspect.signature(api.prefill)
            self._ragged_ok = "prompt_lens" in sig.parameters
        except (TypeError, ValueError):          # builtins / C callables
            self._ragged_ok = False

    @property
    def buffer_sets(self) -> Dict[Tuple, int]:
        """Buffer sets built so far, per shape key."""
        return {k: len(v) for k, v in self._sets.items()}

    def decode_set(self, cache, held: Sequence[DecodeSet] = ()) -> DecodeSet:
        """A buffer set of ``cache``'s shape that is not in ``held`` (the
        sets of the groups still decoding), loaded with ``cache``; a new set
        only when every set of that shape is held."""
        sets = self._sets.setdefault(shape_key(cache), [])
        for ds in sets:
            if ds not in held:
                ds.load(cache)
                return ds
        ds = DecodeSet(self, cache)
        sets.append(ds)
        return ds

    def _capture(self, ds: DecodeSet) -> torch.Tensor:
        """A set's first step on the card: run eagerly on a side stream (its
        logits are this step's), then captured into the set's graph."""
        from repro_torch.kernels.graph import warm_and_capture
        t0 = time.perf_counter()
        ds.graph, logits, ds.logits, grew = warm_and_capture(
            ds._run, self._pool, self.device)
        self.graph_pool_bytes += grew
        self.graphs_captured += 1
        self.capture_s += time.perf_counter() - t0
        return logits

    def generate(self, prompts: Sequence, max_new: int = 16,
                 frames: Optional[np.ndarray] = None) -> List[List[int]]:
        """Greedy/temperature generation. Ragged prompts pad to the chunk
        max and mask (see class docstring); ``max_new=0`` emits nothing.
        Entries may be ``Request`` objects — their ``out`` is filled in
        place (``max_new`` still comes from the argument)."""
        reqs = [p if isinstance(p, Request) else None for p in prompts]
        arrs = [np.asarray(p.prompt if isinstance(p, Request) else p)
                for p in prompts]
        outs: List[List[int]] = []
        for i in range(0, len(arrs), self.B):
            kw: Dict[str, Any] = {}
            if frames is not None:
                kw["frames"] = frames[i:i + self.B]
            outs.extend(self._generate_chunk(arrs[i:i + self.B], max_new, kw))
        for r, o in zip(reqs, outs):
            if r is not None:
                r.out[:] = o
        return outs

    def _generate_chunk(self, chunk: List[np.ndarray], max_new: int,
                        kw: Dict[str, Any]) -> List[List[int]]:
        logits, cache, splits = self._prefill_groups(chunk, kw)
        if max_new <= 0:
            return [[] for _ in chunk]
        if splits is not None:               # recurrent ragged fallback
            outs: List[Optional[List[int]]] = [None] * len(chunk)
            for idx, (lg, ch) in splits:
                for j, o in zip(idx, self._decode_tokens(lg, ch, max_new)):
                    outs[j] = o
            return outs
        return self._decode_tokens(logits, cache, max_new)

    def _prefill_groups(self, chunk: List[np.ndarray], kw: Dict[str, Any]):
        """Prefill one batch chunk. Returns (logits, cache, None) for a
        single batched prefill, or (None, None, groups) when a ragged
        chunk on a recurrent family (no pad mask in the state) must run
        as equal-length sub-batches: groups = [(row_idx, (logits, cache))]."""
        lens = [len(p) for p in chunk]
        pad_to = max(lens)
        ragged = min(lens) != pad_to
        if ragged and not self._ragged_ok:
            by_len: Dict[int, List[int]] = {}
            for j, n in enumerate(lens):
                by_len.setdefault(n, []).append(j)
            groups = []
            for n, idx in sorted(by_len.items()):
                sub_kw = dict(kw)
                if "frames" in kw:
                    sub_kw["frames"] = np.asarray(kw["frames"])[idx]
                lg, ch, _ = self._prefill_groups([chunk[j] for j in idx],
                                                 sub_kw)
                groups.append((idx, (lg, ch)))
            return None, None, groups
        toks = np.zeros((len(chunk), pad_to), dtype=np.int32)
        for j, p in enumerate(chunk):
            toks[j, :len(p)] = p
        kw = dict(kw)
        if ragged:
            kw["prompt_lens"] = torch.as_tensor(lens, device=self.device)
        if "frames" in kw:
            kw["frames"] = torch.as_tensor(np.asarray(kw["frames"]),
                                           device=self.device)
        logits, cache = self.api.prefill(
            self.params, torch.as_tensor(toks, dtype=torch.int64,
                                         device=self.device),
            self.S_max, **kw)
        return logits, cache, None

    def _decode_tokens(self, logits, cache, max_new: int) -> List[List[int]]:
        cur = self._sample(logits)
        gen = [cur]
        if max_new > 1:
            ds = self.decode_set(cache)
            for _ in range(max_new - 1):
                cur = self._sample(ds.step(cur))
                gen.append(cur)
        seq = torch.cat(gen, dim=1).cpu().numpy()
        return [list(map(int, row)) for row in seq]

    def replay_trace(self, trace, *, vocab_size: int, prompt_len: int = 8,
                     seed: int = 0,
                     requests: Optional[List[Request]] = None
                     ) -> List[List[int]]:
        """Serve a simulator ``Trace``'s request *mix* closed-loop: the
        trace contributes the request count and per-request decode lengths
        (its size buckets), served back to back. Requests are grouped by
        decode length (``generate`` takes one decode length per call)
        and each group runs through the continuous-batching ``generate``
        loop; outputs return in trace order and land in each request's
        ``out``. Arrival times — burstiness — are NOT replayed: that is
        ``serve_open_loop``'s job; this method shares the workload
        definition so the two score the same requests. Pass ``requests``
        to serve pre-materialized ``Request`` objects instead."""
        reqs = requests if requests is not None else requests_from_trace(
            trace, vocab_size=vocab_size, prompt_len=prompt_len, seed=seed)
        by_len: Dict[int, List[int]] = {}
        for i, r in enumerate(reqs):
            by_len.setdefault(r.max_new, []).append(i)
        outs: List[Optional[List[int]]] = [None] * len(reqs)
        for max_new, idx in sorted(by_len.items()):
            got = self.generate([reqs[i] for i in idx], max_new=max_new)
            for i, o in zip(idx, got):
                outs[i] = o
        return outs

    def serve_open_loop(self, requests: Sequence[Request], *,
                        step_cycles: float, prefill_cycles: float = 0.0,
                        buckets: Sequence[int] = DEFAULT_BUCKETS,
                        step_schedule: Optional[Sequence] = None,
                        switch_cycles: float = 0.0) -> ServeReport:
        """Open-loop continuous batching driven by arrival timestamps.

        Waiting requests are admitted into free batch slots only at
        bucket boundaries: every admission round issues one real prefill
        per admission group, each live group decodes in quanta of the
        smallest bucket, and a row retires (freeing its slot at the
        boundary) once the group has sampled its bucketed decode length
        (``bucket_sizes`` pad-up rule applied to ``max_new``). The
        virtual clock serializes the groups on one executor:
        ``prefill_cycles`` per admission prefill, ``step_cycles`` per
        decode step per group. On a backlogged trace whose ``max_new``
        equals a bucket this issues exactly ``generate``'s model-call
        sequence, so greedy outputs match bit for bit (property-tested).
        ``fleet.open_loop_schedule`` is this method's pure-timing twin —
        keep the two in lockstep.

        A request whose ``deadline`` has passed when its admission round
        opens is *shed* (no prefill, no slot; ``shed_mask`` set,
        ``completions = inf``) — stale work is dropped, not served late.

        ``step_schedule`` is the graceful-degradation hook (DESIGN.md
        §17): sorted ``(t, scale)`` breakpoints after which a decode step
        costs ``scale * step_cycles`` (a sparsity-frontier rung's relative
        step time). Crossing a breakpoint while actively serving charges
        ``switch_cycles`` once — the temporal partition-switch stall; an
        idle executor re-points silently."""
        reqs = list(requests)
        n = len(reqs)
        b = np.sort(np.asarray(list(buckets), dtype=np.int64))
        if len(b) == 0 or b[0] < 1 or np.any(b % b[0] != 0):
            raise ValueError("buckets must be multiples of the smallest "
                             "(the admission quantum)")
        quantum = int(b[0])
        order = sorted(range(n), key=lambda i: reqs[i].arrival)
        quota = np.zeros(n, dtype=np.int64)
        alive = [i for i in range(n) if reqs[i].max_new > 0]
        if alive:
            quota[alive] = bucket_sizes([reqs[i].max_new for i in alive], b)
        arrivals = np.array([r.arrival for r in reqs], dtype=np.float64)
        dl = np.array([r.deadline for r in reqs], dtype=np.float64)
        admissions = np.zeros(n, dtype=np.float64)
        completions = np.zeros(n, dtype=np.float64)
        done = np.zeros(n, dtype=bool)
        shed_mask = np.zeros(n, dtype=bool)
        outputs: List[List[int]] = [[] for _ in range(n)]
        waiting = deque(order)
        groups: List[dict] = []
        free = self.B
        t = 0.0
        decode_steps = prefills = 0
        sc_t, sc_v = _norm_step_schedule(step_schedule)
        si = 0
        eff_step = step_cycles
        switches = 0
        captured = self.graphs_captured

        while waiting or groups:
            if not groups and waiting:
                t = max(t, reqs[waiting[0]].arrival)   # executor idles
                while si < len(sc_t) and sc_t[si] <= t:   # silent re-point
                    eff_step = step_cycles * sc_v[si]
                    si += 1
            # admission round: arrived requests into free slots; one real
            # prefill per admission group (ragged chunks may split).
            # Past-deadline requests shed here — before the prefill.
            admit: List[int] = []
            while waiting and free > 0 and reqs[waiting[0]].arrival <= t:
                i = waiting.popleft()
                if t > dl[i]:
                    admissions[i] = t
                    completions[i] = np.inf
                    done[i] = True
                    shed_mask[i] = True
                    continue
                admit.append(i)
                free -= 1
            if admit:
                chunk = [np.asarray(reqs[i].prompt) for i in admit]
                lg, ch, splits = self._prefill_groups(chunk, {})
                grouped = [(admit, (lg, ch))] if splits is None else \
                    [([admit[j] for j in idx], lc) for idx, lc in splits]
                for idx, (logits, cache) in grouped:
                    while si < len(sc_t) and sc_t[si] <= t:  # rung switch
                        eff_step = step_cycles * sc_v[si]
                        si += 1
                        t += switch_cycles
                        switches += 1
                    t += prefill_cycles
                    prefills += 1
                    cur = self._sample(logits)
                    toks = cur.cpu().numpy()               # (g, 1)
                    for row, i in enumerate(idx):
                        admissions[i] = t
                        if quota[i] > 0:
                            outputs[i] = [int(toks[row, 0])]
                        else:                  # max_new=0: done at admission
                            completions[i] = t
                            done[i] = True
                            free += 1
                    if any(quota[i] > 0 for i in idx):
                        # the group's own buffer set until it retires
                        ds = self.decode_set(cache,
                                             [g["set"] for g in groups])
                        groups.append({"set": ds, "cur": cur,
                                       "rows": list(idx), "taken": 1})
            # one decode round: each live group advances to its next bucket
            # boundary (quantum - 1 steps right after a prefill — the
            # prefill logits already produced the first sampled token)
            for g in groups:
                while si < len(sc_t) and sc_t[si] <= t:      # rung switch
                    eff_step = step_cycles * sc_v[si]
                    si += 1
                    t += switch_cycles
                    switches += 1
                cap = int(max(quota[i] for i in g["rows"])) - g["taken"]
                steps = quantum - (g["taken"] % quantum or quantum)
                steps = min(steps or quantum, cap)
                cur = g["cur"]
                for _ in range(steps):
                    cur = self._sample(g["set"].step(cur))
                    toks = cur.cpu().numpy()
                    for row, i in enumerate(g["rows"]):
                        if quota[i] > 0 and len(outputs[i]) < quota[i]:
                            outputs[i].append(int(toks[row, 0]))
                g["cur"] = cur
                g["taken"] += steps
                decode_steps += steps
                t += steps * eff_step
                for i in g["rows"]:
                    if not done[i] and 0 < quota[i] <= g["taken"]:
                        completions[i] = t     # leaves at this boundary
                        done[i] = True
                        free += 1
            groups = [g for g in groups
                      if g["taken"] < max(quota[i] for i in g["rows"])]

        for i, r in enumerate(reqs):
            outputs[i] = outputs[i][:r.max_new]
            r.out[:] = outputs[i]
        # every request is accounted exactly once: served (finite
        # completion) or shed (inf) — admissions == completions + shed
        assert done.all() \
            and np.isfinite(completions[~shed_mask]).all() \
            and np.isinf(completions[shed_mask]).all(), \
            "open-loop accounting broken: admissions != completions + shed"
        tr = get_tracer()
        if tr.enabled:
            # counters accumulated as plain loop locals, published once
            tr.count("serve.runs")
            tr.count("serve.requests", n)
            tr.count("serve.decode_steps", decode_steps)
            tr.count("serve.graphs", self.graphs_captured - captured)
            tr.count("serve.prefills", prefills)
            tr.count("serve.rung_switches", switches)
            tr.count("serve.shed", int(shed_mask.sum()))
        return ServeReport(arrivals=arrivals, admissions=admissions,
                           completions=completions,
                           latency=completions - arrivals,
                           queue_wait=admissions - arrivals,
                           outputs=outputs, decode_steps=decode_steps,
                           prefills=prefills, shed_mask=shed_mask,
                           switch_stalls=switches)

    def _sample(self, logits) -> torch.Tensor:
        """(B, 1) int64 next tokens from the last position's logits."""
        logits = logits[:, -1]
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits.to(torch.float32) / self.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)
