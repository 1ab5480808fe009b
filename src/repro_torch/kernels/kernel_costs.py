"""Seeded per-pattern decode microbench over block-sparse matmul schedules.

Closes the measured loop of DESIGN.md §16: the DSE's analytic t(S̄) model
(Eq. 1) assumes every skipped element is free, but the four sparsity
patterns pay different *decode* costs on real hardware — tile schedules
skip whole tiles (free once a tile empties), N:M decode gathers the kept
reduction rows, hierarchical composes both, and activation sparsity leaves
weights dense. This module measures those costs per pattern on a seeded
synthetic workload and condenses them into

  * a cost table (per pattern x sparsity level), and
  * ``decode_factors`` — per-pattern c_p >= 1 multipliers applied to the
    Eq. 1 numerator via ``LayerVectors.t_scale`` and the optional Eq. 6
    ``Lambdas.meas`` term.

Two modes, chosen by ``device``:

  * ``"cpu"`` — every probe is its *modeled* estimate from the schedule
    counts (mode ``"modeled"``, cycles of one 128 x 128 MXU pass per
    cycle). Deterministic: two runs write byte-identical tables.
  * ``"cuda"`` — every probe is a device time on the card, in nanoseconds
    (mode ``"cuda"``; the table says ``"unit": "ns"`` and names the card
    under ``"device"``). The dense probe is one ``torch.matmul``; the tile
    probe is the ``block_sparse_matmul`` kernel under the seeded schedule,
    its work plan built once outside the timed region; the N:M probe is an
    ``index_select`` of the kept reduction rows and a ``torch.matmul``. Each
    probe's product is checked against its plain version before it is
    timed, and a failed build, launch or check raises: there is no modeled
    fallback on the card. Each measured record is normalised by the *same
    implementation* at zero sparsity (``dense_ref``): the tile kernel under
    the all-ones schedule for the tile leg, the gather-free product for the
    N:M leg, so that a factor counts decode overhead and not the gap
    between the hand-written kernel and the library product.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pruning import NM_M
from repro_torch.device import resolve_device

DEFAULT_PATH = os.path.join("experiments", "kernel_costs_h100.json")
SCHEMA_VERSION = 1
#: float32 tolerance of a measured probe's product against its plain version
PROBE_TOL = 1e-4


@dataclass(frozen=True)
class MicrobenchConfig:
    """One decode-cost probe workload; part of the cache key."""
    m: int = 256            # activations rows
    k: int = 1024           # reduction dim
    n: int = 512            # output dim
    bm: int = 128
    bk: int = 128
    bn: int = 128
    nm_m: int = NM_M
    sparsities: Tuple[float, ...] = (0.25, 0.5, 0.75)
    flops_per_cycle: float = 2.0 * 128 * 128   # one MXU pass per cycle
    bytes_per_cycle: float = 128.0
    seed: int = 0


#: the table the search uses on the card: the im2col product of a ResNet-18
#: layer-3 convolution (K = 3 * 3 * 256, N = 256) over 6,272 rows (32 images
#: at 14 x 14; every dimension a multiple of 128, as the probes need), where
#: a probe times the kernel and not its launch
MAIN_PATH_CONFIG = MicrobenchConfig(m=6272, k=2304, n=256)


def cache_key(cfg: MicrobenchConfig) -> str:
    d = asdict(cfg)
    d["sparsities"] = list(cfg.sparsities)
    d["schema"] = SCHEMA_VERSION
    return json.dumps(d, sort_keys=True)


def _tile_schedule(cfg: MicrobenchConfig, s_tile: float,
                   rng: np.random.Generator
                   ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Seeded (counts, indices) with exactly round(s_tile * Kt * Nt) zero
    tiles, plus the realized tile sparsity."""
    kt, nt = cfg.k // cfg.bk, cfg.n // cfg.bn
    n_zero = int(round(s_tile * kt * nt))
    flat = np.ones(kt * nt, dtype=bool)
    flat[rng.permutation(kt * nt)[:n_zero]] = False
    mask = flat.reshape(kt, nt)
    # never empty a whole column: the schedule pads to max_nnz >= 1 and an
    # all-zero column measures the write of a zeroed tile, not decode cost
    for j in range(nt):
        if not mask[:, j].any():
            mask[rng.integers(0, kt), j] = True
    from repro_torch.kernels.block_sparse_matmul import build_tile_schedule
    counts, indices = build_tile_schedule(mask)
    return counts, indices, 1.0 - mask.mean()


def _nm_kept(cfg: MicrobenchConfig, n_keep: int,
             rng: np.random.Generator) -> np.ndarray:
    """The sorted reduction rows an N:M probe keeps (whole ``bk`` blocks of
    ``k * n_keep / nm_m``, at least one)."""
    kc = max(cfg.bk, (cfg.k * n_keep // cfg.nm_m) // cfg.bk * cfg.bk)
    return np.sort(rng.permutation(cfg.k)[:kc]).astype(np.int32)


# ------------------------------------------------------------------ #
# probes — each returns (cycles, mode)

class _Modeled:
    """The schedule-derived estimates (the CPU's only mode)."""

    def __init__(self, cfg: MicrobenchConfig):
        self.cfg = cfg

    def dense(self) -> Tuple[float, str]:
        c = self.cfg
        return 2.0 * c.m * c.k * c.n / c.flops_per_cycle, "modeled"

    def tile(self, counts: np.ndarray, indices: np.ndarray
             ) -> Tuple[float, str]:
        c = self.cfg
        steps = float(np.sum(counts)) * (c.m // c.bm)
        return steps * (2.0 * c.bm * c.bk * c.bn) / c.flops_per_cycle, \
            "modeled"

    def nm(self, idx: np.ndarray) -> Tuple[float, str]:
        """N:M decode proxy: compressed (M, Kc) x (Kc, N) matmul fed by a
        row-gather of the activations — the gather is the decode cost a
        structured-sparse datapath pays per kept group."""
        c = self.cfg
        kc = len(idx)
        gather_bytes = 4.0 * c.m * kc + 4.0 * kc
        return (2.0 * c.m * kc * c.n / c.flops_per_cycle
                + gather_bytes / c.bytes_per_cycle), "modeled"


class _OnCard:
    """Device times on the card, in nanoseconds (mode ``"cuda"``). Seeded
    float32 operands: x unit normal, weights at 1/sqrt(fan-in) so that
    outputs stay O(1) and the 1e-4 check means what it says."""

    def __init__(self, cfg: MicrobenchConfig, dev: torch.device,
                 checks: Optional[List[dict]]):
        self.cfg, self.dev, self.checks = cfg, dev, checks
        gen = torch.Generator(device="cpu")
        gen.manual_seed(cfg.seed)
        self.x = torch.randn((cfg.m, cfg.k), generator=gen).to(dev)
        self.w = (torch.randn((cfg.k, cfg.n), generator=gen)
                  / np.sqrt(cfg.k)).to(dev)
        self._tile_ref = None

    def _time(self, fn) -> float:
        from repro_torch.kernels.bench_util import device_ms
        return device_ms(fn) * 1e6

    def _check(self, probe: str, got: torch.Tensor, want: torch.Tensor,
               **info) -> None:
        err = float((got.double() - want.double()).abs().max())
        if not (err <= PROBE_TOL and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"kernel_costs: the {probe} probe's product "
                               f"is {err:.3e} off its plain version "
                               f"(limit {PROBE_TOL}) at {info}")
        if self.checks is not None:
            self.checks.append({"probe": probe, "max_abs_err": err,
                                "tolerance": PROBE_TOL, **info})

    def dense(self) -> Tuple[float, str]:
        x, w = self.x, self.w
        return self._time(lambda: torch.matmul(x, w)), "cuda"

    def tile(self, counts: np.ndarray, indices: np.ndarray
             ) -> Tuple[float, str]:
        from repro_torch.kernels import block_sparse_matmul as bsm
        from repro_torch.kernels import ref
        c = self.cfg
        idx = torch.from_numpy(np.ascontiguousarray(indices)).to(self.dev)
        # the plan is built once, outside the timed region: the public
        # wrapper plans from the counts on the host at every call
        dplan = bsm.DevicePlan(bsm.make_plan(counts, c.m, c.n, bk=c.bk,
                                             bn=c.bn), self.dev)

        def run():
            return bsm.run_plan(self.x, self.w, idx, dplan, c.n, bk=c.bk,
                                bn=c.bn)

        mask = torch.from_numpy(bsm.schedule_mask(counts, indices,
                                                  c.k // c.bk))
        self._check("tile", run(), ref.block_sparse_matmul_ref(
            self.x, self.w, mask, c.bk, c.bn), steps=int(np.sum(counts)))
        return self._time(run), "cuda"

    def nm(self, idx: np.ndarray) -> Tuple[float, str]:
        kc = len(idx)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(self.cfg.seed + kc)
        w_c = (torch.randn((kc, self.cfg.n), generator=gen)
               / np.sqrt(kc)).to(self.dev)
        i = torch.from_numpy(idx.astype(np.int64)).to(self.dev)
        x = self.x

        def run():
            return torch.matmul(torch.index_select(x, 1, i), w_c)

        self._check("nm", run(), x.double()[:, i] @ w_c.double(), kc=kc)
        return self._time(run), "cuda"

    def tile_ref(self) -> float:
        """The tile kernel under the all-ones schedule."""
        if self._tile_ref is None:
            c = self.cfg
            kt, nt = c.k // c.bk, c.n // c.bn
            from repro_torch.kernels.block_sparse_matmul import \
                build_tile_schedule
            counts, indices = build_tile_schedule(np.ones((kt, nt), bool))
            self._tile_ref = self.tile(counts, indices)[0]
        return self._tile_ref


def card_record(dev: torch.device) -> Dict[str, str]:
    """The card a measured table was taken on: its name, and its power limit
    as ``nvidia-smi`` reports it ("not measured" where it reports none)."""
    import subprocess
    limit = "not measured"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(index)],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            limit = out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {"name": torch.cuda.get_device_name(dev), "power_limit": limit}


# ------------------------------------------------------------------ #

def measure(cfg: Optional[MicrobenchConfig] = None, device="cuda", *,
            checks: Optional[List[dict]] = None) -> Dict:
    """Run every probe; returns the full (JSON-serializable) cost table.
    ``device="cpu"`` is the modeled table; on the card every probe is timed
    (see the module docstring). ``checks``, where given, receives one record
    per measured probe's check against its plain version."""
    cfg = cfg or MicrobenchConfig()
    dev = resolve_device(device)
    probe = _OnCard(cfg, dev, checks) if dev.type == "cuda" \
        else _Modeled(cfg)
    m = cfg.nm_m
    dense, dense_mode = probe.dense()
    # a modeled probe counts only the compute leg, so it must be normalized
    # by the compute-leg dense — never by a memory-bound roofline dense —
    # or the ratio deflates below 1 and the decode overhead vanishes
    dense_modeled = 2.0 * cfg.m * cfg.k * cfg.n / cfg.flops_per_cycle

    def ref_for(leg: str, mode: str) -> float:
        if mode == "modeled":
            return dense_modeled
        # a measured leg against the same implementation at zero sparsity
        return probe.tile_ref() if leg == "tile" else dense

    table: Dict = {
        "schema": SCHEMA_VERSION,
        "config": json.loads(cache_key(cfg)),
        "dense": {"cycles": float(dense), "mode": dense_mode,
                  "modeled_cycles": float(dense_modeled)},
        "patterns": {},
    }
    if dev.type == "cuda":
        table["unit"] = "ns"
        table["device"] = card_record(dev)

    unstructured = {}
    for s in cfg.sparsities:
        rng = np.random.default_rng((cfg.seed, int(s * 1000), 1))
        counts, indices, s_real = _tile_schedule(cfg, s, rng)
        cyc, mode = probe.tile(counts, indices)
        unstructured[f"{s:.4f}"] = {
            "cycles": float(cyc), "mode": mode, "s_eff": float(s_real),
            "dense_ref": float(ref_for("tile", mode))}
    table["patterns"]["unstructured"] = unstructured

    nm = {}
    for s in cfg.sparsities:
        n_keep = int(np.clip(m - np.floor(s * m), 1, m))
        s_real = 1.0 - n_keep / m
        rng = np.random.default_rng((cfg.seed, n_keep, 2))
        cyc, mode = probe.nm(_nm_kept(cfg, n_keep, rng))
        nm[f"{s:.4f}"] = {"cycles": float(cyc), "mode": mode,
                          "s_eff": float(s_real), "n_keep": n_keep,
                          "dense_ref": float(ref_for("nm", mode))}
    table["patterns"]["nm"] = nm

    hier = {}
    for s in cfg.sparsities:
        # DESIGN.md §16 split: half the budget at tile level, residual N:M
        st = s / 2.0
        r = (s - st) / (1.0 - st)
        n_keep = int(np.clip(m - np.floor(r * m), 1, m))
        s_nm = 1.0 - n_keep / m
        rng = np.random.default_rng((cfg.seed, int(s * 1000), 3))
        counts, indices, st_real = _tile_schedule(cfg, st, rng)
        t_cyc, t_mode = probe.tile(counts, indices)
        n_cyc, n_mode = probe.nm(_nm_kept(cfg, n_keep, rng))
        # compose multiplicatively: per-leg overheads vs that leg's ideal
        # (1 - s_leg) * dense scaling, each against its same-mode dense
        g_tile = t_cyc / max(1e-9, (1.0 - st_real) * ref_for("tile", t_mode))
        g_nm = n_cyc / max(1e-9, (1.0 - s_nm) * ref_for("nm", n_mode))
        s_real = 1.0 - (1.0 - st_real) * (1.0 - s_nm)
        cyc = dense * (1.0 - s_real) * g_tile * g_nm
        hier[f"{s:.4f}"] = {
            "cycles": float(cyc), "mode": f"{t_mode}+{n_mode}",
            "s_eff": float(s_real), "dense_ref": float(dense)}
    table["patterns"]["hierarchical"] = hier

    # activation sparsity leaves weights dense: the weight-side schedule is
    # the dense one at every level (zeros are skipped per-operand at the
    # SPE, not in the tile schedule)
    table["patterns"]["activation"] = {
        f"{s:.4f}": {"cycles": float(dense), "mode": dense_mode,
                     "s_eff": 0.0, "dense_ref": float(dense)}
        for s in cfg.sparsities}

    table["decode_factors"] = decode_factors(table)
    return table


def decode_factors(table: Dict) -> Dict[str, float]:
    """Per-pattern c_p = mean over levels of cycles / ((1 - s_eff) * dense),
    floored at 1.0 — the ``LayerVectors.t_scale`` multiplier: how many Eq. 1
    cycles the pattern pays per unit of ideally-skippable work."""
    dense = float(table["dense"]["cycles"])
    out: Dict[str, float] = {}
    for pat, levels in table["patterns"].items():
        ratios = []
        for rec in levels.values():
            ref = float(rec.get("dense_ref", dense))
            ideal = (1.0 - float(rec["s_eff"])) * ref
            if ideal > 0.0:
                ratios.append(float(rec["cycles"]) / ideal)
        out[pat] = float(max(1.0, np.mean(ratios))) if ratios else 1.0
    return out


def load_or_measure(path: Optional[str] = DEFAULT_PATH,
                    cfg: Optional[MicrobenchConfig] = None,
                    refresh: bool = False, device="cuda") -> Dict:
    """Cached ``measure``: reuse ``path`` when its embedded config matches
    ``cfg`` and it was taken the way ``device`` asks — a modeled table for
    the CPU, a table measured on a card of the same name for the card —
    else measure and rewrite. ``path=None`` skips the disk cache entirely.
    Writes use sorted keys and no timestamps (a modeled table is
    byte-deterministic)."""
    cfg = cfg or MicrobenchConfig()
    dev = resolve_device(device)
    want = json.loads(cache_key(cfg))
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
    if path and not refresh and os.path.exists(path):
        try:
            with open(path) as f:
                table = json.load(f)
            taken_on = (table.get("device") or {}).get("name")
            if table.get("config") == want and \
                    table.get("schema") == SCHEMA_VERSION and \
                    taken_on == card:
                return table
        except (json.JSONDecodeError, OSError, AttributeError):
            pass
    table = measure(cfg, dev)
    if path:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
            f.write("\n")
    return table
