"""HASS performance model — Eq. 1–3 of the paper, plus the TPU mapping.

The paper models a layer-pipelined sparse dataflow accelerator:

    t(S̄)        = ceil((1 - S̄) * M / N)                     (Eq. 1)
    θ(l, d, S̄)  = (i*o) * M / (C_l * t(S̄))   [outputs/cycle] (Eq. 2)
    θ(network)  = min_l θ(l, d_l, S̄_l)                       (Eq. 3)

where M = weight/activation pairs per dot product, N = MACs per SPE,
i*o = parallel SPEs, C_l = dense MAC count of the layer, and S̄ = probability
that a (weight, activation) pair has at least one zero:
S̄ = 1 - (1 - S_w)(1 - S_a) under the paper's calibration-based estimate.

Two hardware backends implement the same interface:
  * ``FPGAModel``  — the paper's own units (DSPs, 250 MHz, images/s) used by
    the paper-faithful benchmarks (Table II, Fig. 4/5/6).
  * ``TPUModel``   — the TPU-v5e adaptation: SPEs -> MXU tile lanes, DSPs ->
    chip-MXU-seconds, with *tile-granular* compute skipping (a systolic array
    cannot skip single MACs; DESIGN.md §6). Used by the LM-side DSE and the
    §Roofline accounting.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig

# ---------------------------------------------------------------------- #
# TPU v5e hardware constants (per chip)
# ---------------------------------------------------------------------- #
PEAK_FLOPS = 197e12          # bf16 FLOP/s
HBM_BW = 819e9               # bytes/s
ICI_BW = 50e9                # bytes/s per link
ICI_LINKS = 4                # 2D torus
HBM_BYTES = 16 * 2 ** 30
MXU_TILE = 128               # systolic dim: tiles are 128-aligned
ACT_BYTES = 2                # bf16 activations (ICI boundary transfers)


@dataclass
class LayerCost:
    """One pipeline-stage workload (the paper's (l, C_l, M) triple + memory)."""
    name: str
    macs: int                     # dense MACs per sample (C_l)
    m_dot: int                    # M: pairs per dot product (fan-in)
    weight_count: int
    act_in: int                   # input activations per sample
    act_out: int
    kind: str = "linear"          # conv | linear | attn | other
    prunable: bool = True
    s_w: float = 0.0              # weight sparsity (compile-time)
    s_a: float = 0.0              # activation sparsity (calibrated)
    s_w_tile: float = 0.0         # fraction of all-zero weight tiles (TPU skip)
    pattern: str = "unstructured"  # sparsity pattern (pruning.PATTERNS §16)
    t_scale: float = 1.0          # per-pattern decode-cost multiplier on the
    #                               t_cycles numerator (1.0 = free skipping)

    @property
    def s_pair(self) -> float:
        """S̄: P(weight==0 or activation==0)."""
        return 1.0 - (1.0 - self.s_w) * (1.0 - self.s_a)

    @property
    def s_pair_tile(self) -> float:
        """Tile-granular S̄ for the MXU backend (weight tiles only are
        skippable at compile time; activation sparsity does not skip MXU
        compute — DESIGN.md §6)."""
        return self.s_w_tile


def pair_sparsity(s_w: float, s_a: float) -> float:
    return 1.0 - (1.0 - s_w) * (1.0 - s_a)


def t_cycles(s_bar: float, M: int, N: int, scale: float = 1.0) -> int:
    """Eq. 1: initiation interval of one SPE. ``scale`` is the per-pattern
    decode-cost multiplier on the non-zero work (DESIGN.md §16) — the
    default 1.0 takes the original expression path, so pre-pattern callers
    are bit-identical."""
    om = (1.0 - s_bar) * M
    if scale != 1.0:
        om = om * scale
    return max(1, math.ceil(om / max(N, 1)))


@dataclass
class DesignPoint:
    """d in the paper: per-layer hardware allocation."""
    spe: int = 1                  # i*o parallel engines (FPGA) / tile lanes (TPU)
    macs_per_spe: int = 1         # N


@dataclass
class LayerVectors:
    """Per-layer workload constants as flat arrays — the vectorized DSE's
    view of a pipeline. Design state lives outside this struct as two int
    arrays (spe, macs_per_spe); designs only ever double/halve, so the whole
    search state is those two small vectors (DESIGN.md §7).
    """
    macs: np.ndarray        # (L,) int64 — C_l
    m_dot: np.ndarray       # (L,) int64 — M
    s_eff: np.ndarray       # (L,) float64 — hardware-effective S̄
    max_n: np.ndarray       # (L,) int64
    max_spe: np.ndarray     # (L,) int64
    res_unit: np.ndarray    # (L,) float64 — resource per (spe * macs_per_spe)
    t_scale: "Optional[np.ndarray]" = None   # (L,) float64 per-pattern
    #   decode-cost multiplier on the t_cycles numerator, or None (== all
    #   ones, the pre-pattern path: every engine keeps the original float
    #   expressions bit-for-bit; DESIGN.md §16)

    def __len__(self) -> int:
        return len(self.macs)


@dataclass
class HardwareModel:
    freq: float = 250e6

    def layer_throughput(self, l: LayerCost, d: DesignPoint) -> float:
        """Eq. 2, in samples/cycle."""
        t = t_cycles(self.effective_sparsity(l), l.m_dot, d.macs_per_spe,
                     l.t_scale)
        return d.spe * l.m_dot / (l.macs * t) if l.macs else float("inf")

    def effective_sparsity(self, l: LayerCost) -> float:
        raise NotImplementedError

    def layer_resource(self, l: LayerCost, d: DesignPoint) -> float:
        raise NotImplementedError

    def max_n(self, l: LayerCost) -> int:
        return max(1, l.m_dot)

    def max_spe(self, l: LayerCost) -> int:
        return max(1, l.macs // max(l.m_dot, 1))

    # ------------------------------------------------------------------ #
    # Vectorized API (the DSE hot path operates on these; DESIGN.md §7)
    # ------------------------------------------------------------------ #
    def layer_vectors(self, layers: Sequence[LayerCost]) -> LayerVectors:
        """Freeze a pipeline's workload constants into arrays. ``res_unit``
        is derived from ``layer_resource`` at the unit design, so any model
        whose resource is proportional to spe*macs_per_spe (both backends
        here) stays consistent with the scalar API by construction."""
        unit = DesignPoint(1, 1)
        return LayerVectors(
            macs=np.array([l.macs for l in layers], dtype=np.int64),
            m_dot=np.array([l.m_dot for l in layers], dtype=np.int64),
            s_eff=np.array([self.effective_sparsity(l) for l in layers],
                           dtype=np.float64),
            max_n=np.array([self.max_n(l) for l in layers], dtype=np.int64),
            max_spe=np.array([self.max_spe(l) for l in layers],
                             dtype=np.int64),
            res_unit=np.array([self.layer_resource(l, unit) for l in layers],
                              dtype=np.float64),
            t_scale=self._t_scale_vec(layers))

    @staticmethod
    def _t_scale_vec(layers: Sequence[LayerCost]) -> Optional[np.ndarray]:
        """Per-layer decode-cost multipliers, or None when every layer is
        at the free-skipping default — the None sentinel keeps the engines,
        the cache fingerprint, and the compiled-C dispatch on their exact
        pre-pattern paths (DESIGN.md §16)."""
        ts = [l.t_scale for l in layers]
        if all(v == 1.0 for v in ts):
            return None
        return np.array(ts, dtype=np.float64)

    def throughput_vec(self, lv: LayerVectors, spe: np.ndarray,
                       n: np.ndarray) -> np.ndarray:
        """Eq. 1–2 over all layers at once; float-for-float identical to
        ``layer_throughput`` (same operation order, products < 2**53)."""
        om = (1.0 - lv.s_eff) * lv.m_dot
        if lv.t_scale is not None:
            om = om * lv.t_scale
        t = np.maximum(1.0, np.ceil(om / np.maximum(n, 1)))
        with np.errstate(divide="ignore"):
            thr = (spe * lv.m_dot) / (lv.macs * t)
        return np.where(lv.macs > 0, thr, np.inf)

    def resource_vec(self, lv: LayerVectors, spe: np.ndarray,
                     n: np.ndarray) -> np.ndarray:
        return spe * n * lv.res_unit


@dataclass
class FPGAModel(HardwareModel):
    """The paper's backend: resource = DSPs (1 DSP per MAC), 250 MHz."""
    dsp_budget: float = 12288     # Alveo U250

    def effective_sparsity(self, l: LayerCost) -> float:
        return l.s_pair if l.prunable else 0.0

    def layer_resource(self, l: LayerCost, d: DesignPoint) -> float:
        return d.spe * d.macs_per_spe


@dataclass
class TPUModel(HardwareModel):
    """TPU adaptation: an SPE lane is one 128x128 MXU tile-row pass; N maps to
    tiles processed per pass; resource = chip-MXU occupancy (in tile-lanes).
    Compute skipping is tile-granular (s_w_tile).

    ``chips > 1`` models a multi-chip slice: a pipeline partition is resident
    on one chip (a mesh program does not span chips), so per-partition DSE
    runs against ``chip_budget`` and the partition handoff is an ICI transfer
    of the boundary activations (``ici_transfer_cycles``) instead of an FPGA
    full reconfiguration — DESIGN.md §10.

    ``chip_lanes`` models a *heterogeneous* (mixed-generation) slice: per-chip
    tile-lane budgets, one entry per chip. ``chip_budgets`` expands either
    spelling to the per-chip tuple the max-min DP's budget lookup reads
    (``partition_pipeline(chip_budgets=...)`` — DESIGN.md §13)."""
    freq: float = 940e6           # v5e MXU clock
    chips: int = 1
    lanes_per_chip: int = 4 * 128  # 4 MXUs x 128 rows
    chip_lanes: Optional[Sequence[float]] = None   # per-chip lane budgets

    def effective_sparsity(self, l: LayerCost) -> float:
        """Per-pattern hardware-effective S̄ (DESIGN.md §16): the MXU skips
        whole all-zero tiles for unstructured pruning (``s_w_tile``), but a
        compile-time N:M / hierarchical structure is decodable at group
        granularity — the structured decode path (cf. 2:4 sparse cores)
        skips every structured zero, so those patterns spend the full
        element sparsity ``s_w`` (paying their decode cost through
        ``t_scale``). Activation sparsity never skips MXU compute."""
        if not l.prunable:
            return 0.0
        if l.pattern in ("nm", "hierarchical"):
            return l.s_w
        return l.s_pair_tile

    def layer_resource(self, l: LayerCost, d: DesignPoint) -> float:
        return d.spe * d.macs_per_spe / MXU_TILE   # tile-lane occupancy

    @property
    def budget(self) -> float:
        return float(sum(self.chip_budgets))

    @property
    def chip_budgets(self) -> Tuple[float, ...]:
        """Per-chip tile-lane budgets. Uniform ``lanes_per_chip`` unless the
        slice is heterogeneous (``chip_lanes``); pipeline stage ``p`` is
        resident on chip ``p``, so the DP prices segment DSEs against the
        stage's own chip."""
        if self.chip_lanes is not None:
            if len(self.chip_lanes) != self.chips:
                raise ValueError(
                    f"chip_lanes has {len(self.chip_lanes)} entries for "
                    f"{self.chips} chips")
            return tuple(float(b) for b in self.chip_lanes)
        return (float(self.lanes_per_chip),) * self.chips

    @property
    def chip_budget(self) -> float:
        """Tile-lane budget of a single chip (one resident partition). On a
        heterogeneous slice this is the largest chip — the one a single
        resident partition would land on; per-stage budgets go through
        ``chip_budgets``."""
        return max(self.chip_budgets)

    def ici_transfer_cycles(self, n_bytes: float) -> float:
        """MXU cycles to move ``n_bytes`` across one chip-to-chip hop, all
        torus links aggregated (the roofline collective constants)."""
        return n_bytes / (ICI_BW * ICI_LINKS) * self.freq


def pipeline_throughput(layers: Sequence[LayerCost],
                        designs: Sequence[DesignPoint],
                        hw: HardwareModel) -> float:
    """Eq. 3, samples/cycle."""
    return min(hw.layer_throughput(l, d) for l, d in zip(layers, designs))


# ---------------------------------------------------------------------- #
# Workload extraction: CNNs (paper models) and LMs (assigned archs)
# ---------------------------------------------------------------------- #
def cnn_layer_costs(cfg: ModelConfig) -> List[LayerCost]:
    from repro_torch.models.cnn import build_specs
    out: List[LayerCost] = []
    for s in build_specs(cfg):
        if s.kind == "conv":
            m = s.cin * s.k * s.k
        elif s.kind == "dwconv":
            m = s.k * s.k
        elif s.kind == "linear":
            m = s.cin
        elif s.kind == "se":
            m = s.cin
        else:
            continue
        out.append(LayerCost(
            name=s.name, macs=s.macs, m_dot=m, weight_count=s.weights,
            act_in=s.cin * s.in_hw ** 2 if s.in_hw else s.cin,
            act_out=s.cout * s.out_hw ** 2 if s.out_hw else s.cout,
            kind="conv" if s.kind in ("conv", "dwconv") else "linear",
            prunable=s.prunable))
    return out


def lm_layer_costs(cfg: ModelConfig, seq_len: int = 1,
                   per_layer: bool = True) -> List[LayerCost]:
    """Per-transformer-layer matmul workloads, per token (sample = token)."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out: List[LayerCost] = []

    def add(name, cin, cout, n_apply=1, kind="linear", prunable=True):
        out.append(LayerCost(name=name, macs=cin * cout * n_apply, m_dot=cin,
                             weight_count=cin * cout, act_in=cin * n_apply,
                             act_out=cout * n_apply, kind=kind,
                             prunable=prunable))

    L = cfg.num_layers
    for i in range(L if per_layer else 1):
        tag = f"l{i}"
        if cfg.mla is not None:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            add(f"{tag}.wq_a", d, m.q_lora_rank)
            add(f"{tag}.wq_b", m.q_lora_rank, H * qk)
            add(f"{tag}.wkv_a", d, m.kv_lora_rank + m.qk_rope_head_dim)
            add(f"{tag}.wkv_b", m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim))
            add(f"{tag}.wo", H * m.v_head_dim, d)
            attn_macs = H * (qk + m.v_head_dim) * seq_len
        elif cfg.rwkv is not None:
            for nm in ("wr", "wk", "wv", "wg", "wo"):
                add(f"{tag}.{nm}", d, d)
            add(f"{tag}.cm_wk", d, cfg.d_ff)
            add(f"{tag}.cm_wv", cfg.d_ff, d)
            add(f"{tag}.cm_wr", d, d)
            attn_macs = d * cfg.rwkv.head_dim      # state update per token
        elif cfg.ssm is not None:
            s = cfg.ssm
            d_in = s.expand * d
            add(f"{tag}.in_proj", d, 2 * d_in + 2 * s.state_dim + d_in // s.head_dim)
            add(f"{tag}.out_proj", d_in, d)
            attn_macs = d_in * s.state_dim * 2     # SSD state update per token
        else:
            add(f"{tag}.wq", d, H * hd)
            add(f"{tag}.wk", d, KV * hd)
            add(f"{tag}.wv", d, KV * hd)
            add(f"{tag}.wo", H * hd, d)
            win = cfg.attn_window or seq_len
            attn_macs = H * hd * min(seq_len, win)
        # attention score/value (not weight-prunable: data-data product)
        out.append(LayerCost(name=f"{tag}.attn", macs=2 * attn_macs,
                             m_dot=hd, weight_count=0, act_in=d, act_out=d,
                             kind="attn", prunable=False))
        if cfg.moe is not None:
            fe = cfg.moe.expert_d_ff or cfg.d_ff
            active = cfg.moe.top_k + cfg.moe.num_shared_experts
            add(f"{tag}.moe_gate", d, fe, n_apply=active)
            add(f"{tag}.moe_up", d, fe, n_apply=active)
            add(f"{tag}.moe_down", fe, d, n_apply=active)
        elif cfg.ssm is None and cfg.rwkv is None:
            add(f"{tag}.w_gate", d, cfg.d_ff)
            add(f"{tag}.w_up", d, cfg.d_ff)
            add(f"{tag}.w_down", cfg.d_ff, d)
        if cfg.hybrid_attn_every and i % cfg.hybrid_attn_every == 0:
            add(f"{tag}.shared_qkvo", 2 * d, 4 * d)   # concat-proj + attn blk
            add(f"{tag}.shared_ffn", d, 2 * cfg.d_ff)
    add("unembed", d, cfg.vocab_size)
    return out


def lm_block_bounds(layers: Sequence[LayerCost]) -> List[int]:
    """Block boundaries of an ``lm_layer_costs`` stack: the indices ``k``
    where ``layers[k]`` starts a new transformer block (the ``l{i}.`` name
    prefix changes; ``unembed`` is its own block). These are the natural cut
    positions for partitioning an LM pipeline across chips — a cut inside a
    block would split a residual stream mid-layer (DESIGN.md §11)."""
    bounds: List[int] = []
    prev = None
    for k, l in enumerate(layers):
        tag = l.name.split(".", 1)[0]
        if tag != prev:
            if k:
                bounds.append(k)
            prev = tag
    return bounds


def thin_cut_points(bounds: Sequence[int], max_cuts: int) -> List[int]:
    """Evenly subsample candidate cut positions down to ``max_cuts`` (keeps
    the DP's segment table at O(max_cuts^2) DSEs on deep LM stacks)."""
    bounds = list(bounds)
    if max_cuts <= 0 or len(bounds) <= max_cuts:
        return bounds
    idx = np.linspace(0, len(bounds) - 1, max_cuts).round().astype(int)
    return [bounds[i] for i in sorted(set(int(i) for i in idx))]


def tile_quantize_sparsity(s_w: float, m_dot: int, weight_count: int) -> float:
    """Largest achievable tile-granular sparsity <= ``s_w`` for a weight
    matrix of shape (m_dot, weight_count/m_dot) pruned in whole 128x128
    tiles. The MXU can only skip all-zero 128-aligned tiles (DESIGN.md §6),
    so a tile-structured pruner realizes sparsity in steps of 1/n_tiles."""
    if weight_count <= 0 or m_dot <= 0:
        return 0.0
    cout = max(1, weight_count // m_dot)
    n_tiles = math.ceil(m_dot / MXU_TILE) * math.ceil(cout / MXU_TILE)
    return math.floor(min(max(s_w, 0.0), 1.0) * n_tiles) / n_tiles


def param_count(cfg: ModelConfig) -> int:
    total = sum(l.weight_count for l in lm_layer_costs(cfg)) \
        if cfg.family != "cnn" else sum(l.weight_count for l in cnn_layer_costs(cfg))
    if cfg.family != "cnn":
        total += cfg.vocab_size * cfg.d_model        # embed
        if cfg.moe is not None:                      # all experts (not just active)
            fe = cfg.moe.expert_d_ff or cfg.d_ff
            inactive = cfg.moe.num_experts - cfg.moe.top_k
            total += cfg.num_layers * inactive * 3 * cfg.d_model * fe
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    active = sum(l.weight_count for l in lm_layer_costs(cfg)) \
        if cfg.family != "cnn" else sum(l.weight_count for l in cnn_layer_costs(cfg))
    if cfg.family != "cnn":
        active += cfg.vocab_size * cfg.d_model
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


# ---------------------------------------------------------------------- #
# Roofline terms (used by analysis/roofline.py on dry-run artifacts)
# ---------------------------------------------------------------------- #
@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
             chips: int) -> RooflineTerms:
    return RooflineTerms(
        compute_s=hlo_flops / (chips * PEAK_FLOPS),
        memory_s=hlo_bytes / (chips * HBM_BW),
        collective_s=collective_bytes / (chips * ICI_BW))
