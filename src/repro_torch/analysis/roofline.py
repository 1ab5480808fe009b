"""Roofline terms of a dry-run cell, from its shapes.

Conventions (important — everything is PER RANK):
    compute_s    = (model flops / ranks) / BF16_FLOPS
    memory_s     = (modeled HBM traffic / ranks) / HBM_BYTES_PER_S
    collective_s = None

The reference reads its compute and collective terms from the compiled HLO
(``hlo_costs.analyze``, ``parse_collectives``); nothing on this side is
lowered to HLO, so the port's report takes the compute term from
``core.perf_model.model_flops``, the memory term from ``analytic_traffic``,
and leaves the collective term unknown (``None``, not 0). The peaks are the
H100 SXM data sheet's (dense bf16 989 TFLOP/s, 3.35 TB/s, 80 GB of HBM):
``core.perf_model``'s ``PEAK_FLOPS`` / ``HBM_BW`` / ``ICI_BW`` are TPU
constants of the hardware *model*, not this device's.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.kernels.bench_util import BF16_FLOPS, HBM_BYTES_PER_S

HBM_CAPACITY_BYTES = 80e9        # H100 SXM, NVIDIA data sheet


def analytic_traffic(cfg, shape, *, params_bytes: float, opt_bytes: float = 0,
                     cache_bytes: float = 0, accum: int = 1,
                     remat: bool = True) -> Dict[str, float]:
    """Modeled per-step global HBM traffic (bytes), by component.

    Assumptions: flash-style attention keeps per-block score temporaries on
    chip; weights are re-read from HBM per microbatch (fwd + remat-fwd +
    bwd); the baseline decode cache write is a full-cache read + write.
    """
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    t: Dict[str, float] = {}
    if shape.kind == "train":
        reads_per_ub = 2 + (1 if remat else 0)           # fwd + bwd (+remat)
        t["weights"] = reads_per_ub * accum * params_bytes
        t["optimizer"] = 2 * params_bytes + 2 * opt_bytes     # p r/w + m,v r/w
        t["grads"] = 2 * accum * params_bytes                 # accum buffer r/w
        t["stash"] = 4.0 * tokens * d * L * 2                 # h save w+r (bf16)
        t["logits"] = 4.0 * tokens * V * 2                    # write + read, bf16
        if cfg.moe is not None:
            cap = cfg.moe.capacity_factor * cfg.moe.top_k
            t["moe_dispatch"] = 8.0 * cap * tokens * d * L    # in/out buf w+r
    elif shape.kind == "prefill":
        t["weights"] = params_bytes                      # bf16 serving weights
        t["cache_write"] = cache_bytes
        t["activations"] = 4.0 * tokens * d * L * 2
        t["logits"] = 2.0 * shape.global_batch * V * 2
    else:                                                # decode
        t["weights"] = params_bytes
        t["cache"] = 2.0 * cache_bytes                   # full r+w (baseline)
        t["logits"] = 2.0 * shape.global_batch * V * 2
        t["activations"] = 8.0 * shape.global_batch * d * L * 2
    t["total"] = sum(t.values())
    return t


@dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: Optional[float]
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    dominant: str
    bound_s: float
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (flops_per_device * chips)
    arg_bytes: int = 0
    temp_bytes: int = 0
    out_bytes: int = 0
    hbm_total_gib: float = 0.0
    fits_hbm: bool = True
    coll_by_op: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    note: str = ""
    roofline_frac: float = 0.0   # model-flops time / bound
    traffic: Dict[str, float] = field(default_factory=dict)
    xla_bytes_accessed: Optional[float] = None

    def to_json(self) -> dict:
        return asdict(self)


def build_report(*, arch: str, shape: str, mesh_name: str, chips: int,
                 model_flops: float, traffic: Dict[str, float],
                 arg_bytes: int, note: str = "") -> CellReport:
    """A cell's roofline from its shapes (module docstring): ``arg_bytes``
    is the per-rank bytes of the sharded state the step takes (no
    temporaries are known without a compiler, so none are counted)."""
    flops = model_flops / chips
    mem_bytes_dev = traffic["total"] / chips
    compute_s = flops / BF16_FLOPS
    memory_s = mem_bytes_dev / HBM_BYTES_PER_S
    terms = {"compute": compute_s, "memory": memory_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    rep = CellReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=mem_bytes_dev,
        coll_bytes_per_device=None,
        compute_s=compute_s, memory_s=memory_s, collective_s=None,
        dominant=dominant, bound_s=bound, model_flops=model_flops,
        useful_ratio=model_flops / max(flops * chips, 1e-9),
        arg_bytes=int(arg_bytes), hbm_total_gib=arg_bytes / 2 ** 30,
        fits_hbm=arg_bytes <= HBM_CAPACITY_BYTES, note=note,
        roofline_frac=compute_s / max(bound, 1e-12),
        traffic={k: float(v) for k, v in traffic.items()})
    return rep
