"""Multi-pod dry run: lay out every (arch x shape x mesh) cell on a mesh of 256
or 512 ranks, without hardware.

For each cell this shows:
  * the sharding rules are coherent: every leaf of the cell's state, batch
    and cache is placed as a ``DTensor`` by ``param_specs`` / ``batch_spec``
    / ``cache_spec`` through ``distribute_tensor`` on the production mesh,
  * the bytes per rank of each part (the local shards' sizes),
  * the roofline terms from the shapes (``analysis.roofline``).

Nothing is compiled and nothing is allocated: the state is on the ``meta``
device and the process group is ``fake`` (this process is rank 0 of 256 or
512 and every collective is a no-op), so run it in a process of its own.
Where the reference lowers and compiles the step, the port builds the step
(``make_train_step`` / prefill / decode with the cell's tuning) and places
its arguments; the bytes per rank are shape arithmetic, not a measurement.
``cache_scatter`` has no effect here: the port's decode cache is already
written in place by row.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod]
Results are merged into experiments/dryrun_torch.json (idempotent per key).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.analysis.roofline import analytic_traffic, build_report
from repro_torch.configs import (ASSIGNED, SHAPE_BY_NAME, SHAPES,
                                 cell_supported, get_config)
from repro_torch.core.perf_model import model_flops
from repro_torch.distributed import ctx as shard_ctx
from repro_torch.distributed.sharding import (batch_spec, cache_spec,
                                              distribute, mesh_axes,
                                              param_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, input_specs
from repro_torch.obs.log import get_logger
from repro_torch.train.optimizer import OptConfig, Packed8, tree_map
from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                          train_state_shape)

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch.json")

_log = get_logger("dryrun")


def _arrays(tree):
    """Every tensor of a tree (a ``Packed8`` gives its ``q`` and ``s``)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _arrays(v)
    elif isinstance(tree, Packed8):
        yield tree.q
        yield tree.s
    else:
        yield tree


def _tree_bytes(tree) -> int:
    """Global bytes of a tree of tensors."""
    return sum(a.numel() * a.element_size() for a in _arrays(tree))


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree of ``DTensor``s."""
    return sum(a.to_local().numel() * a.element_size() for a in _arrays(tree))


def _bf16_params(shape_tree):
    return tree_map(lambda s: s.to(torch.bfloat16) if s.is_floating_point()
                    else s, shape_tree)


def train_tcfg(arch: str) -> TrainConfig:
    # bf16 moments for the two largest configs (HBM fit — DESIGN.md §7)
    big = arch in ("deepseek-v3-671b", "deepseek-67b")
    return TrainConfig(
        opt=OptConfig(state_dtype="bfloat16" if big else "float32"),
        accum=8, remat="full", grad_dtype="bfloat16" if big else "float32")


# ------------------------------------------------------------------ #
# The reference's hill-climb tunings, applied with --tuned; baselines
# stay under their original keys.
# ------------------------------------------------------------------ #
class CellTuning:
    def __init__(self, accum=None, cast_bf16=False, no_fsdp=False,
                 embed_tp=False, opt_dtype=None, attn_impl=None,
                 cache_scatter=False, moe_shard_cap=False,
                 grad_dtype=None, dp_all=False, remat="keep",
                 moe_shardmap=False):
        self.accum, self.cast_bf16, self.no_fsdp = accum, cast_bf16, no_fsdp
        self.embed_tp, self.opt_dtype = embed_tp, opt_dtype
        self.attn_impl, self.cache_scatter = attn_impl, cache_scatter
        self.moe_shard_cap, self.grad_dtype = moe_shard_cap, grad_dtype
        self.remat = remat            # "keep" | None | "full" | "dots"
        self.moe_shardmap = moe_shardmap
        # dp_all: batch over EVERY mesh axis, replicated params, TP off —
        # the right layout for models far too small for 256-way TP
        self.dp_all = dp_all


TUNINGS = {
    # tiny model over-sharded -> pure DP over all ranks, one microbatch,
    # bf16 grads
    ("whisper-base", "train_4k"): CellTuning(
        accum=1, cast_bf16=True, no_fsdp=True, grad_dtype="bfloat16",
        dp_all=True, remat="dots"),
    # most collective-bound: bf16 gathers, fewer microbatches, the
    # expert-parallel dispatch
    ("deepseek-v3-671b", "train_4k"): CellTuning(
        accum=4, cast_bf16=True, moe_shardmap=True, grad_dtype="bfloat16"),
    # serving: TP-only weights (no per-token FSDP gather)
    ("deepseek-67b", "decode_32k"): CellTuning(
        no_fsdp=True, cache_scatter=True),
}


def lay_out_cell(arch: str, shape_name: str, multi_pod: bool,
                 tuning: Optional[CellTuning] = None):
    """The counterpart of the reference's ``lower_cell``: the cell's step
    function and its arguments placed on the production mesh. Returns
    (laid, note, traffic), or (None, why) for a cell that is not run.
    ``laid`` holds ``fn`` (the step, not run), ``loss_fn`` / ``prefill_fn``
    where the cell has one, ``tcfg`` for a train cell, ``rules``, ``mesh``
    and ``parts``: each argument as a tree of ``DTensor``s."""
    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return None, why
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    api = build_model(cfg)
    specs = input_specs(cfg, shape)
    t = tuning or CellTuning()
    os.environ["REPRO_CACHE_SCATTER"] = "1" if t.cache_scatter else "0"
    os.environ["REPRO_MOE_SHARD_CAP"] = "1" if t.moe_shard_cap else "0"
    os.environ["REPRO_MOE_SHARDMAP"] = "1" if t.moe_shardmap else "0"
    spec_kw = dict(no_fsdp=t.no_fsdp, embed_tp=t.embed_tp)

    loss_fn = api.loss
    prefill_fn_base = api.prefill
    if t.attn_impl and cfg.family not in ("ssm", "cnn") and cfg.rwkv is None:
        loss_fn = functools.partial(api.loss, attn_impl=t.attn_impl)
        prefill_fn_base = functools.partial(api.prefill, attn_impl=t.attn_impl)

    rules = None
    dp_axes = None
    if t.dp_all:
        sizes = mesh_axes(mesh)
        dp_axes = tuple(sizes)
        while dp_axes and shape.global_batch % \
                math.prod(sizes[a] for a in dp_axes):
            dp_axes = dp_axes[:-1]       # drop trailing axes until divisible
        rules = {"batch": dp_axes, "heads": None, "kv_heads": None,
                 "ff": None, "vocab": None, "experts": None}

    laid: Dict[str, Any] = {"mesh": mesh, "rules": rules}
    with shard_ctx.use_sharding(mesh, rules=rules):
        if shape.kind == "train":
            tcfg = train_tcfg(arch)
            if t.accum is not None:
                tcfg = dataclasses.replace(tcfg, accum=t.accum)
            if t.cast_bf16:
                tcfg = dataclasses.replace(tcfg, cast_params_bf16=True)
            if t.grad_dtype:
                tcfg = dataclasses.replace(tcfg, grad_dtype=t.grad_dtype)
            if t.opt_dtype:
                tcfg = dataclasses.replace(tcfg, opt=dataclasses.replace(
                    tcfg.opt, state_dtype=t.opt_dtype))
            if t.remat != "keep":
                tcfg = dataclasses.replace(tcfg, remat=t.remat)
            state_shape = train_state_shape(api.init, tcfg)
            state_specs = param_specs(mesh, state_shape, **spec_kw)
            if t.dp_all:
                state_specs = tree_map(lambda _: (), state_specs)
            b_specs = batch_spec(mesh, specs["batch"],
                                 dp_axes=dp_axes if t.dp_all else None)
            laid.update(fn=make_train_step(loss_fn, tcfg), loss_fn=loss_fn,
                        tcfg=tcfg, parts={
                            "params": distribute(state_shape["params"], mesh,
                                                 state_specs["params"]),
                            "opt": distribute(state_shape["opt"], mesh,
                                              state_specs["opt"]),
                            "batch": distribute(specs["batch"], mesh,
                                                b_specs)})
            traffic = analytic_traffic(
                cfg, shape,
                params_bytes=_tree_bytes(state_shape["params"]),
                opt_bytes=_tree_bytes(state_shape["opt"]["m"]) +
                _tree_bytes(state_shape["opt"]["v"]),
                accum=tcfg.accum, remat=tcfg.remat is not None)
        elif shape.kind == "prefill":
            params_shape = _bf16_params(api.init(torch.Generator(),
                                                 device="meta"))
            p_specs = param_specs(mesh, params_shape, **spec_kw)
            b_specs = batch_spec(mesh, specs["batch"])

            def prefill_fn(params, batch):
                kw = {}
                if "frames" in batch:
                    kw["frames"] = batch["frames"]
                return prefill_fn_base(params, batch["tokens"],
                                       shape.seq_len, **kw)

            laid.update(fn=prefill_fn, prefill_fn=prefill_fn_base, parts={
                "params": distribute(params_shape, mesh, p_specs),
                "batch": distribute(specs["batch"], mesh, b_specs)})
            cache_shape = api.init_cache(shape.global_batch, shape.seq_len,
                                         device="meta")
            traffic = analytic_traffic(
                cfg, shape, params_bytes=_tree_bytes(params_shape),
                cache_bytes=_tree_bytes(cache_shape))
        else:  # decode
            params_shape = _bf16_params(api.init(torch.Generator(),
                                                 device="meta"))
            p_specs = param_specs(mesh, params_shape, **spec_kw)
            c_specs = cache_spec(mesh, specs["cache"])
            t_spec = batch_spec(mesh, {"t": specs["token"]})["t"]

            def decode_fn(params, cache, token):
                return api.decode_step(params, cache, token)

            laid.update(fn=decode_fn, parts={
                "params": distribute(params_shape, mesh, p_specs),
                "cache": distribute(specs["cache"], mesh, c_specs),
                "token": distribute(specs["token"], mesh, t_spec)})
            cache_traffic_scale = 1.0 if t.cache_scatter else 2.0
            traffic = analytic_traffic(
                cfg, shape, params_bytes=_tree_bytes(params_shape),
                cache_bytes=_tree_bytes(specs["cache"]) *
                cache_traffic_scale / 2.0)
    return laid, "", traffic


def fake_world(n: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of ``n`` ranks
    (replacing one of another size). The backend lives in a private module
    of torch's tests, imported here only."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, tuned: bool = False) -> Dict[str, Any]:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = 512 if multi_pod else 256
    key = f"{arch}|{shape_name}|{mesh_name}" + ("|tuned" if tuned else "")
    tuning = TUNINGS.get((arch, shape_name)) if tuned else None
    if tuned and tuning is None:
        return {"key": key, "status": "skipped", "note": "no tuning defined"}
    t0 = time.time()
    try:
        fake_world(chips)
        out = lay_out_cell(arch, shape_name, multi_pod, tuning=tuning)
        if out[0] is None:
            rec = {"key": key, "status": "skipped", "note": out[1]}
            if verbose:
                _log.info(f"SKIP {key}: {out[1]}")
            return rec
        laid, note, traffic = out
        t_layout = time.time() - t0
        per_rank = {k: _local_bytes(v) for k, v in laid["parts"].items()}
        cfg = get_config(arch)
        shape = SHAPE_BY_NAME[shape_name]
        rep = build_report(arch=arch, shape=shape_name, mesh_name=mesh_name,
                           chips=chips, model_flops=model_flops(cfg, shape),
                           traffic=traffic, arg_bytes=sum(per_rank.values()),
                           note=note)
        rec = {"key": key, "status": "ok", "layout_s": round(t_layout, 1),
               "bytes_per_rank": per_rank, **rep.to_json()}
        if verbose:
            _log.info(f"OK {key} compute={rep.compute_s:.3e}s "
                      f"mem={rep.memory_s:.3e}s dominant={rep.dominant} "
                      f"state/rank={rep.hbm_total_gib:.2f}GiB "
                      f"(layout {t_layout:.1f}s)")
        return rec
    except Exception as e:                                     # noqa: BLE001
        traceback.print_exc()
        return {"key": key, "status": "error", "error": f"{type(e).__name__}: {e}"}


def load_results(path: str) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(path: str, res: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tuned", action="store_true",
                    help="apply the hill-climb tunings (separate keys)")
    ap.add_argument("--out", default=os.path.abspath(RESULTS))
    args = ap.parse_args()

    meshes = []
    if args.multi_pod or not args.single_pod:
        meshes.append(True)
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    meshes = sorted(set(meshes))        # False (single) first

    archs = [args.arch] if args.arch else sorted(ASSIGNED)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]

    res = load_results(args.out)
    # mesh-major, so that each fake world is brought up once
    for mp in meshes:
        for arch in archs:
            for shape_name in shapes:
                key = f"{arch}|{shape_name}|" + \
                    ("pod2x16x16" if mp else "pod16x16") + \
                    ("|tuned" if args.tuned else "")
                if args.tuned and (arch, shape_name) not in TUNINGS:
                    continue
                if not args.force and res.get(key, {}).get("status") == "ok":
                    _log.info(f"cached {key}")
                    continue
                rec = run_cell(arch, shape_name, mp, tuned=args.tuned)
                res[key] = rec
                save_results(args.out, res)
    n_ok = sum(1 for r in res.values() if r.get("status") == "ok")
    n_skip = sum(1 for r in res.values() if r.get("status") == "skipped")
    n_err = sum(1 for r in res.values() if r.get("status") == "error")
    _log.info(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
