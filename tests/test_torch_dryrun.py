"""repro_torch's dry run (``launch/dryrun.py``) on the ``fake`` backend.

The port lays each cell out as ``DTensor``s on a 256- or 512-rank mesh in a
process of its own (this process keeps no process group) and runs its step.
Its bytes per rank of the train state must equal the arithmetic from the
reference's ``PartitionSpec``s on the same shapes (``jax.eval_shape``, no
devices), at full depth as laid out and at one layer (full width) as run;
the step must have run and counted its collectives, and each
``CellTuning`` flag must reach its knob.

Each site the executed step had to repair for DTensor is held by a reduced
config on a small ``fake`` mesh that reproduces its gap (8 KV heads over
16 model ranks at full size become 2 over 4 here).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.distributed import sharding as jsh
from repro.models import build_model as jbuild
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import Packed8 as JPacked8
from repro.train.train_loop import TrainConfig as JTrainConfig
from repro.train.train_loop import train_state_shape as jtrain_state_shape

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, m) for a in ("qwen3-0.6b", "deepseek-v3-671b")
         for m in sorted(MESHES)]

SCRIPT = textwrap.dedent("""
    import json, os, sys
    import torch
    from repro_torch.distributed.sharding import mesh_axes
    from repro_torch.launch import dryrun

    out = {"cells": {}, "full_bytes": {}}
    for arch in ("qwen3-0.6b", "deepseek-v3-671b"):
        for mp in (False, True):
            rec = dryrun.run_cell(arch, "train_4k", mp, verbose=False,
                                  layers=1)
            out["cells"][rec["key"]] = rec
            # the full-depth state, laid out and not run
            dryrun.fake_world(512 if mp else 256)
            laid, _, _ = dryrun.lay_out_cell(arch, "train_4k", mp)
            out["full_bytes"][rec["key"].rsplit("|", 1)[0]] = {
                k: dryrun._local_bytes(v) for k, v in laid["parts"].items()}

    def flags(arch, shape, tuning):
        dryrun.fake_world(256)
        laid, _, _ = dryrun.lay_out_cell(arch, shape, False, tuning)
        dims = {}
        for part, tree in laid["parts"].items():
            for a in dryrun._arrays(tree):
                for i, p in enumerate(a.placements):
                    if p.is_shard():
                        dims.setdefault(part, set()).add(
                            list(mesh_axes(laid["mesh"]))[i])
        return laid, {k: sorted(v) for k, v in dims.items()}

    t = dryrun.TUNINGS
    laid, dims = flags("whisper-base", "train_4k",
                       t[("whisper-base", "train_4k")])
    out["whisper"] = {"dims": dims, "rules": laid["rules"],
                      "accum": laid["tcfg"].accum,
                      "cast": laid["tcfg"].cast_params_bf16,
                      "grad_dtype": laid["tcfg"].grad_dtype,
                      "remat": laid["tcfg"].remat}
    laid, dims = flags("deepseek-v3-671b", "train_4k",
                       t[("deepseek-v3-671b", "train_4k")])
    out["deepseek_v3"] = {"shardmap": os.environ["REPRO_MOE_SHARDMAP"],
                          "accum": laid["tcfg"].accum}
    laid, dims = flags("deepseek-67b", "decode_32k",
                       t[("deepseek-67b", "decode_32k")])
    out["deepseek_67b"] = {"dims": dims}
    laid, dims = flags("deepseek-67b", "decode_32k", None)
    out["deepseek_67b_base"] = {"dims": dims}
    laid, _ = flags("qwen3-0.6b", "train_4k",
                    dryrun.CellTuning(attn_impl="banded"))
    out["attn_impl"] = laid["loss_fn"].keywords
    laid, _ = flags("qwen3-0.6b", "prefill_32k",
                    dryrun.CellTuning(attn_impl="banded"))
    out["attn_impl_prefill"] = laid["prefill_fn"].keywords
    laid, _ = flags("qwen3-0.6b", "train_4k", None)
    out["shardmap_base"] = os.environ["REPRO_MOE_SHARDMAP"]
    out["no_attn_impl"] = "attn_impl" in laid["loss_fn"].keywords
    sys.argv = ["dryrun", "--arch", "qwen3-0.6b", "--shape", "decode_32k",
                "--single-pod", "--out", sys.argv[1]]
    dryrun.main()
    out["default_out"] = os.path.basename(dryrun.RESULTS)
    print("RESULT " + json.dumps(out))
""")


# each repaired site: (arch, step, (data, model) mesh, config changes,
# accum, tuning, global batch (0: the smoke shape's)); every mesh has 16
# ranks, so that one fake process group serves them all
SITES = {
    # 8 microbatches of a batch over 8 data ranks: 4 does not divide by 8
    "microbatch_split": ("qwen3-0.6b", "train", (8, 2), {}, 4, None, 8),
    # 2 KV heads over 4 model ranks, in _gqa_qkv
    "gqa_kv_heads": ("qwen3-0.6b", "prefill", (4, 4), {}, 1, None, 0),
    # a plain prefill cache given DTensor rows
    "prefill_cache": ("qwen3-0.6b", "prefill", (4, 4),
                      {"num_kv_heads": 4}, 1, None, 0),
    # the in-place row write of a sharded decode cache
    "decode_cache_write": ("qwen3-0.6b", "decode", (4, 4),
                           {"num_kv_heads": 4}, 1, None, 0),
    # the label gather over a vocabulary sharded over 'model'
    "vocab_gather": ("qwen3-0.6b", "train", (8, 2), {"vocab_size": 512}, 1,
                     None, 8),
    # the MoE token reshape, whose gradient comes back sharded twice
    "moe_reshape_grad": ("mixtral-8x7b", "train", (4, 4),
                         {"num_kv_heads": 4}, 1, None, 0),
    # the expert-parallel dispatch (moe_shardmap), 4 experts over 4
    "moe_shardmap": ("deepseek-v3-671b", "train", (4, 4), {}, 1,
                     "moe_shardmap", 0),
    # MLA's query and wkv_b splits: 4 heads over 8
    "mla_heads": ("deepseek-v3-671b", "decode", (2, 8), {}, 1, None, 0),
    # RWKV6's 5 token-shift mixes over 4, and its time-mix state
    "rwkv_mixes": ("rwkv6-1.6b", "train", (4, 4), {}, 1, None, 0),
    # Zamba2's selective scan and its state
    "mamba_scan": ("zamba2-1.2b", "train", (4, 4), {}, 1, None, 0),
    # Whisper's self- and cross-attention heads: 4 over 8
    "whisper_heads": ("whisper-base", "prefill", (2, 8), {}, 1, None, 0),
    # and its 12 frames over 8, an uneven shard moved between dimensions
    "whisper_uneven_frames": ("whisper-base", "train", (2, 8), {}, 1, None,
                              0),
}

SITES_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import SMOKE_SHAPES, get_config, reduce_config
    from repro_torch.launch import dryrun
    from repro_torch.train.train_loop import TrainConfig

    dryrun.fake_world(16)
    out = {}
    for name, (arch, kind, mesh_shape, kw, accum, tuning, B) in \
            json.loads(sys.argv[1]).items():
        cfg = dataclasses.replace(reduce_config(get_config(arch)), **kw)
        shape = SMOKE_SHAPES[kind]
        if B:
            shape = dataclasses.replace(shape, global_batch=B)
        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=("data", "model"))
        t = dryrun.CellTuning(**{tuning: True}) if tuning else None
        try:
            laid, _, _ = dryrun.lay_out(
                cfg, shape, mesh, TrainConfig(accum=accum, remat="full"), t)
            c = dryrun.run_step(laid)
            out[name] = {"flops": c.flops, "coll": c.collective_bytes,
                         "by_op": c.coll_by_op, "ops": c.n_ops,
                         "sharded": sum(
                             any(p.is_shard() for p in a.placements)
                             for a in dryrun._arrays(laid["parts"]))}
        except Exception as e:                             # noqa: BLE001
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    print("RESULT " + json.dumps(out))
""")


def _run(log, script, *args):
    """A subprocess writing to the file ``log`` (two at once would block
    on full pipes)."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-c", script, *args],
                                env=dict(os.environ, PYTHONPATH=SRC),
                                stdout=f, stderr=subprocess.STDOUT,
                                text=True)


def _wait(proc, log):
    proc.wait(timeout=600)
    with open(log) as f:
        out = f.read()
    assert proc.returncode == 0, out[-6000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dry")
    out = str(tmp / "dryrun_torch.json")
    logs = str(tmp / "cells.log"), str(tmp / "sites.log")
    cells = _run(logs[0], SCRIPT, out)
    sites = _run(logs[1], SITES_SCRIPT, json.dumps(SITES))
    res = _wait(cells, logs[0])
    res["sites"] = _wait(sites, logs[1])
    with open(out) as f:
        res["main_file"] = json.load(f)
    return res


def _ref_bytes_per_rank(tree, specs, sizes):
    """Bytes of one rank's shard of each leaf, from the reference's specs
    (a Packed8's spec covers its q and s)."""
    total = 0
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JPacked8))
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        arrays = [leaf.q, leaf.s] if isinstance(leaf, JPacked8) else [leaf]
        for a in arrays:
            n = 1
            for i, dim in enumerate(a.shape):
                e = tuple(spec)[i] if i < len(tuple(spec)) else None
                axes = () if e is None else (e if isinstance(e, tuple) else (e,))
                div = int(np.prod([sizes[x] for x in axes]))
                assert dim % div == 0
                n *= dim // div
            total += n * a.dtype.itemsize
    return total


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_state_bytes_per_rank_equal_the_reference_arithmetic(result, arch,
                                                             mesh):
    rec = result["cells"][f"{arch}|train_4k|{mesh}|L1"]
    assert rec["status"] == "ok", rec
    shape, axes = MESHES[mesh]
    duck = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    big = arch in ("deepseek-v3-671b", "deepseek-67b")
    tcfg = JTrainConfig(
        opt=JOptConfig(state_dtype="bfloat16" if big else "float32"),
        accum=8, remat="full", grad_dtype="bfloat16" if big else "float32")
    sizes = dict(zip(axes, shape))
    dp = int(np.prod([sizes[a] for a in axes if a != "model"]))
    # the full-depth state as laid out, and the one-layer state that ran
    full = result["full_bytes"][f"{arch}|train_4k|{mesh}"]
    for cfg, got in ((jget(arch), full),
                     (dataclasses.replace(jget(arch), num_layers=1),
                      rec["bytes_per_rank"])):
        state = jtrain_state_shape(jbuild(cfg).init, tcfg)
        specs = jsh.param_specs(duck, state)
        for part in ("params", "opt"):
            assert got[part] == _ref_bytes_per_rank(
                state[part], specs[part], sizes), (cfg.num_layers, part)
        # the batch: (256, 4096) tokens over the data axes, int64 in the port
        assert got["batch"] == 256 // dp * 4096 * 8
    assert rec["arg_bytes"] == sum(rec["bytes_per_rank"].values())
    assert rec["ran"] and rec["collective_s"] > 0 and rec["compute_s"] > 0
    assert rec["coll_bytes_per_device"] == sum(
        b for _, b in rec["coll_by_op"].values())
    assert rec["temp_bytes"] > 0 and rec["run_s"] >= 0


def test_cell_tuning_flags_reach_their_knobs(result):
    w = result["whisper"]
    # dp_all: the batch over every mesh axis that divides 256, params and
    # optimizer state replicated, TP rules off
    assert w["rules"]["batch"] == ["data", "model"]
    assert all(w["rules"][k] is None for k in ("heads", "ff", "vocab"))
    assert w["dims"] == {"batch": ["data", "model"]}
    assert (w["accum"], w["cast"], w["grad_dtype"], w["remat"]) == \
        (1, True, "bfloat16", "dots")
    # moe_shardmap sets the switch moe_ffn reads; off by default
    assert result["deepseek_v3"] == {"shardmap": "1", "accum": 4}
    assert result["shardmap_base"] == "0"
    # no_fsdp: serving weights over 'model' only (the baseline uses data too)
    assert "data" not in result["deepseek_67b"]["dims"]["params"]
    assert "data" in result["deepseek_67b_base"]["dims"]["params"]
    # attn_impl reaches the loss and the prefill
    assert result["attn_impl"] == {"attn_impl": "banded"}
    assert result["attn_impl_prefill"] == {"attn_impl": "banded"}
    assert result["no_attn_impl"] is False


def test_main_writes_the_ports_own_results_file(result):
    assert result["default_out"] == "dryrun_torch.json"
    rec = result["main_file"]["qwen3-0.6b|decode_32k|pod16x16"]
    assert rec["status"] == "ok" and rec["ran"]
    assert set(rec["bytes_per_rank"]) == {"params", "cache", "token"}
    assert rec["collective_s"] > 0 and rec["flops_per_device"] > 0


@pytest.mark.parametrize("site", sorted(SITES))
def test_each_repaired_site_runs_sharded(result, site):
    """The reduced config's step on a 16-rank fake mesh that reproduces the
    site's gap runs to its end under the counter: flops and collectives
    counted, the arguments laid out sharded."""
    rec = result["sites"][site]
    assert "error" not in rec, rec
    assert rec["flops"] > 0 and rec["ops"] > 0 and rec["sharded"] > 0
    assert rec["coll"] == sum(b for _, b in rec["by_op"].values()) > 0
    if site == "microbatch_split":      # the batch is gathered for the split
        assert rec["by_op"]["all-gather"][0] > 0
