"""repro_torch's dry run (``launch/dryrun.py``) on the ``fake`` backend.

The port lays each cell out as ``DTensor``s on a 256- or 512-rank mesh in a
process of its own (this process keeps no process group). Its bytes per rank
of the train state must equal the arithmetic from the reference's
``PartitionSpec``s on the same shapes (``jax.eval_shape``, no devices), and
each ``CellTuning`` flag must reach its knob.
"""
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

    out = {"cells": {}}
    for arch in ("qwen3-0.6b", "deepseek-v3-671b"):
        for mp in (False, True):
            rec = dryrun.run_cell(arch, "train_4k", mp, verbose=False)
            out["cells"][rec["key"]] = rec

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


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dry") / "dryrun_torch.json")
    r = subprocess.run([sys.executable, "-c", SCRIPT, out],
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
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
    rec = result["cells"][f"{arch}|train_4k|{mesh}"]
    assert rec["status"] == "ok", rec
    shape, axes = MESHES[mesh]
    duck = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    big = arch in ("deepseek-v3-671b", "deepseek-67b")
    tcfg = JTrainConfig(
        opt=JOptConfig(state_dtype="bfloat16" if big else "float32"),
        accum=8, remat="full", grad_dtype="bfloat16" if big else "float32")
    state = jtrain_state_shape(jbuild(jget(arch)).init, tcfg)
    specs = jsh.param_specs(duck, state)
    sizes = dict(zip(axes, shape))
    for part in ("params", "opt"):
        assert rec["bytes_per_rank"][part] == _ref_bytes_per_rank(
            state[part], specs[part], sizes), part
    # the batch: (256, 4096) tokens over the data axes, int64 in the port
    dp = int(np.prod([sizes[a] for a in axes if a != "model"]))
    assert rec["bytes_per_rank"]["batch"] == 256 // dp * 4096 * 8
    assert rec["arg_bytes"] == sum(rec["bytes_per_rank"].values())
    assert rec["collective_s"] is None and rec["compute_s"] > 0


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
    assert rec["status"] == "ok"
    assert set(rec["bytes_per_rank"]) == {"params", "cache", "token"}
