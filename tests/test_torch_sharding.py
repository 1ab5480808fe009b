"""repro_torch's sharding rules, context, input specs, roofline traffic and
pipeline arithmetic against repro's, in process (no process group).

The reference's rules read only a mesh's axis names and sizes, so both
packages get the same duck-typed mesh (``axis_names`` and ``devices.shape``)
at the production shapes, (16, 16) ("data", "model") and (2, 16, 16)
("pod", "data", "model"): no 256- or 512-device process is needed. The
parameter trees are the full configs' shapes (``jax.eval_shape`` on one side,
the ``meta`` device on the other), and every spec must equal the
reference's ``PartitionSpec`` entry for entry.
"""
import dataclasses
import functools
import threading
import types

import jax
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroof
from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_supported as jcell_supported
from repro.configs import get_config as jget
from repro.distributed import ctx as jctx
from repro.distributed import pipeline as jpipe
from repro.distributed import sharding as jsh
from repro.models import build_model as jbuild
from repro.models import input_specs as jinput_specs
from repro.train import optimizer as jopt
from repro.train.train_loop import TrainConfig as JTrainConfig
from repro.train.train_loop import train_state_shape as jtrain_state_shape
from repro_torch.analysis import roofline as troof
from repro_torch.configs import get_config
from repro_torch.distributed import ctx as tctx
from repro_torch.distributed import pipeline as tpipe
from repro_torch.distributed import sharding as tsh
from repro_torch.models import build_model, input_specs
from repro_torch.models.common import remat_fn
from repro_torch.models.moe import _shard_map_dispatch
from repro_torch.train.optimizer import OptConfig, Packed8
from repro_torch.train.train_loop import TrainConfig, train_state_shape

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LM_ARCHS = sorted(JASSIGNED)
ARCHS = LM_ARCHS + ["resnet18"]


def duck_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _flat(tree, prefix=""):
    """path -> leaf of nested dicts (a spec, a shape or a Packed8 is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _same_specs(jspecs, tspecs):
    jf, tf = _flat(jspecs), _flat(tspecs)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tuple(jf[k]) == tf[k], (k, jf[k], tf[k])
    return len(jf)


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    api = jbuild(jget(arch))
    return jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _tparams(arch):
    return build_model(get_config(arch)).init(torch.Generator(),
                                              device="meta")


@pytest.mark.parametrize("embed_tp", [False, True])
@pytest.mark.parametrize("no_fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, no_fsdp, embed_tp):
    m = duck_mesh(mesh)
    kw = dict(no_fsdp=no_fsdp, embed_tp=embed_tp)
    n = _same_specs(jsh.param_specs(m, _jparams(arch), **kw),
                    tsh.param_specs(m, _tparams(arch), **kw))
    assert n >= 3


@pytest.mark.parametrize("no_fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b"])
def test_train_state_specs_with_int8_moments(arch, mesh, no_fsdp):
    """The whole train state (params, m, v, step) with ``Packed8`` moments:
    each moment's block dim over every mesh axis (or 'model' alone without
    fsdp), for ``q`` and ``s`` alike."""
    m = duck_mesh(mesh)
    jstate = jtrain_state_shape(
        jbuild(jget(arch)).init,
        JTrainConfig(opt=jopt.OptConfig(state_dtype="int8")))
    tstate = train_state_shape(build_model(get_config(arch)).init,
                               TrainConfig(opt=OptConfig(state_dtype="int8")))
    assert isinstance(next(iter(_flat(tstate["opt"]["m"]).values())), Packed8)
    _same_specs(jsh.param_specs(m, jstate, no_fsdp=no_fsdp),
                tsh.param_specs(m, tstate, no_fsdp=no_fsdp))


@pytest.mark.parametrize("dp_all", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["whisper-base", "resnet18"])
def test_batch_spec_equals_the_reference(arch, mesh, dp_all):
    m = duck_mesh(mesh)
    shape = [s for s in JSHAPES if s.name == "train_4k"][0]
    dp = MESHES[mesh][1] if dp_all else None
    jb = jinput_specs(jget(arch), shape)["batch"]
    tb = input_specs(get_config(arch), shape)["batch"]
    _same_specs(jsh.batch_spec(m, jb, dp_axes=dp),
                tsh.batch_spec(m, tb, dp_axes=dp))


def _decode_cells():
    return [(a, s.name) for a in LM_ARCHS for s in JSHAPES
            if s.kind == "decode" and jcell_supported(jget(a), s)[0]]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", _decode_cells())
def test_cache_spec_equals_the_reference(arch, shape, mesh):
    m = duck_mesh(mesh)
    sh = [s for s in JSHAPES if s.name == shape][0]
    jc = jinput_specs(jget(arch), sh)
    tc = input_specs(get_config(arch), sh)
    _same_specs(jsh.cache_spec(m, jc["cache"]), tsh.cache_spec(m, tc["cache"]))
    _same_specs({"t": jsh.batch_spec(m, {"t": jc["token"]})["t"]},
                {"t": tsh.batch_spec(m, {"t": tc["token"]})["t"]})


LOGICAL = [("batch", None, "embed"), ("batch", None, "heads", None),
           ("batch", "kv_heads", None, None, None), ("batch", None, "ff"),
           ("batch", None, "vocab"), ("experts", "batch", None),
           ("fsdp", "layers", "seq"), (None,), ()]


@pytest.mark.parametrize("dp_all", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ctx_spec_equals_the_reference(mesh, dp_all):
    """``ShardingCtx.spec`` under DEFAULT_RULES and the dry run's dp_all
    rules (batch over the longest prefix of the mesh axes dividing 256)."""
    m = duck_mesh(mesh)
    rules = None
    if dp_all:
        sizes = dict(zip(*reversed(MESHES[mesh])))
        dp = MESHES[mesh][1]
        while 256 % int(np.prod([sizes[a] for a in dp])):
            dp = dp[:-1]
        rules = {"batch": dp, "heads": None, "kv_heads": None, "ff": None,
                 "vocab": None, "experts": None}
    assert tctx.DEFAULT_RULES == jctx.DEFAULT_RULES
    jc, tc = jctx.ShardingCtx(m, rules), tctx.ShardingCtx(m, rules)
    for logical in LOGICAL:
        assert tuple(jc.spec(*logical)) == tc.spec(*logical), logical


def test_shard_is_the_identity_outside_a_context_and_on_plain_tensors():
    x = torch.randn(4, 8)
    assert tctx.current() is None
    assert tctx.shard(x, "batch", "embed") is x
    assert tctx.named_sharding("batch") is None
    m = duck_mesh("pod16x16")
    with tctx.use_sharding(m) as c:
        assert tctx.current() is c
        assert tctx.shard(x, "batch", "embed") is x
        mesh, pl = tctx.named_sharding("batch", None, "vocab")
        assert mesh is m and [str(p) for p in pl] == ["S(0)", "S(2)"]
    assert tctx.current() is None


def test_context_is_per_thread_and_reaches_a_recomputation_elsewhere():
    """Another thread does not see a thread's context; a checkpointed
    block recomputed on another thread (autograd's device thread on the
    card) sees the context its forward pass saw."""
    seen = []

    def block(x):
        seen.append(tctx.current())
        return torch.sin(x) * torch.cos(x)

    run = remat_fn(block, "full")
    x = torch.linspace(0.0, 1.0, 5, requires_grad=True)
    with tctx.use_sharding(duck_mesh("pod16x16")) as c:
        other = []
        t = threading.Thread(target=lambda: other.append(tctx.current()))
        t.start()
        t.join()
        loss = run(x).sum()
    assert other == [None] and tctx.current() is None
    t = threading.Thread(target=loss.backward)
    t.start()
    t.join()
    assert seen == [c, c]
    torch.testing.assert_close(x.grad, torch.cos(2 * x.detach()))
    assert tctx.current() is None


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = duck_mesh("pod2x16x16")
    assert tsh.placements(m, (("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Shard(1))
    assert tsh.placements(m, (None, None, ("model",))) == \
        (Replicate(), Replicate(), Shard(2))
    assert tsh.placements(m, ()) == (Replicate(),) * 3
    with pytest.raises(AssertionError):
        tsh.placements(m, (("data", "pod"),))
    sh = tsh.shardings_for(m, {"embed": torch.empty(151936, 1024,
                                                    device="meta")})
    assert sh["embed"] == (m, (Shard(1), Shard(1), Shard(0)))


def _cells():
    return [(a, s.name) for a in ARCHS for s in JSHAPES
            if jcell_supported(jget(a), s)[0]]


_DTYPES = {"int32": torch.int64, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_equal_the_reference(arch, shape):
    """Same shapes; the reference's int32 is the port's int64, and every
    other dtype is the same."""
    sh = [s for s in JSHAPES if s.name == shape][0]
    jf = _flat(jinput_specs(jget(arch), sh))
    tf = _flat(input_specs(get_config(arch), sh))
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tuple(jf[k].shape) == tuple(tf[k].shape), k
        assert _DTYPES[str(jf[k].dtype)] == tf[k].dtype, k
        assert tf[k].device.type == "meta"


@pytest.mark.parametrize("arch,shape", _cells())
def test_analytic_traffic_equals_the_reference(arch, shape):
    sh = [s for s in JSHAPES if s.name == shape][0]
    kw = dict(params_bytes=1.2e9 + 3, opt_bytes=2.4e9 + 7,
              cache_bytes=3.1e9 + 11, accum=8, remat=shape == "train_4k")
    assert troof.analytic_traffic(get_config(arch), sh, **kw) == \
        jroof.analytic_traffic(jget(arch), sh, **kw)


def test_cell_report_keeps_the_reference_fields():
    from repro_torch.analysis.op_costs import OpCosts
    assert [f.name for f in dataclasses.fields(troof.CellReport)] == \
        [f.name for f in dataclasses.fields(jroof.CellReport)]
    costs = OpCosts(dot_flops=989e12 * 0.5, conv_flops=989e12 * 0.25,
                    collective_bytes=900e9 * 3,
                    coll_by_op={"all-gather": (2, 900e9),
                                "all-reduce": (1, 1800e9)},
                    peak_bytes=2 ** 30 + 2 ** 29, arg_bytes=2 ** 30)
    rep = troof.build_report(arch="a", shape="s", mesh_name="m", chips=256,
                             model_flops=989e12 * 256,
                             traffic={"total": 3.35e12 * 512}, costs=costs)
    assert rep.compute_s == pytest.approx(0.75)
    assert rep.memory_s == pytest.approx(2.0)
    assert rep.collective_s == pytest.approx(3.0)
    assert rep.coll_bytes_per_device == 900e9 * 3
    assert rep.coll_by_op == {"all-gather": (2, int(900e9)),
                              "all-reduce": (1, int(1800e9))}
    assert rep.dominant == "collective" and rep.bound_s == pytest.approx(3.0)
    assert rep.useful_ratio == pytest.approx(1 / 0.75)
    assert rep.roofline_frac == pytest.approx(1 / 3)
    assert (rep.arg_bytes, rep.temp_bytes) == (2 ** 30, 2 ** 29)
    assert rep.hbm_total_gib == 1.5 and rep.fits_hbm
    assert not troof.build_report(
        arch="a", shape="s", mesh_name="m", chips=1, model_flops=1.0,
        traffic={"total": 1.0},
        costs=OpCosts(peak_bytes=int(80e9) + 1)).fits_hbm


@pytest.mark.parametrize("seed", range(4))
def test_stage_assignment_and_bubble_are_exact(seed):
    rng = np.random.default_rng(seed)
    for L in (1, 3, 7, 28):
        costs = rng.uniform(0.1, 3.0, size=L).tolist()
        for S in (1, 2, 4, 8):
            assert tpipe.balanced_stage_assignment(costs, S) == \
                jpipe.balanced_stage_assignment(costs, S)
            assert tpipe.bubble_fraction(S, L) == jpipe.bubble_fraction(S, L)


def test_shard_map_dispatch_returns_none_where_the_reference_does():
    """No context, no 'model' axis, 'model' of size 1, E % model, T % dp:
    None, so ``moe_ffn`` takes ``dispatch_combine``."""
    cfg = get_config("mixtral-8x7b")            # 8 experts
    x = torch.zeros(16, 4)
    args = (x, None, None, None, cfg.moe, None, None)

    def mesh(shape, axes):
        return types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape))

    assert _shard_map_dispatch(*args) is None
    for m in (mesh((4,), ("data",)), mesh((4, 1), ("data", "model")),
              mesh((1, 3), ("data", "model")),
              mesh((3, 2), ("data", "model"))):
        with tctx.use_sharding(m):
            assert _shard_map_dispatch(*args) is None
