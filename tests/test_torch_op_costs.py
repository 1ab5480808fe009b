"""repro_torch's ``analysis/op_costs.py`` against the reference's
``analysis/hlo_costs.py`` on the programs of ``tests/test_hlo_costs.py``.

The reference compiles each program and parses its HLO (loop bodies scaled
by their trip counts); the port runs the same shapes under ``OpCounter``,
whose Python loops need no trip counts. Flops must agree exactly on the
loops and within the reference's own 2 % on the reduced train step; the
sharded loop at world 4 (the reference on 4 virtual XLA devices, the port on
a ``fake`` process group, each in a subprocess) moves the same collective
bytes. A sharded step counts the same on ``meta`` and on CPU tensors, warm
or cold (DTensor's sharding propagation is not counted).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.hlo_costs import analyze
from repro_torch.analysis.op_costs import OpCounter, count

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _analyze(f, *specs):
    return analyze(jax.jit(f).lower(*specs).compile().as_text())


def _loop(x, w, n):
    for _ in range(n):
        x = torch.tanh(x @ w)
    return x


def test_scan_flops_equal_the_reference():
    def scan8(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=8)[0]

    s = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    ref = _analyze(scan8, s, s)
    x, w = torch.randn(128, 128), torch.randn(128, 128)
    _, c = count(_loop, x, w, 8)
    assert c.flops == ref.flops == 8 * 2 * 128 ** 3
    assert c.dot_flops == c.flops and c.conv_flops == 0
    assert c.collective_bytes == 0 and c.coll_by_op == {}


def test_nested_loop_flops_equal_the_reference():
    def g(x, w):
        def outer(c, _):
            def inner(c2, _2):
                return jnp.tanh(c2 @ w), None
            return jax.lax.scan(inner, c, None, length=4)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    s = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    ref = _analyze(g, s, s)

    def nested(x, w):
        for _ in range(3):
            x = _loop(x, w, 4)
        return x

    _, c = count(nested, torch.randn(64, 64, device="meta"),
                 torch.randn(64, 64, device="meta"))
    assert c.flops == ref.flops == 12 * 2 * 64 ** 3


def test_reduced_qwen3_train_step_within_2_percent_of_the_reference():
    from repro.configs import get_config, reduce_config
    from repro.models import build_model
    from repro.train.train_loop import TrainConfig, make_train_step, \
        train_state_shape
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import reduce_config as treduce
    from repro_torch.models import build_model as tbuild
    from repro_torch.train.train_loop import TrainConfig as TTrainConfig
    from repro_torch.train.train_loop import init_train_state
    from repro_torch.train.train_loop import make_train_step as tmake

    cfg = dataclasses.replace(reduce_config(get_config("qwen3-0.6b")),
                              num_layers=2)
    api = build_model(cfg)
    tcfg = TrainConfig(accum=2, remat="full")
    ref = _analyze(make_train_step(api.loss, tcfg),
                   train_state_shape(api.init, tcfg),
                   {"tokens": jax.ShapeDtypeStruct((4, 32), jnp.int32)})

    tcfg_t = TTrainConfig(accum=2, remat="full")
    api_t = tbuild(dataclasses.replace(treduce(tget("qwen3-0.6b")),
                                       num_layers=2))
    state = init_train_state(api_t.init, tcfg_t, torch.Generator(),
                             device="meta")
    batch = {"tokens": torch.zeros((4, 32), dtype=torch.int64,
                                   device="meta")}
    _, c = count(tmake(api_t.loss, tcfg_t), state, batch)
    assert ref.flops > 0
    assert c.flops == pytest.approx(ref.flops, rel=0.02)
    assert c.peak_bytes > c.arg_bytes > 0


REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.analysis.hlo_costs import analyze
    mesh = jax.make_mesh((4,), ("d",))
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=5)[0]
    s = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    a = analyze(jax.jit(f, in_shardings=(
        NamedSharding(mesh, P(None, "d")), NamedSharding(mesh, P("d", None)))
    ).lower(s, s).compile().as_text())
    print("RESULT " + json.dumps({"bytes": a.collective_bytes,
                                  "by_op": a.coll_by_op}))
""")

PORT_SCRIPT = textwrap.dedent("""
    import json, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.analysis.op_costs import count
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("d",))
    x = distribute_tensor(torch.randn(64, 64), mesh, [Shard(1)])
    w = distribute_tensor(torch.randn(64, 64), mesh, [Shard(0)])
    def f(x, w):
        for _ in range(5):
            x = torch.tanh(x @ w)
        return x
    _, c = count(f, x, w)
    print("RESULT " + json.dumps({"bytes": c.collective_bytes,
                                  "by_op": c.coll_by_op,
                                  "flops": c.flops}))
""")


def _result(script):
    r = subprocess.run([sys.executable, "-c", script],
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_sharded_loop_at_world_4_moves_the_references_collective_bytes():
    """A contraction over the sharded dimension, five times: each step's
    partial product is summed over the 4 ranks. XLA and DTensor both pick an
    all-reduce of the (64, 64) float32 result."""
    ref, port = _result(REF_SCRIPT), _result(PORT_SCRIPT)
    single = 64 * 64 * 4
    assert port["bytes"] == ref["bytes"] >= 5 * single
    assert port["by_op"] == {"all-reduce": [5, 5 * single]}
    assert set(ref["by_op"]) == {"all-reduce"}
    assert port["flops"] == 5 * 2 * 64 * 16 * 64      # the local products


SHARDED_STEP = textwrap.dedent("""
    import dataclasses, json, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.analysis.op_costs import OpCounter
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.distributed.ctx import use_sharding
    from repro_torch.distributed.sharding import (batch_spec, distribute,
                                                  param_specs)
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import (TrainConfig, init_train_state,
                                              make_train_step)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(reduce_config(get_config("qwen3-0.6b")),
                              vocab_size=512, dtype="float32")
    api = build_model(cfg)
    tcfg = TrainConfig(accum=2, remat="full")
    step = make_train_step(api.loss, tcfg)
    out = []
    for dev in ("meta", "cpu", "meta", "cpu"):
        gen = torch.Generator()
        gen.manual_seed(0)
        st = init_train_state(api.init, tcfg, gen, device=dev)
        batch = {"tokens": torch.zeros((4, 16), dtype=torch.int64,
                                       device=dev)}
        st = distribute(st, mesh, param_specs(mesh, st))
        batch = distribute(batch, mesh, batch_spec(mesh, batch))
        with use_sharding(mesh), OpCounter() as c:
            c.track(st, batch)
            step(st, batch)
        out.append({"dev": dev, "flops": c.costs.flops,
                    "coll": c.costs.collective_bytes,
                    "by_op": c.costs.coll_by_op})
    print("RESULT " + json.dumps(out))
""")


def test_sharded_step_counts_the_same_on_meta_and_cpu_warm_or_cold():
    """The reduced train step at fake world 4 (data 2, model 2), counted on
    meta and on real CPU tensors, twice each: the first run of each op
    signature also runs DTensor's sharding propagation on fake tensors,
    which must not be counted; a meta run issues no ``wait_tensor``."""
    runs = _result(SHARDED_STEP)
    assert [r["dev"] for r in runs] == ["meta", "cpu", "meta", "cpu"]
    first = runs[0]
    assert first["flops"] > 0 and first["coll"] > 0
    for r in runs[1:]:
        assert (r["flops"], r["coll"], r["by_op"]) == \
            (first["flops"], first["coll"], first["by_op"]), r


def test_peak_bytes_follow_python_lifetimes():
    """Live bytes are the arguments plus every storage an op made, until it
    is freed: in ``y = exp(x) + 1; x = y * 2`` the old ``y`` and ``x`` stay
    alive while the new ones are made."""
    def f(x):
        for _ in range(10):
            y = torch.exp(x) + 1
            x = y * 2
        return x

    one = 1000 * 1000 * 4
    for dev in ("meta", "cpu"):
        _, c = count(f, torch.zeros(1000, 1000, device=dev))
        assert c.arg_bytes == one
        assert c.peak_bytes == 5 * one, dev
        assert c.n_ops == 30


def test_a_counter_skips_nothing_outside_its_block():
    x = torch.randn(8, 8)
    with OpCounter() as c:
        x @ x
    x @ x
    assert c.costs.flops == 2 * 8 ** 3 and c.costs.n_ops == 1
