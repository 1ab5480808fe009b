"""repro_torch's distribution layer on ``torch.distributed`` (gloo, eight CPU
ranks) against repro's (eight virtual XLA devices).

One spawn of the port's ranks (``tests/_torch_dist_worker.py``) and one JAX
subprocess run side by side on the same numpy inputs, made here from a seed;
each test then reads its part of both results:

* ``make_pipelined_fn`` at 4 stages, (S=4, M=8, mb=2, d=16): within the
  reference test's 1e-5 of the JAX function and of sequential execution;
* ``compressed_psum`` at 8 ranks on an 8 x 64 input, two rounds: the mean
  within 1e-6 of the JAX package's, the errors within 1e-7;
* the expert-parallel MoE dispatch (``_shard_map_dispatch``) on a (data 2,
  model 2) mesh, reduced Mixtral experts: within 1e-5 of the reference's
  under ``use_sharding``;
* ``elastic_remesh`` of a world-4 checkpoint onto a world-2 mesh: every leaf
  bit for bit, with the placements of ``param_specs``;
* a reduced Qwen3 train step with its state sharded at world 2 (data 2),
  float32 and int8 moments, and a reduced Mixtral one with float32
  moments: loss within 1e-6 relative and parameters within 1e-5 of the
  unsharded step.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config, reduce_config
    from repro.distributed.collectives import compressed_psum
    from repro.distributed.ctx import use_sharding
    from repro.distributed.pipeline import make_pipelined_fn
    from repro.models.common import activation
    from repro.models.moe import _shard_map_dispatch

    inp = dict(np.load(os.path.join(sys.argv[1], "inputs.npz")))
    out = {}
    devs = np.array(jax.devices())
    pp = make_pipelined_fn(lambda W, h: jnp.tanh(h @ W),
                           Mesh(devs[:4], ("stage",)), n_stages=4,
                           n_microbatches=inp["pp_x"].shape[0])
    out["pp_y"] = np.asarray(pp(jnp.asarray(inp["pp_W"]),
                                jnp.asarray(inp["pp_x"])))

    mesh8 = Mesh(devs, ("data",))
    g = jnp.asarray(inp["psum_g"])
    mean, err2 = compressed_psum(g, jnp.zeros_like(g), mesh8, axis="data")
    mean2, err3 = compressed_psum(g, err2, mesh8, axis="data")
    out.update(psum_mean=np.asarray(mean), psum_err=np.asarray(err2),
               psum_mean2=np.asarray(mean2), psum_err3=np.asarray(err3))

    cfg = reduce_config(get_config("mixtral-8x7b"))
    p = {k: jnp.asarray(inp["moe_" + k]) for k in ("w_gate", "w_up", "w_down")}
    with use_sharding(Mesh(devs[:4].reshape(2, 2), ("data", "model"))):
        y = _shard_map_dispatch(jnp.asarray(inp["moe_x"]),
                                jnp.asarray(inp["moe_gates"]),
                                jnp.asarray(inp["moe_idx"], jnp.int32), p,
                                cfg.moe, activation(cfg.act), None)
    out["moe_y"] = np.asarray(y)
    np.savez(os.path.join(sys.argv[1], "jax.npz"), **out)
""")


def _inputs(tmp):
    rng = np.random.default_rng(0)
    S, M, mb, d = 4, 8, 2, 16
    T, dm, E, f, k = 16, 64, 4, 32, 2          # reduced Mixtral experts
    idx = np.argsort(rng.random((T, E)), axis=1)[:, :k]
    gates = rng.uniform(0.1, 1.0, size=(T, k))
    np.savez(os.path.join(tmp, "inputs.npz"),
             pp_W=(rng.normal(size=(S, d, d)) * 0.3).astype(np.float32),
             pp_x=rng.normal(size=(M, mb, d)).astype(np.float32),
             psum_g=rng.normal(size=(8, 64)).astype(np.float32),
             moe_x=rng.normal(size=(T, dm)).astype(np.float32),
             moe_gates=(gates / gates.sum(1, keepdims=True)).astype(np.float32),
             moe_idx=idx.astype(np.int64),
             moe_w_gate=(rng.normal(size=(E, dm, f)) / 8).astype(np.float32),
             moe_w_up=(rng.normal(size=(E, dm, f)) / 8).astype(np.float32),
             moe_w_down=(rng.normal(size=(E, f, dm)) / 6).astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist"))
    _inputs(tmp)
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, tmp],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True),
             subprocess.Popen([sys.executable,
                               os.path.join(HERE, "_torch_dist_worker.py"),
                               tmp], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    ref = dict(np.load(os.path.join(tmp, "jax.npz")))
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
             for r in range(8)]
    return inp, ref, ranks


def test_pipeline_at_4_stages_matches_the_reference(runs):
    inp, ref, ranks = runs
    seq = inp["pp_x"]
    for W in inp["pp_W"]:
        seq = np.tanh(seq @ W)
    for r in range(4):                   # every stage returns the last's
        y = ranks[r]["pp_y"]
        assert y.shape == (8, 2, 16)
        assert np.abs(y - ref["pp_y"]).max() < 1e-5, r
        assert np.abs(y - seq).max() < 1e-5, r


def test_compressed_psum_at_8_ranks_matches_the_reference(runs):
    _, ref, ranks = runs
    for r in range(8):
        for k in ("psum_mean", "psum_mean2"):
            assert np.abs(ranks[r][k] - ref[k][r]).max() <= 1e-6, (r, k)
        for k in ("psum_err", "psum_err3"):
            assert np.abs(ranks[r][k] - ref[k][r]).max() <= 1e-7, (r, k)
    assert np.abs(ref["psum_err"]).max() > 0      # error feedback is live


def test_shard_map_dispatch_matches_the_reference(runs):
    _, ref, ranks = runs
    for r in range(4):
        y = ranks[r]["moe_y"]
        assert y.shape == ref["moe_y"].shape == (16, 64)
        assert np.abs(y - ref["moe_y"]).max() < 1e-5, r
        assert list(ranks[r]["moe_placements"]) == ["S(0)", "R"]
    assert np.abs(ref["moe_y"]).max() > 0.1


def test_elastic_remesh_from_world_4_to_world_2(runs):
    _, _, ranks = runs
    for r in range(2):
        o = ranks[r]
        assert int(o["remesh_step"]) == 7
        assert o["remesh_bad_bits"].size == 0, o["remesh_bad_bits"]
        assert o["remesh_bad_placements"].size == 0, o["remesh_bad_placements"]
        assert int(o["remesh_sharded"]) >= 10
        assert int(o["remesh_leaves"]) >= 40


@pytest.mark.parametrize("state_dtype,pair", [("float32", (4, 5)),
                                              ("int8", (6, 7))])
def test_sharded_train_step_at_world_2_matches_unsharded(runs, state_dtype,
                                                         pair):
    _, _, ranks = runs
    for r in pair:
        o = ranks[r]
        loss, ref = float(o["train_loss"]), float(o["train_ref_loss"])
        assert abs(loss - ref) <= 1e-6 * abs(ref), (loss, ref)
        assert float(o["train_param_err"]) <= 1e-5
        assert int(o["train_sharded"]) >= 5


def test_sharded_moe_train_step_at_world_2_matches_unsharded(runs):
    """The MoE dispatch under a batch-sharded state: the expert ranks come
    from a count, an exclusive cumsum and a gather, and the buffer writes
    are out-of-place ``index_put``s, all of which DTensor shards."""
    _, _, ranks = runs
    for r in (4, 5):
        o = ranks[r]
        loss, ref = float(o["moe_train_loss"]), float(o["moe_train_ref_loss"])
        assert abs(loss - ref) <= 1e-6 * abs(ref), (loss, ref)
        assert float(o["moe_train_param_err"]) <= 1e-5
        assert int(o["moe_train_sharded"]) >= 5
