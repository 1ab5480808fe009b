"""The port's side of ``test_torch_distributed.py``: eight gloo ranks on the
CPU, started once by ``python tests/_torch_dist_worker.py OUT_DIR``.

Reads ``OUT_DIR/inputs.npz`` (written by the test) and writes one
``rank<r>.npz`` per rank with what that rank computed:

* all 8 ranks: ``compressed_psum`` over a ("data",) mesh, two rounds;
* ranks 0-3: ``make_pipelined_fn`` at 4 stages (a ("stage",) mesh), the
  expert-parallel MoE dispatch on a (data 2, model 2) mesh, and a state laid
  out on that mesh, saved, restored and re-laid on ranks 0-1 as (1, 2) by
  ``elastic_remesh``;
* ranks 4-5 (float32 moments) and 6-7 (int8 moments): a reduced Qwen3 train
  step with its state sharded over (data 2, model 1), beside the unsharded
  step from the same state; ranks 4-5 also the same for reduced Mixtral;
* ranks 0-3: the same at world 4 where the sharded step needs a reshard:
  Qwen3 with a 512 vocabulary over (data 1, model 4), Qwen3 over (data 4,
  model 1), Mixtral over (data 2, model 2).

Imports torch and the port only.
"""
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _leaves(tree):
    """path -> tensor, a Packed8 as its q and s."""
    from repro_torch.train.optimizer import Packed8
    out = {}
    for k, v in _flat(tree).items():
        if isinstance(v, Packed8):
            out[k + "/q"], out[k + "/s"] = v.q, v.s
        else:
            out[k] = v
    return out


def _bits(t):
    t = t.detach().cpu().contiguous()
    if t.is_floating_point():
        t = t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)
    return t


def psum(rank, inp, out):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed.collectives import compressed_psum
    mesh = DeviceMesh("cpu", torch.arange(WORLD), mesh_dim_names=("data",))
    g = torch.as_tensor(inp["psum_g"][rank])
    mean, err2 = compressed_psum(g, torch.zeros_like(g), mesh, axis="data")
    mean2, err3 = compressed_psum(g, err2, mesh, axis="data")
    out.update(psum_mean=mean.numpy(), psum_err=err2.numpy(),
               psum_mean2=mean2.numpy(), psum_err3=err3.numpy())


def pipeline(rank, inp, out):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed.pipeline import make_pipelined_fn
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("stage",))
    if rank >= 4:
        return
    Ws, x = torch.as_tensor(inp["pp_W"]), torch.as_tensor(inp["pp_x"])
    pp = make_pipelined_fn(lambda W, h: torch.tanh(h @ W), mesh,
                           n_stages=4, n_microbatches=x.shape[0])
    out["pp_y"] = pp(Ws[mesh.get_local_rank("stage")], x).numpy()


def moe(rank, inp, out, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.distributed.ctx import use_sharding
    from repro_torch.models.common import activation
    from repro_torch.models.moe import _shard_map_dispatch
    if rank >= 4:
        return
    cfg = reduce_config(get_config("mixtral-8x7b"))

    def rep(name):
        return distribute_tensor(torch.as_tensor(inp[name]), mesh,
                                 [Replicate(), Replicate()])

    p = {k: rep("moe_" + k) for k in ("w_gate", "w_up", "w_down")}
    with use_sharding(mesh):
        y = _shard_map_dispatch(rep("moe_x"), rep("moe_gates"),
                                rep("moe_idx"), p, cfg.moe,
                                activation(cfg.act), None)
    out["moe_y"] = y.full_tensor().numpy()
    out["moe_placements"] = np.array([str(q) for q in y.placements])


def remesh(rank, inp, out, mesh4, mesh2, tmp):
    """A state sharded over (data 2, model 2), gathered and saved, restored
    and laid out again on (1, 2) by elastic_remesh."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.distributed.sharding import param_specs, placements
    from repro_torch.models import build_model
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.fault_tolerance import elastic_remesh
    from repro_torch.train.optimizer import OptConfig, Packed8, tree_map
    from repro_torch.train.train_loop import TrainConfig, init_train_state
    if rank >= 4:
        return
    cfg = reduce_config(get_config("qwen3-0.6b"))
    gen = torch.Generator()
    gen.manual_seed(5)
    state = init_train_state(build_model(cfg).init,
                             TrainConfig(opt=OptConfig(state_dtype="int8")),
                             gen, device="cpu")
    for k, v in _leaves(state["opt"]).items():      # moments that are not 0
        v.copy_(torch.randint(-127, 128, v.shape, generator=gen)
                if v.dtype == torch.int8 else torch.rand(v.shape, generator=gen))
    on4 = elastic_remesh(state, mesh4, state)
    full = tree_map(lambda x: Packed8(x.q.full_tensor(), x.s.full_tensor(),
                                      x.shape) if isinstance(x, Packed8)
                    else x.full_tensor(), on4)
    ck = os.path.join(tmp, "world4_ckpt")
    if rank >= 2:
        return
    if rank == 0:
        save_checkpoint(ck, 7, full)
    dist.barrier(group=mesh2.get_group("model"))          # ranks 0 and 1
    back, step, _ = restore_checkpoint(ck, device="cpu")
    on2 = elastic_remesh(back, mesh2, back)
    a, b, c = _leaves(state), _leaves(back), _leaves(on2)
    assert sorted(a) == sorted(b) == sorted(c)
    bad_bits = [k for k in a if not (torch.equal(_bits(a[k]), _bits(b[k])) and
                torch.equal(_bits(c[k].full_tensor()), _bits(a[k])))]
    specs = _flat(param_specs(mesh2, back))
    bad_pl, sharded = [], 0
    for k, x in _flat(on2).items():
        arrays = (x.q, x.s) if isinstance(x, Packed8) else (x,)
        want = placements(mesh2, specs[k])
        bad_pl += [k for a_ in arrays if tuple(a_.placements) != want]
        sharded += any(str(q) != "R" for q in want)
    out.update(remesh_step=step, remesh_leaves=len(c),
               remesh_sharded=sharded, remesh_bad_bits=np.array(bad_bits),
               remesh_bad_placements=np.array(bad_pl))


def train(rank, inp, out, mesh, state_dtype, arch="qwen3-0.6b", key="train",
          **cfg_kw):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed.ctx import use_sharding
    from repro_torch.distributed.sharding import (batch_spec, distribute,
                                                  param_specs)
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import (TrainConfig, init_train_state,
                                              make_train_step)
    if mesh.get_coordinate() is None:
        return
    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              dtype="float32", **cfg_kw)
    api = build_model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1,
                                     total_steps=10, state_dtype=state_dtype),
                       accum=2, remat="full")

    def fresh():
        gen = torch.Generator()
        gen.manual_seed(0)
        return init_train_state(api.init, tcfg, gen, device="cpu")

    batch = lm_batch(cfg, 4, 16, seed=0, step=0, device="cpu")
    step = make_train_step(api.loss, tcfg)
    ref, ref_m = step(fresh(), batch)
    st = fresh()
    dst = distribute(st, mesh, param_specs(mesh, st))
    with use_sharding(mesh):
        new, m = step(dst, distribute(batch, mesh, batch_spec(mesh, batch)))
        loss = float(m["loss"])
    a, b = _flat(ref["params"]), _flat(new["params"])
    out.update({
        f"{key}_loss": loss, f"{key}_ref_loss": float(ref_m["loss"]),
        f"{key}_param_err": max(float((a[k] - b[k].full_tensor()).abs().max())
                                for k in a),
        f"{key}_sharded": sum(any(str(q) != "R" for q in b[k].placements)
                              for k in b)})


def worker(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=WORLD)
    from torch.distributed.device_mesh import DeviceMesh
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    # every mesh is made by every rank, in the same order
    mesh4 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                       mesh_dim_names=("data", "model"))
    mesh2 = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                       mesh_dim_names=("data", "model"))
    mesh_f32 = DeviceMesh("cpu", torch.arange(4, 6).reshape(2, 1),
                          mesh_dim_names=("data", "model"))
    mesh_i8 = DeviceMesh("cpu", torch.arange(6, 8).reshape(2, 1),
                         mesh_dim_names=("data", "model"))
    mesh_m4 = DeviceMesh("cpu", torch.arange(4).reshape(1, 4),
                         mesh_dim_names=("data", "model"))
    mesh_d4 = DeviceMesh("cpu", torch.arange(4).reshape(4, 1),
                         mesh_dim_names=("data", "model"))
    out = {}
    psum(rank, inp, out)
    pipeline(rank, inp, out)
    moe(rank, inp, out, mesh4)
    remesh(rank, inp, out, mesh4, mesh2, tmp)
    train(rank, inp, out, mesh_f32, "float32")
    train(rank, inp, out, mesh_i8, "int8")
    train(rank, inp, out, mesh_f32, "float32", "mixtral-8x7b", "moe_train")
    # the sites the dry run repaired: 2 KV heads and a 512 vocabulary over
    # 4 model ranks; 2 microbatches of 4 rows over 4 data ranks; the MoE
    # token reshape with its gradient over data and model
    train(rank, inp, out, mesh_m4, "float32", key="heads_train",
          vocab_size=512)
    train(rank, inp, out, mesh_d4, "float32", key="split_train")
    train(rank, inp, out, mesh4, "float32", "mixtral-8x7b", "moe2d_train")
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(sys.argv[1],), nprocs=WORLD)
