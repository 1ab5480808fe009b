"""The port's checkpoints and resilient loop: twins of
``tests/test_checkpoint_ft.py``, the checkpoint format against the JAX
package's (a float32 tree restores bit-equal across the two packages, both
ways), bfloat16 and int8 train states round-tripped bit for bit, the async
save's snapshot, and the two faults of the reference's checkpoints that the
port does not copy (each shown by running the same tree through both)."""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs import get_config, reduce_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.models import build_model
from repro_torch.train.checkpoint import (CheckpointManager, latest_step,
                                          restore_checkpoint, save_checkpoint)
from repro_torch.train.fault_tolerance import (ResilienceReport, StepWatchdog,
                                               run_resilient)
from repro_torch.train.optimizer import OptConfig, Packed8, init_opt_state
from repro_torch.train.train_loop import (TrainConfig, TrainProgram,
                                          init_train_state, make_train_step)

torch.set_num_threads(2)

CFG = reduce_config(get_config("qwen3-0.6b"))


def _leaf_pairs(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            yield from _leaf_pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, Packed8):
        assert isinstance(b, Packed8) and a.shape == b.shape, path
        yield f"{path}/q", a.q, b.q
        yield f"{path}/s", a.s, b.s
    else:
        yield path, a, b


def _manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)


def _assert_bit_equal(a, b):
    for path, x, y in _leaf_pairs(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        elif x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), path


# ---------------------------------------------------------------------- #
# twins of tests/test_checkpoint_ft.py
# ---------------------------------------------------------------------- #
def test_save_restore_roundtrip(tmp_path):
    tree = {"a": {"b": torch.arange(6).reshape(2, 3)},
            "c": torch.tensor(3.5)}
    save_checkpoint(str(tmp_path), 7, tree, meta={"note": "x"})
    assert latest_step(str(tmp_path)) == 7
    out, step, meta = restore_checkpoint(str(tmp_path))
    assert step == 7 and meta["note"] == "x"
    assert torch.equal(out["a"]["b"], torch.arange(6).reshape(2, 3))
    assert float(out["c"]) == 3.5 and out["c"].dtype == torch.float32


def test_corruption_detected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones((4,))})
    # tamper with the arrays file
    d = os.path.join(tmp_path, "step_00000001")
    np.savez(os.path.join(d, "arrays.npz"), w=np.zeros((4,), np.float32))
    with pytest.raises(IOError, match="digest"):
        restore_checkpoint(str(tmp_path))
    assert CheckpointManager(str(tmp_path)).restore_or_none() is None


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((2,), s)})
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(5, {"w": torch.ones((8,))})
    mgr.wait()
    assert latest_step(str(tmp_path)) == 5


def _setup(tmp_path, **tkw):
    api = build_model(CFG)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, **tkw), accum=1, remat=None)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = init_train_state(api.init, tcfg, gen, device="cpu")
    step_fn = TrainProgram(make_train_step(api.loss, tcfg), "cpu")
    mgr = CheckpointManager(str(tmp_path), keep=3)

    def nb(i):
        return lm_batch(CFG, 4, 32, seed=0, step=i, device="cpu")
    return state, step_fn, mgr, nb


def test_resilient_run_survives_injected_failures(tmp_path):
    state, step_fn, mgr, nb = _setup(tmp_path)
    rep = run_resilient(step_fn, state, nb, steps=12, ckpt=mgr, ckpt_every=4,
                        fail_at={6: RuntimeError("pod lost"),
                                 10: RuntimeError("host hang")})
    assert rep.restarts == 2
    assert rep.steps_run >= 12                   # re-ran the lost segments
    assert np.isfinite(rep.final_loss)


@pytest.mark.parametrize("sdtype", ["float32", "int8"])
def test_restart_is_bitwise_deterministic(tmp_path, sdtype):
    """crash+restore must replay the identical loss trajectory (deterministic
    data cursor + step-atomic state): bit for bit here, where the reference
    asks for 1e-6."""
    state, step_fn, mgr, nb = _setup(tmp_path / "a", state_dtype=sdtype)
    rep1 = run_resilient(step_fn, state, nb, steps=8, ckpt=mgr, ckpt_every=2)
    # fresh copy, crash in the middle
    state2, step_fn2, _, _ = _setup(tmp_path / "a", state_dtype=sdtype)
    mgr2 = CheckpointManager(str(tmp_path / "b"), keep=3, async_save=True)
    rep2 = run_resilient(step_fn2, state2, nb, steps=8, ckpt=mgr2,
                         ckpt_every=2, fail_at={5: RuntimeError("boom")})
    assert rep2.restarts == 1
    # steps 1-5, then 5 and 6 again from the step-4 checkpoint, then 7, 8
    assert rep2.history == rep1.history[:5] + rep1.history[4:]


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(ratio=3.0, window=10, grace_steps=2)
    flags = [wd.observe(0.1) for _ in range(5)]
    assert not any(flags)
    assert wd.observe(1.0)                      # 10x median
    assert not wd.observe(0.1)
    assert ResilienceReport().restarts == 0


# ---------------------------------------------------------------------- #
# the format
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sdtype", ["bfloat16", "int8"])
def test_train_state_roundtrip_bit_for_bit(tmp_path, sdtype):
    state, step_fn, _, nb = _setup(tmp_path, state_dtype=sdtype)
    state, _ = step_fn(state, nb(0))
    tree = {"state": state, "bf16_params": {
        k: v.to(torch.bfloat16) for k, v in state["params"].items()
        if isinstance(v, torch.Tensor)}}
    save_checkpoint(str(tmp_path), 1, tree)
    out, step, _ = restore_checkpoint(str(tmp_path))
    assert step == 1
    _assert_bit_equal(tree, out)
    if sdtype == "int8":
        m = out["state"]["opt"]["m"]["embed"]
        assert isinstance(m, Packed8) and m.q.dtype == torch.int8 and \
            m.s.dtype == torch.float32
    manifest = _manifest(os.path.join(tmp_path, "step_00000001"))
    assert manifest["arrays"]["bf16_params/embed"]["dtype"] == "bfloat16"
    with np.load(os.path.join(tmp_path, "step_00000001", "arrays.npz"),
                 allow_pickle=False) as z:             # nothing pickled
        assert z["bf16_params/embed"].dtype == np.uint16
        assert all(z[k].dtype != object for k in z.files)


def test_async_save_snapshots_before_in_place_update(tmp_path):
    """The optimizer writes into the parameters: a save must copy them
    before it returns, in async mode too."""
    state, step_fn, _, nb = _setup(tmp_path)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    saved = {k: v.clone() for k, v in state["params"].items()
             if isinstance(v, torch.Tensor)}
    gate = threading.Event()
    write = mgr._save_sync

    def slow_write(*a):                          # hold the writer back
        gate.wait(10)
        write(*a)
    mgr._save_sync = slow_write
    mgr.save(0, state)
    state, _ = step_fn(state, nb(0))             # in place, while saving
    assert not torch.equal(state["params"]["embed"], saved["embed"])
    gate.set()
    mgr.wait()
    out, _, _ = restore_checkpoint(str(tmp_path))
    for k, v in saved.items():
        assert torch.equal(out["params"][k], v), k


def test_float32_checkpoints_cross_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {"w": rng.normal(size=(4, 300)).astype(np.float32),
                       "b": rng.normal(size=(300,)).astype(np.float32)},
            "opt": {"step": np.array(3, np.int32)}}
    # the JAX package writes, the port reads
    jckpt.save_checkpoint(str(tmp_path / "j"), 3, jax.tree_util.tree_map(
        jnp.asarray, tree))
    out, step, _ = restore_checkpoint(str(tmp_path / "j"))
    assert step == 3
    for k in ("w", "b"):
        np.testing.assert_array_equal(out["params"][k].numpy(),
                                      tree["params"][k])
        assert out["params"][k].dtype == torch.float32
    assert out["opt"]["step"].dtype == torch.int32
    # the port writes the same bytes and digests, and the JAX package reads
    save_checkpoint(str(tmp_path / "t"), 3, jax.tree_util.tree_map(
        torch.from_numpy, tree))
    assert _manifest(tmp_path / "j" / "step_00000003") == \
        _manifest(tmp_path / "t" / "step_00000003")
    back, step, _ = jckpt.restore_checkpoint(str(tmp_path / "t"))
    assert step == 3
    for k in ("w", "b"):
        assert back["params"][k].dtype == np.float32
        np.testing.assert_array_equal(back["params"][k], tree["params"][k])


def test_reference_fault_int8_state_cannot_be_restored(tmp_path):
    """The JAX package pickles a Packed8 into an object array and then
    refuses to load it; the port stores q and s and restores them."""
    oc = jopt.OptConfig(state_dtype="int8")
    jtree = {"params": {"w": jnp.ones((4, 300))}}
    jtree["opt"] = jopt.init_opt_state(jtree["params"], oc)
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jtree)
    with pytest.raises(ValueError, match="allow_pickle"):
        jckpt.restore_checkpoint(str(tmp_path / "j"))

    ttree = {"params": {"w": torch.ones((4, 300))}}
    ttree["opt"] = init_opt_state(ttree["params"],
                                  OptConfig(state_dtype="int8"))
    save_checkpoint(str(tmp_path / "t"), 1, ttree)
    out, _, _ = restore_checkpoint(str(tmp_path / "t"))
    _assert_bit_equal(ttree, out)


def test_reference_fault_bfloat16_comes_back_as_bytes(tmp_path):
    """A bfloat16 array comes back from the JAX package's restore as raw
    2-byte voids; the port keeps it bfloat16."""
    jckpt.save_checkpoint(str(tmp_path / "j"), 1,
                          {"x": jnp.ones(2, jnp.bfloat16)})
    out, _, _ = jckpt.restore_checkpoint(str(tmp_path / "j"))
    assert out["x"].dtype == np.dtype("V2")
    assert out["x"][0].tobytes() == b"\x80\x3f"          # 1.0, as bytes

    save_checkpoint(str(tmp_path / "t"), 1,
                    {"x": torch.ones(2, dtype=torch.bfloat16)})
    got, _, _ = restore_checkpoint(str(tmp_path / "t"))
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"], torch.ones(2, dtype=torch.bfloat16))


def test_restore_onto_the_state_device_and_async_errors_surface(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ok"), async_save=True)
    mgr.save(1, {"opt": {"step": torch.tensor(1, dtype=torch.int32)},
                 "params": {"w": torch.ones(3)}})
    out, step, _ = mgr.restore_or_none(device="meta")  # waits for the save
    assert step == 1 and out["params"]["w"].device.type == "meta"
    blocked = tmp_path / "blocked"
    blocked.write_text("a file where the directory should be")
    bad = CheckpointManager(str(blocked), async_save=True)
    bad.save(1, {"w": torch.ones(3)})
    with pytest.raises(OSError):
        bad.wait()
