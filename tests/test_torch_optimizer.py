"""repro_torch's optimizers and int8 numerics against repro's.

The learning-rate schedule, the int8 block quantisation of the moments
(``Packed8``), one AdamW step in each optimizer-state dtype, SGD, the
weight-decay mask, and the error-feedback gradient compression, on the same
numpy inputs in both packages. The quantisation is bit-equal: the same
float32 divisions, ``round`` half to even in both. An AdamW step is float32
arithmetic op for op, so parameters and moments agree to 1e-6; an int8
moment's ``q`` is the one place a last-ulp difference can show, as a
neighbouring integer where ``m / scale`` sits on a rounding tie, which the
test counts and bounds.

Also the port's ``DataPipeline`` (the twin of
``test_serve_data.py::test_pipeline_prefetch_and_cursor``) and the import
isolation of the training modules.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as jcoll
from repro.train import optimizer as jopt
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import train_state_from_jax, train_state_to_jax
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import batch_for
from repro_torch.distributed import collectives as coll
from repro_torch.train import optimizer as opt

torch.set_num_threads(2)


def _np(t):
    return t.detach().cpu().numpy()


def test_lr_schedule_matches_reference():
    for oc in (dict(lr=1.0, warmup_steps=10, total_steps=110,
                    min_lr_frac=0.1),
               dict(lr=6e-4, warmup_steps=2, total_steps=16),
               dict(lr=3e-4, warmup_steps=0, total_steps=50)):
        jc, tc = jopt.OptConfig(**oc), opt.OptConfig(**oc)
        for step in range(121):
            ref = float(jopt.lr_at(jc, step))
            got = float(opt.lr_at(tc, step))
            assert got == pytest.approx(ref, rel=1e-6, abs=1e-12), (oc, step)
    # the twin of test_train_loop.py::test_lr_schedule
    oc = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                       min_lr_frac=0.1)
    assert float(opt.lr_at(oc, 0)) == 0.0
    assert float(opt.lr_at(oc, 10)) == pytest.approx(1.0, abs=1e-3)
    assert float(opt.lr_at(oc, 110)) == pytest.approx(0.1, abs=1e-3)


def _quant_inputs():
    rng = np.random.default_rng(0)
    yield "matrix", rng.normal(size=(8, 96)).astype(np.float32), 256
    yield "ragged", (rng.normal(size=(7, 37)) * 1e-3).astype(np.float32), 256
    yield "ragged_block64", rng.standard_t(2, size=(1001,)).astype(
        np.float32), 64
    z = rng.normal(size=(3, 256)).astype(np.float32)
    z[1] = 0.0                                  # one all-zero block
    yield "zero_block", z, 256
    yield "scalar", np.array(2.5, np.float32), 256


@pytest.mark.parametrize("name,x,block", list(_quant_inputs()),
                         ids=[c[0] for c in _quant_inputs()])
def test_quant_dequant_bit_equal(name, x, block):
    jp = jopt._quant(jnp.asarray(x), block)
    tp = opt._quant(torch.from_numpy(x.copy()), block)
    assert tuple(tp.shape) == tuple(jp.shape)
    np.testing.assert_array_equal(_np(tp.q), np.asarray(jp.q))
    np.testing.assert_array_max_ulp(_np(tp.s), np.asarray(jp.s), maxulp=1)
    np.testing.assert_array_equal(_np(opt._dequant(tp)),
                                  np.asarray(jopt._dequant(jp)))
    # the collective's numerics are the same function
    q, s, shape = coll.quantize_int8(torch.from_numpy(x.copy()), block)
    jq, js, jshape = jcoll.quantize_int8(jnp.asarray(x), block)
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    np.testing.assert_array_equal(_np(coll.dequantize_int8(q, s, shape)),
                                  np.asarray(jcoll.dequantize_int8(jq, js,
                                                                   jshape)))


def test_ef_quantize_bit_equal():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 300)).astype(np.float32)
    err = (rng.normal(size=(5, 300)) * 1e-3).astype(np.float32)
    jd, je = jcoll.ef_quantize(jnp.asarray(x), jnp.asarray(err))
    td, te = coll.ef_quantize(torch.from_numpy(x), torch.from_numpy(err))
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_array_equal(_np(te), np.asarray(je))
    assert float(torch.abs(te).sum()) > 0        # the error is carried


def _tree(rng):
    """Matrices (decayed) and vectors (not), one of them ragged for the
    int8 blocks."""
    return {"w": rng.normal(size=(16, 40)).astype(np.float32),
            "blk": {"wq": rng.normal(size=(2, 8, 33)).astype(np.float32),
                    "ln": (1 + 0.1 * rng.normal(size=(33,))).astype(
                        np.float32)},
            "b": rng.normal(size=(40,)).astype(np.float32)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("sdtype", ["float32", "bfloat16", "int8"])
def test_adamw_step_matches_reference(sdtype):
    """One AdamW step from the same (non-zero) state: the state after one
    reference step with other gradients, converted to the port."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    g0, g1 = _tree(rng), _tree(rng)
    # a gradient norm above clip_norm, so the clip scale is in play
    g1 = jax.tree_util.tree_map(lambda g: 3.0 * g, g1)
    oc = dict(lr=1e-2, warmup_steps=1, total_steps=10, state_dtype=sdtype,
              quant_block=64)
    jc, tc = jopt.OptConfig(**oc), opt.OptConfig(**oc)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init_opt_state(jp, jc)
    jp, js, _ = jopt.adamw_update(jp, jax.tree_util.tree_map(jnp.asarray, g0),
                                  js, jc)
    state = train_state_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jp, "opt": js}), "cpu")
    jp2, js2, jm = jopt.adamw_update(
        jp, jax.tree_util.tree_map(jnp.asarray, g1), js, jc)
    tp2, ts2, tm = opt.adamw_update(
        state["params"], jax.tree_util.tree_map(torch.from_numpy, g1),
        state["opt"], tc)
    assert int(ts2["step"]) == int(js2["step"]) == 2
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    assert float(tm["grad_norm"]) > tc.clip_norm
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    ref_p, got_p = _flat(jax.tree_util.tree_map(np.asarray, jp2)), \
        _flat(train_state_to_jax(tp2))
    for k in ref_p:
        np.testing.assert_allclose(got_p[k], ref_p[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    for mom in ("m", "v"):
        ref, got = _flat(js2[mom]), _flat(ts2[mom])
        for k in ref:
            if sdtype != "int8":
                assert got[k].dtype == {"float32": torch.float32,
                                        "bfloat16": torch.bfloat16}[sdtype]
                np.testing.assert_allclose(
                    _np(got[k].float()), np.asarray(ref[k], np.float32),
                    rtol=1e-6 if sdtype == "float32" else 8e-3, atol=1e-9,
                    err_msg=f"{mom}/{k}")
                continue
            q_ref, q_got = np.asarray(ref[k].q), _np(got[k].q)
            # the scale of a moment that several float32 ops made: a few ulp
            np.testing.assert_array_max_ulp(_np(got[k].s),
                                            np.asarray(ref[k].s), maxulp=4)
            # q may differ only by one, where the reference's own quotient
            # moment / scale sits on a rounding tie (x.5 within 1e-3)
            diff = q_got.astype(np.int32) - q_ref.astype(np.int32)
            quot = _ref_quotient(jc, mom, k, js, g1)
            frac = np.abs(quot - np.trunc(quot))
            assert np.all(np.abs(diff) <= 1), f"{mom}/{k}"
            assert np.all(np.abs(frac[diff != 0] - 0.5) < 1e-3), f"{mom}/{k}"
            assert np.count_nonzero(diff) <= 1 + q_ref.size // 1000


def _ref_quotient(jc, mom, path, js, grads):
    """The reference's new moment over its block scale, before rounding:
    adamw_update's arithmetic for one leaf, in JAX."""
    leaves = jax.tree_util.tree_leaves(grads)
    gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(jnp.asarray(g)))
                         for g in leaves))
    scale = jnp.minimum(1.0, jc.clip_norm / (gnorm + 1e-9))
    g = jnp.asarray(_flat(grads)[path]) * scale
    old = jopt._from_state_dtype(_flat(js[mom])[path], jc)
    new = jc.b1 * old + (1 - jc.b1) * g if mom == "m" else \
        jc.b2 * old + (1 - jc.b2) * jnp.square(g)
    flat = new.reshape(-1)
    b = jnp.pad(flat, (0, (-flat.size) % jc.quant_block)).reshape(
        -1, jc.quant_block)
    s = jnp.max(jnp.abs(b), axis=1, keepdims=True) / 127.0 + 1e-12
    return np.asarray(b / s)


def test_sgd_matches_reference():
    rng = np.random.default_rng(4)
    params, g = _tree(rng), _tree(rng)
    oc = dict(lr=0.1, warmup_steps=2, total_steps=20)
    jc, tc = jopt.OptConfig(**oc), opt.OptConfig(**oc)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init_opt_state(jp, jc)
    state = train_state_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jp, "opt": js}), "cpu")
    for _ in range(3):
        jp, js, _ = jopt.sgd_update(jp, jax.tree_util.tree_map(jnp.asarray, g),
                                    js, jc)
        opt.sgd_update(state["params"], jax.tree_util.tree_map(
            torch.from_numpy, g), state["opt"], tc)
    ref, got = _flat(jax.tree_util.tree_map(np.asarray, jp)), \
        _flat(train_state_to_jax(state["params"]))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7)


def test_weight_decay_mask_excludes_vectors():
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    grads = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    oc = opt.OptConfig(lr=1.0, weight_decay=0.1, warmup_steps=0,
                       total_steps=10)
    st = opt.init_opt_state(params, oc)
    p2, _, _ = opt.adamw_update(params, grads, st, oc)
    assert float(torch.max(torch.abs(p2["b"] - 1.0))) < 1e-6   # no decay
    assert float(torch.max(torch.abs(p2["w"] - 1.0))) > 1e-3   # decay


def test_update_is_in_place_and_state_keeps_its_form():
    params = {"w": torch.randn((4, 300), generator=torch.Generator()
                               .manual_seed(0))}
    oc = opt.OptConfig(lr=1e-2, warmup_steps=0, state_dtype="int8")
    st = opt.init_opt_state(params, oc)
    w, q = params["w"], st["m"]["w"].q
    before = w.clone()
    p2, st2, _ = opt.adamw_update(params, {"w": torch.ones_like(w)}, st, oc)
    assert p2["w"] is w and st2["m"]["w"].q is q
    assert not torch.equal(w, before)
    assert isinstance(st2["v"]["w"], opt.Packed8)
    assert st2["step"].dtype == torch.int32 and int(st2["step"]) == 1


def test_pipeline_prefetch_and_cursor():
    """Twin of test_serve_data.py::test_pipeline_prefetch_and_cursor."""
    cfg = reduce_config(get_config("qwen3-0.6b"))
    shape = ShapeConfig("t", 16, 4, "train")
    p1 = DataPipeline(cfg, shape, seed=5, start_step=0, device="cpu",
                      prefetch=2)
    batches = [next(p1) for _ in range(3)]
    assert p1.step == 3
    p1.close()
    assert not p1._thread.is_alive()             # close() ended the thread
    for i, b in enumerate(batches):              # prefetch keeps the order
        ref = batch_for(cfg, shape, seed=5, step=i, device="cpu")
        assert torch.equal(b["tokens"], ref["tokens"])
        assert torch.equal(p1.batch_at(i)["tokens"], ref["tokens"])
    # resume from step 2 reproduces batch index 2
    p2 = DataPipeline(cfg, shape, seed=5, start_step=2, device="cpu",
                      prefetch=0)
    assert torch.equal(batches[2]["tokens"], next(p2)["tokens"])
    assert p2._thread is None


def test_entry_points_default_to_the_card():
    from repro_torch.train.train_loop import TrainConfig, init_train_state
    from repro_torch.models import build_model
    cfg = reduce_config(get_config("qwen3-0.6b"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataPipeline(cfg, ShapeConfig("t", 16, 4, "train"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(build_model(cfg).init, TrainConfig(),
                         torch.Generator())


def test_training_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch.train.optimizer, repro_torch.train.train_loop\n"
        "import repro_torch.train.checkpoint\n"
        "import repro_torch.train.fault_tolerance\n"
        "import repro_torch.data.pipeline, repro_torch.convert\n"
        "import repro_torch.distributed.collectives\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("sdtype", ["float32", "bfloat16", "int8"])
def test_train_state_converts_both_ways(sdtype):
    """A JAX train state (params, opt m/v/step, ef) -> the port -> back:
    every array bit for bit, a Packed8 rebuilt from its q, s and shape."""
    from repro.train.train_loop import TrainConfig as JTC, init_train_state
    rng = np.random.default_rng(5)
    params = _tree(rng)
    jstate = init_train_state(lambda k: jax.tree_util.tree_map(
        jnp.asarray, params), JTC(opt=jopt.OptConfig(state_dtype=sdtype),
                                  compress_grads=True), None)
    jstate["opt"] = jopt.adamw_update(
        jstate["params"], jax.tree_util.tree_map(jnp.asarray, _tree(rng)),
        jstate["opt"], jopt.OptConfig(state_dtype=sdtype))[1]
    tstate = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                  "cpu")
    assert tstate["opt"]["step"].dtype == torch.int32
    back = train_state_to_jax(tstate)
    for mom in ("m", "v"):
        for k, ref in _flat(jstate["opt"][mom]).items():
            got = _flat(back["opt"][mom])[k]
            if sdtype == "int8":
                assert isinstance(_flat(tstate["opt"][mom])[k], opt.Packed8)
                rebuilt = jopt.Packed8(got.q, got.s, got.shape)
                np.testing.assert_array_equal(rebuilt.q, np.asarray(ref.q))
                np.testing.assert_array_equal(rebuilt.s, np.asarray(ref.s))
                assert rebuilt.shape == ref.shape
            else:
                np.testing.assert_array_equal(
                    np.asarray(jnp.asarray(got, ref.dtype)), np.asarray(ref))
    for k, ref in _flat(jstate["params"]).items():
        np.testing.assert_array_equal(_flat(back["params"])[k],
                                      np.asarray(ref))
    assert int(back["opt"]["step"]) == 1 and "ef" in back


def test_pipeline_worker_error_reaches_the_caller():
    cfg = reduce_config(get_config("qwen3-0.6b"))
    pipe = DataPipeline(cfg, ShapeConfig("t", 16, 4, "train"), device="cpu",
                        prefetch=2)

    def broken(step):
        raise ValueError(f"no batch {step}")
    pipe._host_batch = broken
    with pytest.raises(ValueError, match="no batch 0"):
        next(pipe)
    pipe.close()
    assert not pipe._thread.is_alive()
