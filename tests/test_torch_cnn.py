"""repro_torch.models.cnn against repro.models.cnn: the same numpy images and
JAX-initialised parameters (carried over by ``convert.params_from_jax``) go
through both forwards, for all five paper CNNs at ``reduce_config`` size."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_config as jreduce
from repro.data.synthetic import image_batch as jimage_batch
from repro.models import cnn as jcnn
from repro_torch.configs import PAPER_CNNS, get_config, reduce_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.data.synthetic import image_batch
from repro_torch.models import cnn
from repro_torch.models.common import act_clip, dense_init, softmax_xent

# the suite runs several test processes side by side: a few threads each
# instead of every core each (the shapes here are tiny)
torch.set_num_threads(2)

ARCHS = [c.name for c in PAPER_CNNS]
# conv summation order differs between the two frameworks' CPU kernels
TOL = dict(rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _jax_forwards(arch):
    """Both JAX forwards of one architecture in ONE jitted call (eager JAX
    compiles every primitive on its own, which takes far longer): every
    layer's output of the plain forward, and the logits + stats of the
    clipped forward at fixed taus."""
    jcfg, cfg, jparams, params, images = _setup(arch)
    names = [s.name for s in cnn.build_specs(cfg) if s.prunable]
    rng = np.random.default_rng(2)
    taus = {n: float(rng.uniform(0.0, 0.6)) for n in names}
    taus.pop(names[1])                       # one layer unclipped (tau=None)

    @jax.jit
    def both(p, x):
        return (jcnn.forward(jcfg, p, x, return_intermediates=True),
                jcnn.forward(jcfg, p, x, sparsity=taus, collect_stats=True))

    (jl, jouts), (jl2, jstats) = jax.tree_util.tree_map(
        np.asarray, both(jparams, jnp.asarray(images)))
    return cfg, params, images, names, taus, jl, jouts, jl2, jstats


def _setup(arch, batch=4, seed=0):
    jcfg, cfg = jreduce(jget(arch)), reduce_config(get_config(arch))
    jparams = jcnn.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    images = np.random.default_rng(seed).normal(
        size=(batch, cfg.img_res, cfg.img_res, 3)).astype(np.float32)
    return jcfg, cfg, jparams, params, images


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_configs_match(arch):
    jfull, full = jget(arch), get_config(arch)
    assert dataclasses.asdict(jfull) == dataclasses.asdict(full)
    for jc, c in ((jfull, full), (jreduce(jfull), reduce_config(full))):
        js, ts = jcnn.build_specs(jc), cnn.build_specs(c)
        # the port's spec also carries ``pad``, None: (k - 1) // 2, the
        # reference's one padding
        ours = [dataclasses.asdict(s) for s in ts]
        assert all(d.pop("pad") is None for d in ours)
        assert [dataclasses.asdict(s) for s in js] == ours
        assert [s.macs for s in js] == [s.macs for s in ts]
        assert [s.prunable for s in js] == [s.prunable for s in ts]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_every_layer_matches_jax(arch):
    cfg, params, images, _, _, jl, jouts, _, _ = _jax_forwards(arch)
    tl, touts = cnn.forward(cfg, params, torch.from_numpy(images),
                            return_intermediates=True)
    assert set(jouts) == set(touts)
    for name in jouts:
        np.testing.assert_allclose(touts[name].numpy(),
                                   np.asarray(jouts[name]), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    plain = cnn.forward(cfg, params, torch.from_numpy(images))
    assert torch.equal(plain, tl)


@pytest.mark.parametrize("arch", ARCHS)
def test_clipped_stats_forward_matches_jax(arch):
    cfg, params, images, names, taus, _, _, jl, jstats = _jax_forwards(arch)
    tl, tstats = cnn.forward(cfg, params, torch.from_numpy(images),
                             sparsity=taus, collect_stats=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert list(tstats) == names and set(jstats) == set(names)
    # an activation within rounding of tau may fall on the other side
    np.testing.assert_allclose([float(tstats[n]) for n in names],
                               [float(jstats[n]) for n in names], atol=1e-3)
    # the stats path (clip + count in one pass) leaves the logits as the
    # plain clipped forward has them
    assert torch.equal(tl, cnn.forward(cfg, params, torch.from_numpy(images),
                                       sparsity=taus))


def test_maxpool_same_padding_follows_xla_on_even_and_odd_sizes():
    for size in (7, 8, 15, 16):
        x = np.random.default_rng(size).normal(
            size=(2, size, size, 3)).astype(np.float32)
        want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                     (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
        cfg = dataclasses.replace(get_config("resnet18"), img_res=4 * size)
        spec = [s for s in cnn.build_specs(cfg) if s.kind == "pool"][0]
        (t, b) = cnn._same_pads(size, spec.k, spec.stride)
        xp = torch.nn.functional.pad(
            torch.from_numpy(x).permute(0, 3, 1, 2), (t, b, t, b),
            value=float("-inf"))
        got = torch.nn.functional.max_pool2d(xp, 3, 2).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cnn._same_pads(112, 3, 2) == (0, 1)


def test_depthwise_and_hwio_layouts():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 9, 6)).astype(np.float32)
    for groups, wshape in ((1, (3, 3, 6, 5)), (6, (3, 3, 1, 6))):
        w = rng.normal(size=wshape).astype(np.float32)
        for stride in (1, 2):
            want = jax.lax.conv_general_dilated(
                jnp.asarray(x), jnp.asarray(w), (stride, stride),
                [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
                feature_group_count=groups)
            got = cnn._conv(torch.from_numpy(x), torch.from_numpy(w), stride,
                            1, groups)
            assert got.is_contiguous()
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_and_softmax_xent_match_jax():
    from repro.models.transformer import softmax_xent as jxent
    jcfg, cfg, jparams, params, images = _setup("resnet18", batch=6, seed=3)
    labels = np.random.default_rng(4).integers(0, cfg.num_classes, size=6)
    jl, _ = jcnn.loss(jcfg, jparams, {"images": jnp.asarray(images),
                                      "labels": jnp.asarray(labels)})
    tl, m = cnn.loss(cfg, params, {"images": torch.from_numpy(images),
                                   "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    assert float(m["xent"]) == float(tl)
    logits = np.random.default_rng(5).normal(size=(3, 7, 11)).astype(np.float32)
    lab = np.random.default_rng(6).integers(0, 11, size=(3, 7))
    np.testing.assert_allclose(
        softmax_xent(torch.from_numpy(logits), torch.from_numpy(lab)).numpy(),
        np.asarray(jxent(jnp.asarray(logits), jnp.asarray(lab))),
        rtol=1e-6, atol=1e-6)


def test_common_act_clip_matches_jax():
    from repro.models.common import act_clip as jclip
    x = np.random.default_rng(0).normal(size=(5, 17)).astype(np.float32)
    assert act_clip(torch.from_numpy(x), None).numpy() is not None
    for tau in (0.0, 0.3, 1.5):
        np.testing.assert_array_equal(
            act_clip(torch.from_numpy(x), tau).numpy(),
            np.asarray(jclip(jnp.asarray(x), tau)))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_scale(arch):
    jcfg, cfg, jparams, _, _ = _setup(arch)
    gen = torch.Generator().manual_seed(0)
    params = cnn.init_params(cfg, gen, device="cpu")
    jnp_params = jax.tree_util.tree_map(np.asarray, jparams)
    assert set(params) == set(jnp_params)
    for name, p in params.items():
        for k, v in p.items():
            assert tuple(v.shape) == jnp_params[name][k].shape, (name, k)
            assert v.dtype == torch.float32
            if k.startswith("b"):
                assert float(v.abs().max()) == 0.0
    # same seed, same weights; LeCun scale over the contracted axis
    again = cnn.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert all(torch.equal(params[n][k], again[n][k])
               for n in params for k in params[n])
    w = dense_init(torch.Generator().manual_seed(1), (3, 3, 64, 256),
                   scale=1.0 / 3, device="cpu")
    assert abs(float(w.std()) - (1.0 / 3) / 8.0) < 2e-3


def test_convert_round_trip():
    _, _, jparams, params, _ = _setup("mobilenetv3s")
    back = params_to_jax(params)
    for n, p in jax.tree_util.tree_map(np.asarray, jparams).items():
        for k, v in p.items():
            np.testing.assert_array_equal(back[n][k], v)
            assert back[n][k].dtype == v.dtype


def test_image_batch_contract():
    cfg = reduce_config(get_config("resnet18"))
    jb = jimage_batch(jreduce(jget("resnet18")), 5, seed=3, step=2)
    b = image_batch(cfg, 5, seed=3, step=2, device="cpu")
    assert tuple(b["images"].shape) == tuple(jb["images"].shape)
    assert tuple(b["labels"].shape) == tuple(jb["labels"].shape)
    assert b["images"].dtype == torch.float32
    assert int(b["labels"].min()) >= 0 and \
        int(b["labels"].max()) < cfg.num_classes
    # a pure function of (seed, step); other steps give other batches
    b2 = image_batch(cfg, 5, seed=3, step=2, device="cpu")
    assert torch.equal(b["images"], b2["images"])
    b3 = image_batch(cfg, 5, seed=3, step=3, device="cpu")
    assert not torch.equal(b["images"], b3["images"])
    # same class -> same prototype: images of one class correlate
    big = image_batch(cfg, 64, seed=0, step=0, device="cpu", n_classes=2)
    m0 = big["images"][big["labels"] == 0].mean(0)
    m1 = big["images"][big["labels"] == 1].mean(0)
    assert float((m0 - m1).abs().mean()) > 0.5


def test_sgd_warm_up_lowers_the_loss():
    from repro_torch.search_run import trained_cnn
    cfg = reduce_config(get_config("resnet18"))
    p0 = trained_cnn(cfg, steps=0, device="cpu")
    p1 = trained_cnn(cfg, steps=12, lr=2e-3, device="cpu")
    batch = image_batch(cfg, 16, seed=0, step=0, device="cpu")
    with torch.no_grad():
        l0 = float(cnn.loss(cfg, p0, batch)[0])
        l1 = float(cnn.loss(cfg, p1, batch)[0])
    assert np.isfinite(l1) and l1 < l0
