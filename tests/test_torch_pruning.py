"""repro_torch.core.pruning against repro.core.pruning: every function on the
same numpy arrays — thresholds, masks and measured fractions equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import pruning as jpr
from repro_torch.core import pruning as tpr

# the suite runs several test processes side by side: a few threads each
# instead of every core each (the shapes here are tiny)
torch.set_num_threads(2)

RNG = np.random.default_rng(0)


def _w(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _same_threshold(got, want):
    """Equal to within one float32 ulp. The port's lerp ``low * lw + high *
    hw`` rounds each product and the sum (three float32 roundings, as eager
    PyTorch does on every device); XLA's CPU backend fuses one multiply into
    the add (an FMA, two roundings), so the JAX value can sit one ulp away.
    The masks the thresholds cut are compared exactly below."""
    np.testing.assert_array_max_ulp(np.asarray(got, np.float32),
                                    np.asarray(want, np.float32), maxulp=1)


SPARSITIES = [0.0, 0.013, 0.25, 0.5, 0.7777, 0.95, 1.0, -0.1, 1.3]


@pytest.mark.parametrize("s", SPARSITIES)
def test_thresholds_equal(s):
    w = _w((37, 53), 1)
    jt = np.asarray(jpr.threshold_for_sparsity(jnp.asarray(w), s))
    tt = tpr.threshold_for_sparsity(torch.from_numpy(w), s).numpy()
    assert tt.dtype == np.float32
    _same_threshold(tt, jt)
    asort = tpr.sorted_abs(torch.from_numpy(w))
    np.testing.assert_array_equal(asort.numpy(),
                                  np.asarray(jpr.sorted_abs(jnp.asarray(w))))
    # the table path is the sorting path, bit for bit
    assert tpr.threshold_for_sparsity_sorted(asort, s).numpy() == tt
    assert tpr.threshold_for_sparsity_sorted(
        asort, np.float32(s)).numpy() == tt


def test_sorted_quantile_matches_jnp_quantile():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 64, 1000, 4097):
        a = np.abs(rng.normal(size=n)).astype(np.float32)
        asort = torch.sort(torch.from_numpy(a)).values
        for q in [0.0, 1.0, 0.5, 1 / 3, 0.999, *rng.uniform(0, 1, 6)]:
            want = np.asarray(jnp.quantile(jnp.asarray(a), np.float32(q)))
            got = tpr.sorted_quantile(asort, np.float32(q)).numpy()
            _same_threshold(got, want)


@pytest.mark.parametrize("s", [0.0, 0.3, 0.62, 0.9])
def test_prune_masks_equal(s):
    w = _w((3, 3, 16, 24), 2)
    jw = np.asarray(jpr.prune_by_sparsity(jnp.asarray(w), s))
    tw = tpr.prune_by_sparsity(torch.from_numpy(w), s)
    np.testing.assert_array_equal(tw.numpy(), jw)
    assert tpr.sparsity_of(tw) == jpr.sparsity_of(jnp.asarray(jw))
    tau = 0.4
    np.testing.assert_array_equal(
        tpr.prune_tensor(torch.from_numpy(w), tau).numpy(),
        np.asarray(jpr.prune_tensor(jnp.asarray(w), tau)))


@settings(max_examples=20, deadline=None)
@given(s=st.floats(0.0, 0.95), n=st.integers(64, 2048))
def test_property_achieved_sparsity_close_to_target(s, n):
    w = torch.from_numpy(RNG.normal(size=(n,)).astype(np.float32))
    assert abs(tpr.sparsity_of(tpr.prune_by_sparsity(w, s)) - s) <= 2.0 / n + 1e-6


@pytest.mark.parametrize("shape", [(256, 256), (300, 200), (3, 3, 64, 160),
                                   (1, 1, 64, 128), (512, 1000)])
@pytest.mark.parametrize("s", [0.0, 0.3, 0.5, 0.77])
def test_tile_prune_equal(shape, s):
    w = _w(shape, 4)
    jw, jf = jpr.tile_prune(jnp.asarray(w), s)
    tw, tf = tpr.tile_prune(torch.from_numpy(w), s)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert float(tf) == float(jf)
    assert tpr.tile_sparsity(tw) == jpr.tile_sparsity(jw)
    if s == 0.0:
        assert torch.equal(tw, torch.from_numpy(w)) and float(tf) == 0.0


def test_tile_prune_small_blocks_and_alignment():
    w = _w((64, 96), 5)
    jw, jf = jpr.tile_prune(jnp.asarray(w), 0.5, bk=16, bn=32)
    tw, tf = tpr.tile_prune(torch.from_numpy(w), 0.5, bk=16, bn=32)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert float(tf) == float(jf) > 0
    t = tw.numpy().reshape(4, 16, 3, 32)
    zero = ~(t != 0).any(axis=(1, 3))
    assert zero.mean() == pytest.approx(float(tf))
    assert tpr.tile_sparsity(tw, 16, 32) == pytest.approx(float(tf))


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 8), rows=st.integers(1, 40), cols=st.integers(1, 24),
       seed=st.integers(0, 1000))
def test_property_nm_prune_equal(n, rows, cols, seed):
    w = np.random.default_rng(seed).normal(size=(rows, cols)).astype(np.float32)
    w[np.random.default_rng(seed + 1).random((rows, cols)) < 0.2] = 0.0
    jw = np.asarray(jpr.nm_prune(jnp.asarray(w), n))
    tw = tpr.nm_prune(torch.from_numpy(w), n).numpy()
    np.testing.assert_array_equal(tw, jw)


def test_nm_prune_ties_break_to_the_lower_row():
    w = np.ones((16, 3), np.float32)
    w[8:] = -1.0                                # |w| all equal: pure ties
    for n in (1, 3, 8):
        jw = np.asarray(jpr.nm_prune(jnp.asarray(w), n))
        tw = tpr.nm_prune(torch.from_numpy(w), n).numpy()
        np.testing.assert_array_equal(tw, jw)
        assert (tw[:n] != 0).all() and (tw[n:8] == 0).all()
    w4 = _w((3, 3, 8, 5), 6)
    np.testing.assert_array_equal(
        tpr.nm_prune(torch.from_numpy(w4), 2).numpy(),
        np.asarray(jpr.nm_prune(jnp.asarray(w4), 2)))


def test_nm_keep_and_grid_equal():
    for s in [0.0, 0.1, 0.125, 0.5, 0.6, 0.874, 0.875, 0.99, 1.0, 1.5, -1.0]:
        want = float(jpr.nm_keep_for_sparsity(s))
        assert float(tpr.nm_keep_for_sparsity(s)) == want
        assert float(tpr.nm_keep_for_sparsity(np.float32(s))) == want
        assert float(tpr.nm_keep_for_sparsity(torch.tensor(s))) == want
        assert tpr.nm_sparsity_grid(s) == jpr.nm_sparsity_grid(s)
    assert tpr.PATTERNS == jpr.PATTERNS and tpr.NM_M == jpr.NM_M


@settings(max_examples=10, deadline=None)
@given(tile_frac=st.floats(0.0, 0.9), n=st.integers(1, 8),
       seed=st.integers(0, 1000))
def test_property_hierarchical_equal(tile_frac, n, seed):
    w = np.random.default_rng(seed).normal(size=(256, 256)).astype(np.float32)
    jw, jf = jpr.hierarchical_prune(jnp.asarray(w), tile_frac, n)
    tw, tf = tpr.hierarchical_prune(torch.from_numpy(w), tile_frac, n)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert float(tf) == float(jf)


def test_act_realize_pattern_and_gaussian_model_equal():
    s_w, s_a = np.array([0.0, 0.3, 0.9]), np.array([0.5, 0.1, 0.0])
    np.testing.assert_array_equal(tpr.act_realize_pattern(s_w, s_a),
                                  jpr.act_realize_pattern(s_w, s_a))
    for s in (0.0, 0.2, 0.5, 0.93):
        assert tpr.tau_for_act_sparsity(s) == jpr.tau_for_act_sparsity(s)
        assert tpr.act_sparsity_gaussian(s, 0.7) == \
            jpr.act_sparsity_gaussian(s, 0.7)


def test_prune_params_equal():
    tree = {"blocks": {"attn": {"wq": _w((4, 16, 16), 7)},
                       "norm": _w((4, 16), 8)},
            "fc": {"w": _w((16, 10), 9), "b": _w((10,), 10)}}
    spars = {"blocks/attn/wq": np.array([0.1, 0.5, 0.0, 0.9]), "fc/w": 0.4,
             "fc/b": 0.5}
    import jax
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = tpr._unflatten({k: torch.from_numpy(v)
                            for k, v in tpr._flatten(tree).items()})
    jp, ja = jpr.prune_params(jtree, spars, match=jpr.default_prunable)
    tp, ta = tpr.prune_params(ttree, spars, match=tpr.default_prunable)
    assert ja == ta and set(ja) == {"blocks/attn/wq", "fc/w"}
    jflat, tflat = jpr._flatten(jp), tpr._flatten(tp)
    assert sorted(jflat) == sorted(tflat)   # jax sorts dict keys
    for k in jflat:
        np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(jflat[k]))


def test_default_prunable_and_calibration_helpers():
    for path in ("blocks/attn/wq", "blocks/mlp/w_gate", "final_norm/scale",
                 "embed", "blocks/ln1", "fc/w", "blocks/moe/router"):
        assert tpr.default_prunable(path) == jpr.default_prunable(path)
    out = tpr.calibrate_activation_sparsity(
        lambda: {"a": torch.tensor(0.25), "b": 0.5})
    assert out == {"a": 0.25, "b": 0.5}
