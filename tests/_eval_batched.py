"""Shared by ``test_torch_eval_batched.py`` and
``test_torch_eval_batched_tiled.py``: one round of proposals, and the
comparison of the port's batched pass with the JAX package's."""
import numpy as np
import pytest


def batched_round(B: int, L: int):
    """B proposals of per-layer targets (some layers left dense) and
    pattern codes in which every pattern occurs in every proposal."""
    rng = np.random.default_rng(3)
    s_w = rng.uniform(0.0, 0.9, (B, L)).astype(np.float32)
    s_a = rng.uniform(0.0, 0.8, (B, L)).astype(np.float32)
    s_w[0, ::5] = 0.0
    s_a[1, ::4] = 0.0
    codes = (np.arange(L)[None, :] + np.arange(B)[:, None]) % 4
    return s_w, s_a, codes


def assert_passes_agree(got, want):
    """The port's batched pass against the reference's: s_w, s_a and the
    tile fraction within rel 1e-3 / abs 1e-6, the accuracy within one of
    the 8 images."""
    gacc, gsw, gsa, gswt = got
    jacc, jsw, jsa, jswt = want
    assert gsw.shape == gsa.shape == gswt.shape == jsw.shape
    assert gsw.dtype == gsa.dtype == np.float32
    assert gsw == pytest.approx(jsw, rel=1e-3, abs=1e-6)
    assert gsa == pytest.approx(jsa, rel=1e-3, abs=1e-6)
    assert gswt == pytest.approx(jswt, rel=1e-3, abs=1e-6)
    assert np.all(np.abs(gacc - jacc) <= 1.0 / 8 + 1e-6)
