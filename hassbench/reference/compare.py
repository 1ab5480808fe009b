"""The numbers that decide ``correct``: how far a candidate's answers (the
program's, or the control's) lie from the reference's, over the same
proposals.

* ``s_w_mismatch`` — (proposal, layer) pairs whose count of pruned weights
  differs from the reference's: the pruner, compared exactly. A share
  reported in float32 is read back as the count it stands for
  (``counts``): on the card the program divides by multiplying with the
  float32 reciprocal, one rounding off a true quotient.
* ``acc_mismatch`` — proposals whose accuracy proxy (the count of images
  that keep the dense top class) the reference cannot reach by moving
  images whose top-class margin lies within the rounding band
  (``forward.BAND``, relative to the image's largest |logit|): exact to
  rounding. An exact tie of all logits (every input clipped away) is made
  the same way in every summation order, so it cannot move.
* ``s_a_apart`` — the share of (proposal, layer) pairs whose clipped-input
  zero count lies outside the reference's band (the counts that
  activations within the rounding band of the clip threshold could give):
  the clip-and-count kernel and the forward that makes its inputs. A
  share of pairs, not the widest gap of one: where one activation is the
  last left at its position at an expansion layer's input, its clip
  decision (within rounding of tau in a rare pair) decides whether every
  channel there is exactly zero, and the depthwise layer spreads that
  over its window, so one rounding moves ~10^3 zero counts at the next
  projection's input; a fault of the pass moves most pairs.
* ``s_a_layer_apart`` — the same, by layer: the largest share of the
  proposals whose count at one layer lies outside the band. A fault
  confined to one layer, or to one slot of a round at a few layers, is
  too thin a share of all pairs to show in ``s_a_apart``; at its layer
  it moves every proposal, or one in eight.
* ``hw_gap`` — the widest relative gap of the Eq. 6 terms (``spa``,
  ``thr``, ``thr_norm``, ``dsp``, ``eff``) from the reference's performance
  model and DSE on the candidate's own measured sparsities.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from hassbench.reference.forward import BAND

HW_KEYS = ("spa", "thr", "thr_norm", "dsp", "eff")


def acc_margin_gap(acc: float, logits: np.ndarray, dense_pred: np.ndarray
                   ) -> float:
    """``logits`` (N, classes) of the reference for one proposal."""
    N = logits.shape[0]
    if not math.isfinite(float(acc)):
        return math.inf
    k = int(round(float(acc) * N))
    agree = logits.argmax(-1) == dense_pred
    k_ref = int(agree.sum())
    if k == k_ref:
        return 0.0
    idx = np.arange(N)
    z = logits.astype(np.float64)
    other = z.copy()
    other[idx, dense_pred] = -np.inf
    top = z[idx, dense_pred]
    margin = np.abs(top - other.max(-1)) / \
        np.maximum(np.abs(z).max(-1), 1e-30)
    # an exact tie (all logits equal where every input was clipped away)
    # is made the same way in every summation order: no rounding flips it
    margin[top == other.max(-1)] = np.inf
    cands = np.sort(margin[~agree] if k > k_ref else margin[agree])
    need = abs(k - k_ref)
    return float(cands[need - 1]) if need <= len(cands) else math.inf


def counts(shares: np.ndarray, numel: np.ndarray) -> np.ndarray:
    """(B, L) float32 shares of ``numel`` (L,) elements -> the counts they
    stand for (exact while a share is within a few roundings of count /
    numel and numel < 2**22)."""
    return np.rint(np.asarray(shares, np.float64) * numel).astype(np.int64)


def device_numbers(cand: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
                   dense_pred: np.ndarray) -> Dict[str, float]:
    """``cand`` / ``ref``: ``acc`` (B,), ``w_zeros``, ``a_zeros`` (B, L);
    ``ref`` also ``a_band`` (B, L, 2) and ``logits`` (B, N, classes)."""
    c = cand["a_zeros"]
    lo, hi = ref["a_band"][..., 0], ref["a_band"][..., 1]
    outside = (c < lo) | (c > hi)
    return {
        "s_w_mismatch": int((cand["w_zeros"] != ref["w_zeros"]).sum()),
        "acc_mismatch": sum(acc_margin_gap(a, z, dense_pred) > BAND
                            for a, z in zip(cand["acc"], ref["logits"])),
        "s_a_apart": float(outside.mean()),
        "s_a_layer_apart": float(outside.mean(0).max()),
    }


def hw_number(cand: Sequence[Dict[str, float]],
              ref: Sequence[Dict[str, float]]) -> float:
    gap = 0.0
    for c, r in zip(cand, ref):
        for key in HW_KEYS:
            d = abs(float(c[key]) - r[key])
            if not math.isfinite(d):
                return math.inf
            if d:
                gap = max(gap, d / max(abs(r[key]), 1e-30))
    return gap


def numbers(cand_dev, ref_dev, dense_pred, cand_hw: List[dict],
            ref_hw: List[dict]) -> Dict[str, float]:
    return {**device_numbers(cand_dev, ref_dev, dense_pred),
            "hw_gap": hw_number(cand_hw, ref_hw)}
