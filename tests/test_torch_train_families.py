"""One train step of the port against the JAX package's, for every family.

For each of the ten LM configs at ``reduce_config`` size and ResNet-18 at
``img_res=32``, in float32: the JAX package initialises the train state
(``init_train_state``), ``convert.train_state_from_jax`` carries it over,
and the same numpy batch (JAX's ``lm_batch`` / ``image_batch``) goes
through one AdamW step in both packages (lr 1e-3, ``accum=1``, no remat).
One jitted JAX call per case gives the loss, the gradients and the
parameters after the step. The port must match:

* the loss within relative 1e-5;
* each gradient leaf within 1e-4 x that leaf's max |g| in JAX;
* the parameters after the step where the reference's |g| > 1e-3 x its
  leaf's max |g|, within 1e-6 + lr * eps * (1e-4 * max |g|) / g^2. At
  step 1 Adam moves a parameter by lr * (u + wd * p) with
  u = g / (|g| + eps): a sign for every |g| >> eps, so u carries the
  gradient's error only through eps, by at most eps * |dg| / g^2; 1e-6
  covers the float32 rounding of p itself. Elsewhere (|g| tiny, where u is
  the sign of float32 noise) within 2 * lr + 1e-6, since |u| <= 1.

The dense and MoE configs also take one step with ``remat="full"`` and
``accum=2`` against the reference's ``make_train_step`` (its gradient the
mean of the two microbatches' gradients, taken in JAX as the reference's
scan takes them): ``test_torch_train_families_accum.py``.
"""
import pytest

from _train_parity import check_train_step

# the dense and MoE transformers (the other families are in
# test_torch_train_families_mla_audio.py and _rnn_cnn.py, the accumulation
# steps in _accum.py: one JAX compile per case, spread over four files)
CASES = [(a, None, 1) for a in ("qwen3-0.6b", "qwen2.5-3b", "stablelm-12b",
                                "deepseek-67b", "chameleon-34b",
                                "mixtral-8x7b")]


@pytest.mark.parametrize("arch,remat,accum", CASES,
                         ids=[f"{a}-{r}-{n}" for a, r, n in CASES])
def test_train_step_matches_reference(arch, remat, accum):
    check_train_step(arch, remat, accum)
