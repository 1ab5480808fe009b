"""One train step of the port against the JAX package's with remat "full"
and gradient accumulation over 2 microbatches, on the dense (Qwen3-0.6B)
and MoE (Mixtral) configs, against the reference's ``make_train_step``.
What is compared, and the tolerances, are in
test_torch_train_families.py."""
import pytest

from _train_parity import check_train_step

CASES = [("qwen3-0.6b", "full", 2), ("mixtral-8x7b", "full", 2)]


@pytest.mark.parametrize("arch,remat,accum", CASES,
                         ids=[f"{a}-{r}-{n}" for a, r, n in CASES])
def test_train_step_matches_reference(arch, remat, accum):
    check_train_step(arch, remat, accum)
