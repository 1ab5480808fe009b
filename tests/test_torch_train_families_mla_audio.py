"""One train step of the port against the JAX package's: DeepSeek-V3 (MLA,
MoE, the MTP head) and whisper (the encoder-decoder). What is compared, and the tolerances, are in
test_torch_train_families.py."""
import pytest

from _train_parity import check_train_step

CASES = [("deepseek-v3-671b", None, 1), ("whisper-base", None, 1)]


@pytest.mark.parametrize("arch,remat,accum", CASES,
                         ids=[f"{a}-{r}-{n}" for a, r, n in CASES])
def test_train_step_matches_reference(arch, remat, accum):
    check_train_step(arch, remat, accum)
