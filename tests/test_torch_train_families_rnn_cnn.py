"""One train step of the port against the JAX package's: RWKV6, Zamba2
(Mamba2 + the shared attention block) and ResNet-18 at img_res 32. What is
compared, and the tolerances, are in test_torch_train_families.py."""
import pytest

from _train_parity import check_train_step

CASES = [("rwkv6-1.6b", None, 1), ("zamba2-1.2b", None, 1),
         ("resnet18", None, 1)]


@pytest.mark.parametrize("arch,remat,accum", CASES,
                         ids=[f"{a}-{r}-{n}" for a, r, n in CASES])
def test_train_step_matches_reference(arch, remat, accum):
    check_train_step(arch, remat, accum)
