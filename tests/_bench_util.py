"""Helpers shared by the test files that hold the port's benchmark twins
(``benchmarks_torch/``) against the JAX package's scripts (``benchmarks/``):
the guard that no run writes under ``experiments/``, and payload
comparison apart from wall-clock fields."""
import hashlib
import json
import os

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXPERIMENTS = os.path.join(ROOT, "experiments")


def _digest(d: str) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture(scope="module", autouse=True)
def experiments_untouched():
    """No file under ``experiments/`` is written, added or removed while
    the module's tests run."""
    before = _digest(EXPERIMENTS)
    yield
    assert _digest(EXPERIMENTS) == before


def load(path):
    with open(path) as f:
        return json.load(f)


def jsonable(tree):
    """``tree`` as it reads back from the JSON file a script writes."""
    return json.loads(json.dumps(tree))


def without(tree, keys):
    """``tree`` with every dict entry named in ``keys`` dropped, at any
    depth."""
    if isinstance(tree, dict):
        return {k: without(v, keys) for k, v in tree.items()
                if k not in keys}
    if isinstance(tree, list):
        return [without(v, keys) for v in tree]
    return tree
