"""The port's twins of ``examples/quickstart.py``, ``lm_search.py``,
``fleet_serve.py`` and ``chaos_degrade.py``, run with ``--device cpu``.

``lm_search_torch.py`` is host code and prints the JAX example's picks for
the same arguments. ``fleet_serve_torch.py`` and ``chaos_degrade_torch.py``
print the JAX demos' policy, fault and degradation figures, and their
replays the JAX demos' virtual clocks (the reduced Qwen3-0.6B on the CPU;
the published width in bf16 on the card). ``quickstart_torch.py`` runs its
four acts through the kernels' plain versions. Without a card and without
``--device cpu`` the three that touch a device raise before any work."""
import importlib.util
import os
import re
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = os.path.join(ROOT, "examples")

torch.set_num_threads(2)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main(monkeypatch, name, args):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    _example(name).main()


def _untimed(text: str) -> list:
    """The printed lines without their wall-clock readings."""
    text = re.sub(r"in \d+\.\ds \([\d.]+ trials/s\)", "in Ts", text)
    text = re.sub(r"\[\d+\.\ds( search)?\]", "[Ts]", text)
    text = re.sub(r", \d+\.\ds\)", ", Ts)", text)
    return text.splitlines()


@pytest.mark.parametrize("name", ["quickstart_torch", "fleet_serve_torch",
                                  "chaos_degrade_torch"])
def test_an_example_that_touches_a_device_raises_without_a_card(
        monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])


def test_quickstart_on_the_cpu(capsys):
    from repro_torch import kernels
    kernels.reset_launch_counts()
    r = _example("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "quickstart OK" in out and "== 4/4" in out
    assert kernels.launch_counts() == {"act_clip_count": 0,
                                       "act_clip_count_batched": 0,
                                       "block_sparse_matmul": 0,
                                       "conv_igemm": 0}
    assert r["device"] == "cpu" and r["prunable"] > 0
    assert r["stats_forwards"] >= 8          # one per trial at least
    assert r["max_abs_err"] <= 1e-4 and r["max_abs_err_plain"] == 0.0
    assert r["clip_equals_plain"] and 0 < r["clip_zeros"] < 64 * 256
    assert r["loss_sparse"] == pytest.approx(r["loss_dense"], abs=0.5)
    assert 0.0 <= r["best_metrics"]["acc"] <= 1.0


def test_lm_search_prints_the_jax_examples_picks(monkeypatch, capsys):
    args = ["--config", "qwen3_0_6b", "--iters", "10", "--chips", "4",
            "--max-cuts", "8", "--dse-iters", "150"]
    _jax_main(monkeypatch, "lm_search", args)
    want = capsys.readouterr().out
    _example("lm_search_torch").main(args)
    got = capsys.readouterr().out
    assert _untimed(got) == _untimed(want)
    assert "best: acc=" in got and "maxmin: cuts=" in got


def test_fleet_serve_prints_the_jax_demos_figures(monkeypatch, capsys):
    args = ["--requests", "800", "--trials", "8", "--replay-requests", "8"]
    _jax_main(monkeypatch, "fleet_serve", args)
    want = _untimed(capsys.readouterr().out)
    r = _example("fleet_serve_torch").main([*args, "--device", "cpu"])
    got = _untimed(capsys.readouterr().out)
    assert r["twin_identical"] and r["requests"] == 8
    assert got[:-2] == want[:-2]               # trace, static, searched, win
    nums = re.compile(r"(\d+) tokens, (\d+) prefills, (\d+) decode steps")
    assert nums.search(got[-2]).groups() == nums.search(want[-2]).groups()
    assert got[-1] == want[-1] + "; twin-identical=True"


def test_chaos_degrade_prints_the_jax_demos_figures(monkeypatch, capsys):
    args = ["--requests", "600", "--trials", "6", "--replay-requests", "8"]
    _jax_main(monkeypatch, "chaos_degrade", args)
    want = _untimed(capsys.readouterr().out)
    r = _example("chaos_degrade_torch").main([*args, "--device", "cpu"])
    got = _untimed(capsys.readouterr().out)
    assert got[:-1] == want[:-1]               # trace, crash, degrade, search
    tail = re.compile(r"twin-identical=\w+, shed=\d+, rung stalls=\d+")
    assert tail.search(got[-1]).group() == tail.search(want[-1]).group()
    assert r["replay"]["twin_identical"] and r["replay"]["requests"] == 8
    assert r["degrade"]["shed"] <= r["crash"]["shed"]
