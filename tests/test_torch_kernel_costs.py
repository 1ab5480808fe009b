"""repro_torch's pattern decode-cost table (``kernels/kernel_costs.py``)
against the JAX package's.

On the CPU the port's table is the modeled one, and it must serialise to the
same bytes as the JAX package's table with every lowering disabled (the
reference's own modeled fallback, reached by making ``jax.jit`` raise);
the seeded schedules, the config-keyed disk cache and ``decode_factors``
agree too. On the card (tests marked ``cuda``, skipped where there is none)
every probe is a device time, and the table says so; the JAX package is
imported inside the CPU tests' fixtures, so that the card's machine, which
has no JAX, collects this file too:

    PYTHONPATH=src python -m pytest tests/test_torch_kernel_costs.py -m cuda -q
"""
import json
import os
from dataclasses import fields

import numpy as np
import pytest
import torch

from repro_torch.kernels import kernel_costs as kc
from repro_torch.kernels.kernel_costs import (MicrobenchConfig, cache_key,
                                              decode_factors, load_or_measure,
                                              measure)

CFG = MicrobenchConfig(m=128, k=512, n=256, sparsities=(0.5,))
SEED_TABLE = os.path.join(os.path.dirname(__file__), "..", "experiments",
                          "kernel_costs.json")


def _dump(table) -> str:
    return json.dumps(table, indent=1, sort_keys=True) + "\n"


@pytest.fixture(scope="module")
def table():
    return measure(CFG, device="cpu")


@pytest.fixture(scope="module")
def jkc():
    from repro.kernels import kernel_costs
    return kernel_costs


@pytest.fixture
def jax_all_modeled(monkeypatch, jkc):
    """The JAX package's ``measure`` with no lowering available."""
    import jax

    def boom(*a, **k):
        raise RuntimeError("no backend")

    monkeypatch.setattr(jax, "jit", boom)
    return jkc.measure


@pytest.mark.parametrize("kw", [
    dict(m=128, k=512, n=256, sparsities=(0.5,)),
    dict(),
    dict(m=6272, k=2304, n=256),
    dict(m=384, k=1024, n=384, sparsities=(0.1, 0.3, 0.9), seed=5),
    dict(m=256, k=2048, n=512, nm_m=4, sparsities=(0.25, 0.6)),
])
def test_modeled_table_is_byte_identical_to_the_jax_one(jax_all_modeled,
                                                        jkc, kw):
    t = measure(MicrobenchConfig(**kw), device="cpu")
    j = jax_all_modeled(jkc.MicrobenchConfig(**kw))
    assert _dump(t) == _dump(j)
    assert {r["mode"] for lv in t["patterns"].values()
            for r in lv.values()} == {"modeled", "modeled+modeled"}
    assert "unit" not in t and "device" not in t


def test_main_path_config_is_resnet18_layer3():
    assert (kc.MAIN_PATH_CONFIG.m, kc.MAIN_PATH_CONFIG.k,
            kc.MAIN_PATH_CONFIG.n) == (6272, 2304, 256)
    assert cache_key(kc.MAIN_PATH_CONFIG) != cache_key(MicrobenchConfig())


@pytest.mark.parametrize("s", [0.0, 0.25, 0.5, 0.75, 0.95])
@pytest.mark.parametrize("seed", [0, 3])
def test_tile_schedule_bit_equal(jkc, s, seed):
    for cfg_kw in (dict(), dict(m=6272, k=2304, n=256)):
        t = kc._tile_schedule(MicrobenchConfig(**cfg_kw), s,
                              np.random.default_rng((seed, 1)))
        j = jkc._tile_schedule(jkc.MicrobenchConfig(**cfg_kw), s,
                               np.random.default_rng((seed, 1)))
        for a, b in zip(t[:2], j[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert t[2] == j[2]


def test_decode_factors_equal_the_reference_on_the_seed_table(jkc):
    with open(SEED_TABLE) as f:
        seed_table = json.load(f)
    got = decode_factors(seed_table)
    assert got == jkc.decode_factors(seed_table)
    assert got == seed_table["decode_factors"]


def test_committed_card_table_is_the_measured_main_path_table():
    """``experiments/kernel_costs_h100.json`` is what ``measure`` writes on
    the card at the main-path config: every probe a device time, the card
    named, the factors those of its own records."""
    path = os.path.join(os.path.dirname(__file__), "..", kc.DEFAULT_PATH)
    with open(path) as f:
        t = json.load(f)
    assert t["config"] == json.loads(cache_key(kc.MAIN_PATH_CONFIG))
    assert t["unit"] == "ns" and t["device"]["name"].startswith("NVIDIA")
    assert t["dense"]["mode"] == "cuda"
    assert {r["mode"] for lv in t["patterns"].values()
            for r in lv.values()} == {"cuda", "cuda+cuda"}
    assert decode_factors(t) == t["decode_factors"]
    assert all(v >= 1.0 for v in t["decode_factors"].values())


def test_measure_two_runs_identical(table):
    assert measure(CFG, device="cpu") == table


def test_written_json_is_byte_deterministic(tmp_path):
    p1, p2 = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    load_or_measure(p1, CFG, device="cpu")
    load_or_measure(p2, CFG, device="cpu")
    with open(p1, "rb") as f:
        b1 = f.read()
    with open(p2, "rb") as f:
        b2 = f.read()
    assert b1 == b2 and b1.endswith(b"\n")


def test_disk_cache_hit_and_config_mismatch(tmp_path, table):
    p = str(tmp_path / "c.json")
    t1 = load_or_measure(p, CFG, device="cpu")
    mtime = os.path.getmtime(p)
    t2 = load_or_measure(p, CFG, device="cpu")     # cache hit: no rewrite
    assert t2 == t1 == table and os.path.getmtime(p) == mtime
    other = MicrobenchConfig(m=128, k=512, n=256, sparsities=(0.25,))
    t3 = load_or_measure(p, other, device="cpu")   # mismatch: re-measure
    assert t3["config"] == json.loads(cache_key(other))
    with open(p) as f:
        assert json.load(f)["config"] == t3["config"]
    with open(p, "w") as f:                        # corrupt: ignored
        f.write("{not json")
    assert load_or_measure(p, CFG, device="cpu") == t1


def test_a_cpu_request_never_reuses_a_measured_table(tmp_path, table):
    """A table taken on a card (it names the card) is not the modeled table
    a CPU request asks for, even at the same config."""
    p = str(tmp_path / "m.json")
    measured = dict(table, unit="ns",
                    device={"name": "NVIDIA H100 80GB HBM3",
                            "power_limit": "700.00 W"})
    with open(p, "w") as f:
        json.dump(measured, f)
    assert load_or_measure(p, CFG, device="cpu") == table
    with open(p) as f:
        assert "device" not in json.load(f)


def test_path_none_skips_disk(table):
    assert load_or_measure(None, CFG, device="cpu") == table


def test_table_schema(table, jkc):
    assert table["schema"] == kc.SCHEMA_VERSION == jkc.SCHEMA_VERSION
    assert table["config"] == json.loads(cache_key(CFG))
    assert table["dense"]["cycles"] > 0
    assert set(table["patterns"]) == {"unstructured", "nm", "hierarchical",
                                      "activation"}
    for levels in table["patterns"].values():
        for rec in levels.values():
            assert rec["cycles"] > 0 and rec["dense_ref"] > 0
            assert 0.0 <= rec["s_eff"] < 1.0
    for rec in table["patterns"]["activation"].values():
        assert rec["s_eff"] == 0.0
        assert rec["cycles"] == table["dense"]["cycles"]
    rec = table["patterns"]["unstructured"]["0.5000"]
    assert rec["dense_ref"] == table["dense"]["modeled_cycles"]


def test_decode_factors_contract(table):
    f = decode_factors(table)
    assert set(f) == set(table["patterns"])
    assert all(v >= 1.0 for v in f.values())
    assert f["unstructured"] == pytest.approx(1.0, abs=0.2)
    assert f["nm"] > 1.0


def test_seeded_masks_never_empty_a_column():
    cfg = MicrobenchConfig(m=128, k=512, n=256)
    counts, indices, s_real = kc._tile_schedule(cfg, 0.95,
                                                np.random.default_rng(0))
    assert (counts >= 1).all()
    assert 0.0 <= s_real <= 0.95 + 1e-9
    assert indices.shape == (cfg.n // cfg.bn, int(counts.max()))


def test_cache_key_covers_every_config_field(jkc):
    d = json.loads(cache_key(CFG))
    for f in fields(MicrobenchConfig):
        assert f.name in d
    assert d["schema"] == kc.SCHEMA_VERSION
    assert cache_key(CFG) == jkc.cache_key(jkc.MicrobenchConfig(
        m=128, k=512, n=256, sparsities=(0.5,)))


def test_the_card_is_asked_for_by_default_and_raises_without_one():
    """No silent move to the CPU: the default device is the card, and
    without one both entry points raise before they measure anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default measures on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_or_measure(None, CFG, device="cuda")


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probes time the CUDA kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_measured_table(cuda):
    checks = []
    cfg = MicrobenchConfig(m=512, k=1024, n=512)
    t = measure(cfg, device=cuda, checks=checks)
    assert t["unit"] == "ns"
    assert t["device"]["name"] == torch.cuda.get_device_name(cuda)
    assert t["config"] == json.loads(cache_key(cfg))
    modes = {r["mode"] for lv in t["patterns"].values() for r in lv.values()}
    assert t["dense"]["mode"] == "cuda" and modes == {"cuda", "cuda+cuda"}
    # every tile record shares the all-ones tile probe, every N:M record the
    # gather-free product
    unst = t["patterns"]["unstructured"].values()
    assert len({r["dense_ref"] for r in unst}) == 1
    assert all(r["dense_ref"] == t["dense"]["cycles"]
               for r in t["patterns"]["nm"].values())
    assert all(v >= 1.0 for v in t["decode_factors"].values())
    # 3 unstructured + 3 hierarchical tile probes + the all-ones one, 6 N:M
    assert sorted(c["probe"] for c in checks).count("tile") == 7
    assert sorted(c["probe"] for c in checks).count("nm") == 6
    assert max(c["max_abs_err"] for c in checks) <= kc.PROBE_TOL


@pytest.mark.cuda
def test_cuda_cache_is_kept_per_card_name(cuda, tmp_path):
    p = str(tmp_path / "h.json")
    cfg = MicrobenchConfig(m=256, k=512, n=256, sparsities=(0.5,))
    t1 = load_or_measure(p, cfg, device=cuda)
    assert load_or_measure(p, cfg, device=cuda) == t1     # same card: hit
    with open(p) as f:
        other = json.load(f)
    other["device"]["name"] = "some other card"
    with open(p, "w") as f:
        json.dump(other, f)
    t3 = load_or_measure(p, cfg, device=cuda)             # re-measured
    assert t3["device"]["name"] == torch.cuda.get_device_name(cuda)


def test_pattern_compare_prices_the_search_with_the_table():
    """``search_run.pattern_compare`` on a small CNN search (CPU, plain
    kernels): the degenerate axis replays the ``patterns=None`` search trial
    for trial, and the four-pattern arm, priced by a modeled table's
    factors, reports ``meas`` on every trial."""
    from repro_torch.search_run import pattern_compare, search_compare
    p = search_compare(iters=8, img_res=32, seed=0, batch_size=4,
                       device="cpu", train_steps=2)
    factors = measure(kc.MAIN_PATH_CONFIG, device="cpu")["decode_factors"]
    out = pattern_compare(p["ev"], factors, iters=8, batch_size=4)
    assert [(t.x.tolist(), t.score) for t in
            out["unstructured"]["result"].trials] == \
        [(t.x.tolist(), t.score) for t in p["hw_result"].trials]
    trials = out["patterns"]["result"].trials
    assert len(trials) == 8 and all("meas" in t.metrics for t in trials)
    assert out["patterns"]["ev"].pattern_costs == factors
    assert len(out["best_assignment"]) == len(p["ev"].prunable)
