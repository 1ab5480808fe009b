"""The port's twins of ``benchmarks/fleet_bench.py`` and ``chaos_bench.py``
(``benchmarks_torch/``), on the CPU.

Each section of the JAX script runs at ``smoke=True`` and the port's
``run(smoke=True, device="cpu")`` writes its payload into a temporary
directory; the two agree section for section, bit for bit: the engines,
the policy searches and the fault simulators are numpy copies, and the
real serve path's sections (fleet ``replay``, chaos ``zero_fault`` and
``replay``) read virtual clocks and compare a session with itself, so the
port's reduced Qwen3-0.6B (torch weights from seed 0) gives the JAX
model's figures. Wall-clock fields are left out: the fleet's >= 10x engine
race reads the host's clock, so here its engines race on a shorter trace
for their bit-identity (and against the JAX engine's output) and its gate
runs on fixed readings; ``chip_smoke.py`` runs the 1M-event race on the
card's host."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

from benchmarks import chaos_bench as jchaos  # noqa: E402
from benchmarks import fleet_bench as jfleet  # noqa: E402
from benchmarks_torch import chaos_bench, fleet_bench  # noqa: E402
from _bench_util import (experiments_untouched, jsonable, load,  # noqa: E402,F401
                         without)
from repro_torch import kernels  # noqa: E402

torch.set_num_threads(2)

RACE = {"events": 1_000_000, "heap_s": 2.5, "calendar_s": 0.125,
        "speedup": 20.0, "identical": True}


@pytest.fixture(scope="module")
def fleet_jax():
    policy, winner = jfleet.bench_policy(True)
    return {"engine_identity": jfleet.bench_engine_identity(True),
            "policy": policy, "replay": jfleet.bench_replay(True, winner)}


@pytest.fixture(scope="module")
def fleet_port(tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(fleet_bench, "engine_race", lambda n: dict(RACE))
        kernels.reset_launch_counts()
        payload = fleet_bench.run(smoke=True, device="cpu",
                                  out_dir=str(out))
        assert kernels.launch_counts() == {"act_clip_count": 0,
                                           "block_sparse_matmul": 0}
    return payload, load(out / "fleet_bench_cpu.json")


def test_fleet_bench_payload_equals_the_jax_script_but_for_wall_clock(
        fleet_jax, fleet_port):
    got, written = fleet_port
    assert written == jsonable(got)
    assert without(got, fleet_bench.WALL_CLOCK) == dict(
        fleet_jax, smoke=True, engine_speedup={"events": 1_000_000})
    assert set(got["engine_speedup"]) == \
        {"events", "heap_s", "calendar_s", "speedup"}
    assert len(got["engine_identity"]) == 16
    assert all(r["identical"] for r in got["engine_identity"])
    assert got["replay"]["twin_identical"] and got["replay"]["requests"] == 12


def test_fleet_replay_times_the_serve_path(fleet_port):
    got, _ = fleet_port
    t = got["serve_timing"]["replay"]
    assert t["device"] == "cpu" and t["layers"] == 2 and t["d_model"] == 64
    assert t["decode_steps"] == got["replay"]["decode_steps"] > 0
    assert t["ms_per_decode_step"] == pytest.approx(
        t["serve_s"] * 1e3 / t["decode_steps"])


def test_fleet_engine_race_is_bit_identical_and_the_jax_engines():
    from repro.sim.engine import _simulate_chain as j_chain
    from repro_torch.sim import diurnal_trace
    n = 20_000
    race = fleet_bench.engine_race(n)
    assert race["identical"] and race["events"] == 2 * n
    assert race["speedup"] == race["heap_s"] / race["calendar_s"]
    tr = diurnal_trace(n, 1e-5, 4e-5, 1e7, sizes=8, seed=0)
    rates = [1e-4, 1.3e-4]
    service = [lambda sz: sum(sz / r for r in rates) + 1e5]
    from repro_torch.sim.engine import _simulate_chain
    for eng in ("calendar", "heap"):
        a = _simulate_chain(tr.arrivals, tr.sizes, service, [n + 1],
                            engine=eng)
        b = j_chain(tr.arrivals, tr.sizes, service, [n + 1], engine=eng)
        assert all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(a, b)), eng


@pytest.mark.parametrize("speedup", [10.0, 9.9])
def test_fleet_engine_speedup_gates_at_10x(monkeypatch, speedup):
    monkeypatch.setattr(fleet_bench, "engine_race",
                        lambda n: dict(RACE, events=2 * n, speedup=speedup))
    if speedup < 10.0:
        with pytest.raises(AssertionError, match="speedup regressed"):
            fleet_bench.bench_engine_speedup(True)
    else:
        row = fleet_bench.bench_engine_speedup(True)
        assert row == {"events": 1_000_000, "heap_s": 2.5,
                       "calendar_s": 0.125, "speedup": 10.0}


def test_chaos_bench_payload_equals_the_jax_script(tmp_path):
    want = {"zero_fault": jchaos.bench_zero_fault(True),
            "engine": jchaos.bench_faulted_engines(True),
            "search": jchaos.bench_failure_aware_search(True),
            "degrade": jchaos.bench_degradation(True),
            "replay": jchaos.bench_degraded_replay(True)}
    kernels.reset_launch_counts()
    got = chaos_bench.run(smoke=True, device="cpu", out_dir=str(tmp_path))
    assert kernels.launch_counts() == {"act_clip_count": 0,
                                       "block_sparse_matmul": 0}
    assert load(tmp_path / "chaos_bench_cpu.json") == jsonable(got)
    assert without(got, chaos_bench.WALL_CLOCK) == dict(want, smoke=True)
    assert [r["consumer"] for r in got["zero_fault"]][-1] == "serve"
    assert got["replay"]["switch_stalls"] > 0
    assert set(got["serve_timing"]) == {"zero_fault", "replay"}
