"""The port TPE's compiled squared-distance sums (``core/_tpe_ckernel``)
against numpy's expression, bit for bit: the dims cover numpy's
``pairwise_sum`` branches (plain loop under 8 terms, eight accumulators up
to 128, the recursive split above), and the points carry ties and zero
gaps. Then the numpy fallback, and the counts ``hass_search`` reads."""
import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core import _dse_ckernel, _tpe_ckernel, tpe
from repro_torch.core.hass import hass_search

needs_cc = pytest.mark.skipif(_dse_ckernel._compiler() is None,
                              reason="no C compiler on this host")


def _points(n, m, d, seed):
    """TPE-like inputs: candidates and components on a 0.05 grid (ties),
    a candidate on a component and two equal components (zero gaps), and
    bandwidths clipped as ``TPE._bw`` clips them."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(0.0, 0.9, (n, d)) / 0.05) * 0.05
    p = np.round(rng.uniform(0.0, 0.9, (m, d)) / 0.05) * 0.05
    p[0] = x[0]
    if m > 1:
        p[1] = p[0]
        x[1, : d // 2] = p[1, : d // 2]
    bw = np.clip(rng.exponential(0.2, (m, d)), 0.02 * 0.9, 0.7 * 0.9)
    return x, p, bw


def _numpy_sums(x, p, bw):
    return np.sum(((x[:, None] - p[None]) / bw[None]) ** 2, -1)


@needs_cc
@pytest.mark.parametrize("m", [1, 2, 95])
@pytest.mark.parametrize("d", [1, 7, 8, 9, 42, 66, 128, 129, 300])
def test_compiled_sums_equal_numpys_bit_for_bit(d, m):
    x, p, bw = _points(48, m, d, seed=1000 * d + m)
    got = _tpe_ckernel.sq_dist_sums(x, p, bw)
    assert got is not None and got.shape == (48, m)
    assert np.array_equal(got, _numpy_sums(x, p, bw))
    assert np.all(got[0, 0] == 0.0)


@needs_cc
def test_without_the_library_log_kde_runs_numpy_and_counts_it(monkeypatch):
    t = tpe.TPE(lo=np.zeros(66), hi=np.full(66, 0.9))
    x, p, bw = _points(48, 72, 66, seed=3)
    before = tpe.kde_engine_stats()
    native = t._log_kde(x, p, bw)
    mid = tpe.kde_engine_stats()
    monkeypatch.setattr(_tpe_ckernel, "get_lib", lambda: None)
    assert _tpe_ckernel.sq_dist_sums(x, p, bw) is None
    fallback = t._log_kde(x, p, bw)
    after = tpe.kde_engine_stats()
    assert np.array_equal(native, fallback)
    assert np.array_equal(tpe._sq_dist_sums(x, p, bw), _numpy_sums(x, p, bw))
    assert mid["tpe.kde_native"] - before["tpe.kde_native"] == 1
    assert mid["tpe.kde_numpy"] == before["tpe.kde_numpy"]
    assert after["tpe.kde_numpy"] - mid["tpe.kde_numpy"] == 1
    assert after["tpe.kde_native"] == mid["tpe.kde_native"]


@needs_cc
def test_hass_search_records_the_kde_engine(tmp_path):
    def evaluate(x):
        return {"acc": -float(np.sum((x - 0.4) ** 2)), "spa": 0.0}

    tracer = obs.Tracer()
    path = tmp_path / "run.jsonl"
    before = tpe.kde_engine_stats()
    with obs.use_tracer(tracer), obs.FlightRecorder(str(path)) as rec:
        hass_search(evaluate, 6, iters=24, seed=2, hardware_aware=False,
                    batch_size=8, recorder=rec)
    calls = tpe.kde_engine_stats()["tpe.kde_native"] - before["tpe.kde_native"]
    # rounds 1 and 2 are uniform; round 3 asks 8 members, two KDEs each
    assert calls == 16
    assert tracer.counters["tpe.kde_native"] == calls
    assert tracer.counters["tpe.kde_numpy"] == 0
    run = obs.load_run(str(path))
    assert sum(t["engine"].get("tpe.kde_native", 0)
               for t in run["trials"]) == calls
    assert run["footer"]["totals"]["engine"]["tpe.kde_numpy"] == 0
