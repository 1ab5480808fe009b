"""repro_torch's fleet layer (``serve/fleet.py``) against the JAX package's,
and the port's ``ServeSession.serve_open_loop`` against the port's own
timing twin ``fleet.open_loop_schedule``.

Twins of the rest of ``test_fleet.py`` (``test_torch_serve.py`` has its
``ServeSession``-only tests): the open-loop clocks of the real session
equal ``open_loop_schedule``'s bit for bit, on bursty arrivals, ragged and
zero decode lengths, deadlines and a degradation schedule, and the port's
``open_loop_schedule`` equals the JAX package's on the same inputs; the
fleet controller's ``FleetReport`` and the autoscale policy search are
equal field for field across the packages, with the reference's own
properties kept.
"""
import numpy as np
import pytest
import torch

from repro.serve import fleet as jfleet
from repro.sim import (autoscale_policy_search as j_policy_search,
                       mmpp_trace as j_mmpp)
from repro.sim.trace import Trace as JTrace
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import build_model
from repro_torch.serve import fleet as tfleet
from repro_torch.serve.fleet import (AutoscalePolicy, FleetReport,
                                     open_loop_schedule, simulate_fleet)
from repro_torch.serve.serve_loop import (Request, ServeSession,
                                          requests_from_trace)
from repro_torch.sim import autoscale_policy_search, mmpp_trace, poisson_trace
from repro_torch.sim.trace import Trace
from test_torch_core import _as_plain

torch.set_num_threads(2)
# the first parallel torch.exp of a CPU process can come out ~1e-4 off in one
# thread's share of the tensor (tools/cpu_exp_first_call.py); this call takes
# that first call
torch.exp(torch.randn((1 << 17,), generator=torch.Generator().manual_seed(0)))
CFG = reduce_config(get_config("qwen3-0.6b"))
KW = dict(batch_slots=4, step_cycles=10.0, prefill_cycles=30.0)


@pytest.fixture(scope="module")
def sess():
    api = build_model(CFG)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    return ServeSession(api, params, batch_slots=2, S_max=32, device="cpu")


def _schedules(arrivals, max_new, **kw):
    """The port's ``open_loop_schedule``, held bit for bit against the JAX
    package's on the same inputs."""
    t = open_loop_schedule(arrivals, max_new, **kw)
    j = jfleet.open_loop_schedule(arrivals, max_new, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(t, j))
    return t


def test_open_loop_schedule_is_exact_timing_twin(sess):
    tr = poisson_trace(10, 5e-3, sizes=[4, 8, 16, 20], seed=1)
    reqs = requests_from_trace(tr, vocab_size=CFG.vocab_size, prompt_len=6,
                               seed=1)
    reqs[3].max_new = 0
    max_new = [r.max_new for r in reqs]
    rep = sess.serve_open_loop(reqs, step_cycles=7.0, prefill_cycles=3.0)
    adm, comp = _schedules(tr.arrivals, max_new, batch_slots=sess.B,
                           step_cycles=7.0, prefill_cycles=3.0)
    assert np.array_equal(rep.admissions, adm)
    assert np.array_equal(rep.completions, comp)
    with pytest.raises(ValueError, match="buckets"):
        open_loop_schedule([0.0], [8], batch_slots=2, step_cycles=1.0,
                           buckets=(8, 20))


def test_simulate_fleet_static_accounting():
    tr = mmpp_trace(200, 1e-4, 5e-3, dwell_base=2e4, dwell_burst=1e4,
                    sizes=[8, 16], seed=0)
    jtr = j_mmpp(200, 1e-4, 5e-3, dwell_base=2e4, dwell_burst=1e4,
                 sizes=[8, 16], seed=0)
    reps = {}
    for r in (1, 3):
        rep = simulate_fleet(tr, AutoscalePolicy.static(r), **KW)
        ref = jfleet.simulate_fleet(jtr, jfleet.AutoscalePolicy.static(r),
                                    **KW)
        assert _as_plain(rep) == _as_plain(ref)
        assert isinstance(rep, FleetReport)
        assert np.all(rep.assignment >= 0) and np.all(rep.assignment < r)
        assert np.all(rep.completions >= rep.admissions)
        assert np.all(rep.latency >= 0)
        assert rep.replicas_max == r and rep.replica_cycles > 0
        # static fleet: every replica active for the whole horizon
        assert rep.replica_cycles == pytest.approx(r * rep.horizon,
                                                   rel=1e-9)
        reps[r] = rep
    assert reps[3].p99 <= reps[1].p99
    again = simulate_fleet(tr, AutoscalePolicy.static(3), **KW)
    assert _as_plain(again) == _as_plain(reps[3])


def test_simulate_fleet_scales_up_and_down():
    sparse = np.arange(10) * 5e4
    burst = 6e5 + np.arange(120) * 15.0    # ~2x one replica's est capacity
    tail = 1.2e6 + np.arange(10) * 5e4
    arr = np.concatenate([sparse, burst, tail])
    knobs = dict(min_replicas=1, max_replicas=3, scale_up_backlog=0.05,
                 scale_down_backlog=0.04, boundary_cycles=500.0)
    rep = simulate_fleet(Trace(arr, np.full(len(arr), 8), kind="replay"),
                         AutoscalePolicy(**knobs), **KW)
    ref = jfleet.simulate_fleet(JTrace(arr, np.full(len(arr), 8),
                                       kind="replay"),
                                jfleet.AutoscalePolicy(**knobs), **KW)
    assert _as_plain(rep) == _as_plain(ref)
    static = simulate_fleet(Trace(arr, np.full(len(arr), 8), kind="replay"),
                            AutoscalePolicy.static(3), **KW)
    assert rep.replicas_max > 1                     # scaled up in the burst
    assert min(c for _, c in rep.timeline) == 1     # and back down
    assert rep.replica_cycles < static.replica_cycles
    assert rep.p99 <= static.p99 * (1 + 1e-9)


def test_degraded_schedule_is_exact_timing_twin(sess):
    rng = np.random.default_rng(8)
    n = 16
    arr = np.cumsum(rng.exponential(250.0, n)).astype(float)
    new = rng.integers(4, 20, n).astype(float)
    dls = arr + rng.uniform(8e2, 8e3, n)
    sched = [(0.0, 1.0), (float(arr[5]), 0.6), (float(arr[11]), 0.85)]
    reqs = [Request(prompt=rng.integers(0, CFG.vocab_size, size=5),
                    max_new=int(new[i]), arrival=float(arr[i]),
                    deadline=float(dls[i])) for i in range(n)]
    rep = sess.serve_open_loop(reqs, step_cycles=25.0, prefill_cycles=75.0,
                               step_schedule=sched, switch_cycles=40.0)
    adm, comp = _schedules(arr, new, batch_slots=sess.B, step_cycles=25.0,
                           prefill_cycles=75.0, deadlines=dls,
                           step_schedule=sched, switch_cycles=40.0)
    assert np.array_equal(rep.admissions, adm)
    assert np.array_equal(rep.completions, comp)
    assert rep.switch_stalls == 2
    assert rep.shed + rep.completed == n
    with pytest.raises(ValueError, match="scale"):
        open_loop_schedule(arr, new, batch_slots=2, step_cycles=1.0,
                           step_schedule=[(0.0, 0.0)])


def test_autoscale_policy_search_smoke():
    args = (300, 1e-4, 8e-3)
    kw = dict(dwell_base=1e5, dwell_burst=4e4, sizes=[8, 16], seed=2)
    search = dict(batch_slots=4, step_cycles=10.0, prefill_cycles=30.0,
                  max_replicas=3, n_trials=6, seed=0)
    pol, rep, base = autoscale_policy_search(mmpp_trace(*args, **kw),
                                             **search)
    jpol, jrep, jbase = j_policy_search(j_mmpp(*args, **kw), **search)
    assert _as_plain(pol) == _as_plain(jpol)
    assert _as_plain(rep) == _as_plain(jrep) and base == jbase
    assert 1 <= pol.min_replicas <= pol.max_replicas == 3
    assert 0 < pol.scale_down_backlog < pol.scale_up_backlog
    assert set(base) == {1, 2, 3, "static_best"}
    # determinism: same seed, same winner
    pol2, rep2, _ = autoscale_policy_search(mmpp_trace(*args, **kw),
                                            **search)
    assert pol2 == pol and rep2.p99 == rep.p99


def test_busiest_replica_replay_matches_the_timing_twin(sess):
    """The fleet's busiest replica's stream, replayed through the session
    at its routing times (act 3 of ``examples/fleet_serve.py``): the
    session's clocks equal ``open_loop_schedule``'s, and the port's search
    routes exactly as the JAX package's does."""
    tr = mmpp_trace(400, 2e-4, 1.5e-2, dwell_base=3e5, dwell_burst=8e4,
                    sizes=[8, 16], seed=0)
    kw = dict(batch_slots=sess.B, step_cycles=100.0, prefill_cycles=300.0)
    _, frep, _ = autoscale_policy_search(tr, max_replicas=3, n_trials=6,
                                         seed=0, **kw)
    _, jrep, _ = j_policy_search(
        j_mmpp(400, 2e-4, 1.5e-2, dwell_base=3e5, dwell_burst=8e4,
               sizes=[8, 16], seed=0), max_replicas=3, n_trials=6, seed=0,
        **kw)
    assert np.array_equal(frep.assignment, jrep.assignment)
    assert np.array_equal(frep.routed_at, jrep.routed_at)
    busiest = int(np.argmax(np.bincount(frep.assignment, minlength=3)))
    idx = np.flatnonzero(frep.assignment == busiest)[:6]
    sub = Trace(frep.routed_at[idx] - frep.routed_at[idx].min(),
                tr.sizes[idx], kind=tr.kind)
    reqs = requests_from_trace(sub, vocab_size=CFG.vocab_size, prompt_len=6,
                               seed=0)
    rep = sess.serve_open_loop(reqs, step_cycles=100.0, prefill_cycles=300.0)
    adm, comp = _schedules(sub.arrivals, sub.sizes, **kw)
    assert np.array_equal(rep.admissions, adm)
    assert np.array_equal(rep.completions, comp)
    assert [len(o) for o in rep.outputs] == [int(s) for s in sub.sizes]
